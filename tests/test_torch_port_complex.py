"""The complex-valued RG-LRU scan of the PyTorch port vs the JAX package.

On the CPU, the same seeded numpy inputs go through the JAX package's
``complex_lib`` and scan stack and through the port's: the ``Complex``
container's operations in float32 and bfloat16; the forward scan through
``ops.scan.linear_scan`` (the kernel path, which takes its plain versions
on CPU tensors) against ``lru_pallas_scan`` in interpret mode and against
``lru_linear_scan``; the native scans and the decode step; the gradients of
``x``, ``a`` and ``h0`` against ``jax.grad`` through the interpret-mode
kernel's ``custom_vjp``; and the sequence-sharded scan against JAX's
``shard_map`` on the 8 virtual CPU devices, forward and gradients.

Tolerances. float32 ops: both packages round each operation once in the
same order; XLA may fuse a multiply into an add, so results agree to a few
units in the last place (1e-6 relative, 1e-5 over a scan). bfloat16 ops and
scan outputs: one bf16 step, 2^-7 of the value (a rounding that went the
other way). Gradients: JAX's own tolerance between its kernel and native
paths, 1e-4 absolute (``tests/test_scan.py``).
"""

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu import complex_lib as jcl
from cadence_gemma_tpu.ops import pallas_lru
from cadence_gemma_tpu.ops import scan as jscan
from cadence_gemma_tpu.parallel import sharding as jsh
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import complex_lib as cl
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import scan
from cadence_gemma_tpu_torch.parallel import sharding

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
OP_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
          "bfloat16": dict(rtol=2.0**-7, atol=1e-6)}
SCAN_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=2.0**-7, atol=1e-5)}
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_ATOL = 1e-4


def _np(v):
  """float32 numpy components of a port or JAX value (real or Complex)."""
  if isinstance(v, (cl.Complex, jcl.Complex)):
    return _np(v.real), _np(v.imag)
  if isinstance(v, torch.Tensor):
    return v.detach().float().numpy()
  return np.asarray(v, np.float32)


def _assert_close(got, want, err_msg="", **tol):
  got, want = _np(got), _np(want)
  if isinstance(got, tuple):
    assert isinstance(want, tuple), err_msg
    for part, g, w in zip(("real", "imag"), got, want):
      np.testing.assert_allclose(g, w, err_msg=f"{err_msg} {part}", **tol)
  else:
    np.testing.assert_allclose(got, want, err_msg=err_msg, **tol)


def _pair(seed=0, shape=(3, 4), dtype="float32"):
  """(port Complex, JAX Complex) from one seeded numpy pair."""
  rng = np.random.default_rng(seed)
  re = rng.standard_normal(shape, dtype=np.float32)
  im = rng.standard_normal(shape, dtype=np.float32)
  tdt, jdt = DTYPES[dtype]
  return (cl.from_numpy(re, im).to(tdt),
          jcl.Complex(jnp.asarray(re, jdt), jnp.asarray(im, jdt)))


def _real(seed, shape, dtype="float32"):
  r = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
  tdt, jdt = DTYPES[dtype]
  return torch.tensor(r).to(tdt), jnp.asarray(r, jdt)


# -- complex_lib --------------------------------------------------------------

# (name, function of (module, x, y, r)): x, y Complex [3, 4] (y [4, 5] for
# matmul), r a real [3, 4]; each runs on the port and on JAX.
_OPS = {
    "add": lambda m, x, y, r: x + y,
    "sub": lambda m, x, y, r: x - y,
    "mul": lambda m, x, y, r: x * y,
    "div": lambda m, x, y, r: x / y,
    "add_scalar": lambda m, x, y, r: x + 2.0,
    "rsub_scalar": lambda m, x, y, r: 2.0 - x,
    "mul_scalar": lambda m, x, y, r: x * 3.0,
    "neg": lambda m, x, y, r: -x,
    "div_scalar": lambda m, x, y, r: x / 2.0,
    "mul_real": lambda m, x, y, r: x * r,
    "add_real": lambda m, x, y, r: x + r,
    "exp": lambda m, x, y, r: m.exp(x),
    "log": lambda m, x, y, r: m.log(x),
    "conjugate": lambda m, x, y, r: m.conjugate(x),
    "abs_squared": lambda m, x, y, r: m.abs_squared(x),
    "real_part": lambda m, x, y, r: m.real_part(x),
    "zeros_like": lambda m, x, y, r: m.zeros_like(x),
    "ones_like": lambda m, x, y, r: m.ones_like(x),
    "getitem": lambda m, x, y, r: x[1:, ::2],
    "reshape": lambda m, x, y, r: x.reshape(4, 3),
    "concatenate": lambda m, x, y, r: m.concatenate([x, r, y], axis=1),
    "where": lambda m, x, y, r: m.where(r > 0, x, y),
    "where_real": lambda m, x, y, r: m.where(r > 0, x, r),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", sorted(_OPS))
def test_complex_lib_op_matches_jax(op, dtype):
  x, xj = _pair(0, dtype=dtype)
  y, yj = _pair(1, dtype=dtype)
  r, rj = _real(2, (3, 4), dtype)
  if op in ("div", "log"):  # away from the poles at 0
    y, yj = y + 3.0, yj + 3.0
    x, xj = x + 3.0, xj + 3.0
  got = _OPS[op](cl, x, y, r)
  want = _OPS[op](jcl, xj, yj, rj)
  assert isinstance(got, cl.Complex) == isinstance(want, jcl.Complex)
  assert got.dtype == DTYPES[dtype][0]
  _assert_close(got, want, op, **OP_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["matmul", "einsum", "einsum_real",
                                  "einsum_three"])
def test_complex_lib_products_match_jax(case, dtype):
  x, xj = _pair(0, (3, 4), dtype)
  y, yj = _pair(1, (4, 5), dtype)
  r, rj = _real(2, (4, 5), dtype)
  s, sj = _real(3, (5, 2), dtype)
  if case == "matmul":
    got, want = x @ y, xj @ yj
  elif case == "einsum":
    got = cl.einsum("ij,jk->ik", x, y)
    want = jcl.einsum("ij,jk->ik", xj, yj)
  elif case == "einsum_real":
    got = cl.einsum("ij,jk->ik", x, r)
    want = jcl.einsum("ij,jk->ik", xj, rj)
  else:
    got = cl.einsum("ij,jk,kl->il", x, r, s)
    want = jcl.einsum("ij,jk,kl->il", xj, rj, sj)
  # Sums of products in another order (BLAS vs XLA): float32 rounding of
  # a 4-term dot, or one bf16 step.
  tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
         else dict(rtol=2.0**-7, atol=2e-2))
  _assert_close(got, want, case, **tol)


_LIFTED = {
    "reshape": (lambda x: cl.reshape(x, (4, 3)),
                lambda x: jcl.reshape(x, (4, 3))),
    "transpose": (lambda x: cl.transpose(x, 0, 1),
                  lambda x: jcl.transpose(x)),
    "flip": (lambda x: cl.flip(x, (1,)), lambda x: jcl.flip(x, axis=1)),
    "expand_dims": (lambda x: cl.expand_dims(x, 0),
                    lambda x: jcl.expand_dims(x, 0)),
    "tile": (lambda x: cl.tile(x, (2, 1)), lambda x: jcl.tile(x, (2, 1))),
    "broadcast_to": (lambda x: cl.broadcast_to(x, (5, 3, 4)),
                     lambda x: jcl.broadcast_to(x, (5, 3, 4))),
    "squeeze": (lambda x: cl.squeeze(cl.expand_dims(x, 0), 0),
                lambda x: jcl.squeeze(jcl.expand_dims(x, 0), axis=0)),
    "narrow": (lambda x: cl.narrow(x, 1, 1, 2),
               lambda x: jcl.slice_in_dim(x, 1, 3, axis=1)),
    "pad_value": (lambda x: cl.pad(x, (1, 1), value=1.0),
                  lambda x: jcl.pad(x, 1.0, [(0, 0, 0), (1, 1, 0)])),
    "add_real": (lambda x: cl.add(x, torch.ones(3, 4)),
                 lambda x: jcl.add(x, jnp.ones((3, 4)))),
}


@pytest.mark.parametrize("name", sorted(_LIFTED))
def test_lifted_structural_op_matches_jax(name):
  """Componentwise lifting: a bare real operand (a tensor, a pad value)
  takes a zero imaginary part."""
  x, xj = _pair(0)
  ours, theirs = _LIFTED[name]
  got, want = ours(x), theirs(xj)
  assert isinstance(got, cl.Complex)
  _assert_close(got, want, name, rtol=0, atol=0)


def test_stack_split_and_real_passthrough():
  x, xj = _pair(0)
  y, yj = _pair(1)
  s = cl.stack([x, y], 0)
  _assert_close(s, jcl.stack([xj, yj], axis=0), rtol=0, atol=0)
  parts = cl.split(s, 1, 0)
  assert len(parts) == 2 and all(isinstance(p, cl.Complex) for p in parts)
  _assert_close(parts[1][0], y, rtol=0, atol=0)
  r = torch.arange(12.0).reshape(3, 4)
  out = cl.reshape(r, (4, 3))
  assert isinstance(out, torch.Tensor) and torch.equal(out, r.reshape(4, 3))
  assert isinstance(cl.exp(r), torch.Tensor)


def test_container_protocol_and_conversions():
  x, xj = _pair(0, (2, 6))
  assert x.shape == (2, 6) and x.ndim == 2
  assert x.dtype == torch.float32 and x.device.type == "cpu"
  assert x.to(torch.bfloat16).dtype == torch.bfloat16
  assert x.astype(None) is x
  assert x.reshape((3, 4)).shape == (3, 4) and x[0].shape == (6,)
  # bf16 components stay bf16 through the product: no complex dtype.
  b = x.to(torch.bfloat16)
  assert (b * b).dtype == torch.bfloat16
  native = x.to_complex64()
  assert native.dtype == torch.complex64
  np.testing.assert_allclose(native.numpy(), xj.to_numpy(), atol=0)
  back = cl.to_custom_complex(native)
  assert torch.equal(back.real, x.real) and torch.equal(back.imag, x.imag)
  real = cl.to_custom_complex(x.real)
  assert torch.equal(real.imag, torch.zeros_like(x.real))
  assert cl.to_custom_complex(x) is x and cl.is_complex(x)
  assert not cl.is_complex(x.real)
  assert bool((x == x).all()) and not bool((x == x + 1.0).any())
  with pytest.raises(ValueError, match="shape"):
    cl.Complex(torch.zeros(2), torch.zeros(3))


# -- the scans ----------------------------------------------------------------


def _scan_case(b, t, d, seed=0, dtype="float32"):
  """(port x, a, h0; JAX x, a, h0): x, h0 normal; a = sigmoid + 0.1i
  normal, a decay of modulus near the real scan's."""
  rng = np.random.default_rng(seed)
  xr, xi = rng.standard_normal((2, b, t, d), dtype=np.float32)
  ar = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, d))))).astype(
      np.float32)
  ai = (0.1 * rng.standard_normal((b, t, d))).astype(np.float32)
  h0r, h0i = rng.standard_normal((2, b, d), dtype=np.float32)
  tdt, jdt = DTYPES[dtype]
  port = (cl.from_numpy(xr, xi).to(tdt), cl.from_numpy(ar, ai).to(tdt),
          cl.from_numpy(h0r, h0i))
  jax_ = (jcl.Complex(jnp.asarray(xr, jdt), jnp.asarray(xi, jdt)),
          jcl.Complex(jnp.asarray(ar, jdt), jnp.asarray(ai, jdt)),
          jcl.Complex(jnp.asarray(h0r), jnp.asarray(h0i)))
  return port, jax_


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_forward_scan_matches_jax(dtype, reverse, with_h0):
  """The port's kernel path (plain on the CPU) vs the interpret-mode Pallas
  kernel and ``lru_linear_scan``; d = 200 is off the TPU's 128 lanes."""
  (x, a, h0), (xj, aj, h0j) = _scan_case(2, 40, 200, dtype=dtype)
  if not with_h0:
    h0 = h0j = None
  with pltpu.force_tpu_interpret_mode():
    want_pallas = pallas_lru.lru_pallas_scan(xj, aj, h0j, reverse)
  want_lax = jscan.lru_linear_scan(xj, aj, h0j, reverse=reverse)
  launches = lru_scan.complex_launches
  y, h_last = scan.linear_scan(x, a, h0, reverse=reverse)
  assert lru_scan.complex_launches == launches  # plain on the CPU
  assert isinstance(y, cl.Complex) and isinstance(h_last, cl.Complex)
  assert y.dtype == DTYPES[dtype][0] and h_last.dtype == torch.float32
  for name, (y_ref, h_ref) in (("pallas", want_pallas), ("lax", want_lax)):
    _assert_close(y, y_ref, name, **SCAN_TOL[dtype])
    _assert_close(h_last, h_ref, name, **STATE_TOL)


@pytest.mark.parametrize("scan_type", ["LINEAR_NATIVE", "ASSOCIATIVE_NATIVE"])
@pytest.mark.parametrize("reverse", [False, True])
def test_native_scans_match_jax(scan_type, reverse):
  (x, a, h0), (xj, aj, h0j) = _scan_case(2, 37, 24, seed=1)
  # Jitted: eager JAX runs the associative scan op by op.
  jfn = jax.jit(jscan.lru_linear_scan if scan_type == "LINEAR_NATIVE"
                else jscan.lru_associative_scan,
                static_argnames=("reverse", "return_a_prod"))
  want = jfn(xj, aj, h0j, reverse=reverse)
  got = scan.linear_scan(x, a, h0, reverse=reverse,
                         scan_type=common.ScanType[scan_type])
  # The associative scans sum in other orders on the two sides: float32
  # reassociation over 37 steps of |a| < 1.
  for g, w in zip(got, want):
    _assert_close(g, w, scan_type, **STATE_TOL)
  # With the product of `a` (the native scans' sequence-parallel contract).
  pfn = (scan.lru_linear_scan if scan_type == "LINEAR_NATIVE"
         else scan.lru_associative_scan)
  (_, _), (a_prod, p_last) = pfn(x, a, None, reverse=reverse,
                                 return_a_prod=True)
  (_, _), (a_prod_j, p_last_j) = jfn(xj, aj, None, reverse=reverse,
                                     return_a_prod=True)
  _assert_close(a_prod, a_prod_j, "a_prod", **STATE_TOL)
  _assert_close(p_last, p_last_j, "a_prod_last", **STATE_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_decode_step_matches_jax(with_h0):
  (x, a, h0), (xj, aj, h0j) = _scan_case(3, 1, 8, seed=2)
  if not with_h0:
    h0 = h0j = None
  got = scan.linear_scan(x, a, h0)
  want = jscan.linear_scan(xj, aj, h0j)
  for g, w in zip(got, want):
    _assert_close(g, w, rtol=1e-6, atol=1e-6)


def _loss_port(y, h):
  return ((y.real.float() ** 2 + y.imag.float() ** 2).sum()
          + (h.real ** 2 + h.imag ** 2).sum())


def _loss_jax(y, h):
  return (jnp.sum(y.real.astype(jnp.float32) ** 2
                  + y.imag.astype(jnp.float32) ** 2)
          + jnp.sum(h.real ** 2 + h.imag ** 2))


def _port_grads(x, a, h0, **kwargs):
  """Gradients of the loss through ``linear_scan`` with respect to the
  components of x, a and (if given) h0."""
  leaves = [v for v in (x, a, h0) if v is not None]
  inputs = [z.clone().requires_grad_() for v in leaves
            for z in (v.real, v.imag)]
  pairs = [cl.Complex(*inputs[i:i + 2]) for i in range(0, len(inputs), 2)]
  y, h = scan.linear_scan(pairs[0], pairs[1],
                          pairs[2] if h0 is not None else None, **kwargs)
  grads = torch.autograd.grad(_loss_port(y, h), inputs)
  return [cl.Complex(*grads[i:i + 2]) for i in range(0, len(grads), 2)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_gradients_match_jax(reverse, with_h0):
  """dx, da (= dx * conj(h_prev)) and dh0 of the port's autograd Function
  vs ``jax.grad`` through the interpret-mode kernel's ``custom_vjp``
  (the premultiply scan with conj(a))."""
  (x, a, h0), (xj, aj, h0j) = _scan_case(1, 32, 16, seed=3)
  if not with_h0:
    h0 = h0j = None
  argnums = (0, 1, 2) if with_h0 else (0, 1)

  def loss_j(*args):
    y, h = pallas_lru.lru_pallas_scan(
        args[0], args[1], args[2] if with_h0 else None, reverse)
    return _loss_jax(y, h)

  with pltpu.force_tpu_interpret_mode():
    want = jax.grad(loss_j, argnums=argnums)(
        *((xj, aj, h0j) if with_h0 else (xj, aj)))
  launches = lru_scan.complex_backward_launches
  got = _port_grads(x, a, h0, reverse=reverse)
  assert lru_scan.complex_backward_launches == launches
  assert len(got) == len(want)
  for name, g, w in zip(("dx", "da", "dh0"), got, want):
    _assert_close(g, w, name, rtol=0, atol=GRAD_ATOL)


def _spec_pair(axis_shapes):
  n = int(np.prod(axis_shapes))
  names = ("data", "sequence")
  kw = dict(batch_axis_name="data", sequence_axis_name="sequence")
  return (jsh.ShardingSpec(
              mesh=jsh.make_mesh(axis_shapes, names, jax.devices()[:n]), **kw),
          sharding.ShardingSpec(
              mesh=sharding.make_mesh(axis_shapes, names, ["cpu"] * n), **kw))


@pytest.mark.parametrize("scan_type,mesh,with_h0", [
    ("LINEAR_NATIVE", (1, 8), False),
    ("LINEAR_NATIVE", (2, 4), True),
    ("LINEAR_PALLAS", (1, 4), False),
    ("LINEAR_PALLAS", (1, 4), True),
])
def test_sequence_sharded_scan_matches_jax(scan_type, mesh, with_h0):
  """The port's sequence-sharded complex scan (the complex correction;
  the kernel path's sharded autograd Function) vs JAX's ``shard_map``:
  forward and the gradients of x, a and h0."""
  jspec, tspec = _spec_pair(mesh)
  (x, a, h0), (xj, aj, h0j) = _scan_case(2, 32, 8, seed=4)
  if not with_h0:
    h0 = h0j = None
  kind = dict(scan_type=common.ScanType[scan_type], reverse=with_h0)
  jkind = dict(scan_type=jcommon.ScanType[scan_type], reverse=with_h0)
  argnums = (0, 1, 2) if with_h0 else (0, 1)

  @jax.jit
  def forward_and_grads(*args):
    def loss(*args):
      return _loss_jax(*jscan.linear_scan(
          args[0], args[1], args[2] if with_h0 else None,
          sharding_spec=jspec, **jkind))

    out = jscan.linear_scan(args[0], args[1], args[2] if with_h0 else None,
                            sharding_spec=jspec, **jkind)
    return out, jax.grad(loss, argnums=argnums)(*args)

  with pltpu.force_tpu_interpret_mode():
    want, want_grads = jax.block_until_ready(
        forward_and_grads(*((xj, aj, h0j) if with_h0 else (xj, aj))))
  counts = (lru_scan.complex_a_prod_launches,
            lru_scan.complex_backward_a_prod_launches)
  got = scan.linear_scan(x, a, h0, sharding_spec=tspec, **kind)
  got_grads = _port_grads(x, a, h0, sharding_spec=tspec, **kind)
  assert counts == (lru_scan.complex_a_prod_launches,
                    lru_scan.complex_backward_a_prod_launches)
  for name, g, w in zip(("y", "h_last"), got, want):
    _assert_close(g, w, name, **STATE_TOL)
  for name, g, w in zip(("dx", "da", "dh0"), got_grads, want_grads):
    _assert_close(g, w, name, rtol=0, atol=GRAD_ATOL)


def test_sharded_scan_equals_unsharded_on_one_device():
  """The kernel path's sharded Function against the unsharded scan of the
  port itself: the corrections in float32 agree to float32 reassociation."""
  (x, a, h0), _ = _scan_case(1, 48, 6, seed=5)
  _, tspec = _spec_pair((1, 4))
  got = scan.linear_scan(x, a, h0, sharding_spec=tspec)
  want = scan.linear_scan(x, a, h0)
  for g, w in zip(got, want):
    _assert_close(g, w, **STATE_TOL)
  grads = _port_grads(x, a, h0, sharding_spec=tspec)
  grads_ref = _port_grads(x, a, h0)
  for g, w in zip(grads, grads_ref):
    _assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_native_complex_tensors_are_refused():
  """A torch complex64 tensor is refused with a pointer to the container,
  as JAX's Pallas path refuses one."""
  (x, a, _), _ = _scan_case(1, 4, 3)
  native_x, native_a = x.to_complex64(), a.to_complex64()
  with pytest.raises(ValueError, match="to_custom_complex"):
    scan.linear_scan(native_x, native_a)
  with pytest.raises(ValueError, match="to_custom_complex"):
    lru_scan.lru_scan_forward(native_x, native_a)
  with pytest.raises(ValueError, match="both be real or both Complex"):
    lru_scan.lru_scan(x, a.real)
  y, _ = scan.linear_scan(cl.to_custom_complex(native_x),
                          cl.to_custom_complex(native_a))
  _assert_close(y, scan.linear_scan(x, a)[0], rtol=0, atol=0)
