"""Kernel modules of the PyTorch port: plain versions vs JAX, kernels vs plain.

CPU tests hold each kernel's plain PyTorch version against the JAX package's
Pallas kernel, run in interpret mode as the JAX package's own tests run it,
and against its einsum / ``lax.scan`` oracle, on the same numpy inputs:
forwards, and the backwards through the port's autograd Functions against
``jax.vjp`` of the JAX ``custom_vjp``s.

Card tests (skipped without CUDA) build the CUDA kernels and hold them
against the plain versions on the card, at small shapes and at the shapes
of the RecurrentGemma-2B prefill and training step, of the vision towers
of the sequence-parallel prefill's shards that ``chip_smoke.py``
drives, and the complex scan's four entry points. They import
no JAX, so they also run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_port_kernels.py -k "cuda or bits"``.
"""

import numpy as np
import pytest
import torch

from cadence_gemma_tpu_torch import complex_lib
from cadence_gemma_tpu_torch.ops import fused_epilogue
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import mha_attention
from cadence_gemma_tpu_torch.ops import scan
from cadence_gemma_tpu_torch.ops import window_attention as wa
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import sp_attention

# A string condition is evaluated when each test is set up, not when the
# module is imported, so every pytest-xdist worker collects the same tests.
requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)


def _lru_inputs(b, t, d, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((b, t, d), dtype=np.float32)
  a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, d), dtype=np.float32)))
  h0 = rng.standard_normal((b, d), dtype=np.float32)
  return x, a.astype(np.float32), h0


def _attn_inputs(b, t, n, h, pad=0, boundary=None, seed=0, offset=0,
                 right_pad=0):
  """q, k, v and segment_pos; row 0 left-padded by `pad`, row 1 (if any)
  starts a second document at `boundary` and is right-padded by
  `right_pad` as the trainer pads (the last position repeats); positions
  start at `offset`."""
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, t, n, h), dtype=np.float32)
  k = rng.standard_normal((b, t, 1, h), dtype=np.float32)
  v = rng.standard_normal((b, t, 1, h), dtype=np.float32)
  seg = np.tile(np.arange(offset, offset + t, dtype=np.int32), (b, 1))
  if pad:
    seg[0] = np.arange(t, dtype=np.int32) - pad
    seg[0, :pad] = -1
  if boundary is not None and b > 1:
    seg[1, boundary:] = np.arange(t - boundary, dtype=np.int32)
  if right_pad and b > 1:
    seg[1, t - right_pad:] = seg[1, t - right_pad - 1]
  return q, k, v, seg


def _jax_bf16(x):
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel

  return jnp.asarray(x, jnp.bfloat16)


_U32 = 2.0**-24  # float32 unit roundoff


def _attention_oracle(q, k, v, seg, window):
  """Float64 outputs of the windowed attention and, per output, a bound on
  the error of any float32 evaluation that sums in another order.

  A float32 dot of h terms errs by at most gamma_h * sum|q_i k_i|
  (gamma_h = h u / (1 - h u)), so each scaled logit of a row is off by at
  most eps_s = gamma_h * scale * max_k sum_i |q_i k_i|. The softmax weights
  then err by a relative 2 eps_s plus the roundings of exp, the normalizer
  and the n_visible-term weighted sum, and an output by at most
  max|v| * (2 eps_s + (n_visible + 8) u). Rows that see no key are exact
  zeros.
  """
  q, k, v = (z.astype(np.float64) for z in (q, k, v))
  _, t, _, h = q.shape
  pos = np.arange(t)
  lower = np.maximum(pos[None] - window, pos[None] - seg)
  vis = ((pos[None, None] >= lower[..., None])
         & (pos[None, None] <= pos[None, :, None])
         & (seg >= 0)[..., None])[:, None]  # [b, 1, t, s]
  scale = h**-0.5
  s = np.einsum("btnh,bsh->bnts", q, k[:, :, 0]) * scale
  s = np.where(vis, s, -np.inf)
  m = s.max(-1, keepdims=True)
  m = np.where(np.isfinite(m), m, 0.0)
  p = np.exp(s - m)
  l = p.sum(-1, keepdims=True)
  out = np.einsum("bnts,bsh->btnh", p / np.where(l > 0, l, 1.0), v[:, :, 0])

  gamma = h * _U32 / (1 - h * _U32)
  abs_dot = np.einsum("btnh,bsh->bnts", np.abs(q), np.abs(k[:, :, 0]))
  eps_s = gamma * scale * np.where(vis, abs_dot, 0.0).max(-1)  # [b, n, t]
  n_vis = vis.sum(-1)  # [b, 1, t]
  v_max = np.where(vis, np.abs(v[:, None, None, :, 0]).max(-1), 0.0).max(-1)
  bound = v_max * (2 * eps_s + (n_vis + 8) * _U32)  # [b, n, t]
  return out, bound.transpose(0, 2, 1)[..., None]  # [b, t, n, 1]


def _assert_within_oracle(name, got, oracle, bound):
  err = np.abs(np.asarray(got, np.float64) - oracle)
  over = err > bound
  assert not over.any(), (
      f"{name}: {over.sum()} of {over.size} outputs beyond the float32 bound "
      f"of the float64 oracle; worst error {err.max():.3e}, "
      f"bound there {np.broadcast_to(bound, err.shape)[over].min():.3e}"
  )


# -- CPU: plain versions vs the JAX package ---------------------------------

# Both sides run the same float32 recurrence; XLA may fuse the multiply-add,
# so fp32 agrees to 1e-5. bf16 outputs are the same fp32 carry rounded once
# to bf16: one bf16 rounding step (2^-8 relative) covers any difference.
_LRU_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=2e-2, rtol=8e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_plain_matches_jax(dtype, reverse, with_h0):
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import pallas_lru  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import scan as jax_scan  # pylint: disable=import-outside-toplevel

  # d = 200 is not a multiple of the TPU kernel's 128 lanes.
  x, a, h0 = _lru_inputs(2, 40, 200)
  h0_j = jnp.asarray(h0) if with_h0 else None
  jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
  xj, aj = jnp.asarray(x, jdt), jnp.asarray(a, jdt)
  with pltpu.force_tpu_interpret_mode():
    y_pallas, h_pallas = pallas_lru.lru_pallas_scan(xj, aj, h0_j, reverse)
  y_lax, h_lax = jax_scan.lru_linear_scan(xj, aj, h0_j, reverse=reverse)

  y, h = lru_scan.lru_scan(
      torch.tensor(x).to(dtype), torch.tensor(a).to(dtype),
      torch.tensor(h0) if with_h0 else None, reverse,
  )
  assert y.dtype == dtype and h.dtype == torch.float32
  for y_ref, h_ref in ((y_pallas, h_pallas), (y_lax, h_lax)):
    np.testing.assert_allclose(
        y.float().numpy(), np.asarray(y_ref, np.float32), **_LRU_TOL[dtype]
    )
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_sequential(reverse):
  x, a, h0 = _lru_inputs(2, 37, 24, seed=1)
  args = (torch.tensor(x), torch.tensor(a), torch.tensor(h0))
  y1, h1 = scan.lru_linear_scan(*args, reverse=reverse)
  y2, h2 = scan.lru_associative_scan(*args, reverse=reverse)
  # Different summation order in float32 over 37 steps of |a| < 1.
  torch.testing.assert_close(y1, y2, atol=1e-5, rtol=1e-5)
  torch.testing.assert_close(h1, h2, atol=1e-5, rtol=1e-5)


def test_linear_scan_decode_step_is_closed_form():
  x, a, h0 = _lru_inputs(3, 1, 8, seed=2)
  y, h = scan.linear_scan(torch.tensor(x), torch.tensor(a), torch.tensor(h0))
  want = a[:, 0] * h0 + x[:, 0]
  np.testing.assert_allclose(y[:, 0].numpy(), want, atol=1e-6)
  np.testing.assert_allclose(h.numpy(), want, atol=1e-6)


def test_linear_scan_rejects_sharding():
  """Sharding without a mesh (JAX's pmap regime) runs one process a card:
  its axis name must be bound to a process group (``sharding.axis_env``);
  an unbound name raises as JAX's unbound axis does."""
  x, a, _ = _lru_inputs(1, 4, 8)
  spec = sharding.ShardingSpec(mesh=None, sequence_axis_name="sequence")
  with pytest.raises(NameError, match="pmap"):
    scan.linear_scan(torch.tensor(x), torch.tensor(a), sharding_spec=spec)


def test_window_attention_plain_matches_jax():
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import pallas_attention as fa  # pylint: disable=import-outside-toplevel

  window = 128
  q, k, v, seg = _attn_inputs(2, 300, 2, 128, pad=40, boundary=150)
  with pltpu.force_tpu_interpret_mode():
    out_j, lse_j = fa._flash_window_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        window,
    )
  out, lse = wa.window_attention(
      torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(seg),
      window,
  )
  # Both sides are float32 sums in different orders (the kernel's online
  # softmax over 128-key tiles, the plain einsum over the whole row): each
  # is held against the float64 oracle within the float32 error bound, so a
  # failure names the side that moved.
  oracle, bound = _attention_oracle(q, k, v, seg, window)
  _assert_within_oracle("port plain version", out.numpy(), oracle, bound)
  _assert_within_oracle("JAX Pallas kernel", np.asarray(out_j), oracle, bound)
  np.testing.assert_allclose(
      lse.numpy(), np.asarray(lse_j)[:, :, :300, 0], atol=1e-4, rtol=1e-6
  )
  # Left padding: zeros and the masked lse.
  assert not out[0, :40].any()
  assert (lse[0, :, :40] == wa.MASKED_LSE).all()

  # Valid rows also equal the JAX einsum oracle and its port (their padded
  # rows attend the padding among themselves; the kernels' give zeros).
  ref_j = np.asarray(fa._reference_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
      window,
  ))
  ref = wa.reference_attention(
      torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(seg),
      window,
  ).numpy()
  real = (seg >= 0)[..., None, None]
  _assert_within_oracle("JAX einsum oracle", np.where(real, ref_j, 0.0),
                        oracle, bound)
  _assert_within_oracle("port einsum oracle", np.where(real, ref, 0.0),
                        oracle, bound)


def test_window_attention_plain_matches_jax_offset_positions():
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import pallas_attention as fa  # pylint: disable=import-outside-toplevel

  # Positions from 500 with no cache before them: qp - segment_pos < 0, so
  # the document bound must stop at key 0 (the JAX kernel clamps it there).
  window = 256
  q, k, v, seg = _attn_inputs(1, 200, 2, 128, offset=500, seed=3)
  with pltpu.force_tpu_interpret_mode():
    out_j, lse_j = fa._flash_window_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        window,
    )
  out, lse = wa.window_attention(
      torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(seg),
      window,
  )
  # float32 sums in two orders, each within the float32 bound of float64.
  oracle, bound = _attention_oracle(q, k, v, seg, window)
  _assert_within_oracle("port plain version", out.numpy(), oracle, bound)
  _assert_within_oracle("JAX Pallas kernel", np.asarray(out_j), oracle, bound)
  np.testing.assert_allclose(
      lse.numpy(), np.asarray(lse_j)[:, :, :200, 0], atol=1e-4, rtol=1e-6
  )


def test_attention_oracle_bound_is_tight_enough():
  """The float32 bound is far below the outputs' size: a wrong mask or
  softmax (here: one key more per row) still fails it."""
  q, k, v, seg = _attn_inputs(2, 300, 2, 128, pad=40, boundary=150)
  oracle, bound = _attention_oracle(q, k, v, seg, 128)
  wider, _ = _attention_oracle(q, k, v, seg, 129)
  real = (seg >= 0)[..., None, None]
  assert bound.max() < 2e-3
  assert (np.abs(wider - oracle) > bound)[np.broadcast_to(real, oracle.shape)].any()


# The cotangent scan runs the same float32 operations in the same order on
# both sides (XLA may fuse the multiply into the next add): dx and dh0 agree
# to 1e-5 in float32, and da = dx * h_prev to 1e-5 relative. In bf16 each
# output is one rounding of the same float32 value (one bf16 step, as the
# forward); against the lax.scan path da also differs by that path's use of
# the float32 carry instead of the bf16 outputs for h_prev (one more step).
_LRU_BWD_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
                torch.bfloat16: dict(atol=2e-2, rtol=8e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_backward_plain_matches_jax(dtype, reverse, with_h0):
  import jax  # pylint: disable=import-outside-toplevel
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import pallas_lru  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import scan as jax_scan  # pylint: disable=import-outside-toplevel

  # d = 200 is not a multiple of the TPU kernel's 128 lanes.
  x, a, h0 = _lru_inputs(2, 40, 200)
  rng = np.random.default_rng(5)
  g_y = rng.standard_normal(x.shape, dtype=np.float32)
  g_h = rng.standard_normal(h0.shape, dtype=np.float32)
  jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
  args = [jnp.asarray(x, jdt), jnp.asarray(a, jdt)]
  if with_h0:
    args.append(jnp.asarray(h0))
  cotangents = (jnp.asarray(g_y, jdt), jnp.asarray(g_h))

  def pallas(x, a, *h0):
    return pallas_lru.lru_pallas_scan(x, a, *h0, reverse=reverse)

  def lax(x, a, *h0):
    return jax_scan.lru_linear_scan(x, a, *h0, reverse=reverse)

  # The context covers the backward's trace: its own pallas_call.
  with pltpu.force_tpu_interpret_mode():
    _, vjp = jax.vjp(pallas, *args)
    want_pallas = vjp(cotangents)
  _, vjp = jax.vjp(lax, *args)
  want_lax = vjp(cotangents)

  inputs = [torch.tensor(x).to(dtype).requires_grad_(),
            torch.tensor(a).to(dtype).requires_grad_()]
  if with_h0:
    inputs.append(torch.tensor(h0).requires_grad_())
  y, h = lru_scan.lru_scan(*inputs, reverse=reverse)
  got = torch.autograd.grad(
      (y, h), inputs, (torch.tensor(g_y).to(dtype), torch.tensor(g_h))
  )
  assert [g.dtype for g in got] == [z.dtype for z in inputs]
  for want in (want_pallas, want_lax):
    for name, g, w in zip(("dx", "da", "dh0"), got, want):
      np.testing.assert_allclose(
          g.float().numpy(), np.asarray(w, np.float32),
          **(_LRU_BWD_TOL[dtype] if name != "dh0" else _LRU_BWD_TOL[
              torch.float32]), err_msg=name,
      )


def test_lru_backward_plain_is_exact_cotangent_scan():
  """The plain backward against the recurrence written out in float64."""
  x, a, _ = _lru_inputs(1, 12, 5, seed=4)
  g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
  dx, dh0 = lru_scan.lru_scan_backward_plain(torch.tensor(g), torch.tensor(a))
  want = np.zeros_like(g, dtype=np.float64)
  carry = np.zeros(g[:, 0].shape)
  for t in range(g.shape[1] - 1, -1, -1):
    carry = carry + g[:, t]
    want[:, t] = carry
    carry = carry * a[:, t]
  np.testing.assert_allclose(dx.numpy(), want, rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(dh0.numpy(), carry, rtol=1e-5, atol=1e-6)


# A complex case's dtype: its components' dtype, marked Complex.
_COMPLEX_BF16 = (complex_lib.Complex, torch.bfloat16)
_COMPLEX_F32 = (complex_lib.Complex, torch.float32)


def _route_streams(shape, dtype, misaligned):
  """x and a of a route case: real tensors, or Complex pairs for a dtype
  marked Complex. ``misaligned`` puts x's base (a Complex x's imaginary
  component's) one element past a 16-byte boundary."""
  if isinstance(dtype, tuple):
    z = torch.zeros(shape, dtype=dtype[1])
    imag = _misaligned(z) if misaligned else torch.zeros_like(z)
    return [complex_lib.Complex(z, imag),
            complex_lib.Complex(torch.zeros_like(z), torch.zeros_like(z))]
  x = torch.zeros(shape, dtype=dtype)
  return [_misaligned(x) if misaligned else x, torch.zeros_like(x)]


@pytest.mark.parametrize("shape, dtype, misaligned, ring", [
    ((2, 3000, 2560), torch.bfloat16, False, True),
    ((1, 4096, 2560), torch.float32, False, True),
    ((3, 5, 8), torch.bfloat16, False, True),
    ((3, 5, 4), torch.float32, False, True),
    ((1, 9, 7), torch.float32, False, False),
    ((2, 64, 33), torch.bfloat16, False, False),
    ((2, 64, 12), torch.bfloat16, False, False),
    ((2, 0, 2560), torch.bfloat16, False, False),
    ((2, 300, 2560), torch.bfloat16, True, False),
    # Complex operands: the complex path's shapes in bf16 and fp32 take the
    # ring; a misaligned imaginary component, an odd width or t = 0 not.
    ((2, 4096, 2560), _COMPLEX_BF16, False, True),
    ((1, 4096, 2560), _COMPLEX_BF16, False, True),
    ((2, 4096, 2560), _COMPLEX_F32, False, True),
    ((1, 4096, 2560), _COMPLEX_F32, False, True),
    ((2, 300, 2560), _COMPLEX_BF16, True, False),
    ((2, 300, 2560), _COMPLEX_F32, True, False),
    ((2, 64, 33), _COMPLEX_BF16, False, False),
    ((2, 0, 2560), _COMPLEX_BF16, False, False),
])
def test_lru_ring_route_rule(shape, dtype, misaligned, ring):
  """Which scans run on the TMA ring (csrc/lru_ring.cuh): rows of a
  multiple of 16 bytes, 16-byte aligned bases of every component of every
  stream, a non-empty time axis."""
  streams = _route_streams(shape, dtype, misaligned)
  assert lru_scan._takes_ring(*streams) == ring  # pylint: disable=protected-access


def _attention_cotangent(q, seg, seed=7, real_only=False):
  g = np.random.default_rng(seed).standard_normal(q.shape, dtype=np.float32)
  return g * (seg >= 0)[..., None, None] if real_only else g


# float32 on both sides in other summation orders; 3e-5 is the JAX
# package's own tolerance between its flash backward and the einsum's.
_ATTN_BWD_ATOL = 3e-5


def test_window_attention_backward_plain_matches_jax():
  import jax  # pylint: disable=import-outside-toplevel
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import pallas_attention as fa  # pylint: disable=import-outside-toplevel

  window = 128
  q, k, v, seg = _attn_inputs(2, 300, 2, 128, pad=40, boundary=150)
  qkv_j = [jnp.asarray(z) for z in (q, k, v)]
  qkv = [torch.tensor(z).requires_grad_() for z in (q, k, v)]

  def port_grads(g):
    out, _ = wa.window_attention(*qkv, torch.tensor(seg), window)
    return torch.autograd.grad(out, qkv, torch.tensor(g))

  # Against the Pallas dq / dk-dv kernels in interpret mode, with a
  # cotangent on every row (the kernels give padded rows zero outputs).
  g = _attention_cotangent(q, seg)
  with pltpu.force_tpu_interpret_mode():
    _, vjp = jax.vjp(
        lambda *z: fa.flash_window_attention(*z, jnp.asarray(seg), window),
        *qkv_j,
    )
    want = vjp(jnp.asarray(g))
  got = port_grads(g)
  for name, a_, b_ in zip(("dq", "dk", "dv"), got, want):
    np.testing.assert_allclose(a_.numpy(), np.asarray(b_),
                               atol=_ATTN_BWD_ATOL, err_msg=name)
  # Padded rows get zero gradients: no dq, and their keys feed no one.
  assert not got[0][0, :40].any()
  assert not got[1][0, :40].any() and not got[2][0, :40].any()

  # Against autodiff of the einsum oracle, on the real rows' cotangent
  # (the oracle's padded rows attend the padding among themselves).
  g = _attention_cotangent(q, seg, real_only=True)
  _, vjp = jax.vjp(
      lambda *z: fa._reference_attention(*z, jnp.asarray(seg), window),
      *qkv_j,
  )
  want = vjp(jnp.asarray(g))
  got = port_grads(g)
  for name, a_, b_ in zip(("dq", "dk", "dv"), got, want):
    np.testing.assert_allclose(a_.numpy(), np.asarray(b_),
                               atol=_ATTN_BWD_ATOL, err_msg=name)


def test_window_attention_backward_plain_is_split_like_the_kernels():
  """``window_attention_backward_plain`` is the dq and dk/dv wrappers'
  plain versions on the Function's own residuals."""
  q, k, v, seg = (torch.tensor(z) for z in _attn_inputs(1, 90, 3, 16, pad=7))
  out, lse = wa.window_attention(q, k, v, seg, 32)
  g = torch.tensor(_attention_cotangent(q.numpy(), seg.numpy(), seed=2))
  dq, dk, dv = wa.window_attention_backward_plain(q, k, v, seg, out, lse, g,
                                                  32)
  delta = wa.attention_delta(out, g)
  torch.testing.assert_close(
      dq, wa.window_attention_dq(q, k, v, seg, lse, delta, g, 32))
  for got, want in zip((dk, dv),
                       wa.window_attention_dkv(q, k, v, seg, lse, delta, g,
                                               32)):
    torch.testing.assert_close(got, want)
  assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


def test_window_attention_rejects_halo():
  """Keys that do not hold the halo rows (kv_prefix) raise, in the forward
  and in the dq and dk/dv wrappers; a well-formed halo takes gradients,
  which cover the halo's rows (their values are held against JAX in
  tests/test_torch_port_sp_training.py)."""
  q, k, v, seg = (torch.tensor(z) for z in _attn_inputs(1, 8, 1, 8))
  halo = torch.zeros(1, 128, 1, 8)
  k, v = torch.cat([halo, k], dim=1), torch.cat([halo, v], dim=1)
  with pytest.raises(ValueError, match="kv_prefix"):
    wa.window_attention(q, k[:, 1:], v[:, 1:], seg, 4, kv_prefix=128)
  lse = torch.zeros(1, 1, 8)
  for fn in (wa.window_attention_dq, wa.window_attention_dkv):
    with pytest.raises(ValueError, match="kv_prefix"):
      fn(q, k[:, 1:], v[:, 1:], seg, lse, lse, q, 4, kv_prefix=128)
  qkv = [z.clone().requires_grad_() for z in (q, k, v)]
  out, _ = wa.window_attention(*qkv, seg, 4, kv_prefix=128)
  grads = torch.autograd.grad(out.square().sum(), qkv)
  assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
  # Positions from 0 put every query's document after the zero halo.
  assert not grads[1][:, :128].any() and not grads[2][:, :128].any()


# -- Card: CUDA kernels vs their plain versions ------------------------------

_LRU_CUDA_SHAPES = [(2, 64, 16), (1, 40, 200), (3, 17, 128), (1, 9, 7),
                    (2, 3000, 2560),
                    # Edges of the TMA ring's 128-step tiles at the model's
                    # width: t = 1, st - 1, st + 1; batch 1 (16 channels a
                    # block) and 3; widths that leave the last block of
                    # channels partial (200, 2568); an odd bf16 width and
                    # (1, 9, 7) above, which take the per-thread walk.
                    (2, 1, 2560), (2, 127, 2560), (2, 129, 2560),
                    (1, 3000, 2560), (3, 300, 2560), (2, 300, 200),
                    (1, 130, 2568), (2, 64, 33)]


@requires_cuda
@pytest.mark.parametrize("shape", _LRU_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_cuda_kernel_matches_plain(shape, dtype, reverse, with_h0):
  x, a, h0 = _lru_inputs(*shape)
  x = torch.tensor(x, device="cuda").to(dtype)
  a = torch.tensor(a, device="cuda").to(dtype)
  h0 = torch.tensor(h0, device="cuda") if with_h0 else None
  before = lru_scan.launches
  y, h = lru_scan.lru_scan(x, a, h0, reverse)
  torch.cuda.synchronize()
  assert lru_scan.launches == before + 1
  y_ref, h_ref = lru_scan.lru_scan_plain(x, a, h0, reverse)
  # The kernel rounds the multiply and the add separately, as the plain
  # loop's two float32 ops do: the results are identical.
  assert torch.equal(y, y_ref), (y.float() - y_ref.float()).abs().max()
  assert torch.equal(h, h_ref), (h - h_ref).abs().max()


_ATTN_CUDA_CASES = [
    # (b, t, n, h, window, pad, boundary, offset)
    (1, 256, 2, 128, 64, 0, None, 0),
    (2, 300, 2, 128, 128, 40, 150, 0),
    (1, 130, 3, 256, 512, 0, None, 0),
    (2, 700, 2, 256, 256, 100, 333, 0),
    # Positions that start at 500 with t < W: bounds below key 0.
    (2, 300, 2, 256, 2048, 0, None, 500),
    # The 2B prefill of chip_smoke.py: 3000 tokens, a partial last tile.
    (2, 3000, 10, 256, 2048, 700, 1500, 0),
    # Edges of the two-heads-a-block design: an odd head count leaves the
    # last block's second warpgroup without a head; t = 1, 63 and 65 around
    # one 64-row tile; head_dim 128 at the 2B's 10 heads.
    (2, 200, 3, 256, 128, 30, 120, 0),
    (2, 1, 3, 256, 2048, 0, None, 0),
    (2, 63, 2, 256, 32, 10, 40, 0),
    (2, 65, 2, 256, 2048, 0, 30, 0),
    (2, 500, 10, 128, 256, 50, 200, 0),
]


@requires_cuda
@pytest.mark.parametrize("case", _ATTN_CUDA_CASES)
def test_window_attention_cuda_kernel_matches_plain(case):
  b, t, n, h, window, pad, boundary, offset = case
  q, k, v, seg = _attn_inputs(b, t, n, h, pad=pad, boundary=boundary,
                              offset=offset)
  q, k, v = (torch.tensor(z, device="cuda").to(torch.bfloat16)
             for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  before = wa.launches
  out, lse = wa.window_attention(q, k, v, seg, window)
  torch.cuda.synchronize()
  assert wa.launches == before + 1
  out_ref, lse_ref = wa.window_attention_plain(q, k, v, seg, window)
  # Same bf16 inputs; the kernel rounds unnormalized probabilities to bf16
  # before PV and its output to bf16: 2e-2 covers both roundings at |o| < 2.
  torch.testing.assert_close(out.float(), out_ref.float(), atol=2e-2,
                             rtol=0)
  # Statistics are float32 on both sides, summed in another order.
  torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-5)
  if pad:
    assert not out[0, :pad].any()
    assert (lse[0, :, :pad] == wa.MASKED_LSE).all()


@requires_cuda
@pytest.mark.parametrize("shape", _LRU_CUDA_SHAPES + [(2, 4096, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_carry", [False, True])
def test_lru_backward_cuda_kernel_matches_plain(shape, dtype, reverse,
                                                with_carry):
  g, a, dh_last = _lru_inputs(*shape, seed=8)
  g = torch.tensor(g, device="cuda").to(dtype)
  a = torch.tensor(a, device="cuda").to(dtype)
  dh_last = torch.tensor(dh_last, device="cuda") if with_carry else None
  before = lru_scan.backward_launches
  dx, dh0 = lru_scan.lru_scan_backward(g, a, dh_last, reverse)
  torch.cuda.synchronize()
  assert lru_scan.backward_launches == before + 1
  dx_ref, dh0_ref = lru_scan.lru_scan_backward_plain(g, a, dh_last, reverse)
  # The same separately rounded float32 add and multiply in the same order.
  assert torch.equal(dx, dx_ref), (dx.float() - dx_ref.float()).abs().max()
  assert torch.equal(dh0, dh0_ref), (dh0 - dh0_ref).abs().max()


@requires_cuda
def test_lru_scan_autograd_runs_both_kernels_on_cuda():
  x, a, h0 = _lru_inputs(2, 300, 256, seed=9)
  inputs = [torch.tensor(z, device="cuda").requires_grad_()
            for z in (x, a, h0)]
  fwd, bwd = lru_scan.launches, lru_scan.backward_launches
  y, h = lru_scan.lru_scan(*inputs)
  grads = torch.autograd.grad((y.square().sum() + h.sum()), inputs)
  assert (lru_scan.launches, lru_scan.backward_launches) == (fwd + 1, bwd + 1)
  cpu = [z.detach().cpu().requires_grad_() for z in inputs]
  y_c, h_c = lru_scan.lru_scan(*cpu)
  want = torch.autograd.grad((y_c.square().sum() + h_c.sum()), cpu)
  for got, ref in zip(grads, want):
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


_ATTN_BWD_CUDA_CASES = [
    # (b, t, n, h, window, pad, boundary, right_pad)
    (1, 256, 2, 128, 64, 0, None, 0),
    (2, 300, 2, 128, 128, 40, 150, 20),
    (1, 130, 3, 256, 512, 0, None, 0),
    (2, 700, 2, 256, 256, 100, 333, 77),
    # The 2B training step of chip_smoke.py: 4096 tokens, row 1 right-padded
    # after 3000 tokens.
    (2, 4096, 10, 256, 2048, 0, None, 1096),
    # Edges of the Hopper design (dq: 64 queries x 2 heads a block, 32-key
    # tiles at head_dim 256 and 64 at 128; dk/dv: 64 keys a block): a window
    # smaller than one tile; an odd head count, which leaves the last dq
    # block's second warpgroup without a head; t = 2 (at t = 1 the one query
    # sees only its own key, p = 1 and dq is 0 exactly, which a tolerance
    # relative to the largest gradient cannot hold) and t just past a tile;
    # head_dim 128 at the training step's 4096 tokens.
    (2, 200, 2, 256, 16, 30, 120, 10),
    (2, 300, 3, 128, 24, 40, 150, 20),
    (2, 300, 3, 256, 128, 40, 150, 20),
    (2, 2, 3, 256, 2048, 0, None, 0),
    (2, 65, 2, 256, 2048, 10, 30, 5),
    (2, 97, 3, 128, 40, 0, 70, 0),
    (2, 4096, 10, 128, 2048, 0, None, 1096),
]
# The kernels round p and ds to bf16 before their products and the results
# to bf16; the plain version keeps float32 until the end. 2e-2 of the
# largest gradient covers those roundings (about 2^-8 of it, summed).
_ATTN_BWD_REL_ERR = 2e-2


@requires_cuda
@pytest.mark.parametrize("case", _ATTN_BWD_CUDA_CASES)
def test_window_attention_backward_cuda_kernels_match_plain(case):
  b, t, n, h, window, pad, boundary, right_pad = case
  q, k, v, seg = _attn_inputs(b, t, n, h, pad=pad, boundary=boundary,
                              right_pad=right_pad, seed=11)
  q, k, v = (torch.tensor(z, device="cuda").to(torch.bfloat16)
             for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  g = torch.randn(q.shape, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(3)).bfloat16()
  out, lse = wa.window_attention(q, k, v, seg, window)
  delta = wa.attention_delta(out, g)
  args = (q, k, v, seg, lse, delta, g, window)
  before = (wa.dq_launches, wa.dkv_launches)
  dq = wa.window_attention_dq(*args)
  dk, dv = wa.window_attention_dkv(*args)
  torch.cuda.synchronize()
  assert (wa.dq_launches, wa.dkv_launches) == (before[0] + 1, before[1] + 1)
  want = (wa.window_attention_dq_plain(*args),
          *wa.window_attention_dkv_plain(*args))
  for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _ATTN_BWD_REL_ERR * scale, (name, err, scale)
  if pad:
    assert not dq[0, :pad].any()
    assert not dk[0, :pad].any() and not dv[0, :pad].any()


@requires_cuda
def test_window_attention_autograd_runs_the_kernels_on_cuda():
  q, k, v, seg = _attn_inputs(2, 300, 2, 128, pad=40, boundary=150, seed=12)
  qkv = [torch.tensor(z, device="cuda").bfloat16().requires_grad_()
         for z in (q, k, v)]
  seg = torch.tensor(seg, device="cuda")
  before = (wa.launches, wa.dq_launches, wa.dkv_launches)
  out, _ = wa.window_attention(*qkv, seg, 64)
  grads = torch.autograd.grad(out.float().square().sum(), qkv)
  assert (wa.launches, wa.dq_launches, wa.dkv_launches) == tuple(
      c + 1 for c in before)
  assert all(torch.isfinite(z).all() for z in grads)


@requires_cuda
def test_cuda_wrappers_raise_on_unsupported_inputs():
  q, k, v, seg = _attn_inputs(1, 64, 1, 64)
  q, k, v = (torch.tensor(z, device="cuda") for z in (q, k, v))
  with pytest.raises(ValueError, match="bfloat16"):
    wa.window_attention(q, k, v, torch.tensor(seg, device="cuda"), 16)
  q, k, v = (z.bfloat16() for z in (q, k, v))
  with pytest.raises(ValueError, match="head_dim"):
    wa.window_attention(q, k, v, torch.tensor(seg, device="cuda"), 16)
  lse = torch.zeros(1, 1, 64, device="cuda")
  with pytest.raises(ValueError, match="head_dim"):
    wa.window_attention_dq(q, k, v, torch.tensor(seg, device="cuda"), lse,
                           lse, q, 16)
  x = torch.zeros(1, 4, 8, device="cuda", dtype=torch.float16)
  with pytest.raises(ValueError, match="dtype"):
    lru_scan.lru_scan(x, x)
  with pytest.raises(ValueError, match="dtype"):
    lru_scan.lru_scan_backward(x, x)


# -- Card: the towers' MHA and the fused add + RMSNorm -----------------------

_MHA_CUDA_CASES = [
    # (b, t, n, h)
    (1, 40, 2, 64),      # t below one 64-row tile
    (2, 128, 3, 72),     # whole tiles
    (1, 130, 3, 72),     # a partial last tile
    (2, 734, 16, 64),    # DINOv2-L at 384 px (729 patches + 5 prefix)
    (2, 729, 16, 72),    # SigLIP-so400m at 384 px
    (1, 1600, 16, 72),   # the tiled TPU kernel's regime, t_pad > 1024
    (1, 1, 2, 64),       # one query, one key
    (1, 1, 2, 72),
    (2, 63, 3, 64),      # one key short of a tile
    (2, 63, 3, 72),
    (2, 65, 3, 64),      # one key into a second tile
    (2, 65, 3, 72),
    (2, 200, 1, 72),     # one head
]


def _mha_inputs(b, t, n, h, seed=0):
  rng = np.random.default_rng(seed)
  return [torch.tensor(rng.standard_normal((b, t, n, h), dtype=np.float32),
                       device="cuda").bfloat16() for _ in range(3)]


@requires_cuda
@pytest.mark.parametrize("case", _MHA_CUDA_CASES)
def test_mha_cuda_kernel_matches_plain(case):

  q, k, v = _mha_inputs(*case)
  before = mha_attention.launches
  out = mha_attention.flash_mha_attention(q, k, v)
  torch.cuda.synchronize()
  assert mha_attention.launches == before + 1
  ref = mha_attention.mha_attention_plain(q, k, v)
  assert out.shape == q.shape and out.dtype == torch.bfloat16
  # Same bf16 inputs; both round unnormalized probabilities to bf16 before
  # PV, the kernel against the running max of its tiles, and both round the
  # output to bf16: 2e-2 covers those roundings at |out| < 2.
  torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


@requires_cuda
@pytest.mark.parametrize("head_dim", [64, 72])
def test_mha_cuda_kernel_reads_fused_qkv_views(head_dim):
  """Strided views of one fused qkv projection give the same bits as
  contiguous copies."""

  for b, t, n in ((2, 200, 4), (2, 734, 16)):  # 734: DINOv2-L's tokens
    qkv = torch.randn(
        b, t, 3 * n * head_dim, device="cuda",
        generator=torch.Generator("cuda").manual_seed(1)).bfloat16()
    views = [z.unflatten(-1, (n, head_dim))
             for z in qkv.split(n * head_dim, dim=-1)]
    assert not views[1].is_contiguous()
    got = mha_attention.mha_attention_forward(*views)
    want = mha_attention.mha_attention_forward(
        *(z.contiguous() for z in views))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got.float(), mha_attention.mha_attention_plain(*views).float(),
        atol=2e-2, rtol=0)


_RMSNORM_CUDA_SHAPES = [(2, 2129, 2560), (2, 1, 2560), (3, 7, 384), (5, 40),
                        (1, 4096)]


@requires_cuda
@pytest.mark.parametrize("shape", _RMSNORM_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rmsnorm_cuda_kernel_matches_plain(shape, dtype):

  gen = torch.Generator("cuda").manual_seed(2)
  x, r = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
          for _ in range(2))
  scale = (0.1 * torch.randn(shape[-1], device="cuda", generator=gen)).to(dtype)
  before = fused_epilogue.launches
  y, normed = fused_epilogue.fused_add_rmsnorm(x, r, scale)
  torch.cuda.synchronize()
  assert fused_epilogue.launches == before + 1
  y_ref, normed_ref = fused_epilogue.reference_add_rmsnorm(x, r, scale)
  # The add is one rounding of the same float32 sum on both sides.
  assert torch.equal(y, y_ref)
  # float32 statistics summed in another order and rsqrtf: a few float32
  # ulps; in bf16 the output rounding may then land one bf16 ulp apart.
  tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
         else dict(atol=1e-6, rtol=2**-7))
  torch.testing.assert_close(normed.float(), normed_ref.float(), **tol)


@requires_cuda
def test_cuda_tensors_never_take_the_plain_versions(monkeypatch):

  def refuse(*_):
    raise AssertionError("a CUDA tensor took the plain version")

  monkeypatch.setattr(mha_attention, "mha_attention_plain", refuse)
  monkeypatch.setattr(fused_epilogue, "reference_add_rmsnorm", refuse)
  q, k, v = _mha_inputs(1, 70, 2, 72)
  before = (mha_attention.launches, fused_epilogue.launches)
  mha_attention.flash_mha_attention(q, k, v)
  x = q.reshape(1, -1)
  fused_epilogue.fused_add_rmsnorm(x, x, torch.zeros_like(x[0]))
  torch.cuda.synchronize()
  assert (mha_attention.launches, fused_epilogue.launches) == (
      before[0] + 1, before[1] + 1)


@requires_cuda
def test_mha_and_add_rmsnorm_autograd_on_cuda():
  """The forwards launch the kernels; the backwards recompute through the
  plain compositions and match autograd of those on the CPU."""

  q, k, v = (z.float().requires_grad_() for z in _mha_inputs(1, 90, 2, 64))
  qb, kb, vb = (z.detach().bfloat16().requires_grad_() for z in (q, k, v))
  before = mha_attention.launches
  out = mha_attention.flash_mha_attention(qb, kb, vb)
  grads = torch.autograd.grad(out.float().square().sum(), (qb, kb, vb))
  assert mha_attention.launches == before + 1
  assert all(torch.isfinite(g).all() for g in grads)

  x, r = (torch.randn(3, 256, device="cuda").requires_grad_()
          for _ in range(2))
  s = torch.zeros(256, device="cuda").requires_grad_()
  y, normed = fused_epilogue.fused_add_rmsnorm(x, r, s)
  got = torch.autograd.grad((y * normed).sum(), (x, r, s))
  cpu = [z.detach().cpu().requires_grad_() for z in (x, r, s)]
  y_c, n_c = fused_epilogue.fused_add_rmsnorm(*cpu)
  want = torch.autograd.grad((y_c * n_c).sum(), cpu)
  for g, w in zip(got, want):
    torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


@requires_cuda
def test_new_cuda_wrappers_raise_on_unsupported_inputs():

  q = torch.zeros(1, 8, 2, 64, device="cuda")
  with pytest.raises(ValueError, match="bfloat16"):
    mha_attention.flash_mha_attention(q, q, q)
  q = torch.zeros(1, 8, 2, 32, device="cuda", dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="head_dim"):
    mha_attention.flash_mha_attention(q, q, q)
  x = torch.zeros(2, 64, device="cuda", dtype=torch.float16)
  with pytest.raises(ValueError, match="float32 or bfloat16"):
    fused_epilogue.fused_add_rmsnorm(x, x, x[0])
  x = torch.zeros(2, 4, device="cuda", dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="16 bytes"):
    fused_epilogue.fused_add_rmsnorm(x, x, x[0])


# -- Card: the sequence-parallel variants ------------------------------------

_A_PROD_CUDA_SHAPES = [(2, 64, 16), (1, 40, 200), (1, 9, 7), (3, 17, 129),
                       (2, 4096, 2560),
                       # The SP training shard; the ring's tile edges.
                       (1, 4096, 2560), (1, 1, 2560), (2, 129, 2560),
                       (2, 300, 200), (2, 64, 33)]


@requires_cuda
@pytest.mark.parametrize("shape", _A_PROD_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backprop", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lru_a_prod_cuda_kernel_matches_plain(shape, dtype, backprop,
                                              reverse):
  """The running product of `a` in all four walks, bit for bit; odd
  channel counts take the unpaired bf16 path."""
  x, a, _ = _lru_inputs(*shape, seed=13)
  x = torch.tensor(x, device="cuda").to(dtype)
  a = torch.tensor(a, device="cuda").to(dtype)
  if backprop:
    kernel, plain = lru_scan.lru_scan_backward, lru_scan.lru_scan_backward_plain
    counter = "backward_a_prod_launches"
  else:
    kernel, plain = lru_scan.lru_scan_forward, lru_scan.lru_scan_plain
    counter = "a_prod_launches"
  before = (getattr(lru_scan, counter), lru_scan.launches,
            lru_scan.backward_launches)
  got = kernel(x, a, None, reverse, return_a_prod=True)
  torch.cuda.synchronize()
  assert (getattr(lru_scan, counter), lru_scan.launches,
          lru_scan.backward_launches) == (before[0] + 1, *before[1:])
  want = plain(x, a, None, reverse, return_a_prod=True)
  # Separately rounded float32 operations in the same order on both sides.
  for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
    assert g.dtype == w.dtype
    assert torch.equal(g, w), (g.float() - w.float()).abs().max()
  # The product does not change the scan's own outputs.
  fn = lru_scan.lru_scan_backward if backprop else lru_scan.lru_scan_forward
  y, h = fn(x, a, None, reverse)
  assert torch.equal(y, got[0][0]) and torch.equal(h, got[0][1])


_RING_EDGE_SHAPES = [(2, 1, 2560), (2, 127, 2560), (2, 129, 2560),
                     (1, 300, 2568), (3, 17, 128), (1, 9, 7)]


@requires_cuda
@pytest.mark.parametrize("shape", _RING_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backprop", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_carry", [False, True])
def test_lru_a_prod_with_carry_cuda_kernel_matches_plain(shape, dtype,
                                                         backprop, reverse,
                                                         with_carry):
  """Both walks with the product and a carry, bit for bit, across the TMA
  ring's tile and channel edges (and the per-thread walk at (1, 9, 7))."""
  x, a, h0 = _lru_inputs(*shape, seed=17)
  x = torch.tensor(x, device="cuda").to(dtype)
  a = torch.tensor(a, device="cuda").to(dtype)
  h0 = torch.tensor(h0, device="cuda") if with_carry else None
  if backprop:
    kernel, plain = lru_scan.lru_scan_backward, lru_scan.lru_scan_backward_plain
  else:
    kernel, plain = lru_scan.lru_scan_forward, lru_scan.lru_scan_plain
  got = kernel(x, a, h0, reverse, return_a_prod=True)
  torch.cuda.synchronize()
  want = plain(x, a, h0, reverse, return_a_prod=True)
  for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
    assert torch.equal(g, w), (g.float() - w.float()).abs().max()


def _misaligned(z: torch.Tensor) -> torch.Tensor:
  """A contiguous copy of ``z`` whose base lies one element past a 16-byte
  boundary."""
  buf = torch.empty(z.numel() + 1, dtype=z.dtype, device=z.device)
  out = buf[1:].view(z.shape)
  out.copy_(z)
  return out


@requires_cuda
def test_lru_scan_cuda_routes_model_shapes_to_the_tma_ring():
  """The model paths' shapes launch the TMA ring in all four walks; a row
  TMA cannot describe (odd width, (1, 9, 7)) or a base off 16 bytes takes
  the per-thread walk, with the same bits."""
  cases = [((2, 3000, 2560), torch.bfloat16, False, True),
           ((2, 4096, 2560), torch.bfloat16, False, True),
           ((1, 4096, 2560), torch.bfloat16, False, True),
           ((1, 9, 7), torch.float32, False, False),
           ((1, 9, 7), torch.bfloat16, False, False),
           ((2, 64, 33), torch.bfloat16, False, False),
           ((2, 300, 2560), torch.bfloat16, True, False)]
  for shape, dtype, misaligned, ring in cases:
    x, a, h0 = _lru_inputs(*shape, seed=21)
    x = torch.tensor(x, device="cuda").to(dtype)
    a = torch.tensor(a, device="cuda").to(dtype)
    if misaligned:
      x = _misaligned(x)
    h0 = torch.tensor(h0, device="cuda")
    for backprop in (False, True):
      for with_product in (False, True):
        kernel = (lru_scan.lru_scan_backward if backprop
                  else lru_scan.lru_scan_forward)
        plain = (lru_scan.lru_scan_backward_plain if backprop
                 else lru_scan.lru_scan_plain)
        before = (lru_scan.ring_launches, lru_scan.thread_walk_launches)
        got = kernel(x, a, h0, False, with_product)
        torch.cuda.synchronize()
        after = (lru_scan.ring_launches, lru_scan.thread_walk_launches)
        assert after == (before[0] + ring, before[1] + (not ring)), (
            shape, dtype, misaligned, backprop, with_product)
        want = plain(x, a, h0, False, with_product)
        flat = lambda v: (*v[0], *v[1]) if with_product else v
        for g, w in zip(flat(got), flat(want)):
          assert torch.equal(g, w), (g.float() - w.float()).abs().max()


_ATTN_PREFIX_CUDA_CASES = [
    # (b, t, n, h, window, prefix, start, pad, boundary)
    (1, 256, 2, 128, 128, 128, 1000, 0, None),
    (2, 300, 2, 128, 128, 128, 5000, 0, 150),  # a document inside the shard
    (2, 256, 3, 256, 128, 128, 0, 70, None),   # shard 0: padding, zero halo
    (1, 200, 2, 256, 96, 100, 700, 0, None),   # prefix off the 64-key tiles
    # The 2B's SP prefill shards: 4096 queries, a 2048-key halo.
    (2, 4096, 10, 256, 2048, 2048, 4096, 0, 1500),
    (2, 4096, 10, 256, 2048, 2048, 0, 1384, None),
    # Shard 0's zero halo with a left-padded row at head_dim 128.
    (2, 300, 3, 128, 256, 128, 0, 50, None),
]


def _prefix_inputs(b, t, n, h, prefix, start, pad, boundary, seed=14):
  q, k, v, seg = _attn_inputs(b, t, n, h, pad=pad, boundary=boundary,
                              offset=start, seed=seed)
  if pad:
    seg[0] = np.maximum(np.arange(t, dtype=np.int32) - pad, -1)
  halo = np.random.default_rng(seed + 1).standard_normal(
      (2, b, prefix, 1, h), dtype=np.float32)
  if start == 0:
    halo[:] = 0.0  # shard 0 receives zeros
  k = np.concatenate([halo[0], k], axis=1)
  v = np.concatenate([halo[1], v], axis=1)
  return q, k, v, seg


@requires_cuda
@pytest.mark.parametrize("case", _ATTN_PREFIX_CUDA_CASES)
def test_window_attention_kv_prefix_cuda_kernel_matches_plain(case):
  b, t, n, h, window, prefix, start, pad, boundary = case
  q, k, v, seg = _prefix_inputs(b, t, n, h, prefix, start, pad, boundary)
  q, k, v = (torch.tensor(z, device="cuda").to(torch.bfloat16)
             for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  before = (wa.kv_prefix_launches, wa.launches)
  with torch.no_grad():
    out, lse = wa.window_attention(q, k, v, seg, window, kv_prefix=prefix)
  torch.cuda.synchronize()
  assert (wa.kv_prefix_launches, wa.launches) == (before[0] + 1, before[1])
  out_ref, lse_ref = wa.window_attention_plain(q, k, v, seg, window, prefix)
  # The tolerances of the kernel without a halo.
  torch.testing.assert_close(out.float(), out_ref.float(), atol=2e-2, rtol=0)
  torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-5)
  if pad:
    assert not out[0, :pad].any()
    assert (lse[0, :, :pad] == wa.MASKED_LSE).all()


@requires_cuda
@pytest.mark.parametrize("case", [(1, 256, 2, 128, 64), (2, 700, 2, 256, 256),
                                  (2, 3000, 10, 256, 2048)])
def test_window_attention_masked_halo_gives_the_same_bits(case):
  """A halo that every row masks (each row's document starts in the shard),
  a multiple of the 64-key tiles long, leaves every tile and every sum of
  the kernel as with kv_prefix = 0: the halo path changes no arithmetic.
  (tools/compare_kernel_bits.py compares the kernel with another checkout's;
  against a checkout from before the wgmma redesign of the forward its bits
  differ, and both are held to the plain version instead.)"""
  b, t, n, h, window = case
  q, k, v, seg = _attn_inputs(b, t, n, h, seed=15)
  q, k, v = (torch.tensor(z, device="cuda").to(torch.bfloat16)
             for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  halo = torch.randn(b, 128, 1, h, device="cuda").bfloat16()
  out0, lse0 = wa.window_attention_forward(q, k, v, seg, window)
  out1, lse1 = wa.window_attention_forward(
      q, torch.cat([halo, k], dim=1), torch.cat([halo, v], dim=1), seg,
      window, kv_prefix=128)
  torch.cuda.synchronize()
  assert torch.equal(out0, out1) and torch.equal(lse0, lse1)


@requires_cuda
@pytest.mark.parametrize("case", [(2, 700, 3, 256, 256, 0), (2, 4096, 10, 256,
                                                              2048, 2048)])
def test_window_attention_repeats_its_bits(case):
  """Two launches on the same inputs give the same bits: the key tiles run
  in one order and nothing is summed by atomics."""
  b, t, n, h, window, prefix = case
  q, k, v, seg = _prefix_inputs(b, t, n, h, prefix, prefix, 0, 300)
  q, k, v = (torch.tensor(z, device="cuda").to(torch.bfloat16)
             for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  out0, lse0 = wa.window_attention_forward(q, k, v, seg, window, prefix)
  out1, lse1 = wa.window_attention_forward(q, k, v, seg, window, prefix)
  torch.cuda.synchronize()
  assert torch.equal(out0, out1) and torch.equal(lse0, lse1)


@requires_cuda
def test_sequence_parallel_ops_on_cuda_match_unsharded():
  """The SP scan and the halo attention on a four-shard mesh of the card(s)
  against the unsharded kernels, in bfloat16; one launch a shard."""
  devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(4)]
  mesh = sharding.make_mesh((1, 4), ("data", "sequence"), devices)
  spec = sharding.ShardingSpec(mesh=mesh, batch_axis_name="data",
                               sequence_axis_name="sequence")
  x, a, h0 = _lru_inputs(2, 1024, 256, seed=16)
  x, a = (torch.tensor(z, device="cuda").bfloat16() for z in (x, a))
  h0 = torch.tensor(h0, device="cuda")
  before = lru_scan.a_prod_launches
  y, h = scan.linear_scan(x, a, h0, sharding_spec=spec)
  assert lru_scan.a_prod_launches == before + 4
  y_ref, h_ref = lru_scan.lru_scan(x, a, h0)
  # The correction adds h0 * a_prod in bf16: one or two bf16 roundings.
  torch.testing.assert_close(y.float(), y_ref.float(), atol=3e-2, rtol=1.6e-2)
  torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)

  q, k, v, seg = _attn_inputs(2, 1024, 2, 256, pad=100, boundary=600,
                              seed=17)
  q, k, v = (torch.tensor(z, device="cuda").bfloat16() for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  before = wa.kv_prefix_launches
  got = sp_attention.sequence_sharded_attention(q, k, v, seg, 128, spec)
  assert wa.kv_prefix_launches == before + 4
  want, _ = wa.window_attention(q, k, v, seg, 128)
  torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


# -- Card: the backward kernels with a key halo (SP training) ----------------

_ATTN_PREFIX_BWD_CUDA_CASES = [
    # (b, t, n, h, window, prefix, start, pad, boundary, right_pad)
    (1, 256, 2, 128, 128, 128, 1000, 0, None, 0),   # a later shard's halo
    (2, 300, 2, 128, 128, 128, 5000, 0, 150, 0),    # a document in the
                                                    # shard; partial tile
    (2, 256, 3, 256, 128, 128, 0, 70, None, 0),     # shard 0: zero halo,
                                                    # left padding
    (1, 200, 2, 256, 96, 100, 700, 0, None, 0),     # prefix off the tiles
    (2, 1024, 2, 256, 512, 512, 3072, 0, None, 300),  # row 1 right-padded
    # The 2B's SP training shards: 4096 queries, a 2048-key halo.
    (1, 4096, 10, 256, 2048, 2048, 8192, 0, None, 0),
    (1, 4096, 10, 256, 2048, 2048, 0, 0, None, 0),
    # A window smaller than a tile, a halo off the tiles, odd heads.
    (2, 130, 3, 128, 16, 40, 900, 0, 60, 10),
    (1, 65, 3, 256, 24, 70, 500, 0, None, 0),
]


@requires_cuda
@pytest.mark.parametrize("case", _ATTN_PREFIX_BWD_CUDA_CASES)
def test_window_attention_kv_prefix_backward_cuda_kernels_match_plain(case):
  """dq and dk/dv with kv_prefix against their plain versions, to the
  tolerance of the kernels without a halo. dk and dv come from
  torch.empty_like: a block reused from a NaN-filled tensor shows that the
  halo rows no query sees are written (with zeros), not left."""
  b, t, n, h, window, prefix, start, pad, boundary, right_pad = case
  q, k, v, seg = _prefix_inputs(b, t, n, h, prefix, start, pad, boundary)
  if right_pad:
    seg[1, t - right_pad:] = seg[1, t - right_pad - 1]
  q, k, v = (torch.tensor(z, device="cuda").to(torch.bfloat16)
             for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  g = torch.randn(q.shape, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(5)).bfloat16()
  with torch.no_grad():
    out, lse = wa.window_attention(q, k, v, seg, window, kv_prefix=prefix)
  delta = wa.attention_delta(out, g)
  args = (q, k, v, seg, lse, delta, g, window, prefix)
  before = (wa.dq_kv_prefix_launches, wa.dkv_kv_prefix_launches,
            wa.dq_launches, wa.dkv_launches)
  junk = torch.full((2, *k.shape), float("nan"), device="cuda",
                    dtype=k.dtype)
  del junk
  dq = wa.window_attention_dq(*args)
  dk, dv = wa.window_attention_dkv(*args)
  torch.cuda.synchronize()
  assert (wa.dq_kv_prefix_launches, wa.dkv_kv_prefix_launches,
          wa.dq_launches, wa.dkv_launches) == (before[0] + 1, before[1] + 1,
                                               *before[2:])
  want = (wa.window_attention_dq_plain(*args),
          *wa.window_attention_dkv_plain(*args))
  assert dk.shape == dv.shape == (b, prefix + t, 1, h)
  for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert torch.isfinite(got).all(), name
    assert err <= _ATTN_BWD_REL_ERR * scale, (name, err, scale)
  # Keys no query sees get exact zeros: before the first query's window,
  # and all of shard 0's halo.
  unseen = prefix if start == 0 else max(0, prefix - window)
  assert not dk[:, :unseen].any() and not dv[:, :unseen].any()
  if start:
    assert dk[:, unseen:prefix].abs().amax() > 0
  if pad:
    assert not dq[0, :pad].any()


@requires_cuda
@pytest.mark.parametrize("case", [(1, 256, 2, 128, 64), (2, 700, 3, 256, 256),
                                  (2, 4096, 10, 256, 2048)])
def test_window_attention_backward_masked_halo_gives_the_same_bits(case):
  """A 128-key halo that every row masks (each row's document starts in
  the shard) gives dq and dk/dv[:, 128:] the bits of the kernels without a
  halo, and exact zeros to dk/dv[:, :128]: the halo path changes no tile
  and no sum. (Against a checkout from before the Hopper redesign of the
  backward, tools/compare_kernel_bits.py finds other bits; both are held to
  the plain versions instead.)"""
  b, t, n, h, window = case
  q, k, v, seg = _attn_inputs(b, t, n, h, seed=24)
  q, k, v = (torch.tensor(z, device="cuda").to(torch.bfloat16)
             for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  g = torch.randn(q.shape, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(8)).bfloat16()
  out, lse = wa.window_attention_forward(q, k, v, seg, window)
  delta = wa.attention_delta(out, g)
  halo = torch.randn(2, b, 128, 1, h, device="cuda").bfloat16()
  k1, v1 = torch.cat([halo[0], k], dim=1), torch.cat([halo[1], v], dim=1)
  dq0 = wa.window_attention_dq(q, k, v, seg, lse, delta, g, window)
  dk0, dv0 = wa.window_attention_dkv(q, k, v, seg, lse, delta, g, window)
  dq1 = wa.window_attention_dq(q, k1, v1, seg, lse, delta, g, window, 128)
  dk1, dv1 = wa.window_attention_dkv(q, k1, v1, seg, lse, delta, g, window,
                                     128)
  torch.cuda.synchronize()
  assert torch.equal(dq0, dq1)
  assert torch.equal(dk0, dk1[:, 128:]) and torch.equal(dv0, dv1[:, 128:])
  assert not dk1[:, :128].any() and not dv1[:, :128].any()


@requires_cuda
@pytest.mark.parametrize("case", [(2, 700, 3, 256, 256, 0),
                                  (2, 300, 3, 128, 64, 100),
                                  (1, 4096, 10, 256, 2048, 2048)])
def test_window_attention_backward_repeats_its_bits(case):
  """Two launches of dq and of dk/dv on the same inputs give the same bits:
  tiles run in one order, heads are summed in registers, and nothing is
  summed by atomics."""
  b, t, n, h, window, prefix = case
  q, k, v, seg = _prefix_inputs(b, t, n, h, prefix, prefix + 1000, 0, 100)
  q, k, v = (torch.tensor(z, device="cuda").to(torch.bfloat16)
             for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  g = torch.randn(q.shape, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(9)).bfloat16()
  out, lse = wa.window_attention_forward(q, k, v, seg, window, prefix)
  args = (q, k, v, seg, lse, wa.attention_delta(out, g), g, window, prefix)
  first = (wa.window_attention_dq(*args), *wa.window_attention_dkv(*args))
  second = (wa.window_attention_dq(*args), *wa.window_attention_dkv(*args))
  torch.cuda.synchronize()
  for name, x, y in zip(("dq", "dk", "dv"), first, second):
    assert torch.equal(x, y), name


@requires_cuda
def test_window_attention_kv_prefix_autograd_runs_the_kernels_on_cuda():
  q, k, v, seg = _prefix_inputs(2, 300, 2, 128, 128, 1000, 0, 150, seed=18)
  qkv = [torch.tensor(z, device="cuda").bfloat16().requires_grad_()
         for z in (q, k, v)]
  seg = torch.tensor(seg, device="cuda")
  before = (wa.kv_prefix_launches, wa.dq_kv_prefix_launches,
            wa.dkv_kv_prefix_launches, wa.launches, wa.dq_launches,
            wa.dkv_launches)
  out, _ = wa.window_attention(*qkv, seg, 128, kv_prefix=128)
  grads = torch.autograd.grad(out.float().square().sum(), qkv)
  assert (wa.kv_prefix_launches, wa.dq_kv_prefix_launches,
          wa.dkv_kv_prefix_launches, wa.launches, wa.dq_launches,
          wa.dkv_launches) == (before[0] + 1, before[1] + 1, before[2] + 1,
                               *before[3:])
  assert all(torch.isfinite(z).all() for z in grads)
  assert grads[1].shape == (2, 428, 1, 128) and grads[1][:, :128].any()


@requires_cuda
def test_sequence_parallel_gradients_on_cuda_match_unsharded():
  """Gradients of the SP scan and the halo attention on a four-shard mesh
  of the card(s) against the unsharded kernels', in bfloat16: one LRU
  backward with the product, one halo dq and one halo dk/dv a shard."""
  devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(4)]
  mesh = sharding.make_mesh((1, 4), ("data", "sequence"), devices)
  spec = sharding.ShardingSpec(mesh=mesh, batch_axis_name="data",
                               sequence_axis_name="sequence")
  x, a, h0 = _lru_inputs(2, 1024, 256, seed=19)
  gy = torch.randn(2, 1024, 256, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(6))
  grads = []
  for sharded in (True, False):
    inputs = [torch.tensor(z, device="cuda").requires_grad_()
              for z in (x, a, h0)]
    xb, ab = inputs[0].bfloat16(), inputs[1].bfloat16()
    before = (lru_scan.backward_a_prod_launches, lru_scan.backward_launches)
    if sharded:
      y, h = scan.linear_scan(xb, ab, inputs[2], sharding_spec=spec)
    else:
      y, h = lru_scan.lru_scan(xb, ab, inputs[2])
    grads.append(torch.autograd.grad((y.float() * gy).sum() + h.sum(),
                                     inputs))
    want = (before[0] + 4, before[1]) if sharded else (before[0],
                                                        before[1] + 1)
    assert (lru_scan.backward_a_prod_launches,
            lru_scan.backward_launches) == want
  for got, ref in zip(*grads):
    # bf16 cotangents corrected in bf16: a few bf16 steps of the largest.
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 3e-2 * scale

  q, k, v, seg = _attn_inputs(2, 1024, 2, 256, pad=100, boundary=600,
                              seed=20)
  g = torch.randn(2, 1024, 2, 256, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(7)).bfloat16()
  grads = []
  for sharded in (True, False):
    qkv = [torch.tensor(z, device="cuda").bfloat16().requires_grad_()
           for z in (q, k, v)]
    seg_t = torch.tensor(seg, device="cuda")
    before = (wa.dq_kv_prefix_launches, wa.dkv_kv_prefix_launches)
    if sharded:
      out = sp_attention.sequence_sharded_attention(*qkv, seg_t, 128, spec)
    else:
      out, _ = wa.window_attention(*qkv, seg_t, 128)
    grads.append(torch.autograd.grad(out, qkv, g))
    if sharded:
      assert (wa.dq_kv_prefix_launches, wa.dkv_kv_prefix_launches) == (
          before[0] + 4, before[1] + 4)
  for got, ref in zip(*grads):
    scale = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= (
        _ATTN_BWD_REL_ERR * scale)


# -- Card: the complex scan ---------------------------------------------------

_COMPLEX_CUDA_SHAPES = [(2, 64, 16), (1, 40, 200), (1, 9, 7), (3, 17, 129),
                        (2, 4096, 2560),
                        # Edges of the TMA ring's 64-step tiles at the
                        # model's width: t = 1, st +- 1, 2 st +- 1 and 300 (a
                        # partial top tile); d = 2568 leaves the last block
                        # of channels partial; (1, 300, 2568) and
                        # (3, 17, 128) run 16 channels a block; (1, 9, 7)
                        # above takes the per-thread walk.
                        (2, 1, 2560), (2, 63, 2560), (2, 65, 2560),
                        (2, 127, 2560), (2, 129, 2560), (2, 300, 2560),
                        (1, 300, 2568), (3, 17, 128)]
# (walk, with the product): the four C entry points.
_COMPLEX_ENTRIES = [(False, False), (True, False), (False, True),
                    (True, True)]


def _complex_inputs(b, t, d, seed=0):
  """x, a and h0 as Complex pairs on the card: x and h0 normal, a of
  modulus below 1 (a sigmoid and a 0.1 imaginary part)."""
  rng = np.random.default_rng(seed)
  xr, xi = rng.standard_normal((2, b, t, d), dtype=np.float32)
  ar = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, d), dtype=np.float32)))
  ai = 0.1 * rng.standard_normal((b, t, d), dtype=np.float32)
  h0r, h0i = rng.standard_normal((2, b, d), dtype=np.float32)
  return (complex_lib.from_numpy(xr, xi, device="cuda"),
          complex_lib.from_numpy(ar, ai, device="cuda"),
          complex_lib.from_numpy(h0r, h0i, device="cuda"))


def _assert_complex_equal(got, want, *context):
  """Every component of every Complex output, bit for bit."""
  for g, w in zip(got, want):
    assert isinstance(g, complex_lib.Complex) and g.dtype == w.dtype
    for part in ("real", "imag"):
      gp, wp = getattr(g, part), getattr(w, part)
      assert torch.equal(gp, wp), (*context, part,
                                   (gp.float() - wp.float()).abs().max())


def _complex_entry(backprop, a_prod):
  """The kernel and plain loop of an entry point, and a function that
  flattens either's outputs into a tuple of Complex values."""
  if backprop:
    kernel, plain = lru_scan.lru_scan_backward, lru_scan.lru_scan_backward_plain
  else:
    kernel, plain = lru_scan.lru_scan_forward, lru_scan.lru_scan_plain
  flat = (lambda v: (*v[0], *v[1])) if a_prod else tuple
  return kernel, plain, flat


@requires_cuda
@pytest.mark.parametrize("shape", _COMPLEX_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backprop,a_prod", _COMPLEX_ENTRIES)
def test_lru_complex_cuda_kernel_matches_plain(shape, dtype, backprop,
                                               a_prod):
  """Each complex entry point, both directions, with and without a carry,
  bit for bit against its plain loop, across the TMA ring's tile and
  channel edges; odd channel counts take the per-thread walk's unpaired
  bf16 path, and the backward's conj(a) is taken as `a` loads."""
  x, a, h0 = _complex_inputs(*shape, seed=21)
  x, a = x.to(dtype), a.to(dtype)
  kernel, plain, flat = _complex_entry(backprop, a_prod)
  counter = "complex_" + ("backward_" if backprop else "") + (
      "a_prod_launches" if a_prod else "launches")
  for reverse in (False, True):
    for carry in (None, h0):
      before = getattr(lru_scan, counter)
      got = flat(kernel(x, a, carry, reverse, return_a_prod=a_prod))
      torch.cuda.synchronize()
      assert getattr(lru_scan, counter) == before + 1
      want = flat(plain(x, a, carry, reverse, return_a_prod=a_prod))
      _assert_complex_equal(got, want, reverse, carry is not None)


@requires_cuda
def test_lru_complex_cuda_routes_path_shapes_to_the_tma_ring():
  """The complex path's shapes launch the TMA ring in all four walks; a row
  TMA cannot describe (odd width, (1, 9, 7)) or an imaginary component off
  16 bytes takes the per-thread walk, with the same bits."""
  cases = [((2, 4096, 2560), torch.bfloat16, False, True),
           ((1, 4096, 2560), torch.bfloat16, False, True),
           ((1, 9, 7), torch.float32, False, False),
           ((1, 9, 7), torch.bfloat16, False, False),
           ((2, 64, 33), torch.bfloat16, False, False),
           ((2, 300, 2560), torch.bfloat16, True, False)]
  for shape, dtype, misaligned, ring in cases:
    x, a, h0 = _complex_inputs(*shape, seed=25)
    x, a = x.to(dtype), a.to(dtype)
    if misaligned:
      x = complex_lib.Complex(x.real, _misaligned(x.imag))
    for backprop, a_prod in _COMPLEX_ENTRIES:
      kernel, plain, flat = _complex_entry(backprop, a_prod)
      before = (lru_scan.complex_ring_launches,
                lru_scan.complex_thread_walk_launches)
      got = flat(kernel(x, a, h0, False, a_prod))
      torch.cuda.synchronize()
      after = (lru_scan.complex_ring_launches,
               lru_scan.complex_thread_walk_launches)
      assert after == (before[0] + ring, before[1] + (not ring)), (
          shape, dtype, misaligned, backprop, a_prod)
      _assert_complex_equal(got, flat(plain(x, a, h0, False, a_prod)),
                            shape, dtype, backprop, a_prod)


@requires_cuda
def test_lru_complex_autograd_runs_both_kernels_on_cuda():
  x, a, h0 = _complex_inputs(2, 300, 96, seed=22)
  leaves = [z.clone().requires_grad_() for v in (x, a, h0)
            for z in (v.real, v.imag)]
  before = (lru_scan.complex_launches, lru_scan.complex_backward_launches)
  y, h = lru_scan.lru_scan(complex_lib.Complex(*leaves[:2]),
                           complex_lib.Complex(*leaves[2:4]),
                           complex_lib.Complex(*leaves[4:]))
  grads = torch.autograd.grad(
      (y.real.square() + y.imag.square()).sum() + h.real.sum(), leaves)
  assert (lru_scan.complex_launches,
          lru_scan.complex_backward_launches) == (before[0] + 1, before[1] + 1)
  cpu = [z.detach().cpu().requires_grad_() for z in leaves]
  y_c, h_c = lru_scan.lru_scan(complex_lib.Complex(*cpu[:2]),
                               complex_lib.Complex(*cpu[2:4]),
                               complex_lib.Complex(*cpu[4:]))
  want = torch.autograd.grad(
      (y_c.real.square() + y_c.imag.square()).sum() + h_c.real.sum(), cpu)
  for got, ref in zip(grads, want):
    # The kernels' bits equal the plain loops'; da is the same torch
    # product on both devices.
    torch.testing.assert_close(got.cpu(), ref, atol=1e-5, rtol=1e-5)


@requires_cuda
def test_lru_complex_sequence_parallel_on_cuda_matches_unsharded():
  """The complex scan on a four-shard mesh of the card(s): 4 forwards and 4
  backwards with the product, none unsharded; y, h_last and the gradients
  against the unsharded kernels'."""
  devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(4)]
  mesh = sharding.make_mesh((1, 4), ("data", "sequence"), devices)
  spec = sharding.ShardingSpec(mesh=mesh, batch_axis_name="data",
                               sequence_axis_name="sequence")
  x, a, h0 = _complex_inputs(1, 1024, 128, seed=23)
  results = []
  for sharded in (True, False):
    leaves = [z.clone().requires_grad_() for v in (x, a, h0)
              for z in (v.real, v.imag)]
    counts = (lru_scan.complex_a_prod_launches,
              lru_scan.complex_backward_a_prod_launches,
              lru_scan.complex_launches, lru_scan.complex_backward_launches)
    y, h = scan.linear_scan(
        complex_lib.Complex(*leaves[:2]), complex_lib.Complex(*leaves[2:4]),
        complex_lib.Complex(*leaves[4:]),
        sharding_spec=spec if sharded else None)
    grads = torch.autograd.grad(
        (y.real * 0.5 + y.imag).sum() + (h.real - h.imag).sum(), leaves)
    moved = tuple(n - c for n, c in zip(
        (lru_scan.complex_a_prod_launches,
         lru_scan.complex_backward_a_prod_launches,
         lru_scan.complex_launches, lru_scan.complex_backward_launches),
        counts))
    assert moved == ((4, 4, 0, 0) if sharded else (0, 0, 1, 1))
    results.append((y.real, y.imag, h.real, h.imag, *grads))
  for got, ref in zip(*results):
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@requires_cuda
def test_lru_complex_wrappers_raise_on_unsupported_inputs():
  x, a, _ = _complex_inputs(1, 8, 4)
  with pytest.raises(ValueError, match="to_custom_complex"):
    lru_scan.lru_scan_forward(x.to_complex64(), a.to_complex64())
  with pytest.raises(ValueError, match="dtype"):
    lru_scan.lru_scan_forward(x.to(torch.float16), a.to(torch.float16))
  with pytest.raises(ValueError, match="both be real or both Complex"):
    lru_scan.lru_scan_backward(x, a.real)
