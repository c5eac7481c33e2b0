"""RG-LRU scan: the CUDA kernels, their plain PyTorch versions, and autograd.

Computes ``h_t = a_t * h_{t-1} + x_t`` over the time axis of ``[b, t, d]``
inputs with a float32 carry; ``y`` comes back in ``x``'s dtype and the final
state ``h_last`` in float32. Counterpart of the JAX package's
``lru_pallas_scan`` (``cadence_gemma_tpu/ops/pallas_lru.py``) with its
``custom_vjp``, unsharded and over the shards of a sequence-parallel
``_sharded_scan``, for real operands and for complex ones.

:func:`lru_scan` and :func:`sharded_scan` are differentiable. Their forwards
run :func:`lru_scan_forward` and their backwards :func:`lru_scan_backward`,
the cotangent scan of ``_lru_bwd``; each calls its ``torch.library``
operator (:mod:`ops.library`; one a walk, kind of operand and running
product, and one for :func:`lru_scan_carries`), whose CUDA implementation
launches its kernel of ``csrc/lru_scan.cu`` and whose CPU implementation is
the plain version (:func:`lru_scan_plain`, :func:`lru_scan_backward_plain`).
With ``return_a_prod=True`` either also returns the running product
of ``a`` along its walk (``compute_a_prod``), which :func:`sharded_scan`
needs to stitch the shards of a sequence-parallel scan together, in both
walks. A kernel that fails to build or launch raises; nothing falls back.

Complex operands are :class:`complex_lib.Complex` pairs of real tensors
(``_lru_complex_kernel``): every function here takes them where it takes a
real tensor, with a float32 carry per component, the complex product in the
JAX body's order, and the kernels of ``csrc/lru_scan_complex.cu``. The
cotangent scan of a complex forward multiplies by ``conj(a)`` (the R^2
transpose of multiplying by ``a``) and the decay's cotangent is
``dx * conj(h_prev)``. A native torch complex tensor is refused: wrap it
with ``complex_lib.to_custom_complex``. The autograd Functions take and
return component tensors, and the public functions rewrap them.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cadence_gemma_tpu_torch import _build
from cadence_gemma_tpu_torch import complex_lib
from cadence_gemma_tpu_torch.ops import library
from cadence_gemma_tpu_torch.parallel import sharding

Complex = complex_lib.Complex

# Kernel launches in this process: forward and backward without the running
# product of `a`, and with it; callers reset them to count one run.
launches = 0
backward_launches = 0
a_prod_launches = 0
backward_a_prod_launches = 0
# The route each real launch took in csrc/lru_scan.cu: the TMA ring, or the
# per-thread walk for tensors TMA cannot describe (see _takes_ring).
ring_launches = 0
thread_walk_launches = 0
# The same four for complex operands.
complex_launches = 0
complex_backward_launches = 0
complex_a_prod_launches = 0
complex_backward_a_prod_launches = 0
# The route each complex launch took in csrc/lru_scan_complex.cu.
complex_ring_launches = 0
complex_thread_walk_launches = 0
# Forward launches of :func:`lru_scan_carries` (also counted in `launches`).
carry_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lru_scan_plain(
    x: torch.Tensor | Complex,
    a: torch.Tensor | Complex,
    h0: torch.Tensor | Complex | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
    y_in_acc_dtype: bool = False,
):
  """Sequential scan, one step at a time with a float32 carry.

  The same arithmetic as the kernel: a rounded multiply then a rounded add
  in float32, each step's output cast to ``x.dtype``. Differentiable by
  autograd (it is also the ``LINEAR_NATIVE`` scan). For Complex operands
  each step is ``(ar*hr - ai*hi + xr, ar*hi + ai*hr + xi)``, every product
  and sum rounded alone, as the complex kernel computes it.

  Returns ``(y, h_last)``, or ``((y, h_last), (a_prod, a_prod_last))`` with
  ``return_a_prod`` (the JAX ``lru_linear_scan``'s contract,
  ``cadence_gemma_tpu/ops/scan.py:49-93``): the running product of ``a`` in
  the walk's order from a float32 carry that starts at 1, each step a
  separately rounded float32 multiply, in ``x.dtype``, and its last value in
  float32 (``pallas_lru.py:142-160``). ``y_in_acc_dtype`` keeps ``y`` in
  float32: the carries themselves, which a speculative verify commits from.
  """
  f32 = torch.float32
  y_dtype = f32 if y_in_acc_dtype else x.dtype
  seq_len = x.shape[1]
  h = complex_lib.zeros_like(x[:, 0], f32) if h0 is None else h0.to(f32)
  p = complex_lib.ones_like(x[:, 0], f32)
  steps = range(seq_len - 1, -1, -1) if reverse else range(seq_len)
  ys, ps = [], []
  for t in steps:
    a_t = a[:, t].to(f32)
    h = a_t * h + x[:, t].to(f32)
    ys.append(h.to(y_dtype))
    if return_a_prod:
      p = p * a_t
      ps.append(p.to(x.dtype))
  if reverse:
    ys.reverse()
    ps.reverse()
  y = complex_lib.stack(ys, dim=1)
  if return_a_prod:
    return (y, h), (complex_lib.stack(ps, dim=1), p)
  return y, h


def lru_scan_backward_plain(
    g: torch.Tensor | Complex,
    a: torch.Tensor | Complex,
    dh_last: torch.Tensor | Complex | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
):
  """The cotangent scan of a forward scan run with the same ``reverse``.

  Walks against the forward's direction: ``h += g_t``, ``dx_t = h``, then
  ``h *= a_t``, each a separately rounded float32 operation as in the
  kernel; for Complex operands the multiplier is ``conj(a_t)``. ``dh_last``
  (float32, ``None`` for zeros) starts the carry.
  Returns ``(dx in g.dtype, dh0 = a_0 * dh_0 in float32)``; with
  ``return_a_prod``, ``((dx, dh0), (a_prod, a_prod_last))`` where the
  running product of the multipliers follows this backward walk, as
  ``_lru_pallas_call(backprop=True, compute_a_prod=True)`` computes it
  (``pallas_lru.py:145-160``).
  """
  f32 = torch.float32
  seq_len = g.shape[1]
  h = (complex_lib.zeros_like(g[:, 0], f32) if dh_last is None
       else dh_last.to(f32))
  p = complex_lib.ones_like(g[:, 0], f32)
  steps = range(seq_len) if reverse else range(seq_len - 1, -1, -1)
  dxs, ps = [], []
  for t in steps:
    # conj(a) for Complex operands; a real tensor is its own conjugate.
    a_t = complex_lib.conjugate(a[:, t].to(f32))
    h = h + g[:, t].to(f32)
    dxs.append(h.to(g.dtype))
    h = h * a_t
    if return_a_prod:
      p = p * a_t
      ps.append(p.to(g.dtype))
  if not reverse:
    dxs.reverse()
    ps.reverse()
  dx = complex_lib.stack(dxs, dim=1)
  if return_a_prod:
    return (dx, h), (complex_lib.stack(ps, dim=1), p)
  return dx, h


def _check(x, a, h0):
  if isinstance(x, torch.Tensor) and x.is_complex():
    raise ValueError(
        f"Native complex dtype {x.dtype}: the scan takes a complex_lib.Complex "
        "pair of real tensors (complex_lib.to_custom_complex)."
    )
  if x.ndim != 3:
    raise ValueError(f"Expected [b, t, d] inputs, got shape {tuple(x.shape)}.")
  for name, v in (("a", a), ("h0", h0)):
    if v is not None and isinstance(v, Complex) != isinstance(x, Complex):
      raise ValueError(f"`{name}` and `x` must both be real or both Complex.")
  if a.shape != x.shape or a.dtype != x.dtype:
    raise ValueError("`a` must match `x` in shape and dtype.")
  if x.dtype not in _DTYPE_CODES:
    raise ValueError(f"Unsupported dtype {x.dtype}; use float32 or bfloat16.")
  if a.device != x.device:
    raise ValueError("`x` and `a` must be on the same device.")
  if h0 is not None:
    if h0.shape != (x.shape[0], x.shape[2]) or h0.dtype != torch.float32:
      raise ValueError(
          f"`h0` must be float32 of shape {(x.shape[0], x.shape[2])}, got "
          f"{h0.dtype} {tuple(h0.shape)}."
      )
    if h0.device != x.device:
      raise ValueError("`h0` must be on the same device as `x`.")


def _components(v) -> tuple:
  """The tensors of a real tensor (one) or a Complex (two)."""
  return (v.real, v.imag) if isinstance(v, Complex) else (v,)


def _takes_ring(*streams: torch.Tensor | Complex) -> bool:
  """Whether a scan over these ``[b, t, d]`` streams runs on the TMA ring
  (``csrc/lru_ring.cuh``): a non-empty time axis, rows of a multiple of 16
  bytes and 16-byte aligned bases of every component of every stream; the
  twin of the source's ``takes_ring``."""
  tensors = [z for v in streams for z in _components(v)]
  _, t, d = tensors[0].shape
  return (t > 0 and d * tensors[0].element_size() % 16 == 0
          and all(z.data_ptr() % 16 == 0 for z in tensors))


def _launch(symbol: str, x, a, h0, reverse, return_a_prod=False):
  """Runs one scan kernel of ``csrc/lru_scan.cu`` (real operands) or of
  ``csrc/lru_scan_complex.cu`` (Complex operands, every stream passed as
  its two components); returns (out, carry), or ((out, carry), (a_prod,
  a_prod_last)) with ``return_a_prod``."""
  global ring_launches, thread_walk_launches
  global complex_ring_launches, complex_thread_walk_launches
  is_complex = isinstance(x, Complex)
  n = 2 if is_complex else 1
  source = "lru_scan_complex" if is_complex else "lru_scan"
  streams = 7 if return_a_prod else 5
  fn = _build.function(source, symbol + ("_a_prod" if return_a_prod else ""),
                       "p" * (n * streams) + "iiiiip")
  batch, _, dim = x.shape
  x, a = x.contiguous(), a.contiguous()
  h0 = None if h0 is None else h0.contiguous()

  def empty(shape, dtype):
    make = lambda: torch.empty(shape, dtype=dtype, device=x.device)
    return Complex(make(), make()) if is_complex else make()

  out, carry = empty(x.shape, x.dtype), empty((batch, dim), torch.float32)
  products = ()
  if return_a_prod:
    products = (empty(x.shape, x.dtype), empty((batch, dim), torch.float32))
  pointers = [z.data_ptr() for v in (x, a) for z in _components(v)]
  pointers += [None] * n if h0 is None else [z.data_ptr()
                                             for z in _components(h0)]
  pointers += [z.data_ptr() for v in (out, carry, *products)
               for z in _components(v)]
  with torch.cuda.device(x.device):
    err = fn(*pointers, batch, x.shape[1], dim, _DTYPE_CODES[x.dtype],
             int(reverse), torch.cuda.current_stream(x.device).cuda_stream)
  if err:
    raise RuntimeError(f"{symbol} CUDA kernel failed: cudaError_t {err}.")
  if batch and dim:
    ring = _takes_ring(x, a, out, *products[:1])
    if is_complex:
      complex_ring_launches += ring
      complex_thread_walk_launches += not ring
    else:
      ring_launches += ring
      thread_walk_launches += not ring
  return ((out, carry), products) if return_a_prod else (out, carry)


def _out_shapes(x, a_prod: bool):
  """(shape, dtype) of each output of a walk over ``x`` (one component):
  the outputs in ``x.dtype``, the float32 carry and, with ``a_prod``, the
  running product and its float32 last value."""
  batch, _, dim = x.shape
  outs = [(x.shape, x.dtype), ((batch, dim), torch.float32)]
  return outs * 2 if a_prod else outs


def _register_walk(walk: str, is_complex: bool, a_prod: bool):
  """Defines the operator of one walk (``forward`` or ``backward``) of one
  kind of operand, with or without the running product of ``a``.

  Its arguments are the components of ``(x, a, h0)`` (each ``Complex`` as
  its real and imaginary tensors; ``h0`` optional) and ``reverse``; its
  outputs the components of ``(y, h_last)`` or of ``(y, h_last, a_prod,
  a_prod_last)``. The CUDA implementation counts the launch in the counter
  of the walk (``launches``, ``backward_a_prod_launches``,
  ``complex_launches``, ...) and its route in ``ring_launches`` /
  ``thread_walk_launches`` (``complex_*`` for Complex operands)."""
  kind = "complex_" if is_complex else ""
  product = "_a_prod" if a_prod else ""
  name = f"lru_scan_{kind}{walk}{product}"
  counter = (kind + ("" if walk == "forward" else "backward_")
             + ("a_prod_" if a_prod else "") + "launches")
  symbol = f"cg_lru_scan_{kind}{walk}"
  parts = ("_real", "_imag") if is_complex else ("",)
  args = ", ".join(
      [f"Tensor {v}{z}" for v in ("x", "a") for z in parts]
      + [f"Tensor? h0{z}" for z in parts] + ["bool reverse"])
  outs = ", ".join(["Tensor"] * (len(parts) * (4 if a_prod else 2)))

  def flat(out):
    values = [*out[0], *out[1]] if a_prod else list(out)
    return tuple(_flatten(values, is_complex))

  def cpu(*operands):
    x, a, h0 = _unflatten(operands[:-1], is_complex)
    plain = lru_scan_plain if walk == "forward" else lru_scan_backward_plain
    out = flat(plain(x, a, h0, operands[-1], a_prod))
    return tuple(z.contiguous() for z in out)

  def cuda(*operands):
    x, a, h0 = _unflatten(operands[:-1], is_complex)
    out = _launch(symbol, x, a, h0, operands[-1], a_prod)
    globals()[counter] += 1
    return flat(out)

  def fake(*operands):
    x = operands[0]
    return tuple(x.new_empty(shape, dtype=dtype)
                 for shape, dtype in _out_shapes(x, a_prod)
                 for _ in parts)

  return library.define(f"{name}({args}) -> ({outs})", cpu=cpu, cuda=cuda,
                        fake=fake)


# The operators of the walks, by (walk, is_complex, a_prod).
_WALKS = {(walk, is_complex, a_prod): _register_walk(walk, is_complex, a_prod)
          for walk in ("forward", "backward") for is_complex in (False, True)
          for a_prod in (False, True)}


def _walk(walk: str, x, a, h0, reverse: bool, return_a_prod: bool):
  """Calls the operator of a walk and regroups its outputs as the plain
  versions return them."""
  is_complex = isinstance(x, Complex)
  out = _unflatten(
      _WALKS[walk, is_complex, return_a_prod](
          *_flatten((x, a, h0), is_complex), bool(reverse)),
      is_complex)
  return (tuple(out[:2]), tuple(out[2:])) if return_a_prod else tuple(out)


def lru_scan_forward(
    x: torch.Tensor | Complex,
    a: torch.Tensor | Complex,
    h0: torch.Tensor | Complex | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
):
  """The forward scan through its operator: the CUDA kernel for CUDA
  tensors, the plain loop for CPU tensors.

  Returns ``(y, h_last)``: outputs in ``x.dtype``, final state in float32;
  with ``return_a_prod``, ``((y, h_last), (a_prod, a_prod_last))`` (see
  :func:`lru_scan_plain`), counted in ``a_prod_launches``. Complex operands
  run ``cg_lru_scan_complex_forward`` and count in the ``complex_*``
  counters.
  """
  _check(x, a, h0)
  return _walk("forward", x, a, h0, reverse, return_a_prod)


def _carries_cpu(x, a, h0):
  y, h = lru_scan_plain(x, a, h0, y_in_acc_dtype=True)
  return y.contiguous(), h.contiguous()


def _carries_cuda(x, a, h0):
  global launches, carry_launches
  out = _launch("cg_lru_scan_forward", x.float(), a.float(), h0, False)
  launches += 1
  carry_launches += 1
  return out


def _carries_fake(x, a, h0):
  del a, h0
  return (x.new_empty(x.shape, dtype=torch.float32),
          x.new_empty((x.shape[0], x.shape[2]), dtype=torch.float32))


_CARRIES = library.define(
    "lru_scan_carries(Tensor x, Tensor a, Tensor? h0) -> (Tensor, Tensor)",
    cpu=_carries_cpu, cuda=_carries_cuda, fake=_carries_fake)


def lru_scan_carries(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The forward walk with every step's float32 carry as its output: the
  speculative verify's scan (``y_in_acc_dtype=True`` of JAX's
  ``lru_linear_scan``, ``cadence_gemma_tpu/ops/scan.py:57-68``), through its
  operator.

  On the card ``x`` and ``a`` are widened to float32 and the forward
  kernel's float32 instantiation walks them: widening is exact and the walk
  rounds each multiply and add in float32 whatever the input type, so ``y``
  holds the carries of the ``x.dtype`` walk bit for bit (and ``y.to(x.dtype)``
  is that walk's ``y``). Counted in ``launches`` and ``carry_launches``.
  On a CPU tensor, :func:`lru_scan_plain` with ``y_in_acc_dtype``.

  Returns ``(y in float32, h_last in float32)``.
  """
  _check(x, a, h0)
  if isinstance(x, Complex):
    raise ValueError("lru_scan_carries takes real operands.")
  return _CARRIES(x, a, h0)


def lru_scan_backward(
    g: torch.Tensor | Complex,
    a: torch.Tensor | Complex,
    dh_last: torch.Tensor | Complex | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
):
  """The cotangent scan through its operator: the CUDA kernel for CUDA
  tensors, the plain loop for CPU tensors.

  Returns ``(dx, dh0)``, or with ``return_a_prod`` also the running product
  of the multipliers along this walk, counted in
  ``backward_a_prod_launches``; see :func:`lru_scan_backward_plain`. For
  Complex operands the multiplier is ``conj(a)``: the kernel negates
  ``a.imag`` as it loads it, so no conjugated copy is made; counted in the
  ``complex_*`` counters.
  """
  _check(g, a, dh_last)
  return _walk("backward", g, a, dh_last, reverse, return_a_prod)


def _flatten(values, is_complex: bool) -> list:
  """The component tensors of ``values`` (tensors, Complex values or
  ``None``) in order: one slot per value, two for Complex."""
  if not is_complex:
    return list(values)
  out = []
  for v in values:
    out += [None, None] if v is None else [v.real, v.imag]
  return out


def _unflatten(tensors, is_complex: bool) -> list:
  """Inverse of :func:`_flatten`: a Complex value with no tensor is None,
  and one missing component (a cotangent that reaches only the other)
  becomes zeros."""
  if not is_complex:
    return list(tensors)
  values = []
  for re, im in zip(tensors[::2], tensors[1::2]):
    if re is None and im is None:
      values.append(None)
    else:
      values.append(Complex(torch.zeros_like(im) if re is None else re,
                            torch.zeros_like(re) if im is None else im))
  return values


class _LRUScan(torch.autograd.Function):
  """``lru_pallas_scan``'s ``custom_vjp``: ``_lru_fwd`` and ``_lru_bwd``.

  ``apply(reverse, is_complex, *components of (x, a, h0))`` returns the
  components of ``(y, h_last)``.
  """

  @staticmethod
  def forward(ctx, reverse, is_complex, *operands):
    x, a, h0 = _unflatten(operands, is_complex)
    y, h_last = lru_scan_forward(x, a, h0, reverse)
    # The residuals of _lru_fwd: y in x.dtype, a, h0 and whether it exists.
    ctx.save_for_backward(*_flatten((y, a, h0), is_complex))
    ctx.reverse = reverse
    ctx.is_complex = is_complex
    return tuple(_flatten((y, h_last), is_complex))

  @staticmethod
  def backward(ctx, *grads):
    y, a, h0 = _unflatten(ctx.saved_tensors, ctx.is_complex)
    dy, dh_last = _unflatten(grads, ctx.is_complex)
    dx, dh0 = lru_scan_backward(dy, a, dh_last, ctx.reverse)
    da = _decay_cotangent(dx, y, h0, ctx.reverse)
    return (None, None, *_flatten(
        (dx, da, None if h0 is None else dh0), ctx.is_complex))


def _decay_cotangent(dx, y, h0, reverse):
  """``da_t = dx_t * h_{t-1}`` (``dx_t * conj(h_{t-1})`` for Complex), with
  ``h_{t-1}`` taken from the rounded outputs ``y`` (as the JAX backward
  does) and ``h0`` (or zeros) at the boundary: the end the walk starts
  from."""
  boundary = (complex_lib.zeros_like(y[:, :1]) if h0 is None
              else h0[:, None].to(y.dtype))
  if reverse:
    h_prev = complex_lib.concatenate([y[:, 1:], boundary], axis=1)
  else:
    h_prev = complex_lib.concatenate([boundary, y[:, :-1]], axis=1)
  return dx * complex_lib.conjugate(h_prev)


def lru_scan(
    x: torch.Tensor | Complex,
    a: torch.Tensor | Complex,
    h0: torch.Tensor | Complex | None = None,
    reverse: bool = False,
):
  """The differentiable RG-LRU scan: kernels on the card, plain on CPU.

  Args:
    x: Inputs [batch, seq, dim], float32 or bfloat16, real or Complex.
    a: Per-step decay, same shape, dtype and kind as ``x``.
    h0: Optional initial state [batch, dim] in float32, of ``x``'s kind.
    reverse: Scan right to left.

  Returns:
    ``(y, h_last)``: outputs in ``x.dtype`` and the final state in float32.
  """
  _check(x, a, h0)
  is_complex = isinstance(x, Complex)
  out = _LRUScan.apply(reverse, is_complex,
                       *_flatten((x, a, h0), is_complex))
  return tuple(_unflatten(out, is_complex))


def _cotangent_walk(g, a, dh, reverse, return_a_prod):
  """The cotangent scan as a walk of its own direction: ``reverse`` here is
  the backward walk's, the forward's flipped."""
  return lru_scan_backward(g, a, dh, not reverse, return_a_prod)


class _ShardedLRUScan(torch.autograd.Function):
  """``_lru``'s ``custom_vjp`` over the shards of one scan domain
  (``_lru_fwd``, ``_lru_bwd``; ``pallas_lru.py:489-554``).

  ``apply(reverse, num_shards, is_complex, domain, *xs, *as_, *h0s)``
  takes every shard's operands (their components for Complex), since one
  controller holds the whole domain, and returns ``(*ys, *h_lasts)``
  likewise; with a ``domain`` that spans processes, this process's
  positions' (the pmap regime, or a mesh over processes).
  """

  @staticmethod
  def forward(ctx, reverse, num_shards, is_complex, domain, *operands):
    values = _unflatten(operands, is_complex)
    xs, as_, h0s = (values[i * num_shards:(i + 1) * num_shards]
                    for i in range(3))
    ys, h_lasts, h0s_corrected = sharding.scan_with_correction(
        lru_scan_forward, xs, as_, h0s, reverse, domain=domain)
    # The residuals of _lru_fwd: y, a and the corrected h0 of every shard.
    ctx.save_for_backward(*_flatten((*ys, *as_, *h0s_corrected), is_complex))
    ctx.reverse = reverse
    ctx.num_shards = num_shards
    ctx.is_complex = is_complex
    ctx.domain = domain
    ctx.has_h0 = [h0 is not None for h0 in h0s]
    ctx.set_materialize_grads(False)
    return tuple(_flatten((*ys, *h_lasts), is_complex))

  @staticmethod
  def backward(ctx, *grads):
    n = ctx.num_shards
    saved = _unflatten(ctx.saved_tensors, ctx.is_complex)
    ys, as_, h0s = saved[:n], saved[n:2 * n], saved[2 * n:]
    devices = [y.device for y in ys]
    grads = _unflatten(grads, ctx.is_complex)
    dys = [complex_lib.zeros_like(y) if g is None else g
           for g, y in zip(grads[:n], ys)]
    # Every shard returns the global h_last and the caller reads one of
    # them, so the cotangent that starts the walk is their sum (the psum of
    # _lru_bwd); shards with no cotangent add zero (across processes, as
    # zeros: every position takes part in the all-reduce).
    dh_lasts = grads[n:]
    if ctx.domain is not None:
      dh_lasts = [complex_lib.zeros_like(h0) if g is None else g
                  for g, h0 in zip(dh_lasts, h0s)]
    dh_lasts = sharding.psum(dh_lasts, ctx.domain or devices)
    # The cotangent scan walks the shards against the forward's order; each
    # step's incoming carry takes the product of `a` shifted one step, and
    # only the walk's last shard (the forward's first) returns dh0.
    dxs, dh0s, _ = sharding.scan_with_correction(
        _cotangent_walk, dys, as_, dh_lasts, not ctx.reverse,
        shift_a_prod=True, sync_h_last=False, domain=ctx.domain)
    # The corrected h0 of each shard stands in at its boundary.
    das = [_decay_cotangent(dx, y, h0, ctx.reverse)
           for dx, y, h0 in zip(dxs, ys, h0s)]
    dh0s = [dh0 if has else None for dh0, has in zip(dh0s, ctx.has_h0)]
    return (None, None, None, None,
            *_flatten((*dxs, *das, *dh0s), ctx.is_complex))


def sharded_scan(
    xs: Sequence[torch.Tensor | Complex],
    as_: Sequence[torch.Tensor | Complex],
    h0s: Sequence[torch.Tensor | Complex | None],
    reverse: bool = False,
    domain: sharding.Domain | None = None,
) -> tuple[list, list]:
  """The differentiable scan of one sequence-parallel domain: ``_lru`` over
  ``_sharded_scan`` (``cadence_gemma_tpu/ops/pallas_lru.py:453-554``).

  ``xs[j]``, ``as_[j]`` are shard ``j``'s ``[b, t_j, d]`` chunks of the time
  axis, in time order, each on its own device, and ``h0s[j]`` the global
  initial state (float32 ``[b, d]`` or ``None``) on that device; all real
  or all Complex. With one shard this is :func:`lru_scan` with ``h0``
  passed through. Otherwise every shard runs the kernel with the running
  product of ``a`` and no carry, and :func:`sharding.scan_with_correction`
  gathers the shards' ``(h_last, a_prod_last)`` pairs and turns each local
  scan into its part of the global one (every shard returns the global
  final state). The backward sums the shards' ``h_last`` cotangents, runs
  the cotangent-scan kernel with the product on every shard and corrects it
  the same way, walking the shards in reverse.

  ``domain``, a :class:`sharding.Domain` that spans processes, makes
  ``xs``, ``as_`` and ``h0s`` this process's positions of it (JAX's pmap
  regime holds one): the gather of the pairs and the backward's ``psum``
  of the ``h_last`` cotangents (``pallas_lru.py:548-550``) go over its
  process group.

  Returns ``(ys, h_lasts)``, one entry per shard on the shard's device.
  """
  if domain is not None and len(set(domain.ranks)) == 1:
    domain = None
  if len(xs) == 1 and domain is None:
    y, h_last = lru_scan(xs[0], as_[0], h0s[0], reverse)
    return [y], [h_last]
  for x, a, h0 in zip(xs, as_, h0s):
    _check(x, a, h0)
  is_complex = isinstance(xs[0], Complex)
  out = _ShardedLRUScan.apply(
      reverse, len(xs), is_complex, domain,
      *_flatten((*xs, *as_, *h0s), is_complex))
  out = _unflatten(out, is_complex)
  return list(out[:len(xs)]), list(out[len(xs):])
