"""RG-LRU scan: the CUDA kernels, their plain PyTorch versions, and autograd.

Computes ``h_t = a_t * h_{t-1} + x_t`` over the time axis of ``[b, t, d]``
inputs with a float32 carry; ``y`` comes back in ``x``'s dtype and the final
state ``h_last`` in float32. Counterpart of the JAX package's
``lru_pallas_scan`` (``cadence_gemma_tpu/ops/pallas_lru.py``) with its
``custom_vjp``, unsharded and over the shards of a sequence-parallel
``_sharded_scan``; complex operands are not ported.

:func:`lru_scan` and :func:`sharded_scan` are differentiable. Their forwards
run :func:`lru_scan_forward` and their backwards :func:`lru_scan_backward`,
the cotangent scan of ``_lru_bwd``; each launches its kernel of
``csrc/lru_scan.cu`` for a CUDA tensor and takes its plain version
(:func:`lru_scan_plain`, :func:`lru_scan_backward_plain`) only for a CPU
tensor. With ``return_a_prod=True`` either also returns the running product
of ``a`` along its walk (``compute_a_prod``), which :func:`sharded_scan`
needs to stitch the shards of a sequence-parallel scan together, in both
walks. A kernel that fails to build or launch raises; nothing falls back.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cadence_gemma_tpu_torch import _build
from cadence_gemma_tpu_torch.parallel import sharding

# Kernel launches in this process: forward and backward without the running
# product of `a`, and with it; callers reset them to count one run.
launches = 0
backward_launches = 0
a_prod_launches = 0
backward_a_prod_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lru_scan_plain(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
):
  """Sequential scan, one step at a time with a float32 carry.

  The same arithmetic as the kernel: a rounded multiply then a rounded add
  in float32, each step's output cast to ``x.dtype``. Differentiable by
  autograd (it is also the ``LINEAR_NATIVE`` scan).

  Returns ``(y, h_last)``, or ``((y, h_last), (a_prod, a_prod_last))`` with
  ``return_a_prod`` (the JAX ``lru_linear_scan``'s contract,
  ``cadence_gemma_tpu/ops/scan.py:49-93``): the running product of ``a`` in
  the walk's order from a float32 carry that starts at 1, each step a
  separately rounded float32 multiply, in ``x.dtype``, and its last value in
  float32 (``pallas_lru.py:142-160``).
  """
  batch, seq_len, dim = x.shape
  if h0 is None:
    h = torch.zeros(batch, dim, dtype=torch.float32, device=x.device)
  else:
    h = h0.float()
  p = torch.ones(batch, dim, dtype=torch.float32, device=x.device)
  steps = range(seq_len - 1, -1, -1) if reverse else range(seq_len)
  ys, ps = [], []
  for t in steps:
    a_t = a[:, t].float()
    h = a_t * h + x[:, t].float()
    ys.append(h.to(x.dtype))
    if return_a_prod:
      p = p * a_t
      ps.append(p.to(x.dtype))
  if reverse:
    ys.reverse()
    ps.reverse()
  y = torch.stack(ys, dim=1)
  if return_a_prod:
    return (y, h), (torch.stack(ps, dim=1), p)
  return y, h


def lru_scan_backward_plain(
    g: torch.Tensor,
    a: torch.Tensor,
    dh_last: torch.Tensor | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
):
  """The cotangent scan of a forward scan run with the same ``reverse``.

  Walks against the forward's direction: ``h += g_t``, ``dx_t = h``, then
  ``h *= a_t``, each a separately rounded float32 operation as in the
  kernel. ``dh_last`` (float32, ``None`` for zeros) starts the carry.
  Returns ``(dx in g.dtype, dh0 = a_0 * dh_0 in float32)``; with
  ``return_a_prod``, ``((dx, dh0), (a_prod, a_prod_last))`` where the
  running product of ``a`` follows this backward walk, as
  ``_lru_pallas_call(backprop=True, compute_a_prod=True)`` computes it
  (``pallas_lru.py:145-160``).
  """
  batch, seq_len, dim = g.shape
  if dh_last is None:
    h = torch.zeros(batch, dim, dtype=torch.float32, device=g.device)
  else:
    h = dh_last.float()
  p = torch.ones(batch, dim, dtype=torch.float32, device=g.device)
  dx = torch.empty_like(g)
  a_prod = torch.empty_like(g) if return_a_prod else None
  steps = range(seq_len) if reverse else range(seq_len - 1, -1, -1)
  for t in steps:
    a_t = a[:, t].float()
    h = h + g[:, t].float()
    dx[:, t] = h.to(g.dtype)
    h = h * a_t
    if return_a_prod:
      p = p * a_t
      a_prod[:, t] = p.to(g.dtype)
  if return_a_prod:
    return (dx, h), (a_prod, p)
  return dx, h


def _check(x, a, h0):
  if x.ndim != 3:
    raise ValueError(f"Expected [b, t, d] inputs, got shape {tuple(x.shape)}.")
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


def _launch(symbol: str, x, a, h0, reverse, return_a_prod=False):
  """Runs one scan kernel of ``csrc/lru_scan.cu``; returns (out, carry), or
  ((out, carry), (a_prod, a_prod_last)) with ``return_a_prod``."""
  if x.device.type != "cuda":
    raise ValueError(f"lru_scan runs on CUDA or CPU tensors, not {x.device}.")
  if return_a_prod:
    fn = _build.function("lru_scan", symbol + "_a_prod", "pppppppiiiiip")
  else:
    fn = _build.function("lru_scan", symbol, "pppppiiiiip")
  batch, seq_len, dim = x.shape
  x = x.contiguous()
  a = a.contiguous()
  h0 = None if h0 is None else h0.contiguous()
  out = torch.empty_like(x)
  carry = torch.empty(batch, dim, dtype=torch.float32, device=x.device)
  products = ()
  if return_a_prod:
    products = (torch.empty_like(x), torch.empty_like(carry))
  with torch.cuda.device(x.device):
    err = fn(
        x.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), carry.data_ptr(), *(z.data_ptr() for z in products),
        batch, seq_len, dim, _DTYPE_CODES[x.dtype], int(reverse),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
  if err:
    raise RuntimeError(f"{symbol} CUDA kernel failed: cudaError_t {err}.")
  return ((out, carry), products) if return_a_prod else (out, carry)


def lru_scan_forward(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
):
  """The forward scan: its CUDA kernel on the card, the plain loop on CPU.

  Returns ``(y, h_last)``: outputs in ``x.dtype``, final state in float32;
  with ``return_a_prod``, ``((y, h_last), (a_prod, a_prod_last))`` (see
  :func:`lru_scan_plain`), counted in ``a_prod_launches``.
  """
  global launches, a_prod_launches
  _check(x, a, h0)
  if x.device.type == "cpu":
    return lru_scan_plain(x, a, h0, reverse, return_a_prod)
  out = _launch("cg_lru_scan_forward", x, a, h0, reverse, return_a_prod)
  if return_a_prod:
    a_prod_launches += 1
  else:
    launches += 1
  return out


def lru_scan_backward(
    g: torch.Tensor,
    a: torch.Tensor,
    dh_last: torch.Tensor | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
):
  """The cotangent scan: its CUDA kernel on the card, the plain loop on CPU.

  Returns ``(dx, dh0)``, or with ``return_a_prod`` also the running product
  of ``a`` along this walk, counted in ``backward_a_prod_launches``; see
  :func:`lru_scan_backward_plain`.
  """
  global backward_launches, backward_a_prod_launches
  _check(g, a, dh_last)
  if g.device.type == "cpu":
    return lru_scan_backward_plain(g, a, dh_last, reverse, return_a_prod)
  out = _launch("cg_lru_scan_backward", g, a, dh_last, reverse, return_a_prod)
  if return_a_prod:
    backward_a_prod_launches += 1
  else:
    backward_launches += 1
  return out


class _LRUScan(torch.autograd.Function):
  """``lru_pallas_scan``'s ``custom_vjp``: ``_lru_fwd`` and ``_lru_bwd``."""

  @staticmethod
  def forward(ctx, x, a, h0, reverse):
    y, h_last = lru_scan_forward(x, a, h0, reverse)
    # The residuals of _lru_fwd: y in x.dtype, a, h0 and whether it exists.
    ctx.save_for_backward(y, a, h0)
    ctx.reverse = reverse
    return y, h_last

  @staticmethod
  def backward(ctx, dy, dh_last):
    y, a, h0 = ctx.saved_tensors
    dx, dh0 = lru_scan_backward(dy, a, dh_last, ctx.reverse)
    da = _decay_cotangent(dx, y, h0, ctx.reverse)
    return dx, da, (None if h0 is None else dh0), None


def _decay_cotangent(dx, y, h0, reverse):
  """``da_t = dx_t * h_{t-1}``, with ``h_{t-1}`` taken from the rounded
  outputs ``y`` (as the JAX backward does) and ``h0`` (or zeros) at the
  boundary: the end the walk starts from."""
  boundary = (y.new_zeros(y.shape[0], 1, y.shape[2]) if h0 is None
              else h0[:, None].to(y.dtype))
  if reverse:
    h_prev = torch.cat([y[:, 1:], boundary], dim=1)
  else:
    h_prev = torch.cat([boundary, y[:, :-1]], dim=1)
  return dx * h_prev


def lru_scan(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The differentiable RG-LRU scan: kernels on the card, plain on CPU.

  Args:
    x: Inputs [batch, seq, dim], float32 or bfloat16.
    a: Per-step decay, same shape and dtype as ``x``.
    h0: Optional initial state [batch, dim] in float32.
    reverse: Scan right to left.

  Returns:
    ``(y, h_last)``: outputs in ``x.dtype`` and the final state in float32.
  """
  return _LRUScan.apply(x, a, h0, reverse)


def _cotangent_walk(g, a, dh, reverse, return_a_prod):
  """The cotangent scan as a walk of its own direction: ``reverse`` here is
  the backward walk's, the forward's flipped."""
  return lru_scan_backward(g, a, dh, not reverse, return_a_prod)


class _ShardedLRUScan(torch.autograd.Function):
  """``_lru``'s ``custom_vjp`` over the shards of one scan domain
  (``_lru_fwd``, ``_lru_bwd``; ``pallas_lru.py:489-554``).

  ``apply(reverse, num_shards, *xs, *as_, *h0s)`` takes every shard's
  operands, since one controller holds the whole domain, and returns
  ``(*ys, *h_lasts)``.
  """

  @staticmethod
  def forward(ctx, reverse, num_shards, *operands):
    xs, as_, h0s = (operands[i * num_shards:(i + 1) * num_shards]
                    for i in range(3))
    ys, h_lasts, h0s_corrected = sharding.scan_with_correction(
        lru_scan_forward, xs, as_, h0s, reverse)
    # The residuals of _lru_fwd: y, a and the corrected h0 of every shard.
    ctx.save_for_backward(*ys, *as_, *h0s_corrected)
    ctx.reverse = reverse
    ctx.num_shards = num_shards
    ctx.has_h0 = [h0 is not None for h0 in h0s]
    ctx.set_materialize_grads(False)
    return (*ys, *h_lasts)

  @staticmethod
  def backward(ctx, *grads):
    n = ctx.num_shards
    saved = ctx.saved_tensors
    ys, as_, h0s = saved[:n], saved[n:2 * n], saved[2 * n:]
    devices = [y.device for y in ys]
    dys = [torch.zeros_like(y) if g is None else g
           for g, y in zip(grads[:n], ys)]
    # Every shard returns the global h_last and the caller reads one of
    # them, so the cotangent that starts the walk is their sum (the psum of
    # _lru_bwd); shards with no cotangent add zero.
    dh_lasts = sharding.psum(grads[n:], devices)
    # The cotangent scan walks the shards against the forward's order; each
    # step's incoming carry takes the product of `a` shifted one step, and
    # only the walk's last shard (the forward's first) returns dh0.
    dxs, dh0s, _ = sharding.scan_with_correction(
        _cotangent_walk, dys, as_, dh_lasts, not ctx.reverse,
        shift_a_prod=True, sync_h_last=False)
    # The corrected h0 of each shard stands in at its boundary.
    das = [_decay_cotangent(dx, y, h0, ctx.reverse)
           for dx, y, h0 in zip(dxs, ys, h0s)]
    dh0s = [dh0 if has else None for dh0, has in zip(dh0s, ctx.has_h0)]
    return (None, None, *dxs, *das, *dh0s)


def sharded_scan(
    xs: Sequence[torch.Tensor],
    as_: Sequence[torch.Tensor],
    h0s: Sequence[torch.Tensor | None],
    reverse: bool = False,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
  """The differentiable scan of one sequence-parallel domain: ``_lru`` over
  ``_sharded_scan`` (``cadence_gemma_tpu/ops/pallas_lru.py:453-554``).

  ``xs[j]``, ``as_[j]`` are shard ``j``'s ``[b, t_j, d]`` chunks of the time
  axis, in time order, each on its own device, and ``h0s[j]`` the global
  initial state (float32 ``[b, d]`` or ``None``) on that device. With one
  shard this is :func:`lru_scan` with ``h0`` passed through. Otherwise every
  shard runs the kernel with the running product of ``a`` and no carry, and
  :func:`sharding.scan_with_correction` gathers the shards' ``(h_last,
  a_prod_last)`` pairs and turns each local scan into its part of the
  global one (every shard returns the global final state). The backward
  sums the shards' ``h_last`` cotangents, runs the cotangent-scan kernel
  with the product on every shard and corrects it the same way, walking the
  shards in reverse.

  Returns ``(ys, h_lasts)``, one entry per shard on the shard's device.
  """
  if len(xs) == 1:
    y, h_last = lru_scan(xs[0], as_[0], h0s[0], reverse)
    return [y], [h_last]
  out = _ShardedLRUScan.apply(reverse, len(xs), *xs, *as_, *h0s)
  return list(out[:len(xs)]), list(out[len(xs):])
