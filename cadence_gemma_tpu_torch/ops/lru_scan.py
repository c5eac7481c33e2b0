"""RG-LRU scan: the CUDA kernels, their plain PyTorch versions, and autograd.

Computes ``h_t = a_t * h_{t-1} + x_t`` over the time axis of ``[b, t, d]``
inputs with a float32 carry; ``y`` comes back in ``x``'s dtype and the final
state ``h_last`` in float32. Counterpart of the JAX package's
``lru_pallas_scan`` (``cadence_gemma_tpu/ops/pallas_lru.py``) with its
``custom_vjp``, without sequence parallelism or complex operands.

:func:`lru_scan` is differentiable. Its forward runs :func:`lru_scan_forward`
and its backward :func:`lru_scan_backward`, the cotangent scan of
``_lru_bwd``; each launches its kernel of ``csrc/lru_scan.cu`` for a CUDA
tensor and takes its plain version (:func:`lru_scan_plain`,
:func:`lru_scan_backward_plain`) only for a CPU tensor. A kernel that fails
to build or launch raises; nothing falls back.
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch import _build

# Kernel launches in this process, forward and backward; callers reset them
# to count one run.
launches = 0
backward_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lru_scan_plain(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Sequential scan, one step at a time with a float32 carry.

  The same arithmetic as the kernel: a rounded multiply then a rounded add
  in float32, each step's output cast to ``x.dtype``. Differentiable by
  autograd (it is also the ``LINEAR_NATIVE`` scan).
  """
  batch, seq_len, dim = x.shape
  if h0 is None:
    h = torch.zeros(batch, dim, dtype=torch.float32, device=x.device)
  else:
    h = h0.float()
  steps = range(seq_len - 1, -1, -1) if reverse else range(seq_len)
  ys = []
  for t in steps:
    h = a[:, t].float() * h + x[:, t].float()
    ys.append(h.to(x.dtype))
  if reverse:
    ys.reverse()
  return torch.stack(ys, dim=1), h


def lru_scan_backward_plain(
    g: torch.Tensor,
    a: torch.Tensor,
    dh_last: torch.Tensor | None = None,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The cotangent scan of a forward scan run with the same ``reverse``.

  Walks against the forward's direction: ``h += g_t``, ``dx_t = h``, then
  ``h *= a_t``, each a separately rounded float32 operation as in the
  kernel. ``dh_last`` (float32, ``None`` for zeros) starts the carry.
  Returns ``(dx in g.dtype, dh0 = a_0 * dh_0 in float32)``.
  """
  batch, seq_len, dim = g.shape
  if dh_last is None:
    h = torch.zeros(batch, dim, dtype=torch.float32, device=g.device)
  else:
    h = dh_last.float()
  dx = torch.empty_like(g)
  steps = range(seq_len) if reverse else range(seq_len - 1, -1, -1)
  for t in steps:
    h = h + g[:, t].float()
    dx[:, t] = h.to(g.dtype)
    h = h * a[:, t].float()
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


def _launch(symbol: str, x, a, h0, reverse):
  """Runs one scan kernel of ``csrc/lru_scan.cu``; returns (out, carry)."""
  if x.device.type != "cuda":
    raise ValueError(f"lru_scan runs on CUDA or CPU tensors, not {x.device}.")
  fn = _build.function("lru_scan", symbol, "pppppiiiiip")
  batch, seq_len, dim = x.shape
  x = x.contiguous()
  a = a.contiguous()
  h0 = None if h0 is None else h0.contiguous()
  out = torch.empty_like(x)
  carry = torch.empty(batch, dim, dtype=torch.float32, device=x.device)
  with torch.cuda.device(x.device):
    err = fn(
        x.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), carry.data_ptr(), batch, seq_len, dim,
        _DTYPE_CODES[x.dtype], int(reverse),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
  if err:
    raise RuntimeError(f"{symbol} CUDA kernel failed: cudaError_t {err}.")
  return out, carry


def lru_scan_forward(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The forward scan: its CUDA kernel on the card, the plain loop on CPU.

  Returns ``(y, h_last)``: outputs in ``x.dtype``, final state in float32.
  """
  global launches
  _check(x, a, h0)
  if x.device.type == "cpu":
    return lru_scan_plain(x, a, h0, reverse)
  out = _launch("cg_lru_scan_forward", x, a, h0, reverse)
  launches += 1
  return out


def lru_scan_backward(
    g: torch.Tensor,
    a: torch.Tensor,
    dh_last: torch.Tensor | None = None,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The cotangent scan: its CUDA kernel on the card, the plain loop on CPU.

  Returns ``(dx, dh0)``; see :func:`lru_scan_backward_plain`.
  """
  global backward_launches
  _check(g, a, dh_last)
  if g.device.type == "cpu":
    return lru_scan_backward_plain(g, a, dh_last, reverse)
  out = _launch("cg_lru_scan_backward", g, a, dh_last, reverse)
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
    # da_t = dx_t * h_{t-1}, with h_{t-1} taken from the rounded outputs y
    # (as the JAX backward does) and h0 (or zeros) at the boundary.
    boundary = (y.new_zeros(y.shape[0], 1, y.shape[2]) if h0 is None
                else h0[:, None].to(y.dtype))
    if ctx.reverse:
      h_prev = torch.cat([y[:, 1:], boundary], dim=1)
    else:
      h_prev = torch.cat([boundary, y[:, :-1]], dim=1)
    da = dx * h_prev
    return dx, da, (None if h0 is None else dh0), None


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
