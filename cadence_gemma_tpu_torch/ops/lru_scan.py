"""RG-LRU forward scan: the CUDA kernel and its plain PyTorch version.

Computes ``h_t = a_t * h_{t-1} + x_t`` over the time axis of ``[b, t, d]``
inputs with a float32 carry; ``y`` comes back in ``x``'s dtype and the final
state ``h_last`` in float32. Counterpart of the JAX package's
``lru_pallas_scan`` (``cadence_gemma_tpu/ops/pallas_lru.py``) in forward
mode, without sequence parallelism, gradients or complex operands.

:func:`lru_scan` launches ``csrc/lru_scan.cu`` for a CUDA tensor and takes
:func:`lru_scan_plain` only for a CPU tensor. A kernel that fails to build or
launch raises; nothing falls back.
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch import _build

# Kernel launches in this process; callers reset it to count one run.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lru_scan_plain(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Sequential scan, one step at a time with a float32 carry.

  The same arithmetic as the kernel: a rounded multiply then a rounded add
  in float32, each step's output cast to ``x.dtype``.
  """
  batch, seq_len, dim = x.shape
  if h0 is None:
    h = torch.zeros(batch, dim, dtype=torch.float32, device=x.device)
  else:
    h = h0.float()
  y = torch.empty_like(x)
  steps = range(seq_len - 1, -1, -1) if reverse else range(seq_len)
  for t in steps:
    h = a[:, t].float() * h + x[:, t].float()
    y[:, t] = h.to(x.dtype)
  return y, h


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


def lru_scan(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The RG-LRU scan: the CUDA kernel on the card, the plain loop on CPU.

  Args:
    x: Inputs [batch, seq, dim], float32 or bfloat16.
    a: Per-step decay, same shape and dtype as ``x``.
    h0: Optional initial state [batch, dim] in float32.
    reverse: Scan right to left.

  Returns:
    ``(y, h_last)``: outputs in ``x.dtype`` and the final state in float32.
  """
  global launches
  _check(x, a, h0)
  if x.device.type == "cpu":
    return lru_scan_plain(x, a, h0, reverse)
  if x.device.type != "cuda":
    raise ValueError(f"lru_scan runs on CUDA or CPU tensors, not {x.device}.")

  fn = _build.function("lru_scan", "cg_lru_scan_forward", "pppppiiiiip")

  batch, seq_len, dim = x.shape
  x = x.contiguous()
  a = a.contiguous()
  h0 = None if h0 is None else h0.contiguous()
  y = torch.empty_like(x)
  h_last = torch.empty(batch, dim, dtype=torch.float32, device=x.device)
  with torch.cuda.device(x.device):
    err = fn(
        x.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), batch, seq_len, dim,
        _DTYPE_CODES[x.dtype], int(reverse),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
  launches += 1
  if err:
    raise RuntimeError(f"lru_scan CUDA kernel failed: cudaError_t {err}.")
  return y, h_last
