"""RG-LRU scan dispatch.

Counterpart of the JAX package's ``cadence_gemma_tpu/ops/scan.py`` for one
device:

  * ``seq_len == 1``  -> the closed-form decode step ``y = a * h0 + x``, no
    kernel launch.
  * ``AUTO`` / ``LINEAR_PALLAS`` -> :func:`lru_scan.lru_scan`, differentiable:
    the CUDA kernels (forward scan, and the cotangent scan in the backward)
    on a CUDA tensor, their plain sequential versions on a CPU tensor.
  * ``LINEAR_NATIVE`` -> the plain sequential scan, on any device, through
    autograd.
  * ``ASSOCIATIVE_NATIVE`` -> the plain log-depth scan, on any device.

Sequence-parallel scans (a sharding spec) are not ported.
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.ops import lru_scan

# The sequential scan with a float32 carry (the JAX ``lax.scan`` path).
lru_linear_scan = lru_scan.lru_scan_plain


def lru_associative_scan(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Log-depth (Hillis-Steele) scan in float32.

  log2(t) rounds of whole-tensor multiply-adds compose the recurrence's
  monoid ``(a2, x2) o (a1, x1) = (a2 * a1, a2 * x1 + x2)``.
  """
  if reverse:
    y, h_last = lru_associative_scan(
        x.flip(1), a.flip(1), h0, reverse=False
    )
    return y.flip(1), h_last
  seq_len = x.shape[1]
  h = x.float()
  p = a.float()
  k = 1
  while k < seq_len:
    h = h + p * torch.nn.functional.pad(h, (0, 0, k, 0))[:, :seq_len]
    p = p * torch.nn.functional.pad(p, (0, 0, k, 0), value=1.0)[:, :seq_len]
    k *= 2
  if h0 is not None:
    h = h + p * h0.float()[:, None]
  return h.to(x.dtype), h[:, -1]


def linear_scan(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
    scan_type: common.ScanType = common.ScanType.AUTO,
    sharding_spec=None,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Top-level RG-LRU scan entry point.

  Returns the per-step outputs (in ``x.dtype``) and the final hidden state
  (in float32).
  """
  if sharding_spec is not None:
    raise NotImplementedError(
        "Sequence-parallel scans (sharding_spec) are not ported."
    )
  if x.shape[1] == 1:
    # Decode fast path: one step in closed form.
    if h0 is None:
      return x, x[:, 0].float()
    y = a.float() * h0[:, None] + x.float()
    return y.to(x.dtype), y[:, -1]

  if scan_type in (common.ScanType.AUTO, common.ScanType.LINEAR_PALLAS):
    return lru_scan.lru_scan(x, a, h0, reverse=reverse)
  if scan_type is common.ScanType.LINEAR_NATIVE:
    return lru_linear_scan(x, a, h0, reverse=reverse)
  if scan_type is common.ScanType.ASSOCIATIVE_NATIVE:
    return lru_associative_scan(x, a, h0, reverse=reverse)
  raise ValueError(f"Unsupported scan type: {scan_type}.")
