"""RG-LRU scan dispatch.

Counterpart of the JAX package's ``cadence_gemma_tpu/ops/scan.py``:

  * ``seq_len == 1``  -> the closed-form decode step ``y = a * h0 + x``, no
    kernel launch.
  * ``AUTO`` / ``LINEAR_PALLAS`` -> :func:`lru_scan.lru_scan`, differentiable:
    the CUDA kernels (forward scan, and the cotangent scan in the backward)
    on a CUDA tensor, their plain sequential versions on a CPU tensor.
  * ``LINEAR_NATIVE`` -> the plain sequential scan, on any device, through
    autograd.
  * ``ASSOCIATIVE_NATIVE`` -> the plain log-depth scan, on any device.

With a sharding spec whose mesh has a sequence axis, the time axis is split
into shards that each scan their chunk on their own device, corrected
across shards from an all-gather of ``(h_last, a_prod_last)`` pairs (JAX's
``shard_map`` regime): :func:`linear_scan` splits, runs
:func:`single_shard_rnn_scan` and concatenates. Every path is
differentiable across shards: the kernel path through
:func:`lru_scan.sharded_scan`'s autograd Function (the sharded cotangent
scan), the native paths through autograd. The pmap regime (a spec without a
mesh) and channel sharding raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.parallel import sharding

ShardingSpec = sharding.ShardingSpec

# The sequential scan with a float32 carry (the JAX ``lax.scan`` path); with
# ``return_a_prod`` it also returns the running product of ``a``.
lru_linear_scan = lru_scan.lru_scan_plain


def lru_associative_scan(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
):
  """Log-depth (Hillis-Steele) scan in float32 (``ops/scan.py:96-147``).

  log2(t) rounds of whole-tensor multiply-adds compose the recurrence's
  monoid ``(a2, x2) o (a1, x1) = (a2 * a1, a2 * x1 + x2)``. Returns
  ``(y, h_last)``, or with ``return_a_prod``
  ``((y, h_last), (a_prod in x.dtype, a_prod_last in float32))``.
  """
  if reverse:
    out = lru_associative_scan(
        x.flip(1), a.flip(1), h0, reverse=False, return_a_prod=return_a_prod
    )
    if return_a_prod:
      (y, h_last), (a_prod, p_last) = out
      return (y.flip(1), h_last), (a_prod.flip(1), p_last)
    y, h_last = out
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
  if return_a_prod:
    return (h.to(x.dtype), h[:, -1]), (p.to(x.dtype), p[:, -1])
  return h.to(x.dtype), h[:, -1]


def single_shard_rnn_scan(
    xs: Sequence[torch.Tensor],
    as_: Sequence[torch.Tensor],
    h0s: Sequence[torch.Tensor | None],
    reverse: bool = False,
    scan_type: common.ScanType = common.ScanType.AUTO,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
  """Scan of each shard's local chunk, corrected across the shards of one
  scan domain (``ops/scan.py:183-236``).

  JAX runs this function on every device of the sequence axis at once; the
  port runs it for the whole domain: ``xs[j]``, ``as_[j]`` and ``h0s[j]``
  are shard ``j``'s operands on its device. Returns ``(ys, h_lasts)``, one
  entry per shard.
  """
  if scan_type in (common.ScanType.AUTO, common.ScanType.LINEAR_PALLAS):
    # The correction happens inside the kernel path, as in JAX.
    return lru_scan.sharded_scan(xs, as_, h0s, reverse)
  if scan_type is common.ScanType.LINEAR_NATIVE:
    scan_fn = lru_linear_scan
  elif scan_type is common.ScanType.ASSOCIATIVE_NATIVE:
    scan_fn = lru_associative_scan
  else:
    raise ValueError(f"Unsupported scan type: {scan_type}.")
  if len(xs) == 1:
    y, h_last = scan_fn(xs[0], as_[0], h0s[0], reverse=reverse)
    return [y], [h_last]
  # _native_scan_with_correction (``ops/scan.py:150-180``), differentiable
  # by autograd.
  ys, h_lasts, _ = sharding.scan_with_correction(scan_fn, xs, as_, h0s,
                                                reverse)
  return ys, h_lasts


def _sequence_sharded_scan(x, a, h0, reverse, scan_type, spec):
  """The ``shard_map`` regime (``ops/scan.py:290-315``): split over the
  batch and sequence axes, scan every domain, concatenate on ``x``'s
  device. ``h_last`` is replicated along the sequence axis, so it is read
  from sequence shard 0 of each batch shard."""
  if h0 is None:
    h0 = torch.zeros(x.shape[0], x.shape[2], dtype=torch.float32,
                     device=x.device)
  x_sh, a_sh, h0_sh = (sharding.shard_activations(x, spec),
                       sharding.shard_activations(a, spec),
                       sharding.shard_state(h0, spec))
  groups = sharding.seq_axis_groups(len(x_sh[0]),
                                    spec.sequence_axis_index_groups)
  ys = [[None] * len(row) for row in x_sh]
  h_lasts = []
  for i in range(len(x_sh)):
    row_h = [None] * len(x_sh[i])
    for group in groups:
      got_y, got_h = single_shard_rnn_scan(
          [x_sh[i][j] for j in group], [a_sh[i][j] for j in group],
          [h0_sh[i][j] for j in group], reverse, scan_type,
      )
      for j, y_j, h_j in zip(group, got_y, got_h):
        ys[i][j], row_h[j] = y_j, h_j
    h_lasts.append([row_h[0]])
  return (sharding.unshard(ys, x.device),
          sharding.unshard(h_lasts, x.device))


def linear_scan(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor | None = None,
    reverse: bool = False,
    scan_type: common.ScanType = common.ScanType.AUTO,
    sharding_spec: ShardingSpec | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Top-level RG-LRU scan entry point (``ops/scan.py:239-315``).

  Returns the per-step outputs (in ``x.dtype``) and the final hidden state
  (in float32). With ``sharding_spec`` the time axis must divide into the
  mesh's sequence shards (and the batch into its batch shards), as
  ``shard_map`` requires; otherwise this raises ``ValueError``.
  """
  acc_dtype = sharding.get_acc_dtype(x, h0)
  if x.shape[1] == 1:
    # Decode fast path: one step in closed form.
    if h0 is None:
      return x, x[:, 0].to(acc_dtype)
    y = a.to(acc_dtype) * h0[:, None] + x.to(acc_dtype)
    return y.to(x.dtype), y[:, -1]

  if sharding_spec is not None:
    return _sequence_sharded_scan(x, a, h0, reverse, scan_type,
                                  sharding_spec)
  if scan_type in (common.ScanType.AUTO, common.ScanType.LINEAR_PALLAS):
    return lru_scan.lru_scan(x, a, h0, reverse=reverse)
  if scan_type is common.ScanType.LINEAR_NATIVE:
    return lru_linear_scan(x, a, h0, reverse=reverse)
  if scan_type is common.ScanType.ASSOCIATIVE_NATIVE:
    return lru_associative_scan(x, a, h0, reverse=reverse)
  raise ValueError(f"Unsupported scan type: {scan_type}.")
