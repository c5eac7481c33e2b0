"""Sequence-parallel windowed attention: the halo exchange.

Counterpart of the JAX package's ``cadence_gemma_tpu/parallel/sp_attention.py``.
Windowed attention only needs the previous ``window`` positions, so each
sequence shard receives its predecessor's last ``window`` keys and values
(:func:`sharding.ppermute`; shard 0 receives zeros) and runs the window
attention kernel on its own queries against ``[halo || local]`` keys with
``kv_prefix=window``. Document masking needs no halo: the kernel's per-query
lower bound comes from the local ``segment_pos`` alone, and shard 0's zero
halo stays masked because its documents start at or after the halo boundary.

Differentiable: the attention's backward runs the dq and dk/dv kernels with
the halo, whose ``dk``/``dv`` cover the halo's rows. Autograd carries those
rows back through the ``torch.cat``, the ``.to`` of :func:`sharding.ppermute`
and the slice ``k[:, -window:]`` to the shard that sent them: the transpose
of the ``ppermute`` that JAX's autodiff derives. Shard 0's zero halo comes
from no shard and its gradient goes nowhere.
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch.ops import window_attention as window_attention_lib
from cadence_gemma_tpu_torch.parallel import sharding

_TILE = 128  # The JAX kernel's kv_prefix granularity; kept as its gate.


def can_sequence_shard(
    spec: sharding.ShardingSpec | None, seq_len: int, window: int
) -> bool:
  """Static dispatch test for the halo-exchange path
  (``sp_attention.py:42-59``, the same gates)."""
  if spec is None or spec.mesh is None:
    return False
  ax = spec.sequence_axis_name
  if not isinstance(ax, str) or ax not in spec.mesh.axis_names:
    return False
  if spec.sequence_axis_index_groups is not None:
    return False
  n = spec.mesh.shape[ax]
  if n <= 1 or seq_len % n:
    return False
  local = seq_len // n
  # A one-neighbour halo covers the window only if a shard is at least a
  # window long; the TPU kernel also needed a tile-aligned prefix.
  return local >= window and window % _TILE == 0 and local % _TILE == 0


def sequence_sharded_attention(
    queries: torch.Tensor,      # [b, t, n, h]
    keys: torch.Tensor,         # [b, t, 1, h]
    values: torch.Tensor,       # [b, t, 1, h]
    segment_pos: torch.Tensor,  # [b, t]
    window: int,
    spec: sharding.ShardingSpec,
) -> torch.Tensor:
  """Window attention over a sequence-sharded batch, for prefill and
  training (``sp_attention.py:62-94``).

  Splits the operands over the spec's batch and sequence axes, sends each
  shard's last ``window`` keys and values to the next shard, runs the
  window attention with ``kv_prefix=window`` on every shard's device and
  concatenates the ``[b, t, n, h]`` outputs on ``queries``' device.
  """
  devices = sharding.shard_devices(spec)
  q_sh, k_sh, v_sh, seg_sh = (
      sharding.shard_activations(z, spec)
      for z in (queries, keys, values, segment_pos)
  )
  perm = [(j, j + 1) for j in range(len(devices[0]) - 1)]
  outputs = []
  for row, qs, ks, vs, segs in zip(devices, q_sh, k_sh, v_sh, seg_sh):
    halo_k = sharding.ppermute([k[:, -window:] for k in ks], row, perm)
    halo_v = sharding.ppermute([v[:, -window:] for v in vs], row, perm)
    outputs.append([
        window_attention_lib.window_attention(
            q, torch.cat([hk, k], dim=1), torch.cat([hv, v], dim=1), seg,
            window, kv_prefix=window,
        )[0]
        for q, k, v, seg, hk, hv in zip(qs, ks, vs, segs, halo_k, halo_v)
    ])
  return sharding.unshard(outputs, queries.device)
