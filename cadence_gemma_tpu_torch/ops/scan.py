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

Every path takes real tensors or :class:`complex_lib.Complex` operands (the
complex-valued LRU), as JAX's dispatch does: the decode step and the native
scans in the complex product, the kernel path through the complex kernels.

With a sharding spec whose mesh has a sequence axis, the time axis is split
into shards that each scan their chunk on their own device, corrected
across shards from an all-gather of ``(h_last, a_prod_last)`` pairs (JAX's
``shard_map`` regime): :func:`linear_scan` splits, runs
:func:`single_shard_rnn_scan` and concatenates. An ``activations_axis_name``
splits the channels as well: the recurrence is channel-wise, so each
channel slice is its own set of scan domains. Over a mesh that spans
processes, ``x`` is the global array on every process (as a multi-process
``jit`` sees it); each process scans its positions' blocks and the result is
gathered back into the global array. A spec without a mesh is JAX's pmap
regime: ``x`` is this process's shard, and the correction gathers over the
process group :func:`sharding.axis_env` bound the sequence axis to. Every
path is differentiable across shards: the kernel path through
:func:`lru_scan.sharded_scan`'s autograd Function (the sharded cotangent
scan), the native paths through autograd (across processes, through the
collectives' autograd Functions).
"""

from __future__ import annotations

from typing import Sequence

import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import complex_lib
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.parallel import sharding

ShardingSpec = sharding.ShardingSpec

# The sequential scan with a float32 carry (the JAX ``lax.scan`` path); with
# ``return_a_prod`` it also returns the running product of ``a``, with
# ``y_in_acc_dtype`` its outputs are the float32 carries (the speculative
# verify's, whose card route is ``lru_scan.lru_scan_carries``).
lru_linear_scan = lru_scan.lru_scan_plain


def lru_associative_scan(
    x: torch.Tensor | complex_lib.Complex,
    a: torch.Tensor | complex_lib.Complex,
    h0: torch.Tensor | complex_lib.Complex | None = None,
    reverse: bool = False,
    return_a_prod: bool = False,
):
  """Log-depth (Hillis-Steele) scan in float32 (``ops/scan.py:96-147``).

  log2(t) rounds of whole-tensor multiply-adds compose the recurrence's
  monoid ``(a2, x2) o (a1, x1) = (a2 * a1, a2 * x1 + x2)``, in the complex
  product for Complex operands. Returns ``(y, h_last)``, or with
  ``return_a_prod``
  ``((y, h_last), (a_prod in x.dtype, a_prod_last in float32))``.
  """
  if reverse:
    flip = lambda v: complex_lib.flip(v, (1,))
    out = lru_associative_scan(
        flip(x), flip(a), h0, reverse=False, return_a_prod=return_a_prod
    )
    if return_a_prod:
      (y, h_last), (a_prod, p_last) = out
      return (flip(y), h_last), (flip(a_prod), p_last)
    y, h_last = out
    return flip(y), h_last
  seq_len = x.shape[1]
  h = x.to(torch.float32)
  p = a.to(torch.float32)
  k = 1
  while k < seq_len:
    # The padded steps are the monoid's identity (1, 0): 1 + 0i for Complex.
    h = h + p * complex_lib.pad(h, (0, 0, k, 0))[:, :seq_len]
    p = p * complex_lib.pad(p, (0, 0, k, 0), value=1.0)[:, :seq_len]
    k *= 2
  if h0 is not None:
    h = h + p * h0.to(torch.float32)[:, None]
  if return_a_prod:
    return (h.to(x.dtype), h[:, -1]), (p.to(x.dtype), p[:, -1])
  return h.to(x.dtype), h[:, -1]


def single_shard_rnn_scan(
    xs: Sequence[torch.Tensor],
    as_: Sequence[torch.Tensor],
    h0s: Sequence[torch.Tensor | None],
    reverse: bool = False,
    scan_type: common.ScanType = common.ScanType.AUTO,
    domain: sharding.Domain | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
  """Scan of each shard's local chunk, corrected across the shards of one
  scan domain (``ops/scan.py:183-236``).

  JAX runs this function on every device of the sequence axis at once; the
  port runs it for the whole domain: ``xs[j]``, ``as_[j]`` and ``h0s[j]``
  are shard ``j``'s operands on its device. With ``domain``, a
  :class:`sharding.Domain` that spans processes, they are this process's
  positions' (one in the pmap regime) and the correction's collectives go
  over its process group. Returns ``(ys, h_lasts)``, one entry per shard.
  """
  if domain is not None and len(set(domain.ranks)) == 1:
    domain = None
  if scan_type in (common.ScanType.AUTO, common.ScanType.LINEAR_PALLAS):
    # The correction happens inside the kernel path, as in JAX.
    return lru_scan.sharded_scan(xs, as_, h0s, reverse, domain=domain)
  if scan_type is common.ScanType.LINEAR_NATIVE:
    scan_fn = lru_linear_scan
  elif scan_type is common.ScanType.ASSOCIATIVE_NATIVE:
    scan_fn = lru_associative_scan
  else:
    raise ValueError(f"Unsupported scan type: {scan_type}.")
  if len(xs) == 1 and domain is None:
    y, h_last = scan_fn(xs[0], as_[0], h0s[0], reverse=reverse)
    return [y], [h_last]
  # _native_scan_with_correction (``ops/scan.py:150-180``), differentiable
  # by autograd.
  ys, h_lasts, _ = sharding.scan_with_correction(scan_fn, xs, as_, h0s,
                                                reverse, domain=domain)
  return ys, h_lasts


def _channels(v, n: int, c: int):
  """Channel slice ``c`` of ``n`` (the last dimension), contiguous when
  split; Complex by its components."""
  if n == 1:
    return v
  if isinstance(v, complex_lib.Complex):
    return complex_lib.Complex(_channels(v.real, n, c), _channels(v.imag, n, c))
  return v.chunk(n, -1)[c].contiguous()


def _cat_channels(parts):
  return parts[0] if len(parts) == 1 else complex_lib.concatenate(parts, -1)


def _sequence_sharded_scan(x, a, h0, reverse, scan_type, spec):
  """The ``shard_map`` regime (``ops/scan.py:290-315``): split over the
  batch, sequence and channel axes, scan every domain, concatenate on
  ``x``'s device. ``h_last`` is replicated along the sequence axis, so it is
  read from sequence shard 0 of each batch shard."""
  mesh = sharding.check_spec(spec)
  if h0 is None:
    h0 = complex_lib.zeros_like(x[:, 0], torch.float32)
  if mesh.spans_processes:
    return _process_mesh_scan(x, a, h0, reverse, scan_type, spec)
  n_c = sharding._axis_size(mesh, spec.activations_axis_name)  # pylint: disable=protected-access
  if x.shape[-1] % n_c:
    raise ValueError(
        f"Dimension 2 of {tuple(x.shape)} does not divide into the {n_c} "
        f"shards of mesh axis {spec.activations_axis_name!r}.")
  y_parts, h_parts = [], []
  for c in range(n_c):
    x_sh, a_sh, h0_sh = (
        sharding.shard_activations(_channels(x, n_c, c), spec, c),
        sharding.shard_activations(_channels(a, n_c, c), spec, c),
        sharding.shard_state(_channels(h0, n_c, c), spec, c))
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
    y_parts.append(sharding.unshard(ys, x.device))
    h_parts.append(sharding.unshard(h_lasts, x.device))
  return _cat_channels(y_parts), _cat_channels(h_parts)


def _process_mesh_scan(x, a, h0, reverse, scan_type, spec):
  """The ``shard_map`` regime over a mesh that spans processes: ``x``,
  ``a`` and ``h0`` are the global arrays on every process; each process
  scans its positions' blocks, each scan domain's correction gathering over
  the process group of its sequence line, and every position's ``y`` and
  ``h_last`` are gathered back into the global arrays (differentiable:
  ``sharding.local_blocks`` / ``assemble_blocks``)."""
  mesh = spec.mesh
  for axis in mesh.axis_names:
    if (axis not in (spec.batch_axis_name, spec.sequence_axis_name,
                     spec.activations_axis_name)
        and mesh.axis_spans_processes(axis)):
      raise NotImplementedError(
          f"Mesh axis {axis!r} replicates the scan across processes: "
          f"{sharding.PROCESS_PER_CARD_ITEM}.")
  sizes = tuple(sharding._axis_size(mesh, n) for n in (  # pylint: disable=protected-access
      spec.batch_axis_name, spec.sequence_axis_name,
      spec.activations_axis_name))
  n_b, n_s, n_c = sizes
  for dim, n in zip((0, 1, 2), sizes):
    if x.shape[dim] % n:
      raise ValueError(f"Dimension {dim} of {tuple(x.shape)} does not divide "
                       f"into the {n} shards of its mesh axis.")
  blocks = [(i, j, c) for i in range(n_b) for j in range(n_s)
            for c in range(n_c)]
  index = {}
  for c in range(n_c):
    for i, row in enumerate(sharding.shard_positions(spec, c)):
      for j, pos in enumerate(row):
        index[i, j, c] = pos
  ranks = tuple(mesh.rank(index[blk]) for blk in blocks)
  group = mesh.group(ranks)
  act = sharding.BlockLayout(group, sizes, tuple(blocks), ranks)
  state = sharding.BlockLayout(group, (n_b, n_c),
                               tuple((i, c) for i, _, c in blocks), ranks)
  mine = act.mine
  x_b, a_b = sharding.local_blocks(x, act), sharding.local_blocks(a, act)
  h0_b = sharding.local_blocks(h0, state)
  held = {blocks[p]: k for k, p in enumerate(mine)}
  y_out, h_out = [None] * len(mine), [None] * len(mine)
  groups = sharding.seq_axis_groups(n_s, spec.sequence_axis_index_groups)
  for c in range(n_c):
    for i in range(n_b):
      for group_js in groups:
        members = [(i, j, c) for j in group_js if (i, j, c) in held]
        if not members:
          continue
        line = [index[i, j, c] for j in group_js]
        domain = mesh.domain(line, [index[i, j, c] for j in range(n_s)])
        ks = [held[m] for m in members]
        devices = [mesh.devices[index[m]] for m in members]
        got_y, got_h = single_shard_rnn_scan(
            *([v[k].to(d) for k, d in zip(ks, devices)]
              for v in (x_b, a_b, h0_b)),
            reverse, scan_type, domain=domain)
        for k, y_k, h_k in zip(ks, got_y, got_h):
          y_out[k], h_out[k] = y_k.to(x.device), h_k.to(x.device)
  y = sharding.assemble_blocks(y_out, act, x.shape)
  # h_last is replicated along the sequence axis: sequence shard 0's.
  h_last = sharding.assemble_blocks(h_out, state._replace(
      writes=tuple(j == 0 for _, j, _ in blocks)), h0.shape)
  return y, h_last


def _pmap_scan(x, a, h0, reverse, scan_type, spec):
  """JAX's pmap regime (``ops/scan.py:276-288``): ``x`` is this process's
  shard; the scan domain is the group bound to the sequence axis (or this
  process's index group of it)."""
  sharding.check_spec(spec)
  domain = sharding.pmap_domain(spec.sequence_axis_name, x.device,
                                spec.sequence_axis_index_groups)
  ys, h_lasts = single_shard_rnn_scan([x], [a], [h0], reverse, scan_type,
                                      domain=domain)
  return ys[0], h_lasts[0]


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
  (in float32), real tensors or :class:`complex_lib.Complex` values as the
  operands are. With ``sharding_spec`` the time axis must divide into the
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

  if sharding_spec is not None and sharding_spec.mesh is None:
    return _pmap_scan(x, a, h0, reverse, scan_type, sharding_spec)
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
