"""Device meshes and the sequence-parallel correction of the RG-LRU scan.

Counterpart of the JAX package's ``cadence_gemma_tpu/parallel/sharding.py``:

  * :class:`ShardingSpec` names the mesh axes over which scan operands are
    sharded (batch / sequence / activations), with the JAX field names;
  * :func:`make_mesh` builds a :class:`Mesh`: a numpy array of
    ``torch.device``s and its axis names;
  * :func:`multi_shard_correction` turns independent per-shard linear scans
    into one global scan from the all-gathered ``(h_last, a_prod_last)``
    pairs, with the JAX arithmetic.

JAX's sequence parallelism is single-controller: one program holds the whole
``[b, t, ...]`` array and ``shard_map`` runs a per-shard function on every
device of the mesh. The port mirrors that in plain PyTorch. A
sequence-sharded function splits its operands along ``t`` (and the batch
along the ``data`` axis) with :func:`shard_activations`, runs the per-shard
work on each shard's device, and concatenates the results back on the
operands' device. The collectives the path needs are functions over the
list of shards, :func:`all_gather`, :func:`ppermute` and (in the backward)
:func:`psum`, each built of ``.to`` copies that are no-ops when the devices
coincide; a later process-per-card backend (``torch.distributed``) replaces
them.

A device may appear more than once in a mesh. JAX's CPU tests get 8 devices
from ``--xla_force_host_platform_device_count=8``; torch has no such flag,
so ``make_mesh((2, 4), ("data", "sequence"), devices=["cpu"] * 8)`` is the
port's counterpart, and ``[f"cuda:{i % torch.cuda.device_count()}" for i in
range(4)]`` puts four shards on one card (or one on each of four). No shard
is copied when its device is the operands'.

For ``h_t = a_t * h_{t-1} + x_t`` split into shards ``j = 0..J-1``, each
shard scans its chunk from a zero state (``S_j``) and keeps the running
product of its ``a`` (``P_j``); the true values are
``h_j(t) = S_j(t) + P_j(t) * H_{j-1}`` with the incoming states
``H_j = P_j(last) * H_{j-1} + S_j(last)``, ``H_{-1} = h0``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

# Canonical mesh axis names (``sharding.py:47-49``).
BATCH_AXIS = "data"
SEQUENCE_AXIS = "sequence"
MODEL_AXIS = "model"

_PMAP_OR_TP = (
    "the process-per-card regime over torch.distributed (ROADMAP queue 1 "
    "item 14)"
)


class Mesh:
  """A device mesh: an n-d numpy array of ``torch.device``s with axis names.

  The counterpart of ``jax.sharding.Mesh`` for a single controller: a device
  may appear at several positions.
  """

  def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
    if devices.ndim != len(axis_names):
      raise ValueError(
          f"{devices.ndim}-d devices for {len(axis_names)} axis names."
      )
    self.devices = devices
    self.axis_names = tuple(axis_names)

  @property
  def shape(self) -> dict[str, int]:
    """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
    return dict(zip(self.axis_names, self.devices.shape))

  def __repr__(self) -> str:
    return f"Mesh({self.shape}, devices={self.devices.flatten().tolist()})"


class ShardingSpec(NamedTuple):
  """Names of the mesh axes along which scan operands are sharded
  (``sharding.py:52-69``).

  Attributes:
    mesh: The device mesh; ``None`` is JAX's ``pmap`` regime (axis names
      only), which the port does not run.
    batch_axis_name: Mesh axis sharding the batch dimension (DP).
    sequence_axis_name: Mesh axis sharding the time dimension (SP).
    activations_axis_name: Mesh axis sharding the channel dimension (TP);
      not ported.
    sequence_axis_index_groups: Optional sub-groupings of the sequence axis,
      each group forming an independent scan domain.
  """

  mesh: Mesh | None = None
  batch_axis_name: str | None = None
  sequence_axis_name: str | None = None
  activations_axis_name: str | None = None
  sequence_axis_index_groups: list[list[int]] | None = None


def make_mesh(
    axis_shapes: Sequence[int],
    axis_names: Sequence[str],
    devices: Sequence[Any] | None = None,
) -> Mesh:
  """A mesh over ``devices`` (``sharding.py:100-109``).

  ``devices`` are ``torch.device``s or their names, in row-major order; a
  device may repeat. ``None`` means the CUDA devices of this process, and
  raises when there is none: pass ``devices=["cpu"] * n`` for the CPU.
  """
  if devices is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          "No CUDA device is available. make_mesh uses the cards by "
          "default; pass devices=['cpu'] * n to run on the CPU."
      )
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
  flat = np.empty(len(devices), dtype=object)
  flat[:] = [torch.device(d) for d in devices]
  return Mesh(flat.reshape(tuple(axis_shapes)), axis_names)


def _axis_size(mesh: Mesh, axis: str | None) -> int:
  if axis is None:
    return 1
  if not isinstance(axis, str):
    raise NotImplementedError(
        f"Axis {axis!r}: a dimension sharded over several mesh axes is not "
        "ported."
    )
  return mesh.shape[axis]


def num_sequence_shards(
    spec: ShardingSpec,
    seq_axis_index_groups: list[list[int]] | None = None,
) -> int:
  """Number of shards of one scan domain along the sequence axis (>= 1);
  ``sharding.py:112-119`` reads the same from a ``psum`` inside the map."""
  if seq_axis_index_groups is not None:
    return len(seq_axis_index_groups[0])
  if spec.mesh is None:
    raise NotImplementedError(f"A mesh-less ShardingSpec needs {_PMAP_OR_TP}.")
  return _axis_size(spec.mesh, spec.sequence_axis_name)


def sequence_shard_index(
    axis_index: int,
    seq_axis_index_groups: list[list[int]] | None = None,
) -> int:
  """Shard ``axis_index``'s position within its scan domain along the
  sequence axis (``sharding.py:122-139``)."""
  if seq_axis_index_groups is None:
    return axis_index
  for group in seq_axis_index_groups:
    if axis_index in group:
      return list(group).index(axis_index)
  raise ValueError(
      f"Shard {axis_index} is in no group of {seq_axis_index_groups}."
  )


def seq_axis_groups(
    num_shards: int, seq_axis_index_groups: list[list[int]] | None = None
) -> list[list[int]]:
  """The scan domains: lists of sequence-axis indices, each in scan order."""
  if seq_axis_index_groups is None:
    return [list(range(num_shards))]
  members = sorted(i for group in seq_axis_index_groups for i in group)
  if members != list(range(num_shards)):
    raise ValueError(
        f"{seq_axis_index_groups} must cover the {num_shards} sequence shards "
        "once each."
    )
  return [list(group) for group in seq_axis_index_groups]


def get_acc_dtype(x: torch.Tensor, h0: torch.Tensor | None) -> torch.dtype:
  """Accumulation dtype of the scan: float32 (``sharding.py:142-156``).

  The kernels and the plain loops carry float32 only; complex operands are
  not ported.
  """
  if h0 is not None and h0.dtype != torch.float32:
    raise ValueError(f"h0 dtype {h0.dtype} must match accumulator float32.")
  if x.is_complex():
    raise NotImplementedError("Complex scans are not ported.")
  return torch.float32


def check_spec(spec: ShardingSpec) -> Mesh:
  """The mesh of a spec the port runs; raises for the pmap and TP regimes."""
  if spec.mesh is None:
    raise NotImplementedError(
        f"A ShardingSpec without a mesh is JAX's pmap regime; it needs "
        f"{_PMAP_OR_TP}."
    )
  if spec.activations_axis_name is not None:
    raise NotImplementedError(
        f"Sharding channels over {spec.activations_axis_name!r} (TP) needs "
        f"{_PMAP_OR_TP}."
    )
  for axis in (spec.batch_axis_name, spec.sequence_axis_name):
    if axis is not None and axis not in spec.mesh.axis_names:
      raise ValueError(f"Axis {axis!r} is not in the mesh {spec.mesh}.")
  return spec.mesh


def shard_devices(spec: ShardingSpec) -> list[list[torch.device]]:
  """``[i][j]``: the device of batch shard ``i``, sequence shard ``j``.

  Mesh axes the spec does not name replicate the work in JAX; the port runs
  it once, at index 0 of each such axis.
  """
  mesh = check_spec(spec)
  n_b = _axis_size(mesh, spec.batch_axis_name)
  n_s = _axis_size(mesh, spec.sequence_axis_name)
  names = mesh.axis_names
  grid = []
  for i in range(n_b):
    row = []
    for j in range(n_s):
      index = [0] * len(names)
      if spec.batch_axis_name is not None:
        index[names.index(spec.batch_axis_name)] = i
      if spec.sequence_axis_name is not None:
        index[names.index(spec.sequence_axis_name)] = j
      row.append(mesh.devices[tuple(index)])
    grid.append(row)
  return grid


def shard_activations(
    x: torch.Tensor, spec: ShardingSpec
) -> list[list[torch.Tensor]]:
  """Splits ``[b, t, ...]`` into ``[i][j]`` chunks (batch over the batch
  axis, time over the sequence axis), each on its shard's device: the
  ``in_specs`` of the JAX ``shard_map``s (``ops/scan.py:302-306``,
  ``parallel/sp_attention.py:73-80``).

  Chunks are views of ``x`` where the shard's device is ``x``'s. Raises like
  ``shard_map`` when a dimension does not divide by its axis size.
  """
  devices = shard_devices(spec)
  n_b, n_s = len(devices), len(devices[0])
  for dim, n, name in ((0, n_b, spec.batch_axis_name),
                       (1, n_s, spec.sequence_axis_name)):
    if x.shape[dim] % n:
      raise ValueError(
          f"Dimension {dim} of {tuple(x.shape)} does not divide into the "
          f"{n} shards of mesh axis {name!r}."
      )
  return [
      [chunk.to(devices[i][j]) for j, chunk in enumerate(row.chunk(n_s, 1))]
      for i, row in enumerate(x.chunk(n_b, 0))
  ]


def shard_state(
    h: torch.Tensor, spec: ShardingSpec
) -> list[list[torch.Tensor]]:
  """Splits ``[b, ...]`` over the batch axis and gives every sequence shard
  its batch chunk (replicated along the sequence axis), on its device."""
  devices = shard_devices(spec)
  n_b = len(devices)
  if h.shape[0] % n_b:
    raise ValueError(
        f"Batch {h.shape[0]} does not divide into the {n_b} shards of mesh "
        f"axis {spec.batch_axis_name!r}."
    )
  return [[row.to(dev) for dev in devices[i]]
          for i, row in enumerate(h.chunk(n_b, 0))]


def unshard(
    shards: Sequence[Sequence[torch.Tensor]], device: torch.device
) -> torch.Tensor:
  """Concatenates ``[i][j]`` chunks back into one tensor on ``device`` (a
  single chunk is returned as it is, not copied)."""
  rows = [torch.cat([z.to(device) for z in row], dim=1)
          if len(row) > 1 else row[0].to(device) for row in shards]
  return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def _to(value, device: torch.device):
  if isinstance(value, tuple):
    return tuple(_to(v, device) for v in value)
  return value.to(device)


def all_gather(values: Sequence[Any], devices: Sequence[torch.device]
               ) -> list[list[Any]]:
  """Shard ``j`` receives every shard's value (tensors or tuples of them) on
  ``devices[j]``: ``jax.lax.all_gather`` over one scan domain."""
  return [[_to(v, dev) for v in values] for dev in devices]


def psum(values: Sequence[torch.Tensor | None],
         devices: Sequence[torch.device]) -> list[torch.Tensor | None]:
  """Shard ``j`` receives the sum of every shard's value, in shard order, on
  ``devices[j]`` (``jax.lax.psum`` over one scan domain). ``None`` counts as
  zero; if every value is ``None`` every shard receives ``None``."""
  present = [v for v in values if v is not None]
  out = []
  for dev in devices:
    total = None
    for v in present:
      total = v.to(dev) if total is None else total + v.to(dev)
    out.append(total)
  return out


def ppermute(values: Sequence[torch.Tensor], devices: Sequence[torch.device],
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
  """Shard ``dst`` receives ``values[src]`` on ``devices[dst]`` for each
  ``(src, dst)`` of ``perm``, and zeros where no source sends
  (``jax.lax.ppermute``)."""
  out = [torch.zeros_like(v, device=dev) for v, dev in zip(values, devices)]
  for src, dst in perm:
    out[dst] = values[src].to(devices[dst])
  return out


def multi_shard_correction(
    *,
    y: torch.Tensor,
    a_prod: torch.Tensor,
    h0: torch.Tensor | None,
    h_last: torch.Tensor,
    a_prod_last: torch.Tensor,
    reverse: bool = False,
    h_last_all: Sequence[torch.Tensor] | None = None,
    a_last_all: Sequence[torch.Tensor] | None = None,
    shard_index: int = 0,
    shift_a_prod: bool = False,
    sync_h_last: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Corrects one shard's local scan into its part of the global scan
  (``sharding.py:159-255``), from the gathered pairs.

  Args:
    y: This shard's local scan output (zero initial state), [b, t_local, d].
    a_prod: This shard's running product of ``a``, same shape as ``y``.
    h0: Global initial state (used by the first shard in scan order); None
      means zeros.
    h_last: This shard's local final state [b, d] in float32.
    a_prod_last: This shard's total ``a`` product [b, d] in float32.
    reverse: Whether the scan ran right-to-left (shard order flips).
    h_last_all, a_last_all: Every shard's ``h_last`` and ``a_prod_last`` of
      this scan domain, in shard order, on this shard's device (what
      ``jax.lax.all_gather`` hands each shard); None means one shard.
    shard_index: This shard's position in the domain.
    shift_a_prod: Shift ``a_prod`` one step toward the scan start (with a
      leading 1) before applying the correction, as the backward needs.
    sync_h_last: If True every shard returns the global final state; if
      False only the last shard in scan order does (others return zeros).

  Returns:
    ``(y_corrected, h_last_corrected, h0_corrected)``: the J-step recurrence
    runs in float32 and the correction ``y + h0_corrected * a_prod`` in
    ``a_prod``'s dtype, a rounded multiply then a rounded add for bfloat16.
  """
  get_acc_dtype(y, h0)
  h0 = torch.zeros_like(h_last) if h0 is None else h0

  num_shards = 1 if h_last_all is None else len(h_last_all)
  if num_shards == 1:
    return y, h_last, h0

  order = list(range(num_shards))
  if reverse:
    order = order[::-1]
  # The J-step recurrence H_j = P_j * H_{j-1} + S_j, as every shard runs it;
  # this shard keeps the state that flows into it.
  carry = h0
  h0_corrected = torch.zeros_like(h_last)
  for j in order:
    if j == shard_index:
      h0_corrected = h0_corrected + carry
    carry = a_last_all[j] * carry + h_last_all[j]
  h_last_corrected = carry

  if shift_a_prod:
    one = torch.ones_like(a_prod[:, :1])
    if reverse:
      a_prod = torch.cat([a_prod[:, 1:], one], dim=1)
    else:
      a_prod = torch.cat([one, a_prod[:, :-1]], dim=1)

  y_corrected = y + h0_corrected[:, None].to(a_prod.dtype) * a_prod

  if not sync_h_last and shard_index != order[-1]:
    h_last_corrected = h_last_corrected * 0.0
  return y_corrected, h_last_corrected, h0_corrected


def scan_with_correction(
    scan_fn: Callable[..., Any],
    xs: Sequence[torch.Tensor],
    as_: Sequence[torch.Tensor],
    h0s: Sequence[torch.Tensor | None],
    reverse: bool = False,
    *,
    shift_a_prod: bool = False,
    sync_h_last: bool = True,
) -> tuple[list[torch.Tensor], list[torch.Tensor], list[torch.Tensor]]:
  """Scans every shard of one scan domain from a zero state with the running
  product of ``a``, all-gathers the ``(h_last, a_prod_last)`` pairs and runs
  :func:`multi_shard_correction` on every shard, on its own device:
  ``_native_scan_with_correction`` (``ops/scan.py:150-180``) and both walks
  of ``_sharded_scan`` (``ops/pallas_lru.py:453-486``), which differ only in
  the scan and the two options.

  ``scan_fn(x, a, h0, reverse=..., return_a_prod=True)`` returns
  ``((y, h_last), (a_prod, a_prod_last))`` and walks right to left when
  ``reverse``; the correction takes the shards in that walk's order. The
  forward keeps ``shift_a_prod=False, sync_h_last=True``; the cotangent walk
  of the backward passes ``shift_a_prod=True, sync_h_last=False``, its
  ``reverse`` flipped from the forward's. Returns ``(ys, h_lasts,
  h0s_corrected)`` corrected, one entry per shard: the last is the state
  that flowed into each shard, which the backward keeps as a residual.
  """
  local = [scan_fn(x, a, None, reverse=reverse, return_a_prod=True)
           for x, a in zip(xs, as_)]
  pairs = [(h, p_last) for (_, h), (_, p_last) in local]
  gathered = all_gather(pairs, [x.device for x in xs])
  ys, h_lasts, h0s_corrected = [], [], []
  for j, ((y, h_last), (a_prod, a_prod_last)) in enumerate(local):
    h_all, a_all = zip(*gathered[j])
    y, h_last, h0_corrected = multi_shard_correction(
        y=y, a_prod=a_prod, h0=h0s[j], h_last=h_last,
        a_prod_last=a_prod_last, reverse=reverse, h_last_all=h_all,
        a_last_all=a_all, shard_index=j, shift_a_prod=shift_a_prod,
        sync_h_last=sync_h_last)
    ys.append(y)
    h_lasts.append(h_last)
    h0s_corrected.append(h0_corrected)
  return ys, h_lasts, h0s_corrected
