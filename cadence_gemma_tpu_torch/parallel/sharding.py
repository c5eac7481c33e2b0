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
coincide.

One process a card (``torch.distributed``): a :class:`Mesh` may span
processes (``multihost.make_hybrid_mesh``); it knows each position's process
rank and builds one process group for each set of processes an axis line
crosses (:meth:`Mesh.build_groups`). The collectives then take a
:class:`Domain` (the positions of one axis line, their ranks and the group)
in place of the device list and run in SPMD form: each process passes the
values of its own positions and receives its positions' results, through
``dist.all_gather`` / ``all_reduce`` / ``batch_isend_irecv`` on the group
(whatever backend ``multihost.initialize`` started). Autograd does not
cross processes the way ``.to`` lets it, so each collective's transpose is
an autograd Function: ``all_gather`` -> the cotangents summed over the
processes, sliced to this shard; ``ppermute`` -> the inverse permutation;
``psum`` -> ``psum`` of the cotangents. JAX's ``pmap`` regime (a
:class:`ShardingSpec` without a mesh) binds its axis names to process
groups with :func:`axis_env`: each rank of the group holds one shard.

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
``H_j = P_j(last) * H_{j-1} + S_j(last)``, ``H_{-1} = h0``. The same holds
over the complex numbers: the sharding functions and the collectives carry
a :class:`complex_lib.Complex` by its components, and the correction uses
its product.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import distributed as dist

from cadence_gemma_tpu_torch import complex_lib

Complex = complex_lib.Complex

# Canonical mesh axis names (``sharding.py:47-49``).
BATCH_AXIS = "data"
SEQUENCE_AXIS = "sequence"
MODEL_AXIS = "model"

# The ROADMAP item that lifts what the process-per-card regime still refuses.
PROCESS_PER_CARD_ITEM = (
    "ROADMAP queue 1 item 14h (SP, TP, PP, the captured decode and the export "
    "across processes: the rest of item 14g)")


def refuse_processes(mesh: "Mesh | None", what: str) -> None:
  """Raises ``NotImplementedError`` naming :data:`PROCESS_PER_CARD_ITEM`
  where ``mesh`` spans processes: ``what`` runs single-controller only."""
  if mesh is not None and mesh.spans_processes:
    raise NotImplementedError(
        f"{what} over a mesh that spans processes ({mesh}) needs "
        f"{PROCESS_PER_CARD_ITEM}.")


def process_rank() -> int:
  """This process's rank in the default group, 0 without one."""
  if dist.is_available() and dist.is_initialized():
    return dist.get_rank()
  return 0


class Mesh:
  """A device mesh: an n-d numpy array of ``torch.device``s with axis names.

  The counterpart of ``jax.sharding.Mesh``: a device may appear at several
  positions. ``ranks`` (same shape, or ``None``: every position is this
  process's) holds each position's process where the mesh spans processes,
  as JAX's global devices carry ``process_index``; ``devices`` then holds
  each position's device as its own process names it.
  """

  def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
               ranks: np.ndarray | None = None):
    if devices.ndim != len(axis_names):
      raise ValueError(
          f"{devices.ndim}-d devices for {len(axis_names)} axis names."
      )
    if ranks is not None:
      ranks = np.asarray(ranks, dtype=np.int64)
      if ranks.shape != devices.shape:
        raise ValueError(f"ranks of shape {ranks.shape} for devices of shape "
                         f"{devices.shape}.")
    self.devices = devices
    self.axis_names = tuple(axis_names)
    self.ranks = ranks
    self._groups: dict[tuple[int, ...], Any] = {}

  @property
  def shape(self) -> dict[str, int]:
    """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
    return dict(zip(self.axis_names, self.devices.shape))

  @property
  def spans_processes(self) -> bool:
    return self.ranks is not None and np.unique(self.ranks).size > 1

  def rank(self, index: tuple[int, ...]) -> int:
    """The process of the position at ``index``."""
    return process_rank() if self.ranks is None else int(self.ranks[index])

  def is_local(self, index: tuple[int, ...]) -> bool:
    """Whether the position at ``index`` belongs to this process."""
    return self.ranks is None or int(self.ranks[index]) == process_rank()

  def line(self, axis: str, index: Sequence[int]) -> list[tuple[int, ...]]:
    """The positions along ``axis`` through ``index`` (its entry for
    ``axis`` ignored), in axis order."""
    k = self.axis_names.index(axis)
    out = []
    for j in range(self.devices.shape[k]):
      pos = list(index)
      pos[k] = j
      out.append(tuple(pos))
    return out

  def axis_spans_processes(self, axis: str) -> bool:
    """Whether some line along ``axis`` holds positions of two processes."""
    if self.ranks is None:
      return False
    k = self.axis_names.index(axis)
    per_line = np.moveaxis(self.ranks, k, -1).reshape(-1,
                                                      self.ranks.shape[k])
    return any(np.unique(row).size > 1 for row in per_line)

  def build_groups(self) -> "Mesh":
    """Creates the process group of every set of processes that an axis
    line, or the whole mesh, crosses. ``dist.new_group`` is collective:
    every process of the default group calls this for the same meshes in
    the same order (the sets are created sorted). The set of every process
    takes the default group (so does a mesh of one process in a group of
    one)."""
    if self.ranks is None:
      return self
    sets = {tuple(sorted({int(r) for r in self.ranks.flat}))}
    for k in range(self.ranks.ndim):
      rows = np.moveaxis(self.ranks, k, -1).reshape(-1, self.ranks.shape[k])
      sets |= {tuple(sorted({int(r) for r in row})) for row in rows}
    world = tuple(range(dist.get_world_size()))
    for ranks in sorted(s for s in sets if len(s) > 1 or s == world):
      self._groups[ranks] = (dist.group.WORLD if ranks == world
                             else dist.new_group(list(ranks)))
    return self

  def group(self, ranks: Sequence[int]):
    """The process group of the processes ``ranks`` (built by
    :meth:`build_groups`)."""
    key = tuple(sorted(set(int(r) for r in ranks)))
    if key not in self._groups:
      raise RuntimeError(
          f"The mesh has no process group for ranks {key}: build it with "
          "Mesh.build_groups() on every process (multihost.make_hybrid_mesh "
          "does).")
    return self._groups[key]

  def domain(self, positions: Sequence[tuple[int, ...]],
             group_positions: Sequence[tuple[int, ...]] | None = None
             ) -> "Domain":
    """The :class:`Domain` of ``positions``, over the group of the
    processes of ``group_positions`` (default: the same positions)."""
    ranks = tuple(self.rank(p) for p in positions)
    group_ranks = (ranks if group_positions is None
                   else [self.rank(p) for p in group_positions])
    return Domain(ranks, tuple(self.devices[p] for p in positions),
                  self.group(group_ranks))

  def __repr__(self) -> str:
    ranks = "" if self.ranks is None else f", ranks={self.ranks.flatten().tolist()}"
    return (f"Mesh({self.shape}, devices={self.devices.flatten().tolist()}"
            f"{ranks})")


class Domain(NamedTuple):
  """The positions of one collective that spans processes, in axis order:
  each position's process and device, and a process group that holds every
  one of those processes (it may hold more: a scan domain of
  ``sequence_axis_index_groups`` gathers over its whole axis)."""

  ranks: tuple[int, ...]
  devices: tuple[torch.device, ...]
  group: Any

  @property
  def local(self) -> list[int]:
    """This process's positions, in axis order."""
    me = process_rank()
    return [p for p, r in enumerate(self.ranks) if r == me]


class ShardingSpec(NamedTuple):
  """Names of the mesh axes along which scan operands are sharded
  (``sharding.py:52-69``).

  Attributes:
    mesh: The device mesh; ``None`` is JAX's ``pmap`` regime (axis names
      only, bound to process groups by :func:`axis_env`).
    batch_axis_name: Mesh axis sharding the batch dimension (DP).
    sequence_axis_name: Mesh axis sharding the time dimension (SP).
    activations_axis_name: Mesh axis sharding the channel dimension (TP).
    sequence_axis_index_groups: Optional sub-groupings of the sequence axis,
      each group forming an independent scan domain.
  """

  mesh: Mesh | None = None
  batch_axis_name: str | None = None
  sequence_axis_name: str | None = None
  activations_axis_name: str | None = None
  sequence_axis_index_groups: list[list[int]] | None = None


def cuda_devices() -> list[torch.device]:
  """The CUDA devices of this process; raises when there is none. One
  process of several owns one card: ``cuda:{LOCAL_RANK}`` (its rank where
  no launcher set ``LOCAL_RANK``), modulo the card count."""
  if not torch.cuda.is_available():
    raise RuntimeError(
        "No CUDA device is available. make_mesh uses the cards by "
        "default; pass devices=['cpu'] * n to run on the CPU."
    )
  count = torch.cuda.device_count()
  if dist.is_available() and dist.is_initialized() and (
      dist.get_world_size() > 1):
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return [torch.device("cuda", local % count)]
  return [torch.device("cuda", i) for i in range(count)]


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
    devices = cuda_devices()
  flat = np.empty(len(devices), dtype=object)
  flat[:] = [torch.device(d) for d in devices]
  return Mesh(flat.reshape(tuple(axis_shapes)), axis_names)


class PartitionSpec(tuple):
  """Per-dimension mesh axis names (or ``None``), as
  ``jax.sharding.PartitionSpec``: ``PartitionSpec("model", None)`` splits
  dimension 0 over the ``model`` axis; a shorter spec replicates the rest."""

  def __new__(cls, *entries):
    return super().__new__(cls, entries)

  def __repr__(self) -> str:
    return f"PartitionSpec{tuple(self)!r}"


class NamedSharding:
  """A mesh and a :class:`PartitionSpec`: where each piece of a leaf lives
  (``jax.sharding.NamedSharding``)."""

  def __init__(self, mesh: Mesh, spec: PartitionSpec):
    self.mesh = mesh
    self.spec = PartitionSpec(*spec)

  @property
  def is_fully_replicated(self) -> bool:
    return all(a is None or self.mesh.shape[a] == 1 for a in self.spec)

  def __repr__(self) -> str:
    return f"NamedSharding({self.mesh}, {self.spec})"


def axis_devices(mesh: Mesh, axis: str) -> list[torch.device]:
  """The devices along mesh axis ``axis``, at index 0 of every other axis:
  the positions a sharded leaf's pieces live on (the other axes replicate
  the work in JAX; a single controller runs it once, as
  :func:`shard_devices` does)."""
  if axis not in mesh.axis_names:
    raise ValueError(f"Axis {axis!r} is not in the mesh {mesh}.")
  index = [0] * len(mesh.axis_names)
  out = []
  for j in range(mesh.shape[axis]):
    index[mesh.axis_names.index(axis)] = j
    out.append(mesh.devices[tuple(index)])
  return out


def sharded_dim(spec: PartitionSpec, axis: str) -> int | None:
  """The dimension ``spec`` splits over ``axis`` (``None``: replicated
  along it). A spec naming another axis is refused: a single controller
  places pieces along one axis."""
  dim = None
  for i, name in enumerate(spec):
    if name is None:
      continue
    if name != axis:
      raise NotImplementedError(
          f"{spec} splits over {name!r}: placing a leaf over several mesh "
          f"axes needs {PROCESS_PER_CARD_ITEM}.")
    dim = i
  return dim


def place(tensor: torch.Tensor, sharding: NamedSharding,
          axis: str = MODEL_AXIS) -> list[torch.Tensor]:
  """One piece of ``tensor`` for every device along ``axis``: piece ``j``
  is slice ``j`` of the dimension ``sharding``'s spec splits over ``axis``,
  or the whole leaf where the spec replicates it, on ``axis_devices[j]``.

  A piece on ``tensor``'s own device is a view (strided where the spec
  splits a later dimension), on another device a contiguous copy.
  """
  devices = axis_devices(sharding.mesh, axis)
  dim = sharded_dim(sharding.spec, axis)
  if dim is None:
    return [tensor.to(dev) for dev in devices]
  n = len(devices)
  if tensor.shape[dim] % n:
    raise ValueError(f"Dimension {dim} of {tuple(tensor.shape)} does not "
                     f"divide into the {n} shards of mesh axis {axis!r}.")
  size = tensor.shape[dim] // n
  return [tensor.narrow(dim, j * size, size).to(dev)
          for j, dev in enumerate(devices)]


def tree_axis(shardings) -> str:
  """The one mesh axis a :class:`NamedSharding` tree splits its leaves
  over; :data:`MODEL_AXIS` where every leaf is replicated. A tree naming two
  axes is refused, as :func:`sharded_dim` refuses a spec that does."""
  names = {name for s in shardings.values() for name in s.spec
           if name is not None}
  if len(names) > 1:
    raise NotImplementedError(
        f"The sharding tree splits over {sorted(names)}: placing leaves over "
        f"several mesh axes needs {PROCESS_PER_CARD_ITEM}.")
  return names.pop() if names else MODEL_AXIS


def place_state_dict(state_dict, shardings, axis: str | None = None
                     ) -> dict[str, list[torch.Tensor]]:
  """Every leaf of a state dict placed by its :class:`NamedSharding`
  (``jax.device_put(params, shardings)``): ``{name: [piece per device
  along axis]}`` (see :func:`place`). ``axis=None`` takes the axis the
  tree's specs name (:func:`tree_axis`)."""
  missing = set(state_dict) ^ set(shardings)
  if missing:
    raise ValueError(f"The sharding tree and the state dict differ in "
                     f"{sorted(missing)[:4]}.")
  axis = axis or tree_axis(shardings)
  return {name: place(t, shardings[name], axis)
          for name, t in state_dict.items()}


def _axis_size(mesh: Mesh, axis: str | None) -> int:
  if axis is None:
    return 1
  if not isinstance(axis, str):
    raise NotImplementedError(
        f"Axis {axis!r}: a dimension sharded over several mesh axes is not "
        "ported."
    )
  return mesh.shape[axis]


# Mesh-less axis names bound to process groups (jax.pmap's axis_name).
_AXIS_ENV: dict[str, Any] = {}


@contextlib.contextmanager
def axis_env(**groups):
  """Binds axis names to process groups for JAX's ``pmap`` regime (a
  :class:`ShardingSpec` without a mesh): ``with axis_env(seq=group):``
  runs the sharded functions as ``jax.pmap(..., axis_name="seq")`` does,
  each rank of ``group`` one position of the axis in the group's rank
  order, holding its own shard. ``None`` binds the default group."""
  saved = dict(_AXIS_ENV)
  _AXIS_ENV.update({name: dist.group.WORLD if g is None else g
                    for name, g in groups.items()})
  try:
    yield
  finally:
    _AXIS_ENV.clear()
    _AXIS_ENV.update(saved)


def bound_group(name: str):
  """The process group :func:`axis_env` bound ``name`` to; an unbound name
  raises as JAX's unbound axis does."""
  if not isinstance(name, str):
    raise NotImplementedError(
        f"Axis {name!r}: a dimension sharded over several axes is not ported.")
  if name not in _AXIS_ENV:
    raise NameError(
        f"unbound axis name: {name}. A ShardingSpec without a mesh is JAX's "
        f"pmap regime: bind the name to a process group with "
        f"sharding.axis_env({name}=group).")
  return _AXIS_ENV[name]


def _group_ranks(group) -> list[int]:
  """The default-group ranks of ``group``, in its rank order."""
  return sorted(dist.get_process_group_ranks(group))


def pmap_domain(name: str | None, device: torch.device,
                seq_axis_index_groups: list[list[int]] | None = None
                ) -> Domain | None:
  """This process's scan domain along the bound axis ``name``: the ranks of
  its index group (the whole axis without groups), one position each;
  ``None`` without an axis."""
  if name is None:
    return None
  group = bound_group(name)
  ranks = _group_ranks(group)
  me = dist.get_rank(group)
  positions = seq_axis_groups(len(ranks), seq_axis_index_groups)
  mine = next(g for g in positions if me in g)
  return Domain(tuple(ranks[p] for p in mine), (device,) * len(mine), group)


def num_sequence_shards(
    spec: ShardingSpec,
    seq_axis_index_groups: list[list[int]] | None = None,
) -> int:
  """Number of shards of one scan domain along the sequence axis (>= 1);
  ``sharding.py:112-119`` reads the same from a ``psum`` inside the map (a
  mesh-less spec: the size of the group its axis is bound to)."""
  if seq_axis_index_groups is not None:
    return len(seq_axis_index_groups[0])
  if spec.mesh is None:
    if spec.sequence_axis_name is None:
      return 1
    return dist.get_world_size(bound_group(spec.sequence_axis_name))
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


def get_acc_dtype(x: torch.Tensor | Complex,
                  h0: torch.Tensor | Complex | None) -> torch.dtype:
  """Accumulation dtype of the scan: float32 (``sharding.py:142-156``).

  The kernels and the plain loops carry float32, for a
  :class:`complex_lib.Complex` operand in each component. A native torch
  complex tensor is refused: wrap it with ``complex_lib.to_custom_complex``.
  """
  if h0 is not None and h0.dtype != torch.float32:
    raise ValueError(f"h0 dtype {h0.dtype} must match accumulator float32.")
  for v in (x, h0):
    if isinstance(v, torch.Tensor) and v.is_complex():
      raise ValueError(
          f"Native complex operand of dtype {v.dtype}: the scan takes a "
          "complex_lib.Complex pair of real tensors "
          "(complex_lib.to_custom_complex)."
      )
  return torch.float32


def check_spec(spec: ShardingSpec) -> Mesh | None:
  """The mesh of a spec (``None`` for JAX's pmap regime, whose sequence
  axis must be bound by :func:`axis_env`); raises ``ValueError`` for an
  axis the mesh lacks or one axis named twice."""
  if spec.mesh is None:
    if spec.sequence_axis_name is not None:
      bound_group(spec.sequence_axis_name)
    return None
  named = [a for a in (spec.batch_axis_name, spec.sequence_axis_name,
                       spec.activations_axis_name) if a is not None]
  for axis in named:
    if axis not in spec.mesh.axis_names:
      raise ValueError(f"Axis {axis!r} is not in the mesh {spec.mesh}.")
  if len(set(named)) != len(named):
    raise ValueError(f"{spec} names one mesh axis for two dimensions.")
  return spec.mesh


def shard_positions(spec: ShardingSpec, channel: int = 0
                    ) -> list[list[tuple[int, ...]]]:
  """``[i][j]``: the mesh index of batch shard ``i``, sequence shard ``j``
  at channel shard ``channel``.

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
      for axis, k in ((spec.batch_axis_name, i),
                      (spec.sequence_axis_name, j),
                      (spec.activations_axis_name, channel)):
        if axis is not None:
          index[names.index(axis)] = k
      row.append(tuple(index))
    grid.append(row)
  return grid


def shard_devices(spec: ShardingSpec, channel: int = 0
                  ) -> list[list[torch.device]]:
  """``[i][j]``: the device of batch shard ``i``, sequence shard ``j`` (at
  channel shard ``channel``); see :func:`shard_positions`."""
  return [[spec.mesh.devices[p] for p in row]
          for row in shard_positions(spec, channel)]


def _componentwise(fn, x, *args):
  """``fn`` over the components of a Complex ``x``, its nested-list result
  zipped back into Complex values; ``fn(x, *args)`` for a real tensor."""
  if not isinstance(x, Complex):
    return fn(x, *args)
  real, imag = fn(x.real, *args), fn(x.imag, *args)
  return [[Complex(r, i) for r, i in zip(row_r, row_i)]
          for row_r, row_i in zip(real, imag)]


def shard_activations(
    x: torch.Tensor | Complex, spec: ShardingSpec, channel: int = 0
) -> list[list[torch.Tensor]]:
  """Splits ``[b, t, ...]`` into ``[i][j]`` chunks (batch over the batch
  axis, time over the sequence axis), each on its shard's device: the
  ``in_specs`` of the JAX ``shard_map``s (``ops/scan.py:302-306``,
  ``parallel/sp_attention.py:73-80``).

  Chunks are views of ``x`` where the shard's device is ``x``'s. Raises like
  ``shard_map`` when a dimension does not divide by its axis size. A Complex
  ``x`` is split by its components.
  """
  if isinstance(x, Complex):
    return _componentwise(shard_activations, x, spec, channel)
  devices = shard_devices(spec, channel)
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
    h: torch.Tensor | Complex, spec: ShardingSpec, channel: int = 0
) -> list[list[torch.Tensor]]:
  """Splits ``[b, ...]`` over the batch axis and gives every sequence shard
  its batch chunk (replicated along the sequence axis), on its device."""
  if isinstance(h, Complex):
    return _componentwise(shard_state, h, spec, channel)
  devices = shard_devices(spec, channel)
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
  single chunk is returned as it is, not copied); Complex chunks by their
  components."""
  if isinstance(shards[0][0], Complex):
    return Complex(unshard([[z.real for z in row] for row in shards], device),
                   unshard([[z.imag for z in row] for row in shards], device))
  rows = [torch.cat([z.to(device) for z in row], dim=1)
          if len(row) > 1 else row[0].to(device) for row in shards]
  return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def _to(value, device: torch.device):
  if isinstance(value, tuple):
    items = (_to(v, device) for v in value)
    return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
  return value.to(device)


def _zeros_on(v, device: torch.device):
  if isinstance(v, Complex):
    return Complex(_zeros_on(v.real, device), _zeros_on(v.imag, device))
  return torch.zeros_like(v, device=device)


def _per_device(fn, devices: Sequence[torch.device]) -> list[Any]:
  """``fn(device)`` for every position of ``devices``, computed once a
  distinct device: positions that share a device (a mesh that repeats one
  card) receive the same object."""
  done: dict[torch.device, Any] = {}
  out = []
  for dev in devices:
    if dev not in done:
      done[dev] = fn(dev)
    out.append(done[dev])
  return out


def _leaves(value) -> list[torch.Tensor]:
  """The tensors of a tensor, a Complex or a (named) tuple of them."""
  if isinstance(value, torch.Tensor):
    return [value]
  if isinstance(value, Complex):
    return [value.real, value.imag]
  return [t for v in value for t in _leaves(v)]


def _rebuild(like, leaves: list[torch.Tensor]):
  """``like``'s structure over ``leaves`` (consumed from the front)."""
  if isinstance(like, torch.Tensor):
    return leaves.pop(0)
  if isinstance(like, Complex):
    return Complex(leaves.pop(0), leaves.pop(0))
  items = [_rebuild(v, leaves) for v in like]
  return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _spmd(devices) -> Domain | None:
  """The domain of a collective whose positions span processes, else
  ``None`` (a device list, or a domain in one process)."""
  if isinstance(devices, Domain) and len(set(devices.ranks)) > 1:
    return devices
  return None


def _own_devices(devices) -> list[torch.device]:
  if isinstance(devices, Domain):
    return [devices.devices[p] for p in devices.local]
  return list(devices)


class _AllGather(torch.autograd.Function):
  """``dist.all_gather`` of this process's positions' values over a group:
  ``apply(group, *local)`` returns every member's values in the group's
  rank order (each member passes as many). The transpose sums every
  process's cotangents and keeps this process's slices."""

  @staticmethod
  def forward(ctx, group, *local):
    size = dist.get_world_size(group)
    n = len(local)
    ctx.group, ctx.n, ctx.rank = group, n, dist.get_rank(group)
    ctx.like = (torch.empty_like(local[0], device="meta"), local[0].device)
    if n == 1:
      parts = [torch.empty_like(local[0]) for _ in range(size)]
      dist.all_gather(parts, local[0].contiguous(), group=group)
      return tuple(parts)
    stacked = torch.stack(local)
    parts = [torch.empty_like(stacked) for _ in range(size)]
    dist.all_gather(parts, stacked, group=group)
    return tuple(t.clone() for part in parts for t in part.unbind(0))

  @staticmethod
  def backward(ctx, *grads):
    like, device = ctx.like
    total = torch.stack([torch.zeros_like(like, device=device) if g is None
                         else g for g in grads])
    dist.all_reduce(total, group=ctx.group)
    mine = total[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n]
    return (None, *mine.unbind(0))


class _AllReduce(torch.autograd.Function):
  """``dist.all_reduce`` (sum) of one tensor over a group; its transpose
  is the same sum of the cotangents."""

  @staticmethod
  def forward(ctx, group, value):
    ctx.group = group
    out = value.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out

  @staticmethod
  def backward(ctx, grad):
    out = grad.contiguous().clone()
    dist.all_reduce(out, group=ctx.group)
    return None, out


def _exchange(group, sends, recvs) -> list[torch.Tensor]:
  """Posts every send ``(tag, peer, tensor)`` and receive ``(tag, peer,
  template)`` of one step in one ``dist.batch_isend_irecv``, in tag order on
  both sides, and waits; returns the received tensors."""
  ops, out = [], []
  for tag, peer, tensor in sends:
    ops.append((tag, dist.P2POp(dist.isend, tensor.contiguous(), peer,
                                group, tag)))
  for tag, peer, template in recvs:
    buf = torch.empty_like(template, memory_format=torch.contiguous_format)
    out.append(buf)
    ops.append((tag, dist.P2POp(dist.irecv, buf, peer, group, tag)))
  if ops:
    for request in dist.batch_isend_irecv([op for _, op in sorted(
        ops, key=lambda item: item[0])]):
      request.wait()
  return out


class _PPermute(torch.autograd.Function):
  """One ``ppermute`` over a domain that spans processes: ``apply(group,
  plan, *local)`` takes this process's positions' values and returns its
  positions' results. ``plan`` lists, by local index: ``hops`` ``(src,
  dst)`` within the process, ``sends`` ``(tag, peer, src)`` and ``recvs``
  ``(tag, peer, dst)``. The transpose runs the hops backwards: each
  cotangent goes back to its source, across processes by the same tags."""

  @staticmethod
  def forward(ctx, group, plan, *local):
    ctx.group, ctx.plan = group, plan
    out = [torch.zeros_like(v) for v in local]
    for src, dst in plan["hops"]:
      out[dst] = local[src].clone()
    got = _exchange(group, [(tag, peer, local[src])
                            for tag, peer, src in plan["sends"]],
                    [(tag, peer, local[dst])
                     for tag, peer, dst in plan["recvs"]])
    for (_, _, dst), value in zip(plan["recvs"], got):
      out[dst] = value
    ctx.like = [torch.empty_like(v, device="meta") for v in local]
    ctx.devices = [v.device for v in local]
    return tuple(out)

  @staticmethod
  def backward(ctx, *grads):
    plan = ctx.plan
    grads = [torch.zeros_like(like, device=dev) if g is None else g
             for g, like, dev in zip(grads, ctx.like, ctx.devices)]
    back = [torch.zeros_like(g) for g in grads]
    for src, dst in plan["hops"]:
      back[src] = back[src] + grads[dst]
    got = _exchange(ctx.group, [(tag, peer, grads[dst])
                                for tag, peer, dst in plan["recvs"]],
                    [(tag, peer, back[src])
                     for tag, peer, src in plan["sends"]])
    for (_, _, src), value in zip(plan["sends"], got):
      back[src] = back[src] + value
    return (None, None, *back)


class _Tie(torch.autograd.Function):
  """``apply(n, *outputs, *tied)`` returns the ``n`` outputs unchanged and
  gives the tied tensors zero cotangents: a collective's transpose must run
  on every process of its group, so a value whose result this process
  does not use (the first shard's correction ignores the gathered pairs)
  is tied to what it returns."""

  @staticmethod
  def forward(ctx, n, *tensors):
    ctx.tied = [torch.empty_like(t, device="meta") for t in tensors[n:]]
    ctx.devices = [t.device for t in tensors[n:]]
    return tuple(t.view_as(t) for t in tensors[:n])

  @staticmethod
  def backward(ctx, *grads):
    return (None, *grads, *(torch.zeros_like(t, device=d)
                            for t, d in zip(ctx.tied, ctx.devices)))


def tie(outputs: Sequence[Any], tied: Any) -> list[Any]:
  """``outputs`` (tensors or Complex values) unchanged, with every tensor of
  ``tied`` receiving a zero cotangent wherever they receive one (see
  :class:`_Tie`)."""
  leaves = [_leaves(o) for o in outputs]
  flat = [t for group in leaves for t in group]
  out = list(_Tie.apply(len(flat), *flat, *_leaves(tied)))
  return [_rebuild(o, out) for o in outputs]


def gather_positions(values: Sequence[Any], domain: Domain) -> list[Any]:
  """Every position's value of ``domain``, in axis order, on this process:
  ``values`` are this process's positions' (tensors, Complex values or
  tuples of them, alike on every position), and every member of the
  domain's group passes as many (differentiable: see :class:`_AllGather`)."""
  local = domain.local
  if len(values) != len(local):
    raise ValueError(f"{len(values)} values for this process's {len(local)} "
                     "positions of the domain.")
  leaves = [_leaves(v) for v in values]
  members = _group_ranks(domain.group)
  gathered = [_AllGather.apply(domain.group, *[lv[k] for lv in leaves])
              for k in range(len(leaves[0]))]
  seen: dict[int, int] = {}
  out = []
  for rank in domain.ranks:
    j = seen.get(rank, 0)
    seen[rank] = j + 1
    slot = members.index(rank) * len(local) + j
    out.append(_rebuild(values[0], [g[slot] for g in gathered]))
  return out


def all_gather(values: Sequence[Any], devices: Sequence[torch.device] | Domain
               ) -> list[list[Any]]:
  """Shard ``j`` receives every shard's value (tensors or tuples of them) on
  ``devices[j]``: ``jax.lax.all_gather`` over one scan domain. Positions on
  one device share one list. Over a :class:`Domain` that spans processes,
  ``values`` and the result are this process's positions'."""
  domain = _spmd(devices)
  if domain is not None:
    values = gather_positions(values, domain)
  return _per_device(lambda dev: [_to(v, dev) for v in values],
                     _own_devices(devices))


def all_gather_features(values: Sequence[torch.Tensor],
                        devices: Sequence[torch.device] | Domain
                        ) -> list[torch.Tensor]:
  """Shard ``j`` receives every shard's value concatenated along the last
  dimension on ``devices[j]`` (``jax.lax.all_gather(..., tiled=True)``),
  computed once a distinct device: the tensor-parallel forward gathers a
  feature-sharded activation with it where a replicated weight contracts all
  of it. SPMD over a :class:`Domain` that spans processes."""
  domain = _spmd(devices)
  if domain is not None:
    values = gather_positions(values, domain)
  return _per_device(
      lambda dev: torch.cat([v.to(dev) for v in values], dim=-1),
      _own_devices(devices))


def psum(values: Sequence[torch.Tensor | None],
         devices: Sequence[torch.device] | Domain
         ) -> list[torch.Tensor | None]:
  """Shard ``j`` receives the sum of every shard's value, in shard order, on
  ``devices[j]`` (``jax.lax.psum`` over one scan domain). ``None`` counts as
  zero; if every value is ``None`` every shard receives ``None``. The sum is
  computed once a distinct device, and positions on one device share it.

  Over a :class:`Domain` that spans processes, ``values`` (no ``None``) are
  this process's positions': they are summed here, in order, and the sums
  all-reduced over the domain's group (a sub-domain of its group, an index
  group's, sums the gathered values in order instead)."""
  domain = _spmd(devices)
  if domain is not None:
    if any(v is None for v in values):
      raise ValueError("Across processes every position passes a value.")
    if sorted(set(domain.ranks)) == _group_ranks(domain.group):
      local = values[0]
      for v in values[1:]:
        local = local + _to(v, _device_of(local))
      leaves = [_AllReduce.apply(domain.group, t) for t in _leaves(local)]
      total = _rebuild(local, leaves)
    else:
      every = gather_positions(values, domain)
      total = every[0]
      for v in every[1:]:
        total = total + v
    return _per_device(lambda dev: _to(total, dev), _own_devices(devices))

  present = [v for v in values if v is not None]

  def total_on(dev):
    total = None
    for v in present:
      total = v.to(dev) if total is None else total + v.to(dev)
    return total

  return _per_device(total_on, _own_devices(devices))


def _device_of(value) -> torch.device:
  return _leaves(value)[0].device


def psum_(tensor: torch.Tensor, domain: Domain) -> torch.Tensor:
  """Sums ``tensor`` over the processes of ``domain``'s group in place (one
  value a process; not differentiable): the data axis's gradient
  all-reduce, through whatever backend the group runs (a group of one
  process too)."""
  dist.all_reduce(tensor, group=domain.group)
  return tensor


def ppermute(values: Sequence[torch.Tensor | None],
             devices: Sequence[torch.device] | Domain,
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor | None]:
  """Shard ``dst`` receives ``values[src]`` on ``devices[dst]`` for each
  ``(src, dst)`` of ``perm``, and zeros where no source sends
  (``jax.lax.ppermute``). ``None`` marks a position that holds nothing (a
  pipeline's bubble): it sends ``None``, and receives ``None`` where no
  source sends.

  Over a :class:`Domain` that spans processes, ``values`` (no ``None``)
  and the result are this process's positions'; a hop between two
  processes goes through ``dist.batch_isend_irecv`` on the domain's group,
  its receiving position's own value the template of what arrives."""
  domain = _spmd(devices)
  if domain is not None:
    return _ppermute_spmd(values, domain, perm)
  source = {dst: src for src, dst in perm}
  out = []
  for dst, (v, dev) in enumerate(zip(values, devices)):
    sent = values[source[dst]] if dst in source else None
    if sent is not None:
      out.append(sent.to(dev))
    elif dst in source or v is None:
      out.append(None)
    else:
      out.append(_zeros_on(v, dev))
  return out


def _ppermute_spmd(values, domain: Domain, perm) -> list:
  local = domain.local
  if len(values) != len(local):
    raise ValueError(f"{len(values)} values for this process's {len(local)} "
                     "positions of the domain.")
  if any(v is None for v in values):
    raise ValueError("Across processes every position passes a tensor.")
  where = {p: k for k, p in enumerate(local)}
  me = process_rank()
  plan = {"hops": [], "sends": [], "recvs": []}
  for tag, (src, dst) in enumerate(perm):
    src_here, dst_here = domain.ranks[src] == me, domain.ranks[dst] == me
    if src_here and dst_here:
      plan["hops"].append((where[src], where[dst]))
    elif src_here:
      plan["sends"].append((tag, domain.ranks[dst], where[src]))
    elif dst_here:
      plan["recvs"].append((tag, domain.ranks[src], where[dst]))
  out = _PPermute.apply(domain.group, plan, *values)
  return [v.to(domain.devices[p]) for p, v in zip(local, out)]


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
    For the complex scan every operand is a :class:`complex_lib.Complex`,
    both products are complex and ``shift_a_prod``'s leading one is 1 + 0i.
  """
  get_acc_dtype(y, h0)
  h0 = complex_lib.zeros_like(h_last) if h0 is None else h0

  num_shards = 1 if h_last_all is None else len(h_last_all)
  if num_shards == 1:
    return y, h_last, h0

  order = list(range(num_shards))
  if reverse:
    order = order[::-1]
  # The J-step recurrence H_j = P_j * H_{j-1} + S_j, as every shard runs it;
  # this shard keeps the state that flows into it.
  carry = h0
  h0_corrected = complex_lib.zeros_like(h_last)
  for j in order:
    if j == shard_index:
      h0_corrected = h0_corrected + carry
    carry = a_last_all[j] * carry + h_last_all[j]
  h_last_corrected = carry

  if shift_a_prod:
    one = complex_lib.ones_like(a_prod[:, :1])  # 1 + 0i for Complex
    if reverse:
      a_prod = complex_lib.concatenate([a_prod[:, 1:], one], axis=1)
    else:
      a_prod = complex_lib.concatenate([one, a_prod[:, :-1]], axis=1)

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
    domain: Domain | None = None,
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

  ``domain`` (a :class:`Domain` that spans processes) makes the shards this
  process's positions of it, the gather a ``dist.all_gather`` over its
  group.
  """
  local = [scan_fn(x, a, None, reverse=reverse, return_a_prod=True)
           for x, a in zip(xs, as_)]
  pairs = [(h, p_last) for (_, h), (_, p_last) in local]
  index = (list(range(len(xs))) if _spmd(domain) is None else domain.local)
  gathered = all_gather(pairs, domain if _spmd(domain) is not None
                        else [x.device for x in xs])
  ys, h_lasts, h0s_corrected = [], [], []
  for k, ((y, h_last), (a_prod, a_prod_last)) in enumerate(local):
    h_all, a_all = zip(*gathered[k])
    y, h_last, h0_corrected = multi_shard_correction(
        y=y, a_prod=a_prod, h0=h0s[k], h_last=h_last,
        a_prod_last=a_prod_last, reverse=reverse, h_last_all=h_all,
        a_last_all=a_all, shard_index=index[k], shift_a_prod=shift_a_prod,
        sync_h_last=sync_h_last)
    if _spmd(domain) is not None and torch.is_grad_enabled():
      y, h_last = tie((y, h_last), gathered[k])
    ys.append(y)
    h_lasts.append(h_last)
    h0s_corrected.append(h0_corrected)
  return ys, h_lasts, h0s_corrected


class BlockLayout(NamedTuple):
  """A global array's blocks over the positions of a mesh that spans
  processes: ``counts`` blocks a dimension, each position's block index and
  process, and the group of those processes (every one of which holds as
  many positions)."""

  group: Any
  counts: tuple[int, ...]
  blocks: tuple[tuple[int, ...], ...]
  ranks: tuple[int, ...]
  # Whether each position's block is written (a replicated block: one copy).
  writes: tuple[bool, ...] | None = None

  @property
  def mine(self) -> list[int]:
    me = process_rank()
    return [p for p, r in enumerate(self.ranks) if r == me]

  def slices(self, shape, p: int) -> tuple[slice, ...]:
    return tuple(slice(k * (n // c), (k + 1) * (n // c))
                 for n, c, k in zip(shape, self.counts, self.blocks[p]))

  def place(self, out: torch.Tensor, blocks: Sequence[torch.Tensor],
            accumulate: bool = False) -> None:
    """Writes every process's ``blocks`` (its positions', in order) into
    ``out``, gathered over the group; ``accumulate`` adds them instead, in
    position order (a block several positions share)."""
    stacked = torch.stack([b.contiguous() for b in blocks])
    parts = [torch.empty_like(stacked)
             for _ in range(dist.get_world_size(self.group))]
    dist.all_gather(parts, stacked, group=self.group)
    members = _group_ranks(self.group)
    seen: dict[int, int] = {}
    for p, rank in enumerate(self.ranks):
      j = seen.get(rank, 0)
      seen[rank] = j + 1
      block = parts[members.index(rank)][j].to(out.device)
      if accumulate:
        out[self.slices(out.shape, p)] += block
      elif self.writes is None or self.writes[p]:
        out[self.slices(out.shape, p)] = block


class _LocalBlocks(torch.autograd.Function):
  """A replicated global array's blocks at this process's positions:
  ``apply(layout, x)`` slices ``x`` (the same on every process). The
  transpose gathers every position's cotangent, so every process receives
  the whole array's: a global array's gradient is replicated as the array
  is."""

  @staticmethod
  def forward(ctx, layout, x):
    ctx.layout, ctx.like = layout, x
    return tuple(x[layout.slices(x.shape, p)].clone() for p in layout.mine)

  @staticmethod
  def backward(ctx, *grads):
    layout, x = ctx.layout, ctx.like
    blocks = [torch.zeros_like(x[layout.slices(x.shape, p)]) if g is None
              else g for p, g in zip(layout.mine, grads)]
    out = torch.zeros_like(x)
    layout.place(out, blocks, accumulate=True)
    return None, out


class _Assemble(torch.autograd.Function):
  """The inverse of :class:`_LocalBlocks`: ``apply(layout, shape,
  *blocks)`` gathers this process's blocks into the replicated global
  array; the transpose keeps this process's blocks of the cotangent (the
  same on every process)."""

  @staticmethod
  def forward(ctx, layout, shape, *blocks):
    ctx.layout = layout
    out = torch.empty(shape, dtype=blocks[0].dtype, device=blocks[0].device)
    layout.place(out, blocks)
    return out

  @staticmethod
  def backward(ctx, grad):
    layout = ctx.layout
    blocks = [grad[layout.slices(grad.shape, p)] for p in layout.mine]
    return (None, None, *(
        b.clone() if layout.writes is None or layout.writes[p]
        else torch.zeros_like(b) for p, b in zip(layout.mine, blocks)))


def local_blocks(x, layout: BlockLayout) -> list:
  """This process's blocks of the replicated global array ``x`` (a tensor
  or a Complex, by its components), differentiable (see
  :class:`_LocalBlocks`)."""
  if isinstance(x, Complex):
    return [Complex(r, i) for r, i in zip(local_blocks(x.real, layout),
                                          local_blocks(x.imag, layout))]
  return list(_LocalBlocks.apply(layout, x))


def assemble_blocks(blocks: Sequence, layout: BlockLayout, shape):
  """The replicated global array of ``shape`` from this process's
  ``blocks`` (tensors or Complex values), differentiable (see
  :class:`_Assemble`)."""
  if isinstance(blocks[0], Complex):
    return Complex(assemble_blocks([b.real for b in blocks], layout, shape),
                   assemble_blocks([b.imag for b in blocks], layout, shape))
  return _Assemble.apply(layout, tuple(shape), *blocks)
