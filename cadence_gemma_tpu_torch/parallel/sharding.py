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
``H_j = P_j(last) * H_{j-1} + S_j(last)``, ``H_{-1} = h0``. The same holds
over the complex numbers: the sharding functions and the collectives carry
a :class:`complex_lib.Complex` by its components, and the correction uses
its product.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from cadence_gemma_tpu_torch import complex_lib

Complex = complex_lib.Complex

# Canonical mesh axis names (``sharding.py:47-49``).
BATCH_AXIS = "data"
SEQUENCE_AXIS = "sequence"
MODEL_AXIS = "model"

# The ROADMAP item that lifts what tensor parallelism still refuses.
PROCESS_PER_CARD_ITEM = ("ROADMAP queue 1 item 14g (the process-per-card "
                         "backend)")

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


def cuda_devices() -> list[torch.device]:
  """The CUDA devices of this process; raises when there is none."""
  if not torch.cuda.is_available():
    raise RuntimeError(
        "No CUDA device is available. make_mesh uses the cards by "
        "default; pass devices=['cpu'] * n to run on the CPU."
    )
  return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


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


def _componentwise(fn, x, *args):
  """``fn`` over the components of a Complex ``x``, its nested-list result
  zipped back into Complex values; ``fn(x, *args)`` for a real tensor."""
  if not isinstance(x, Complex):
    return fn(x, *args)
  real, imag = fn(x.real, *args), fn(x.imag, *args)
  return [[Complex(r, i) for r, i in zip(row_r, row_i)]
          for row_r, row_i in zip(real, imag)]


def shard_activations(
    x: torch.Tensor | Complex, spec: ShardingSpec
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
    return _componentwise(shard_activations, x, spec)
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
    h: torch.Tensor | Complex, spec: ShardingSpec
) -> list[list[torch.Tensor]]:
  """Splits ``[b, ...]`` over the batch axis and gives every sequence shard
  its batch chunk (replicated along the sequence axis), on its device."""
  if isinstance(h, Complex):
    return _componentwise(shard_state, h, spec)
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


def all_gather(values: Sequence[Any], devices: Sequence[torch.device]
               ) -> list[list[Any]]:
  """Shard ``j`` receives every shard's value (tensors or tuples of them) on
  ``devices[j]``: ``jax.lax.all_gather`` over one scan domain. Positions on
  one device share one list."""
  return _per_device(lambda dev: [_to(v, dev) for v in values], devices)


def all_gather_features(values: Sequence[torch.Tensor],
                        devices: Sequence[torch.device]
                        ) -> list[torch.Tensor]:
  """Shard ``j`` receives every shard's value concatenated along the last
  dimension on ``devices[j]`` (``jax.lax.all_gather(..., tiled=True)``),
  computed once a distinct device: the tensor-parallel forward gathers a
  feature-sharded activation with it where a replicated weight contracts all
  of it."""
  return _per_device(
      lambda dev: torch.cat([v.to(dev) for v in values], dim=-1), devices)


def psum(values: Sequence[torch.Tensor | None],
         devices: Sequence[torch.device]) -> list[torch.Tensor | None]:
  """Shard ``j`` receives the sum of every shard's value, in shard order, on
  ``devices[j]`` (``jax.lax.psum`` over one scan domain). ``None`` counts as
  zero; if every value is ``None`` every shard receives ``None``. The sum is
  computed once a distinct device, and positions on one device share it."""
  present = [v for v in values if v is not None]

  def total_on(dev):
    total = None
    for v in present:
      total = v.to(dev) if total is None else total + v.to(dev)
    return total

  return _per_device(total_on, devices)


def ppermute(values: Sequence[torch.Tensor | None],
             devices: Sequence[torch.device],
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor | None]:
  """Shard ``dst`` receives ``values[src]`` on ``devices[dst]`` for each
  ``(src, dst)`` of ``perm``, and zeros where no source sends
  (``jax.lax.ppermute``). ``None`` marks a position that holds nothing (a
  pipeline's bubble): it sends ``None``, and receives ``None`` where no
  source sends."""
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
