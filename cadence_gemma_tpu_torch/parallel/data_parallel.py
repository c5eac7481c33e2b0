"""DP x TP training replicas of a Griffin over a ``(data, ..., model)`` mesh.

JAX trains over a mesh with one ``jit``: the parameters take the Megatron
layouts (``partitioning.griffin_param_shardings``), the batch splits over
``data`` and GSPMD inserts the gradient all-reduces. The port has no GSPMD,
so :class:`ShardedGriffin` writes the same program out, single-controller
as tensor-parallel serving is (``parallel/tensor_parallel.py``):

  * each position of the ``data`` axis holds a :class:`TensorParallelGriffin`
    over its row of the mesh (its ``model``-axis devices at index 0 of every
    other axis: the ``sequence`` axis of a ``(data, sequence, model)`` mesh
    shards nothing, as in JAX), built over the placed pieces of one state
    dict. A bf16 piece on that state's device is a view, so the rows of a
    mesh that repeats one card share their weights;
  * :meth:`split` gives each row its slice of the batch;
  * :meth:`reduce_gradients` sums each row's shards' gradients of a
    replicated leaf into the leaf's one trained tensor, then each trained
    tensor's gradients over the rows through :func:`sharding.psum` onto row
    0, whose pieces the optimizer updates;
  * :meth:`refresh` copies the updated pieces to wherever a copy of them
    lives that is not a view: the state dict's tensors (so the model the
    state came from holds the trained weights), the other rows, the aliases.

One process a card: over a mesh whose ``data`` axis spans processes
(``multihost.make_hybrid_mesh(..., dcn_axis_names=("data",))``) each
process builds and holds only the rows whose devices are its own and takes
their slices of the global batch (every process reads the whole batch, as
a multi-process JAX ``jit`` sees it); :meth:`all_reduce_gradients` then
all-reduces each trained tensor's gradient over the data axis's process
group, so every process holds the summed gradient and updates its own
replica, and the replicas stay identical (as DDP's and JAX's replicated
parameters do). :meth:`refresh` copies within a process only. A ``model``
axis (or any other) that crosses processes is refused
(``sharding.PROCESS_PER_CARD_ITEM``).

The trained tensors of row 0 partition the logical tree: a split leaf's
pieces once each, a replicated leaf once. So :meth:`named_parameters` under
the leaves' own names is what an optimizer is built over, the clip's global
norm is the logical tree's and the optimizer's state equals the unsharded
one's. :meth:`optimizer_state` and :meth:`load_optimizer_state` move that
state as whole leaves by name, as JAX's checkpoint holds it.
"""

from __future__ import annotations

from typing import Callable, Iterator, Mapping

import numpy as np
import torch

from cadence_gemma_tpu_torch.models import griffin as griffin_lib
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel


def _row_positions(mesh: sharding.Mesh, batch_axis: str, row: int,
                   model_axis: str | None) -> list[tuple[int, ...]]:
  """The mesh indices of data position ``row``: its ``model_axis``
  positions (one where the mesh has no such axis), at index 0 of every
  other axis."""
  names = mesh.axis_names
  index = [0] * len(names)
  index[names.index(batch_axis)] = row
  if model_axis not in names:
    return [tuple(index)]
  return mesh.line(model_axis, index)


class ShardedGriffin:
  """A Griffin's weights placed over a mesh for DP x TP training.

  Args:
    model: The ``Griffin`` the weights belong to (its config and flags).
    state: The state dict to place, ``model.state_dict()`` (its tensors are
      views of the model's parameters, so an update reaches the model).
    mesh: The mesh; ``batch_axis`` must name one of its axes.
    shardings: ``{name: NamedSharding}`` over ``mesh``
      (``partitioning.param_shardings_or_replicated``); ``None`` replicates
      every leaf.
    batch_axis: The mesh axis the batch splits over.
    model_axis: The mesh axis the weights split over (``None`` or an axis
      the mesh lacks: none).
    trains: Whether the leaf of a name trains. int8 twins never do.
  """

  def __init__(self, model: griffin_lib.Griffin,
               state: Mapping[str, torch.Tensor], mesh: sharding.Mesh,
               shardings: Mapping[str, sharding.NamedSharding] | None,
               batch_axis: str = partitioning.BATCH_AXIS,
               model_axis: str | None = partitioning.MODEL_AXIS,
               trains: Callable[[str], bool] = lambda name: True):
    if batch_axis not in mesh.axis_names:
      raise ValueError(f"The mesh {mesh} has no batch axis {batch_axis!r}.")
    tensor_parallel.check_shardable(model)
    if set(state) != set(model.state_dict()):
      raise ValueError("The state dict's names are not the model's.")
    for name in mesh.axis_names:
      if name != batch_axis and mesh.axis_spans_processes(name):
        raise NotImplementedError(
            f"Mesh axis {name!r} crosses processes: tensor parallelism (or "
            f"any axis but the data axis) across processes needs "
            f"{sharding.PROCESS_PER_CARD_ITEM}.")
    self.state = dict(state)
    self.batch_axis = batch_axis
    self.num_rows = mesh.shape[batch_axis]
    axis = (model_axis if model_axis in mesh.axis_names
            else partitioning.MODEL_AXIS)
    self.axis = axis
    specs = {name: (sharding.PartitionSpec() if shardings is None
                    else shardings[name].spec) for name in self.state}
    copies: dict = {}
    self.rows: list[tensor_parallel.TensorParallelGriffin] = []
    # This process's data positions, and for each model position the data
    # axis's line through it: the gradient all-reduce's domain.
    self.row_ids: list[int] = []
    self.data_domains: list[sharding.Domain] | None = None
    # The group of every process of the mesh (checkpoints, preemption).
    self.process_group = None
    if mesh.ranks is not None:
      self.process_group = mesh.group(mesh.ranks.flat)
      self.data_domains = [
          mesh.domain(mesh.line(batch_axis, pos))
          for pos in _row_positions(mesh, batch_axis, 0, model_axis)]
    for row in range(self.num_rows):
      positions = _row_positions(mesh, batch_axis, row, model_axis)
      if not mesh.is_local(positions[0]):
        continue
      self.row_ids.append(row)
      devices = [mesh.devices[p] for p in positions]
      flat = np.empty(len(devices), dtype=object)
      flat[:] = devices
      row_mesh = sharding.Mesh(flat, (axis,))
      placed = sharding.place_state_dict(
          self.state, {name: sharding.NamedSharding(row_mesh, spec)
                       for name, spec in specs.items()}, axis)
      self.rows.append(tensor_parallel.TensorParallelGriffin(
          model.config, placed, row_mesh, axis,
          kernel_copies=copies, **tensor_parallel.model_flags(model)))
    self.trains = {name: trains(name) and not name.endswith(("_q", "_scale"))
                   and self.state[name].is_floating_point()
                   for name in self.state}
    for tp in self.rows:
      for name, pieces in tp.leaves.items():
        for piece in pieces:
          piece.tensor.requires_grad_(self.trains[name])
      for alias in tp.aliases:
        alias.tensor.requires_grad_(self.trains[alias.name])

  @property
  def device(self) -> torch.device:
    """The first device of row 0: where the loss is gathered."""
    return self.rows[0].device

  def named_parameters(self) -> Iterator[tuple[str, torch.Tensor]]:
    """Row 0's trained tensors under their leaves' names (a split leaf's
    pieces share its name), in the state dict's order: what an optimizer
    is built over (``trainer.make_optimizer(self, ...)`` applies the decay
    mask by name)."""
    for name, pieces in self.rows[0].leaves.items():
      for piece in pieces:
        yield name, piece.tensor

  def parameters(self) -> Iterator[torch.Tensor]:
    return (t for _, t in self.named_parameters())

  def zero_grad(self, set_to_none: bool = True) -> None:
    del set_to_none
    for tp in self.rows:
      for t in tp.train_tensors():
        t.grad = None

  def split(self, x: torch.Tensor | None) -> list[torch.Tensor | None]:
    """``x``'s batch split over the data axis, each slice on its row's first
    device (``partitioning.data_sharding``); raises ``ValueError`` where the
    batch does not divide, as JAX's sharded step does."""
    n = self.num_rows
    if x is None:
      return [None] * len(self.rows)
    if x.shape[0] % n:
      raise ValueError(
          f"The batch of {x.shape[0]} rows does not divide into the {n} "
          f"positions of mesh axis {self.batch_axis!r}.")
    chunks = x.chunk(n, 0)
    return [chunks[row].to(tp.device)
            for row, tp in zip(self.row_ids, self.rows)]

  @property
  def spans_processes(self) -> bool:
    """Whether the mesh is over a process group (its data axis all-reduces
    through it)."""
    return self.data_domains is not None

  def sum_rows(self, values: list[torch.Tensor]) -> torch.Tensor:
    """The sum of one value a data row (this process's rows' values, in
    row order) over every row of the mesh, on :attr:`device`: summed here
    and, where the data axis crosses processes, all-reduced over its group
    (each row counted once, whatever rows a process holds)."""
    if self.data_domains is None:
      return sharding.psum(values, [self.device])[0]
    return sharding.psum([v.to(self.device) for v in values],
                         self.data_domains[0])[0]

  def reduce_gradients(self) -> None:
    """Sums the gradients this process's rows accumulated: each row's
    aliases into its trained tensors, then each trained tensor over the
    rows onto row 0 (``sharding.psum``, the data axis's all-reduce); the
    other rows' gradients are cleared. Where the data axis crosses
    processes, :meth:`all_reduce_gradients` then sums row 0's over them."""
    for tp in self.rows:
      tp.sum_replicated_grads()
    if len(self.rows) == 1:
      return
    for name, pieces in self.rows[0].leaves.items():
      for i, piece in enumerate(pieces):
        tensors = [tp.leaves[name][i].tensor for tp in self.rows]
        total = sharding.psum([t.grad for t in tensors],
                              [t.device for t in tensors])[0]
        for t in tensors[1:]:
          t.grad = None
        piece.tensor.grad = total

  def all_reduce_gradients(self) -> None:
    """Sums row 0's gradients (after :meth:`reduce_gradients`) in place over
    the data axis's processes, so every process holds the whole batch's
    gradient; nothing to do in one process."""
    if self.data_domains is None:
      return
    for name, pieces in self.rows[0].leaves.items():
      if not self.trains[name]:
        continue
      for domain, piece in zip(self.data_domains, pieces):
        # A leaf the batch never reaches (the connector of a text batch)
        # has no gradient on any process: every process skips it alike.
        if piece.tensor.grad is not None:
          sharding.psum_(piece.tensor.grad, domain)

  def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
    """Sums ``tensor``, one value a process on :attr:`device` (a whole leaf
    of :meth:`gradients`), in place over the data axis's processes; returns
    it (unchanged in one process)."""
    if self.data_domains is not None:
      sharding.psum_(tensor, self.data_domains[0])
    return tensor

  @torch.no_grad()
  def refresh(self) -> None:
    """Copies row 0's trained tensors to the state dict's tensors, the other
    rows and the aliases, wherever those are not views of the same memory
    (on a mesh that repeats one device, nothing is copied)."""
    for name, pieces in self.rows[0].leaves.items():
      if not self.trains[name]:
        continue
      for piece in pieces:
        tensor_parallel.copy_unless_same(
            tensor_parallel.region(self.state[name], piece), piece.tensor)
      for tp in self.rows[1:]:
        for mine, piece in zip(tp.leaves[name], pieces):
          tensor_parallel.copy_unless_same(mine.tensor, piece.tensor)
    for tp in self.rows:
      for alias in tp.aliases:
        if self.trains[alias.name]:
          tensor_parallel.copy_unless_same(
              alias.tensor,
              tensor_parallel.region(tp.leaves[alias.name][0].tensor, alias))

  def _whole(self, name: str, values: list[torch.Tensor]) -> torch.Tensor:
    """A leaf's whole value from one value a trained tensor of row 0."""
    pieces = self.rows[0].leaves[name]
    if pieces[0].dim is None:
      return values[0]
    return torch.cat([v.to(values[0].device) for v in values],
                     dim=pieces[0].dim)

  def gradients(self) -> dict[str, torch.Tensor]:
    """Row 0's gradients (after :meth:`reduce_gradients`) as whole leaves
    by name."""
    out = {}
    for name, pieces in self.rows[0].leaves.items():
      grads = [p.tensor.grad for p in pieces]
      if all(g is not None for g in grads):
        out[name] = self._whole(name, grads)
    return out

  def load_gradients(self, grads: Mapping[str, torch.Tensor]) -> None:
    """Places whole-leaf gradients on row 0's trained tensors."""
    for name, whole in grads.items():
      for piece in self.rows[0].leaves[name]:
        piece.tensor.grad = tensor_parallel.region(whole, piece).to(
            piece.tensor.device, copy=True)

  def optimizer_state(self, optimizer: torch.optim.Optimizer
                      ) -> dict[str, dict]:
    """``optimizer``'s state as whole leaves: ``{name: {key: value}}``; a
    state the shape of its parameter is the pieces' states joined, any
    other (``step``) the first piece's."""
    out = {}
    for name, pieces in self.rows[0].leaves.items():
      states = [optimizer.state.get(p.tensor) for p in pieces]
      if not states[0]:
        continue
      out[name] = {
          key: (self._whole(name, [s[key] for s in states])
                if torch.is_tensor(v) and v.shape == pieces[0].tensor.shape
                else v)
          for key, v in states[0].items()}
    return out

  def load_optimizer_state(
      self, optimizer: torch.optim.Optimizer,
      leaves: Mapping[str, Mapping[str, object]],
      shardings: Mapping[str, Mapping[str, sharding.NamedSharding]]) -> None:
    """Places whole-leaf optimizer state (:meth:`optimizer_state`) on row
    0's trained tensors by ``shardings``
    (``partitioning.opt_state_shardings``): a split leaf's pieces take their
    slices, a replicated leaf's tensor the whole, each a copy on its
    device."""
    row_mesh = self.rows[0].mesh
    for name, state in leaves.items():
      pieces = self.rows[0].leaves[name]
      placed = [dict() for _ in pieces]
      for key, value in state.items():
        if not torch.is_tensor(value) or value.shape != self.state[name].shape:
          for p in placed:
            p[key] = value.clone() if torch.is_tensor(value) else value
          continue
        spec = shardings[name][key].spec
        parts = sharding.place(value, sharding.NamedSharding(row_mesh, spec),
                               self.axis)
        if len(pieces) == 1:
          parts = parts[:1]
        if len(parts) != len(pieces):
          raise ValueError(f"{name}.{key}: {len(parts)} placed parts for "
                           f"{len(pieces)} trained pieces.")
        for p, piece, part in zip(placed, pieces, parts):
          p[key] = part.to(piece.tensor.device, copy=True)
      for piece, p in zip(pieces, placed):
        optimizer.state[piece.tensor] = p
