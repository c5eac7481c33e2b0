"""Multi-process start-up and DCN x ICI meshes.

Counterpart of the JAX package's ``cadence_gemma_tpu/parallel/multihost.py``
with its names, signatures, axis order and errors:

  * :func:`initialize` starts ``torch.distributed`` where JAX starts
    ``jax.distributed``: guarded, idempotent and a no-op for one process;
  * :func:`make_hybrid_mesh` builds a mesh whose leading axes span the
    processes (DCN, between hosts) and whose trailing axes span one
    process's devices (ICI), collapsing the DCN axes to 1 in one process;
  * :func:`dp_over_dcn_mesh` is the pod preset
    ``(dcn=processes) x (data, sequence, model)``.

Over several processes (one a card, started by ``torchrun`` or by
:func:`initialize` with explicit arguments) the mesh functions lay the
processes out as JAX's ``create_hybrid_device_mesh(process_is_granule=True)``
does: process ``p`` at the ``p``-th position of the DCN axes (row-major),
its own devices over the ICI axes, so no ICI slice crosses a process. Each
process passes its own devices; the mesh learns the others' through
``dist.all_gather_object`` and builds its axes' process groups
(:meth:`sharding.Mesh.build_groups`), so every process must build the same
meshes in the same order.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch
from torch import distributed as dist

from cadence_gemma_tpu_torch.parallel import sharding


def process_count() -> int:
  """The process group's size, 1 without one."""
  if dist.is_available() and dist.is_initialized():
    return dist.get_world_size()
  return 1


def _launched_multi_process() -> bool:
  """Whether a launcher (torchrun) started several processes."""
  return (int(os.environ.get("WORLD_SIZE", "1")) > 1
          and bool(os.environ.get("MASTER_ADDR")))


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> int:
  """Starts ``torch.distributed`` when running multi-process.

  Safe to call unconditionally at program start:
    * if the process group is already initialized, it is a no-op;
    * with no arguments and no multi-process environment (torchrun's
      ``WORLD_SIZE`` > 1 with ``MASTER_ADDR``), it is a no-op: one process
      needs no group;
    * otherwise it calls ``dist.init_process_group`` at
      ``coordinator_address`` (``host:port`` or a URL such as
      ``tcp://host:port``; ``None`` reads torchrun's environment) with
      ``num_processes`` and ``process_id`` (``None``: from the
      environment).

  ``backend`` is ``nccl`` unless the caller names another (``"gloo"`` on
  the CPU, or for several processes on one card); nothing switches it. On
  a machine with cards the process takes its own card
  (``sharding.cuda_devices``) before the group starts, so no allocation
  lands on another process's card. Returns the process count after
  initialization (1 for one process).
  """
  if dist.is_available() and dist.is_initialized():
    return dist.get_world_size()
  if coordinator_address is None and not _launched_multi_process():
    return 1
  if coordinator_address is None:
    init_method = "env://"
  elif "://" in coordinator_address:
    init_method = coordinator_address
  else:
    init_method = f"tcp://{coordinator_address}"
  if torch.cuda.is_available():
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    local = int(os.environ.get("LOCAL_RANK", rank))
    torch.cuda.set_device(local % torch.cuda.device_count())
  dist.init_process_group(
      backend=backend or "nccl", init_method=init_method,
      world_size=-1 if num_processes is None else num_processes,
      rank=-1 if process_id is None else process_id)
  return dist.get_world_size()


def make_hybrid_mesh(
    ici_axis_shapes: Sequence[int],
    ici_axis_names: Sequence[str],
    dcn_axis_shapes: Sequence[int] | None = None,
    dcn_axis_names: Sequence[str] = ("dcn",),
    devices: Sequence[Any] | None = None,
) -> sharding.Mesh:
  """A mesh with DCN-spanning leading axes and ICI-spanning trailing axes.

  Args:
    ici_axis_shapes / ici_axis_names: The per-process mesh.
    dcn_axis_shapes: Sizes of the cross-process axes (their product must
      equal the process count). None = ``(process_count,)``.
    dcn_axis_names: Names for the cross-process axes.
    devices: This process's devices (``torch.device``s or names, a device
      may repeat); None means its cards (its own card, one process of
      several), and raises without one, as :func:`sharding.make_mesh` does.

  Returns:
    A :class:`sharding.Mesh` with axes ``(*dcn_axis_names,
    *ici_axis_names)``; one process collapses the DCN axes to size 1. Over
    several processes (or under a process group of one) the mesh holds
    each position's process (``ranks``) and the process groups of its axes,
    and data-parallel training reduces its gradients through them.
  """
  n_proc = process_count()
  devices = list(sharding.cuda_devices() if devices is None else devices)
  if dcn_axis_shapes is None:
    dcn_axis_shapes = (n_proc,)
  if len(dcn_axis_shapes) != len(dcn_axis_names):
    raise ValueError(
        f"dcn shapes {dcn_axis_shapes} / names {dcn_axis_names} mismatch.")
  dcn_total = int(np.prod(dcn_axis_shapes))
  ici_total = int(np.prod(ici_axis_shapes))
  if dcn_total != n_proc:
    raise ValueError(
        f"DCN axes {tuple(dcn_axis_shapes)} must multiply to the process "
        f"count {n_proc}.")
  shape = tuple(dcn_axis_shapes) + tuple(ici_axis_shapes)
  names = tuple(dcn_axis_names) + tuple(ici_axis_names)
  if n_proc == 1 and not (dist.is_available() and dist.is_initialized()):
    if dcn_total * ici_total != len(devices):
      raise ValueError(
          f"Mesh {tuple(dcn_axis_shapes)} x {tuple(ici_axis_shapes)} needs "
          f"{dcn_total * ici_total} devices, have {len(devices)}.")
    return sharding.make_mesh(shape, names, devices)
  every: list[Any] = [None] * n_proc
  dist.all_gather_object(every, [str(torch.device(d)) for d in devices])
  total = sum(len(names_p) for names_p in every)
  if dcn_total * ici_total != total or any(
      len(names_p) != ici_total for names_p in every):
    raise ValueError(
        f"Mesh {tuple(dcn_axis_shapes)} x {tuple(ici_axis_shapes)} needs "
        f"{dcn_total * ici_total} devices, have {total}.")
  flat = np.empty(total, dtype=object)
  flat[:] = [torch.device(d) for names_p in every for d in names_p]
  ranks = np.repeat(np.arange(n_proc), ici_total)
  return sharding.Mesh(flat.reshape(shape), names,
                       ranks.reshape(shape)).build_groups()


def dp_over_dcn_mesh(
    data: int = 1,
    sequence: int = 1,
    model: int = 1,
    devices: Sequence[Any] | None = None,
) -> sharding.Mesh:
  """The pod preset: DP across processes, (data, sequence, model) within.

  ``data * sequence * model`` must equal the per-process device count; the
  cross-process axis is named ``dcn`` and carries only batch sharding.
  ``train_loop(mesh=)`` splits the batch over one axis named ``data``: for
  data parallelism across processes, name the DCN axis so
  (``make_hybrid_mesh((1,), ("model",), dcn_axis_names=("data",))``).
  """
  return make_hybrid_mesh(
      (data, sequence, model), ("data", "sequence", "model"),
      devices=devices)
