"""The port's checkpoints: parameters and resumable training states.

Counterpart of the JAX package's ``cadence_gemma_tpu/checkpoint/io.py``
(``save_parameters`` / ``load_parameters``, ``save_train_state`` /
``load_train_state``, ``AsyncTrainStateSaver``). Orbax is not part of the
port, so the format is its own: one ``torch.save`` file a checkpoint,
``{"format", "params", ...}`` with the port's state dicts (dotted names,
PyTorch layouts, every leaf in its own dtype: bf16, float32, int8), read
back with ``torch.load(weights_only=True)``, so loading runs no pickled
code.

A checkpoint is written under a temporary name beside its path and renamed
onto it once complete (``os.replace``, as orbax commits a finished
directory): a save that fails leaves the checkpoint that was there intact,
and a reader never sees half a file.

A train state holds what a resume needs to continue as an uninterrupted run
would: the parameters (the combined tree of a LoRA run), the optimizer's
state (Adam / AdamW moments and step counts), and whatever else the caller
puts in ``opt_state`` (``train_loop`` adds the gradient-accumulation buffers,
the micro-step and the count of consecutive non-finite steps).

:class:`AsyncTrainStateSaver` writes on a thread. The optimizer updates
parameters in place, where JAX's arrays are immutable, so ``save`` first
clones the state on the current stream, where the next step's update is
ordered after the clones: on the card that costs a copy at device memory
speed and the state's size in device memory until the thread has copied
the clones to the host and let them go. The thread copies through a small
pinned buffer on a side stream of its own: a copy into pageable memory
from another thread slows the training thread's kernel launches while it
runs, and pinning the whole state would hold the step (``PERF.md``
records both on an H100).

One process a card (a ``torch.distributed`` group of several processes,
the default group unless the caller names the training's own):
:func:`save_train_state` and the async saver write from the group's
process 0 alone, every process of the group then waiting at a barrier
until the file has landed (for the async saver, when it next waits: the
next save, :meth:`wait` or the end of its ``with`` block), so a later
``resume_from`` on any process reads the whole file. :func:`load_parameters` and :func:`load_train_state` read on
every process.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Mapping

import torch
from torch import distributed as dist

from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.parallel import sharding as sharding_lib

FORMAT = "cadence_gemma_tpu_torch/1"

# The pinned buffer the async saver's thread copies device tensors through.
_STAGE_BYTES = 16 << 20


def _several(group) -> bool:
  """Whether ``group`` (``None``: the default group) holds several
  processes."""
  return (dist.is_available() and dist.is_initialized()
          and dist.get_world_size(group) > 1)


def _writes(group) -> bool:
  """Whether this process writes ``group``'s checkpoints: its process 0."""
  return not _several(group) or dist.get_rank(group) == 0


def _detached(tree):
  """``tree`` (dicts, lists, tuples) with each tensor detached."""
  return _map_tensors(lambda t: t.detach(), tree)


def _tensors(tree) -> list[torch.Tensor]:
  found = []
  _map_tensors(found.append, tree)
  return found


def _map_tensors(fn, tree):
  if isinstance(tree, torch.Tensor):
    return fn(tree)
  if isinstance(tree, Mapping):
    return {k: _map_tensors(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map_tensors(fn, v) for v in tree)
  return tree


def _write(obj: dict, path: str) -> None:
  """``torch.save(obj)`` to a temporary file beside ``path``, then renamed
  onto it; on failure the temporary file goes and ``path`` is untouched."""
  directory = os.path.dirname(os.path.abspath(path))
  os.makedirs(directory, exist_ok=True)
  tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
  try:
    with open(tmp, "wb") as f:
      torch.save(obj, f)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, path)
  except BaseException:
    with contextlib.suppress(FileNotFoundError):
      os.remove(tmp)
    raise


def _to_host(t: torch.Tensor, stage: torch.Tensor,
             side: torch.cuda.Stream) -> torch.Tensor:
  """A host copy of the device tensor ``t``, through the pinned ``stage``
  on the ``side`` stream."""
  out = torch.empty(t.shape, dtype=t.dtype)
  src = t.contiguous().reshape(-1).view(torch.uint8)
  dst = out.reshape(-1).view(torch.uint8)
  for start in range(0, src.numel(), stage.numel()):
    n = min(stage.numel(), src.numel() - start)
    with torch.cuda.stream(side):
      stage[:n].copy_(src[start:start + n], non_blocking=True)
    side.synchronize()
    dst[start:start + n].copy_(stage[:n])
  return out


def _read(path: str, device) -> dict:
  device = griffin.resolve_device(device)
  # A CPU load maps the file and reads a tensor's bytes when it is used.
  state = torch.load(path, map_location=device, weights_only=True,
                     mmap=device.type == "cpu")
  if not isinstance(state, dict) or state.get("format") != FORMAT:
    raise ValueError(f"{path} is not a checkpoint of this package (format "
                     f"{FORMAT!r}).")
  return state


def save_parameters(checkpoint_path: str,
                    params: Mapping[str, torch.Tensor]) -> None:
  """Saves a state dict (e.g. ``model.state_dict()``, or the adapters of
  ``training.lora.split_lora``) as a parameters checkpoint (JAX
  ``io.py:21``)."""
  _write({"format": FORMAT, "params": _detached(dict(params))},
         checkpoint_path)


def load_parameters(checkpoint_path: str, device=None,
                    sharding: Any = "single_device") -> dict:
  """Restores a :func:`save_parameters` checkpoint with the requested
  placement (JAX ``io.py:32-72``).

  Args:
    checkpoint_path: The checkpoint file.
    device: Where a ``"single_device"`` or ``"replicated"`` state dict
      lives; ``None`` means CUDA, and raises without a card.
    sharding: ``"single_device"``; ``"replicated"``, every leaf whole (a
      single controller holds the one copy every device of a mesh reads:
      in place on its own device, by a copy on another); or a tree of
      ``NamedSharding``s matching the checkpoint's names, e.g.
      ``partitioning.griffin_param_shardings``: the leaves are read from
      the file and placed by it, along the one mesh axis its specs split
      over (``sharding.tree_axis``).

  Returns:
    The state dict, or for a sharding tree ``{name: [piece per device along
    that axis]}`` (``sharding.place_state_dict``), which
    ``parallel.tensor_parallel.TensorParallelGriffin`` takes.
  """
  if isinstance(sharding, str):
    if sharding not in ("single_device", "replicated"):
      raise ValueError(f"Unknown sharding mode {sharding!r}.")
    return _read(checkpoint_path, device)["params"]
  params = _read(checkpoint_path, "cpu")["params"]
  return sharding_lib.place_state_dict(params, sharding)


def save_train_state(checkpoint_path: str, params: Mapping[str, torch.Tensor],
                     opt_state: Any, step: int, group: Any = None) -> None:
  """Saves a resumable training state: ``params`` (a state dict),
  ``opt_state`` (any tree of dicts, lists and tensors, e.g. an optimizer's
  ``state_dict()``) and ``step`` (JAX ``io.py:112``). One process of
  several (of ``group``, default the default group): its process 0
  writes, then every process of it waits at a barrier."""
  if _writes(group):
    _write({"format": FORMAT, "params": _detached(dict(params)),
            "opt_state": _detached(opt_state), "step": int(step)},
           checkpoint_path)
  if _several(group):
    dist.barrier(group=group)


def load_train_state(checkpoint_path: str, device=None
                     ) -> tuple[dict[str, torch.Tensor], Any, int]:
  """Restores ``(params, opt_state, step)`` saved by
  :func:`save_train_state` on ``device`` (JAX ``io.py:139``). Load them
  into a fresh model and optimizer with ``load_state_dict``, which copies
  in place and keeps the optimizer's references to the parameters."""
  state = _read(checkpoint_path, device)
  return state["params"], state["opt_state"], state["step"]


class AsyncTrainStateSaver:
  """Train-state saves on a background thread (JAX ``io.py:75``).

  :meth:`save` waits only for the previous write, snapshots the state (see
  the module docstring) and returns; the thread copies the snapshot to the
  host and writes the file, renaming it into place. :meth:`wait`, or
  leaving the ``with`` block, waits for the last write and re-raises its
  error, if any. One process of several (of ``group``, default the
  default group): its process 0 alone snapshots and writes, and every
  :meth:`wait` ends at a barrier of the group (every process calls
  :meth:`save` at the same steps).
  """

  def __init__(self, group: Any = None):
    self._thread: threading.Thread | None = None
    self._error: BaseException | None = None
    self._group = group

  def save(self, checkpoint_path: str, params: Mapping[str, torch.Tensor],
           opt_state: Any, step: int) -> None:
    self.wait()
    if not _writes(self._group):
      return
    # Clones on the current stream: the next update cannot reach them.
    snapshot = [_map_tensors(torch.clone,
                             _detached((dict(params), opt_state)))]
    cuda = {t.device for t in _tensors(snapshot) if t.device.type == "cuda"}
    events = {device: torch.cuda.current_stream(device).record_event()
              for device in cuda}

    def write():
      try:
        host = snapshot.pop()  # the clones go as soon as they are copied
        for device, event in events.items():
          side = torch.cuda.Stream(device)
          side.wait_event(event)
          stage = torch.empty(_STAGE_BYTES, dtype=torch.uint8,
                              pin_memory=True)
          host = _map_tensors(
              lambda t, d=device, s=side: (_to_host(t, stage, s)
                                           if t.device == d else t), host)
        _write({"format": FORMAT, "params": host[0], "opt_state": host[1],
                "step": int(step)}, checkpoint_path)
      except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
        self._error = e

    self._thread = threading.Thread(target=write, daemon=True,
                                    name="cadence-checkpoint-writer")
    self._thread.start()

  def wait(self) -> None:
    """Blocks until the last save is on disk (on every process: a
    barrier); re-raises its error."""
    if self._thread is not None:
      self._thread.join()
      self._thread = None
    if _several(self._group):
      dist.barrier(group=self._group)
    if self._error is not None:
      error, self._error = self._error, None
      raise error

  def __enter__(self) -> "AsyncTrainStateSaver":
    return self

  def __exit__(self, *exc_info) -> bool:
    self.wait()
    return False
