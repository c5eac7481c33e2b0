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
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Mapping

import torch

from cadence_gemma_tpu_torch.models import griffin

FORMAT = "cadence_gemma_tpu_torch/1"

# The pinned buffer the async saver's thread copies device tensors through.
_STAGE_BYTES = 16 << 20


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
                    sharding: Any = "single_device") -> dict[str, torch.Tensor]:
  """Restores a :func:`save_parameters` checkpoint's state dict on
  ``device`` (JAX ``io.py:32``; ``None`` means CUDA, and raises without a
  card). ``sharding`` other than ``"single_device"`` (a replicated or a
  sharded placement) is tensor parallelism, which is not ported."""
  if not (isinstance(sharding, str) and sharding == "single_device"):
    raise NotImplementedError(
        f"load_parameters(sharding={sharding!r}): placements over a mesh are "
        "the DP/TP regime, not ported yet (ROADMAP queue 1 item 14c).")
  return _read(checkpoint_path, device)["params"]


def save_train_state(checkpoint_path: str, params: Mapping[str, torch.Tensor],
                     opt_state: Any, step: int) -> None:
  """Saves a resumable training state: ``params`` (a state dict),
  ``opt_state`` (any tree of dicts, lists and tensors, e.g. an optimizer's
  ``state_dict()``) and ``step`` (JAX ``io.py:112``)."""
  _write({"format": FORMAT, "params": _detached(dict(params)),
          "opt_state": _detached(opt_state), "step": int(step)},
         checkpoint_path)


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
  error, if any.
  """

  def __init__(self):
    self._thread: threading.Thread | None = None
    self._error: BaseException | None = None

  def save(self, checkpoint_path: str, params: Mapping[str, torch.Tensor],
           opt_state: Any, step: int) -> None:
    self.wait()
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
        save_train_state(checkpoint_path, *host, step)
      except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
        self._error = e

    self._thread = threading.Thread(target=write, daemon=True,
                                    name="cadence-checkpoint-writer")
    self._thread.start()

  def wait(self) -> None:
    """Blocks until the last save is on disk; re-raises its error."""
    if self._thread is not None:
      self._thread.join()
      self._thread = None
    if self._error is not None:
      error, self._error = self._error, None
      raise error

  def __enter__(self) -> "AsyncTrainStateSaver":
    return self

  def __exit__(self, *exc_info) -> bool:
    self.wait()
    return False
