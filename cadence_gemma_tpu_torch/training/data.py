"""SFT data: batches of token ids, loss masks and images from chat JSON.

Counterpart of the JAX package's ``cadence_gemma_tpu/training/data.py``
(``TrainingInput``, ``DatasetBuilder``, ``apply_it_template``). A record of
the LLaVA form::

    {"image": "...jpg",
     "conversations": [{"from": "human", "value": "..."},
                       {"from": "gpt", "value": "..."}, ...]}

becomes one example: the human turns are prompt (masked out of the loss),
the gpt turns are targets, everything is wrapped in the Gemma chat template
and truncated or right-padded to ``max_seq_len``. A batch whose records all
name an image carries their paths (under ``image_root``), and with
``load_pixels`` their pixels, decoded on the host by
:mod:`cadence_gemma_tpu_torch.utils.image_cpp`; the vision towers encode
them on the card inside the training loop. Pure Python and numpy (the
decoder is native C++, or PIL), but for :func:`prefetch_to_device`, which
moves batches to the device on a thread of its own.
"""

from __future__ import annotations

import dataclasses
import json
import queue as queue_lib
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import griffin


@dataclasses.dataclass
class TrainingInput:
  """One batch: token ids, loss mask, and (optionally) its images."""

  input_tokens: np.ndarray          # [b, t] int32
  target_mask: np.ndarray           # [b, t] bool
  image_paths: list[str] | None = None
  pixels: np.ndarray | None = None  # [b, 3, h, w] float32 in [0, 1]


@dataclasses.dataclass
class DatasetBuilder:
  """Streams batched, tokenized examples from chat-style JSON files.

  Attributes:
    vocab: Tokenizer implementing the ``Vocabulary`` protocol.
    json_path: Path to the JSON list of conversation records.
    image_root: Directory prefix for the records' image paths.
    max_seq_len: Examples are truncated / right-padded to this length.
    batch_size: Examples per batch.
    load_pixels: Decode a batch's images to [b, 3, 384, 384] float32
      pixels; otherwise only their paths are carried.
  """

  vocab: Any
  json_path: str
  image_root: str = ""
  max_seq_len: int = 1024
  batch_size: int = 1
  load_pixels: bool = False

  def __post_init__(self):
    with open(self.json_path) as f:
      self._records = json.load(f)

  def __len__(self) -> int:
    return len(self._records)

  def _encode_record(
      self, record: dict[str, Any]
  ) -> tuple[np.ndarray, np.ndarray]:
    """Tokenizes one conversation; mask is True on answer tokens only."""
    ids: list[int] = [self.vocab.bos_id()]
    mask: list[bool] = [False]
    for turn in record.get("conversations", []):
      text = turn.get("value", "").replace("<image>", "").strip()
      is_answer = turn.get("from") == "gpt"
      if is_answer:
        piece = f"{text}<end_of_turn>\n"
      else:
        piece = (
            f"<start_of_turn>user\n{text}<end_of_turn>\n"
            "<start_of_turn>model\n"
        )
      turn_ids = self.vocab.EncodeAsIds(piece)
      ids.extend(turn_ids)
      mask.extend([is_answer] * len(turn_ids))
    ids.append(self.vocab.eos_id())
    mask.append(True)

    ids = ids[: self.max_seq_len]
    mask = mask[: self.max_seq_len]
    pad = self.max_seq_len - len(ids)
    tokens = np.asarray(ids + [self.vocab.pad_id()] * pad, np.int32)
    target = np.asarray(mask + [False] * pad, bool)
    return tokens, target

  def _image_path(self, record: dict[str, Any]) -> str | None:
    name = record.get("image")
    if not name:
      return None
    return f"{self.image_root}/{name}" if self.image_root else name

  def __iter__(self) -> Iterator[TrainingInput]:
    return self.iterate()

  def iterate(
      self, start: int = 0, limit: int | None = None
  ) -> Iterator[TrainingInput]:
    records = self._records[start:limit]
    for lo in range(0, len(records) - self.batch_size + 1, self.batch_size):
      chunk = records[lo : lo + self.batch_size]
      encoded = [self._encode_record(rec) for rec in chunk]
      paths = [self._image_path(rec) for rec in chunk]
      pixels = None
      if self.load_pixels and all(paths):
        from cadence_gemma_tpu_torch.utils import image_cpp  # pylint: disable=import-outside-toplevel

        pixels = image_cpp.load_jpeg_batch(paths, size=384)
      yield TrainingInput(
          input_tokens=np.stack([tokens for tokens, _ in encoded]),
          target_mask=np.stack([mask for _, mask in encoded]),
          image_paths=paths if all(paths) else None,
          pixels=pixels,
      )


def prefetch_to_device(iterator: Iterable[Any], buffer_size: int = 2,
                       device=None) -> Iterator[Any]:
  """Overlaps host batch preparation and the host-to-device copy with the
  device's compute (JAX ``data.py:137``).

  A producer thread pulls batches from ``iterator`` and moves every numpy
  field of a dataclass batch (or a dict's values) to ``device`` (``None``
  means CUDA, and raises without a card): on the card through pinned host
  memory with ``non_blocking`` copies on a stream of its own, whose event
  the consumer's stream waits on before the batch is used; on the CPU as
  tensors over the arrays. Up to ``buffer_size`` batches are in flight.

  Order is kept and an exception of the producer re-raises at the consumer.
  Closing the generator (``contextlib.closing``, or a ``for`` left early and
  collected) stops the producer. The producer runs ahead of training, so
  keep this off for iterators whose side effects must stay in step with it.
  """
  device = griffin.resolve_device(device)
  q: queue_lib.Queue = queue_lib.Queue(maxsize=buffer_size)
  sentinel = object()
  stop = threading.Event()
  copies = torch.cuda.Stream(device) if device.type == "cuda" else None

  def to_device(batch):
    """The batch with its arrays on the device, the copies' event, and the
    tensors the copies made."""
    moved = []

    def put(x):
      if not isinstance(x, np.ndarray):
        return x
      t = torch.from_numpy(np.ascontiguousarray(x))
      if copies is not None:
        with torch.cuda.stream(copies):
          t = t.pin_memory().to(device, non_blocking=True)
      moved.append(t)
      return t

    if dataclasses.is_dataclass(batch) and not isinstance(batch, type):
      batch = dataclasses.replace(batch, **{
          f.name: put(getattr(batch, f.name))
          for f in dataclasses.fields(batch)})
    elif isinstance(batch, dict):
      batch = {k: put(v) for k, v in batch.items()}
    else:
      batch = put(batch)
    return batch, None if copies is None else copies.record_event(), moved

  def offer(item) -> bool:
    """Enqueues unless the consumer has gone; False tells the producer to
    stop."""
    while not stop.is_set():
      try:
        q.put(item, timeout=0.1)
        return True
      except queue_lib.Full:
        continue
    return False

  def producer():
    try:
      if copies is not None:
        torch.cuda.set_device(device)
      for item in iterator:
        if not offer(to_device(item)):
          return
      offer(sentinel)
    except BaseException as e:  # noqa: BLE001 -- re-raised at the consumer
      offer(e)

  thread = threading.Thread(target=producer, daemon=True,
                            name="cadence-data-prefetch")
  thread.start()
  try:
    while True:
      item = q.get()
      if item is sentinel:
        return
      if isinstance(item, BaseException):
        raise item
      batch, event, moved = item
      if event is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(event)
        for t in moved:  # allocated on the copy stream, used on this one
          t.record_stream(stream)
      yield batch
  finally:
    stop.set()


def apply_it_template(prompt: str) -> str:
  return common.apply_it_formatter(prompt)
