"""Text SFT data: batches of token ids and loss masks from chat JSON records.

Counterpart of the JAX package's ``cadence_gemma_tpu/training/data.py``
(``TrainingInput``, ``DatasetBuilder``, ``apply_it_template``) for text
records. A record of the LLaVA form::

    {"conversations": [{"from": "human", "value": "..."},
                       {"from": "gpt", "value": "..."}, ...]}

becomes one example: the human turns are prompt (masked out of the loss),
the gpt turns are targets, everything is wrapped in the Gemma chat template
and truncated or right-padded to ``max_seq_len``. Records with an image
raise until the vision slice is ported. Pure Python and numpy.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterator

import numpy as np

from cadence_gemma_tpu_torch import common


@dataclasses.dataclass
class TrainingInput:
  """One batch: token ids and the loss mask (images are not ported)."""

  input_tokens: np.ndarray          # [b, t] int32
  target_mask: np.ndarray           # [b, t] bool
  image_paths: list[str] | None = None
  pixels: np.ndarray | None = None


@dataclasses.dataclass
class DatasetBuilder:
  """Streams batched, tokenized examples from chat-style JSON files.

  Attributes:
    vocab: Tokenizer implementing the ``Vocabulary`` protocol.
    json_path: Path to the JSON list of conversation records.
    max_seq_len: Examples are truncated / right-padded to this length.
    batch_size: Examples per batch.
  """

  vocab: Any
  json_path: str
  max_seq_len: int = 1024
  batch_size: int = 1

  def __post_init__(self):
    with open(self.json_path) as f:
      self._records = json.load(f)

  def __len__(self) -> int:
    return len(self._records)

  def _encode_record(
      self, record: dict[str, Any]
  ) -> tuple[np.ndarray, np.ndarray]:
    """Tokenizes one conversation; mask is True on answer tokens only."""
    if record.get("image"):
      raise NotImplementedError(
          "A record with an image needs the vision path, which is not ported "
          "yet."
      )
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

  def __iter__(self) -> Iterator[TrainingInput]:
    return self.iterate()

  def iterate(
      self, start: int = 0, limit: int | None = None
  ) -> Iterator[TrainingInput]:
    records = self._records[start:limit]
    for lo in range(0, len(records) - self.batch_size + 1, self.batch_size):
      encoded = [self._encode_record(rec)
                 for rec in records[lo : lo + self.batch_size]]
      yield TrainingInput(
          input_tokens=np.stack([tokens for tokens, _ in encoded]),
          target_mask=np.stack([mask for _, mask in encoded]),
      )


def apply_it_template(prompt: str) -> str:
  return common.apply_it_formatter(prompt)
