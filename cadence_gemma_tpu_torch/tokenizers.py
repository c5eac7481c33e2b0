"""Tokenizer protocol, the SentencePiece loader and a tiny vocabulary.

The sampler only needs five methods of SentencePiece's processor, captured
here as :class:`Vocabulary`; anything duck-typing it works. A copy of the
JAX package's ``cadence_gemma_tpu/tokenizers.py`` (``Vocabulary``,
``load_sentencepiece`` and ``SimpleVocab``).
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable


@runtime_checkable
class Vocabulary(Protocol):
  """The tokenizer interface the sampler relies on."""

  def pad_id(self) -> int:
    ...

  def bos_id(self) -> int:
    ...

  def eos_id(self) -> int:
    ...

  def EncodeAsIds(self, text: str) -> list[int]:  # noqa: N802
    ...

  def DecodeIds(self, ids: Sequence[int]) -> str:  # noqa: N802
    ...


def load_sentencepiece(model_path: str) -> Vocabulary:
  """Loads a SentencePiece ``tokenizer.model`` (e.g. the official Gemma one).

  Uses the ``sentencepiece`` extension when it is installed, else the
  port's self-contained :class:`sp_native.NativeSentencePiece` (protobuf
  wire parser, unigram and BPE segmentation with a native C++ hot loop).
  """
  try:
    import sentencepiece as spm  # pylint: disable=import-outside-toplevel
  except ImportError:
    from cadence_gemma_tpu_torch import sp_native  # pylint: disable=import-outside-toplevel

    return sp_native.NativeSentencePiece(model_path)
  vocab = spm.SentencePieceProcessor()
  vocab.Load(model_path)
  return vocab


class SimpleVocab:
  """A tiny whitespace vocabulary for tests and offline smoke runs.

  ids: 0=pad, 1=bos, 2=eos, 3=unk, then one id per word.
  """

  def __init__(self, words: Sequence[str]):
    self._words = list(words)
    self._ids = {w: i + 4 for i, w in enumerate(self._words)}

  def pad_id(self) -> int:
    return 0

  def bos_id(self) -> int:
    return 1

  def eos_id(self) -> int:
    return 2

  def unk_id(self) -> int:
    return 3

  def GetPieceSize(self) -> int:  # noqa: N802
    return len(self._words) + 4

  def EncodeAsIds(self, text: str) -> list[int]:  # noqa: N802
    return [self._ids.get(w, 3) for w in text.split(" ") if w]

  def DecodeIds(self, ids: Sequence[int]) -> str:  # noqa: N802
    return " ".join(
        self._words[i - 4] for i in ids if i >= 4 and i - 4 < len(self._words)
    )
