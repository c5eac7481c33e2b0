"""The port's SentencePiece tokenizer vs the JAX package's.

``cadence_gemma_tpu_torch.sp_native`` is a copy of the JAX package's
``sp_native`` (the port imports nothing of that package). On the unigram and
BPE models that ``tests/test_sp_native.py`` synthesizes with protobuf, the
port's encoder -- its Python reference and its native C++ segmenter over
``native/sptokenizer.cc`` -- must give the JAX package's Python reference's
ids exactly, and decode them to the same text; ``load_sentencepiece`` must
load a ``tokenizer.model`` file as the JAX package's does.
"""

import importlib.util
import random

import pytest

from cadence_gemma_tpu import sp_native as jsp
from cadence_gemma_tpu import tokenizers as jtokenizers
from cadence_gemma_tpu_torch import sp_native
from cadence_gemma_tpu_torch import tokenizers
from cadence_gemma_tpu_torch.utils import sp_cpp
from tests import test_sp_native as sp_models


def _byte_fallback_pieces():
  pieces = sp_models.std_specials() + [
      ("a", -1.0, jsp.NORMAL), ("b", -1.5, jsp.NORMAL),
      ("▁", -1.0, jsp.NORMAL), ("▁ab", -0.5, jsp.NORMAL),
  ]
  pieces += [(f"<0x{b:02X}>", 0.0, jsp.BYTE) for b in range(256)]
  return pieces


def _model(kind: str, seed: int) -> tuple[bytes, str]:
  """(serialized ModelProto, the alphabet of its test texts)."""
  if kind == "unigram":
    pieces = sp_models._random_unigram_pieces(random.Random(seed))
    return sp_models.build_model_bytes(
        pieces, remove_extra_whitespaces=False), "abcdef "
  if kind == "bpe":
    pieces, _, _ = sp_models._random_bpe_model(seed)
    return sp_models.build_model_bytes(
        pieces, model_type=jsp.BPE, remove_extra_whitespaces=False), "abcd "
  return sp_models.build_model_bytes(
      _byte_fallback_pieces(), byte_fallback=True), "abé中 x"


CASES = [("unigram", s) for s in range(3)] + [("bpe", s) for s in range(3)]
CASES += [("byte_fallback", 0)]


@pytest.mark.parametrize("kind,seed", CASES)
@pytest.mark.parametrize("use_native", [False, True])
def test_encode_decode_match_jax(kind, seed, use_native):
  data, alphabet = _model(kind, seed)
  want = jsp.NativeSentencePiece(data, use_native=False)
  got = sp_native.NativeSentencePiece(data, use_native=use_native)
  assert (got._native is not None) == (use_native and sp_cpp.available())
  for name in ("pad_id", "bos_id", "eos_id", "unk_id", "GetPieceSize"):
    assert getattr(got, name)() == getattr(want, name)()
  for i in range(want.GetPieceSize()):
    assert got.IdToPiece(i) == want.IdToPiece(i)
    assert got.PieceToId(want.IdToPiece(i)) == want.PieceToId(
        want.IdToPiece(i))
    assert (got.IsControl(i), got.IsByte(i), got.IsUnknown(i)) == (
        want.IsControl(i), want.IsByte(i), want.IsUnknown(i))
  rng = random.Random(100 + seed)
  for _ in range(60):
    text = "".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 30)))
    ids = got.EncodeAsIds(text)
    assert ids == want.EncodeAsIds(text), text
    assert got.DecodeIds(ids) == want.DecodeIds(ids)


def test_load_sentencepiece_matches_jax(tmp_path):
  data, _ = _model("unigram", 7)
  path = tmp_path / "tokenizer.model"
  path.write_bytes(data)
  got = tokenizers.load_sentencepiece(str(path))
  want = jtokenizers.load_sentencepiece(str(path))
  assert isinstance(got, tokenizers.Vocabulary)
  if importlib.util.find_spec("sentencepiece") is None:
    # Without the extension each package loads its own copy.
    assert isinstance(got, sp_native.NativeSentencePiece)
    assert isinstance(want, jsp.NativeSentencePiece)
  for text in ("abc def", "  fed cab  ", ""):
    assert got.EncodeAsIds(text) == want.EncodeAsIds(text)
