"""Self-contained SentencePiece-compatible tokenizer.

A copy of the JAX package's ``cadence_gemma_tpu/sp_native.py`` (host code,
no framework), so the port loads real tokenizers without importing it.

The reference depends on the ``sentencepiece`` C++ extension for the official
Gemma tokenizer (reference ``pyproject.toml:28``; used by every sampler,
``jax/sampler.py:435``). That extension is optional here — this module loads
real ``tokenizer.model`` files (SentencePiece ``ModelProto``) and reproduces
the inference-time pipeline without it, so the serving stack runs standalone:

  * minimal protobuf **wire parser** for the ModelProto subset inference
    needs (pieces, trainer_spec ids/flags, normalizer_spec) — no generated
    pb2 modules, no protoc step;
  * **normalizer**: precompiled charsmap (darts-clone double-array trie +
    replacement-string pool, the same blob HF ``spm_precompiled`` reads),
    ``remove_extra_whitespaces``, ``add_dummy_prefix``,
    ``escape_whitespaces`` (space -> U+2581);
  * **unigram** encoding: Viterbi over a piece trie with SentencePiece's
    unknown handling (per-char unk at ``min_score - 10``, consecutive
    unknowns merged) and ``byte_fallback`` expansion to ``<0xXX>`` pieces;
  * **BPE** encoding: best-score-first agenda merge (ties to the leftmost
    pair, as ``bpe_model.cc``);
  * decoding with control-piece skipping, ``unk_surface``, byte-piece runs
    decoded as UTF-8, and dummy-prefix stripping.

The hot segmentation loop has a native C++ twin (``native/sptokenizer.cc``
via ``utils/sp_cpp.py``) used automatically when it builds; this Python
implementation is the semantic reference (the two are equality-tested on
random models/inputs in ``tests/test_sp_native.py``, the port's copy against
the JAX package's in ``tests/test_torch_port_tokenizer.py``, and both are validated
against HuggingFace ``tokenizers`` — an independent implementation of the
same algorithms — plus protobuf-built model files).

Deliberate deviation from sentencepiece (documented, tested): USER_DEFINED
pieces are matched by a leftmost-longest pre-split before segmentation
rather than by inflated in-lattice scores. For the non-overlapping special
tokens real models use (``<start_of_turn>`` etc.) the result is identical;
pathological overlapping user-defined pieces may split differently.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, Sequence

# SentencePiece piece types (sentencepiece_model.proto, SentencePiece.Type).
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

UNIGRAM = 1
BPE = 2

_SPACE_ESCAPE = "▁"  # the SentencePiece whitespace marker
_UNK_PENALTY = 10.0  # unigram_model.cc kUnkPenalty


# -- protobuf wire parsing ----------------------------------------------------


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
  result = 0
  shift = 0
  while True:
    b = data[i]
    i += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, i
    shift += 7
    if shift > 70:
      raise ValueError("varint too long")


def _signed(value: int) -> int:
  """Interprets a varint as a signed 64-bit int (proto int32/int64)."""
  if value >= 1 << 63:
    value -= 1 << 64
  return value


def _iter_fields(data: bytes) -> Iterator[tuple[int, int, object]]:
  """Yields (field_number, wire_type, raw_value) triples."""
  i = 0
  n = len(data)
  while i < n:
    key, i = _read_varint(data, i)
    field, wire = key >> 3, key & 7
    if wire == 0:  # varint
      value, i = _read_varint(data, i)
    elif wire == 1:  # 64-bit
      value = data[i : i + 8]
      i += 8
    elif wire == 2:  # length-delimited
      length, i = _read_varint(data, i)
      value = data[i : i + length]
      i += length
    elif wire == 5:  # 32-bit
      value = data[i : i + 4]
      i += 4
    else:
      raise ValueError(f"unsupported wire type {wire}")
    yield field, wire, value


@dataclasses.dataclass
class SPModelProto:
  """The ModelProto subset SentencePiece inference depends on."""

  pieces: list[tuple[str, float, int]]  # (piece, score, type)
  model_type: int = UNIGRAM
  # trainer_spec ids (proto2 defaults).
  unk_id: int = 0
  bos_id: int = 1
  eos_id: int = 2
  pad_id: int = -1
  byte_fallback: bool = False
  unk_surface: str = " ⁇ "
  # normalizer_spec.
  normalizer_name: str = ""
  precompiled_charsmap: bytes = b""
  add_dummy_prefix: bool = True
  remove_extra_whitespaces: bool = True
  escape_whitespaces: bool = True


def parse_model_proto(data: bytes) -> SPModelProto:
  """Parses a serialized ``sentencepiece.ModelProto`` (a tokenizer.model)."""
  proto = SPModelProto(pieces=[])
  for field, wire, value in _iter_fields(data):
    if field == 1 and wire == 2:  # repeated SentencePiece pieces
      piece, score, ptype = "", 0.0, NORMAL
      for f2, w2, v2 in _iter_fields(value):
        if f2 == 1 and w2 == 2:
          piece = v2.decode("utf-8")
        elif f2 == 2 and w2 == 5:
          score = struct.unpack("<f", v2)[0]
        elif f2 == 3 and w2 == 0:
          ptype = v2
      proto.pieces.append((piece, score, ptype))
    elif field == 2 and wire == 2:  # TrainerSpec
      for f2, w2, v2 in _iter_fields(value):
        if w2 != 0 and f2 != 44:
          continue
        if f2 == 3:
          proto.model_type = v2
        elif f2 == 35:
          proto.byte_fallback = bool(v2)
        elif f2 == 40:
          proto.unk_id = _signed(v2)
        elif f2 == 41:
          proto.bos_id = _signed(v2)
        elif f2 == 42:
          proto.eos_id = _signed(v2)
        elif f2 == 43:
          proto.pad_id = _signed(v2)
        elif f2 == 44 and w2 == 2:
          proto.unk_surface = v2.decode("utf-8")
    elif field == 3 and wire == 2:  # NormalizerSpec
      for f2, w2, v2 in _iter_fields(value):
        if f2 == 1 and w2 == 2:
          proto.normalizer_name = v2.decode("utf-8")
        elif f2 == 2 and w2 == 2:
          proto.precompiled_charsmap = v2
        elif f2 == 3 and w2 == 0:
          proto.add_dummy_prefix = bool(v2)
        elif f2 == 4 and w2 == 0:
          proto.remove_extra_whitespaces = bool(v2)
        elif f2 == 5 and w2 == 0:
          proto.escape_whitespaces = bool(v2)
  return proto


# -- precompiled charsmap (darts-clone double-array trie) ---------------------


class _CharsMap:
  """Longest-match normalization over the precompiled charsmap blob.

  Blob layout (sentencepiece ``normalizer.cc:DecodePrecompiledCharsMap``):
  ``uint32 trie_blob_size`` then that many bytes of little-endian uint32
  double-array units, then the '\\0'-separated normalized-string pool.
  Unit accessors follow darts-clone's ``DoubleArrayUnit``.
  """

  def __init__(self, blob: bytes):
    (trie_size,) = struct.unpack_from("<I", blob, 0)
    n_units = trie_size // 4
    self.units = struct.unpack_from(f"<{n_units}I", blob, 4)
    self.pool = blob[4 + trie_size :]

  @staticmethod
  def _offset(unit: int) -> int:
    return (unit >> 10) << ((unit & 0x200) >> 6)

  @staticmethod
  def _label(unit: int) -> int:
    return unit & 0x800000FF

  def longest_match(self, data: bytes, pos: int) -> tuple[int, bytes] | None:
    """(match_length, replacement) of the longest key at ``pos``, or None."""
    units = self.units
    node_pos = 0
    unit = units[node_pos]
    node_pos ^= self._offset(unit)
    best = None
    for i in range(pos, len(data)):
      c = data[i]
      if c == 0:
        break
      node_pos ^= c
      if node_pos >= len(units):
        break
      unit = units[node_pos]
      if self._label(unit) != c:
        break
      node_pos ^= self._offset(unit)
      if (unit >> 8) & 1:  # has_leaf
        value = units[node_pos] & 0x7FFFFFFF
        end = self.pool.index(b"\0", value)
        best = (i + 1 - pos, self.pool[value:end])
    return best


def _utf8_char_len(b: int) -> int:
  if b < 0x80:
    return 1
  if b >= 0xF0:
    return 4
  if b >= 0xE0:
    return 3
  if b >= 0xC0:
    return 2
  return 1  # continuation/invalid byte: treat as a single unit


class Normalizer:
  """The inference-time text normalizer (``normalizer.cc`` semantics)."""

  def __init__(self, proto: SPModelProto):
    self.charsmap = (
        _CharsMap(proto.precompiled_charsmap)
        if proto.precompiled_charsmap
        else None
    )
    self.add_dummy_prefix = proto.add_dummy_prefix
    self.remove_extra_whitespaces = proto.remove_extra_whitespaces
    self.escape_whitespaces = proto.escape_whitespaces

  def __call__(self, text: str) -> str:
    if self.charsmap is not None:
      data = text.encode("utf-8")
      out = []
      i = 0
      while i < len(data):
        match = self.charsmap.longest_match(data, i)
        if match is not None:
          length, replacement = match
          out.append(replacement)
          i += length
        else:
          length = _utf8_char_len(data[i])
          out.append(data[i : i + length])
          i += length
      text = b"".join(out).decode("utf-8", errors="replace")
    if self.remove_extra_whitespaces:
      text = " ".join(p for p in text.split(" ") if p)
    if not text:
      return ""
    if self.add_dummy_prefix:
      text = " " + text
    if self.escape_whitespaces:
      text = text.replace(" ", _SPACE_ESCAPE)
    return text


# -- piece trie ---------------------------------------------------------------


class _Trie:
  """Byte trie; nodes are dicts, terminal ids under the ``None`` key."""

  def __init__(self, items: Sequence[tuple[bytes, int]]):
    self.root: dict = {}
    for key, value in items:
      node = self.root
      for b in key:
        node = node.setdefault(b, {})
      node[None] = value

  def matches(self, data: bytes, pos: int) -> list[tuple[int, int]]:
    """All (end_pos, value) for keys matching at ``pos``, shortest first."""
    out = []
    node = self.root
    for i in range(pos, len(data)):
      node = node.get(data[i])
      if node is None:
        break
      value = node.get(None)
      if value is not None:
        out.append((i + 1, value))
    return out


# -- encoders -----------------------------------------------------------------


class _Encoder:
  """Shared tables for the unigram/BPE segmenters (Python reference path)."""

  def __init__(self, proto: SPModelProto):
    self.proto = proto
    self.scores = [p[1] for p in proto.pieces]
    matchable = []
    user_defined = []
    for i, (piece, _, ptype) in enumerate(proto.pieces):
      if ptype == USER_DEFINED:
        user_defined.append((piece.encode("utf-8"), i))
        matchable.append((piece.encode("utf-8"), i))
      elif ptype == NORMAL:
        matchable.append((piece.encode("utf-8"), i))
    self.trie = _Trie(matchable)
    self.ud_trie = _Trie(user_defined) if user_defined else None
    self.piece_to_id = {
        piece: i
        for i, (piece, _, ptype) in enumerate(proto.pieces)
        if ptype in (NORMAL, USER_DEFINED)
    }
    # Byte-fallback table: byte value -> piece id of "<0xXX>", or -1.
    self.byte_ids = [-1] * 256
    for i, (piece, _, ptype) in enumerate(proto.pieces):
      if ptype == BYTE:
        self.byte_ids[int(piece[1:-1], 16)] = i
    self.min_score = min(self.scores) if self.scores else 0.0
    self.unk_score = self.min_score - _UNK_PENALTY

  # --- shared helpers ---

  def _user_defined_split(
      self, data: bytes
  ) -> list[tuple[int, int, int | None]]:
    """Leftmost-longest USER_DEFINED split: (start, end, piece_id|None)."""
    if self.ud_trie is None:
      return [(0, len(data), None)]
    segments = []
    i = 0
    seg_start = 0
    while i < len(data):
      hits = self.ud_trie.matches(data, i)
      if hits:
        end, pid = hits[-1]  # longest
        if seg_start < i:
          segments.append((seg_start, i, None))
        segments.append((i, end, pid))
        i = end
        seg_start = end
      else:
        i += _utf8_char_len(data[i])
    if seg_start < len(data):
      segments.append((seg_start, len(data), None))
    return segments

  def _emit_unknown(self, data: bytes, out: list[int]) -> None:
    """Unknown span -> byte pieces (byte_fallback) or one unk id."""
    if self.proto.byte_fallback:
      for b in data:
        bid = self.byte_ids[b]
        out.append(bid if bid >= 0 else self.proto.unk_id)
    else:
      out.append(self.proto.unk_id)

  # --- unigram ---

  def _unigram_segment(self, data: bytes, out: list[int]) -> None:
    n = len(data)
    neg_inf = float("-inf")
    best = [neg_inf] * (n + 1)
    back: list[tuple[int, int] | None] = [None] * (n + 1)
    best[0] = 0.0
    i = 0
    while i < n:
      if best[i] != neg_inf:
        base = best[i]
        for end, pid in self.trie.matches(data, i):
          cand = base + self.scores[pid]
          if cand > best[end]:
            best[end] = cand
            back[end] = (i, pid)
        # Unknown node covering one (UTF-8) character.
        end = min(i + _utf8_char_len(data[i]), n)
        cand = base + self.unk_score
        if cand > best[end]:
          best[end] = cand
          back[end] = (i, -1)
      i += _utf8_char_len(data[i])
    tokens: list[tuple[int, int, int]] = []  # (start, end, pid)
    pos = n
    while pos > 0:
      start, pid = back[pos]  # type: ignore[misc]
      tokens.append((start, pos, pid))
      pos = start
    tokens.reverse()
    # Merge consecutive unknowns into one span (unigram_model.cc Encode).
    i = 0
    while i < len(tokens):
      start, end, pid = tokens[i]
      if pid >= 0:
        out.append(pid)
        i += 1
        continue
      j = i
      while j + 1 < len(tokens) and tokens[j + 1][2] < 0:
        j += 1
      self._emit_unknown(data[start : tokens[j][1]], out)
      i = j + 1

  # --- BPE ---

  def _bpe_segment(self, data: bytes, out: list[int]) -> None:
    import heapq

    # Symbols as byte spans; singly-linked via index arrays.
    starts: list[int] = []
    i = 0
    while i < len(data):
      starts.append(i)
      i += _utf8_char_len(data[i])
    starts.append(len(data))
    n = len(starts) - 1
    left = list(range(-1, n - 1))
    right = list(range(1, n + 1))
    span = [(starts[k], starts[k + 1]) for k in range(n)]
    alive = [True] * n

    heap: list[tuple[float, int, int, int, int]] = []

    def push(a: int, b: int) -> None:
      merged = data[span[a][0] : span[b][1]].decode("utf-8", "ignore")
      pid = self.piece_to_id.get(merged)
      if pid is not None and self.proto.pieces[pid][2] == NORMAL:
        # Higher score first; ties to the leftmost pair (bpe_model.cc).
        heapq.heappush(
            heap, (-self.scores[pid], span[a][0], a, b, span[b][1])
        )

    for k in range(n - 1):
      push(k, k + 1)
    while heap:
      _, _, a, b, b_end = heapq.heappop(heap)
      if not alive[a] or not alive[b]:
        continue
      if right[a] != b or span[b][1] != b_end:
        continue  # stale pair
      span[a] = (span[a][0], span[b][1])
      alive[b] = False
      right[a] = right[b]
      if right[b] < n:
        left[right[b]] = a
      if left[a] >= 0:
        push(left[a], a)
      if right[a] < n:
        push(a, right[a])
    syms = []
    for k in range(n):
      if alive[k]:
        s, e = span[k]
        pid = self.piece_to_id.get(data[s:e].decode("utf-8", "ignore"))
        syms.append((s, e, pid))
    # Consecutive unknown symbols fuse into one span (as HF's SP-BPE
    # conversion models with fuse_unk=True).
    i = 0
    while i < len(syms):
      s, e, pid = syms[i]
      if pid is not None:
        out.append(pid)
        i += 1
        continue
      j = i
      while j + 1 < len(syms) and syms[j + 1][2] is None:
        j += 1
      self._emit_unknown(data[s : syms[j][1]], out)
      i = j + 1

  # --- entry point ---

  def encode(self, normalized: str) -> list[int]:
    data = normalized.encode("utf-8")
    if not data:
      return []
    out: list[int] = []
    for start, end, pid in self._user_defined_split(data):
      if pid is not None:
        out.append(pid)
      elif self.proto.model_type == BPE:
        self._bpe_segment(data[start:end], out)
      else:
        self._unigram_segment(data[start:end], out)
    return out


# -- public vocabulary --------------------------------------------------------


class NativeSentencePiece:
  """Drop-in ``Vocabulary`` (tokenizers.py protocol) for .model files.

  Implements the SentencePieceProcessor surface the framework touches:
  ids, ``EncodeAsIds``/``DecodeIds``, ``GetPieceSize``, ``IdToPiece``,
  ``PieceToId``, ``IsControl``/``IsByte``/``IsUnknown`` (the grammar
  compiler's ``token_strings_from_vocab`` uses the latter three).
  """

  def __init__(self, model: bytes | str, use_native: bool = True):
    if isinstance(model, str):
      with open(model, "rb") as f:
        model = f.read()
    self.proto = parse_model_proto(model)
    if self.proto.model_type not in (UNIGRAM, BPE):
      raise ValueError(
          f"unsupported SentencePiece model_type {self.proto.model_type} "
          "(only UNIGRAM and BPE inference is implemented)"
      )
    self.normalizer = Normalizer(self.proto)
    self.encoder = _Encoder(self.proto)
    self._piece_index: dict[str, int] | None = None
    self._native = None
    if use_native:
      from cadence_gemma_tpu_torch.utils import sp_cpp

      self._native = sp_cpp.build(self.proto)  # None if unavailable

  # --- SentencePieceProcessor surface ---

  def pad_id(self) -> int:
    return self.proto.pad_id

  def bos_id(self) -> int:
    return self.proto.bos_id

  def eos_id(self) -> int:
    return self.proto.eos_id

  def unk_id(self) -> int:
    return self.proto.unk_id

  def GetPieceSize(self) -> int:  # noqa: N802
    return len(self.proto.pieces)

  def IdToPiece(self, i: int) -> str:  # noqa: N802
    return self.proto.pieces[i][0]

  def PieceToId(self, piece: str) -> int:  # noqa: N802
    if self._piece_index is None:
      self._piece_index = {
          p: i for i, (p, _, _) in enumerate(self.proto.pieces)
      }
    return self._piece_index.get(piece, self.proto.unk_id)

  def IsControl(self, i: int) -> bool:  # noqa: N802
    return self.proto.pieces[i][2] == CONTROL

  def IsByte(self, i: int) -> bool:  # noqa: N802
    return self.proto.pieces[i][2] == BYTE

  def IsUnknown(self, i: int) -> bool:  # noqa: N802
    return self.proto.pieces[i][2] == UNKNOWN

  def EncodeAsIds(self, text: str) -> list[int]:  # noqa: N802
    normalized = self.normalizer(text)
    if not normalized:
      return []
    if self._native is not None:
      ids = self._native.encode(normalized)
      if ids is not None:
        return ids
    return self.encoder.encode(normalized)

  def DecodeIds(self, ids: Sequence[int]) -> str:  # noqa: N802
    pieces = self.proto.pieces
    parts: list[str] = []
    byte_run = bytearray()

    def flush_bytes() -> None:
      if byte_run:
        parts.append(byte_run.decode("utf-8", errors="replace"))
        byte_run.clear()

    for i in ids:
      if i < 0 or i >= len(pieces):
        continue
      piece, _, ptype = pieces[i]
      if ptype == BYTE:
        byte_run.append(int(piece[1:-1], 16))
        continue
      flush_bytes()
      if ptype == CONTROL or ptype == UNUSED:
        continue
      if ptype == UNKNOWN:
        parts.append(self.proto.unk_surface)
        continue
      parts.append(piece)
    flush_bytes()
    text = "".join(parts)
    if self.proto.escape_whitespaces:
      text = text.replace(_SPACE_ESCAPE, " ")
    if self.proto.add_dummy_prefix and text.startswith(" "):
      text = text[1:]
    return text
