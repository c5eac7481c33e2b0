"""ctypes bindings for the native SentencePiece segmenter.

``native/sptokenizer.cc`` implements the hot encode loop (USER_DEFINED
pre-split + unigram Viterbi / BPE agenda merge + byte fallback) of the
self-contained tokenizer in ``cadence_gemma_tpu_torch/sp_native.py``; the Python
encoder there is the semantic reference and the automatic fallback. Builds
the shared library on first use (``make -C native libsptokenizer.so``). A
copy of the JAX package's ``cadence_gemma_tpu/utils/sp_cpp.py``; both load
the one library built from ``native/sptokenizer.cc``.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libsptokenizer.so"
_lib = None
_build_attempted = False


def _load_library():
  global _lib, _build_attempted
  if _lib is not None:
    return _lib
  if not _LIB_PATH.exists() and not _build_attempted:
    _build_attempted = True
    try:
      subprocess.run(
          ["make", "-C", str(_NATIVE_DIR), "libsptokenizer.so"],
          check=True,
          capture_output=True,
          timeout=120,
      )
    except (OSError, subprocess.SubprocessError):
      return None
  if not _LIB_PATH.exists():
    return None
  try:
    lib = ctypes.CDLL(str(_LIB_PATH))
  except OSError:
    return None
  lib.sp_build.argtypes = [
      ctypes.POINTER(ctypes.c_uint8),
      ctypes.POINTER(ctypes.c_int64),
      ctypes.POINTER(ctypes.c_float),
      ctypes.POINTER(ctypes.c_int32),
      ctypes.c_int32,
      ctypes.c_int32,
      ctypes.c_int32,
      ctypes.c_int32,
      ctypes.c_double,
  ]
  lib.sp_build.restype = ctypes.c_void_p
  lib.sp_free.argtypes = [ctypes.c_void_p]
  lib.sp_free.restype = None
  lib.sp_encode.argtypes = [
      ctypes.c_void_p,
      ctypes.POINTER(ctypes.c_uint8),
      ctypes.c_int64,
      ctypes.POINTER(ctypes.c_int32),
      ctypes.c_int64,
  ]
  lib.sp_encode.restype = ctypes.c_int64
  _lib = lib
  return _lib


def available() -> bool:
  return _load_library() is not None


class NativeSegmenter:
  """Owns a C++ model handle; ``encode`` segments normalized text."""

  def __init__(self, lib, handle):
    self._lib = lib
    self._handle = handle

  def encode(self, normalized: str) -> list[int] | None:
    data = np.frombuffer(normalized.encode("utf-8"), np.uint8)
    if data.size == 0:
      return []
    out = np.empty(data.size + 8, np.int32)
    n = self._lib.sp_encode(
        self._handle,
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        data.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.size,
    )
    if n < 0:
      return None
    return out[:n].tolist()

  def __del__(self):
    try:
      if self._handle:
        self._lib.sp_free(self._handle)
        self._handle = None
    except Exception:  # interpreter teardown
      pass


def build(proto) -> NativeSegmenter | None:
  """Builds a native segmenter for an ``sp_native.SPModelProto``."""
  lib = _load_library()
  if lib is None:
    return None
  piece_bytes = [p.encode("utf-8") for p, _, _ in proto.pieces]
  offsets = np.zeros(len(piece_bytes) + 1, np.int64)
  np.cumsum([len(b) for b in piece_bytes], out=offsets[1:])
  blob = np.frombuffer(b"".join(piece_bytes) or b"\0", np.uint8)
  scores = np.asarray([s for _, s, _ in proto.pieces], np.float32)
  types = np.asarray([t for _, _, t in proto.pieces], np.int32)
  min_score = float(scores.min()) if scores.size else 0.0
  handle = lib.sp_build(
      blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
      offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
      scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
      types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
      len(piece_bytes),
      int(proto.model_type),
      int(proto.unk_id),
      int(bool(proto.byte_fallback)),
      min_score - 10.0,
  )
  if not handle:
    return None
  return NativeSegmenter(lib, handle)
