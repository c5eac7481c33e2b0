"""ctypes bindings for the native token-closure walker.

``native/constrain.cc`` computes the (DFA state x vocabulary token) allowed
bitmask of grammar-constrained decoding: the dominant cost of compiling a
grammar against a 256k-token vocabulary. The C++ walk stops early on the
absorbing dead state and runs the DFA states on threads; the numpy walk in
``inference/constrain.py`` gives the same bits (tested against each other).
Builds the shared library on first use (``make -C native libconstrain.so``).
A copy of the JAX package's ``cadence_gemma_tpu/utils/constrain_cpp.py``;
both load the one library built from ``native/constrain.cc``. Host code
only: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libconstrain.so"
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
          ["make", "-C", str(_NATIVE_DIR), "libconstrain.so"],
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
  lib.constrain_walk_pack.argtypes = [
      ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
      ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
      ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
      ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint32),
      ctypes.c_int32,
  ]
  lib.constrain_walk_pack.restype = ctypes.c_int32
  _lib = lib
  return _lib


def available() -> bool:
  return _load_library() is not None


def walk_pack(
    trans: np.ndarray,
    u_cols: np.ndarray,
    u_len: np.ndarray,
    uid: np.ndarray,
    vocab: int,
    dead: int,
    n_threads: int = 0,
) -> np.ndarray | None:
  """[S, ceil(vocab/32)] uint32 allowed bits, or None if unavailable.

  Bit ``v % 32`` of word ``v // 32`` in row ``s`` is set iff unique row
  ``uid[v]`` walks from state ``s`` to a non-dead state (empty tokens,
  ``u_len == 0``, are never set). Stop-token and fail-open bits are the
  caller's responsibility — applied identically over the numpy path.
  """
  lib = _load_library()
  if lib is None:
    return None
  trans = np.ascontiguousarray(trans, np.int32)
  u_cols = np.ascontiguousarray(u_cols, np.int32)
  u_len = np.ascontiguousarray(u_len, np.int32)
  uid = np.ascontiguousarray(uid, np.int32)
  n_states, n_atoms = trans.shape
  n_uniq, max_len = u_cols.shape if u_cols.size else (u_len.shape[0], 1)
  if u_cols.size == 0:
    u_cols = np.zeros((n_uniq, 1), np.int32)
  out = np.zeros((n_states, (vocab + 31) // 32), np.uint32)
  i32p = ctypes.POINTER(ctypes.c_int32)
  status = lib.constrain_walk_pack(
      trans.ctypes.data_as(i32p), n_states, n_atoms,
      u_cols.ctypes.data_as(i32p), n_uniq, max_len,
      u_len.ctypes.data_as(i32p), uid.ctypes.data_as(i32p),
      vocab, dead,
      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
      n_threads,
  )
  if status != 0:
    return None
  return out
