"""ctypes bindings for the native image-preprocessing library.

``native/imageproc.cc`` decodes JPEGs and resizes them bicubically as PIL
does, to float32 CHW in C++ (threaded across a batch): the host-side path
that feeds multimodal SFT batches. This module builds the shared library on
first use (``make -C native libimageproc.so``) and decodes with PIL where
the toolchain or libjpeg is missing, or a file is not a JPEG: both run on
the host, before the card sees the pixels. A copy of the JAX package's
``cadence_gemma_tpu/utils/image_cpp.py``; both load the one library built
from ``native/imageproc.cc``.

API:
  load_jpeg(path, size)            -> np.ndarray [3, size, size] float32
  load_jpeg_batch(paths, size)     -> np.ndarray [n, 3, size, size]
  available()                      -> bool (native library usable)
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
from typing import Sequence

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libimageproc.so"
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
          ["make", "-C", str(_NATIVE_DIR), "libimageproc.so"],
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
  lib.imageproc_load_jpeg.argtypes = [
      ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
  ]
  lib.imageproc_load_jpeg.restype = ctypes.c_int
  lib.imageproc_load_batch.argtypes = [
      ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
      ctypes.POINTER(ctypes.c_float), ctypes.c_int,
  ]
  lib.imageproc_load_batch.restype = ctypes.c_int
  lib.imageproc_resize_rgb.argtypes = [
      ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.POINTER(ctypes.c_float),
  ]
  lib.imageproc_resize_rgb.restype = ctypes.c_int
  _lib = lib
  return _lib


def available() -> bool:
  return _load_library() is not None


def _pil_decode(path: str, size: int) -> np.ndarray:
  from cadence_gemma_tpu_torch.models import vit  # pylint: disable=import-outside-toplevel

  return vit.load_image(path, size=size)[0]


def _float_ptr(array: np.ndarray):
  return array.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_jpeg(path: str, size: int = 384) -> np.ndarray:
  """One image file -> [3, size, size] float32 in [0, 1]."""
  lib = _load_library()
  if lib is None:
    return _pil_decode(path, size)
  out = np.empty((3, size, size), np.float32)
  if lib.imageproc_load_jpeg(path.encode(), size, _float_ptr(out)) != 0:
    # Not a JPEG (or corrupt): decode with PIL, resize natively.
    return _decode_with_pil_resize_native(path, size, lib, out)
  return out


def _decode_with_pil_resize_native(path, size, lib, out) -> np.ndarray:
  from PIL import Image  # pylint: disable=import-outside-toplevel

  with open(path, "rb") as f:
    img = np.ascontiguousarray(
        np.asarray(Image.open(f).convert("RGB"), np.uint8))
  h, w, _ = img.shape
  status = lib.imageproc_resize_rgb(
      img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, size,
      _float_ptr(out))
  if status != 0:
    return _pil_decode(path, size)
  return out


def load_jpeg_batch(
    paths: Sequence[str], size: int = 384, threads: int | None = None
) -> np.ndarray:
  """Many files -> [n, 3, size, size] float32, decoded in parallel."""
  lib = _load_library()
  if lib is None:
    return np.stack([_pil_decode(p, size) for p in paths])
  n = len(paths)
  out = np.empty((n, 3, size, size), np.float32)
  joined = b"\0".join(p.encode() for p in paths) + b"\0"
  threads = threads or min(n, os.cpu_count() or 1)
  if lib.imageproc_load_batch(joined, n, size, _float_ptr(out), threads):
    # A file the batch decoder refused (not a JPEG): one by one.
    return np.stack([load_jpeg(p, size) for p in paths])
  return out
