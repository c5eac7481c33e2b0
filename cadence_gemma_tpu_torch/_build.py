"""Builds the hand-written CUDA kernels at first use and loads them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes``. No PyTorch header is
included, so a build takes seconds, not minutes. Libraries land in
``_build/`` beside this file under a name that carries the hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for all of them.

``ctypes``, ``subprocess`` and ``nvcc`` are touched only inside the
functions below, so importing this module (as the CPU tests do) needs no
CUDA toolkit.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import tempfile

KERNELS = ("lru_scan", "window_attention", "window_attention_backward",
           "mha_attention", "add_rmsnorm", "lru_scan_complex", "kernel_lab")

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Libraries already loaded in this process, by kernel name, and their C
# functions with argument types set, by (kernel name, symbol).
_loaded: dict[str, object] = {}
_functions: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
  candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
  candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
  for path in candidates:
    if path and os.path.exists(path):
      return path
  raise RuntimeError(
      "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
      "/usr/local/cuda/bin); the CUDA kernels cannot be built."
  )


def library_path(name: str) -> pathlib.Path:
  """Where the library of ``csrc/<name>.cu`` lives for its current hash."""
  if name not in KERNELS:
    raise ValueError(f"Unknown kernel {name!r}; known: {KERNELS}.")
  digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
  for header in sorted(_CSRC.glob("*.cuh")):
    digest.update(header.read_bytes())
  digest.update(" ".join(_NVCC_FLAGS).encode())
  return _BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
  """Compiles every library in ``names`` that is missing, in parallel.

  Returns ``{name: ptxas report}`` for the libraries built by this call
  (registers, shared memory and spills of each kernel). Raises with the
  compiler's output if any build fails.
  """
  import subprocess  # pylint: disable=import-outside-toplevel

  _BUILD_DIR.mkdir(parents=True, exist_ok=True)
  jobs = {}
  for name in names:
    target = library_path(name)
    if target.exists():
      continue
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    jobs[name] = (proc, tmp, target)

  reports, failures = {}, []
  for name, (proc, tmp, target) in jobs.items():
    out, _ = proc.communicate()
    if proc.returncode != 0:
      os.unlink(tmp)
      failures.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{out}")
      continue
    os.replace(tmp, target)  # atomic: a reader never sees half a library
    reports[name] = out
  if failures:
    raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
  return reports


def function(name: str, symbol: str, signature: str):
  """C function ``symbol`` of kernel ``name``, built and loaded if needed.

  ``signature`` spells the argument types, one letter each: ``p`` a pointer
  or stream (``c_void_p``), ``i`` an ``int``, ``f`` a ``float``. Every
  function returns its ``cudaError_t`` as an ``int``.
  """
  import ctypes  # pylint: disable=import-outside-toplevel

  fn = _functions.get((name, symbol))
  if fn is not None:
    return fn
  lib = _loaded.get(name)
  if lib is None:
    path = library_path(name)
    if not path.exists():
      build([name])
    lib = ctypes.CDLL(str(path))
    _loaded[name] = lib
  types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
  fn = getattr(lib, symbol)
  fn.argtypes = [types[c] for c in signature]
  fn.restype = ctypes.c_int
  _functions[(name, symbol)] = fn
  return fn


def kernel_attributes(name: str, symbol: str, *args: int) -> dict[str, int]:
  """The resources of a kernel of library ``name``, from its C function
  ``symbol(*args, int info[4])``: registers a thread at launch, local
  (spilled) bytes a thread, dynamic shared memory bytes and threads of a
  block."""
  import ctypes  # pylint: disable=import-outside-toplevel

  info = (ctypes.c_int * 4)()
  err = function(name, symbol, "i" * len(args) + "p")(
      *args, ctypes.addressof(info))
  if err:
    raise RuntimeError(f"{symbol}{args} failed: cudaError_t {err}.")
  return dict(zip(("registers", "local_bytes", "shared_bytes", "threads"),
                  info))
