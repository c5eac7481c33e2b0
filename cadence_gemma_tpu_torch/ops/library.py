"""The port's kernels as ``torch.library`` operators.

Every kernel launched from ``ops/fused_epilogue.py``, ``ops/lru_scan.py``,
``ops/window_attention.py`` and ``ops/int8_matmul.py`` is an operator of the
``cadence_gemma_tpu_torch`` namespace with three implementations:

  * CUDA: the launch of the hand-written kernel (checks, the current stream,
    the module's launch counters, a raise on a non-zero ``cudaError_t``);
  * CPU: the kernel's plain PyTorch version;
  * fake: empty outputs of the right shapes, dtypes and strides, which
    FakeTensor tracing (``torch.export``, ``torch.library.opcheck``) runs.

The dispatcher, not a Python branch in a wrapper, sends a tensor to its
device's implementation, so a program exported by ``torch.export`` holds the
operator, and the program loaded elsewhere launches the same kernel (and
counts it) once the module that registers it is imported. A CUDA tensor
never reaches the CPU implementation.

Registered with ``Library.define`` / ``impl`` rather than
``torch.library.custom_op``: a call pays the dispatcher and no Python
wrapper of its own. Schemas take only tensors, ints, floats and bools, and
every output is a new tensor. No operator has an autograd kernel: each
gradient lives in the ``torch.autograd.Function`` around its operator, and
the CPU implementation runs without recording, as a kernel does.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

NAMESPACE = "cadence_gemma_tpu_torch"

_LIBRARY = torch.library.Library(NAMESPACE, "FRAGMENT")


def define(schema: str, *, cpu: Callable, cuda: Callable,
           fake: Callable) -> torch._ops.OpOverload:
  """Defines ``NAMESPACE::<schema>`` with its three implementations and
  returns the operator's overload, which callers call directly."""
  name = schema.split("(", 1)[0]

  @functools.wraps(cpu)
  def cpu_impl(*args):
    with torch.no_grad():
      return cpu(*args)

  _LIBRARY.define(schema)
  _LIBRARY.impl(name, cpu_impl, "CPU")
  _LIBRARY.impl(name, cuda, "CUDA")
  torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
  return getattr(getattr(torch.ops, NAMESPACE), name).default
