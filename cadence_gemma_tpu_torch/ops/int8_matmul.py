"""Weight-only int8 product: the CUDA kernel and its plain version.

Computes, for ``a`` bfloat16 ``[B, M, K]``, ``q`` int8 ``[B, N, K]`` and
``scale`` float32 ``[B, N]``::

    y[b] = bf16( bf16(a[b] @ q[b].T) * bf16(scale[b]) )

with float32 sums: the JAX package's weight-only expression
``(x @ q.astype(bf16)) * scale.astype(bf16)`` (``QuantizableDense``,
``Einsum``, ``BlockDiagonalLinear`` and ``Embedder.decode``), with the
weight stored contraction-last. It has no Pallas counterpart: XLA fuses the
int8 -> bf16 convert into the dot's operand read, and
``csrc/int8_matmul.cu`` does the same by hand, so only int8 weights cross
device memory. One launch shape covers every weight-only product:

  * ``Dense``: ``B = 1``;
  * the fused ``ffw_up`` ``Einsum``: ``B = 2`` over one activation (batch
    stride 0);
  * ``BlockDiagonalLinear``: ``B`` = heads, the heads of the activation
    read in place (batch stride ``i``, row stride ``h * i``);
  * ``Embedder.decode``: ``B = 1``, ``N`` = the vocabulary.

:func:`int8_weight_matmul` launches the kernel for CUDA tensors and takes
:func:`int8_weight_matmul_plain` only for CPU tensors. A kernel that fails
to build or launch raises; nothing falls back. It launches on the current
stream and allocates only through torch, so CUDA graphs capture it.
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch import _build

# Kernel launches in this process (a split-K call's two kernels count once);
# callers reset it to count one run.
launches = 0

# The kernel's output tile is 64 columns wide and its K tile 64 deep; K is
# split when the output tiles would not give each of the card's SMs two
# blocks.
_BLOCK_N = 64
_BLOCK_K = 64
_TARGET_BLOCKS = 2 * 132


def int8_weight_matmul_plain(a: torch.Tensor, q: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
  """JAX's expression: ``(a @ q.to(a.dtype).T) * scale.to(a.dtype)``.

  Widens the whole weight; the tests and the CPU use it, the card never
  does on its serving path.
  """
  y = a @ q.to(a.dtype).transpose(-1, -2)
  return y * scale.to(a.dtype)[..., None, :]


def block_rows(m: int) -> int:
  """Rows of the kernel's output tile for ``m`` rows of ``a``."""
  return 16 if m <= 16 else 64


def split_k(batches: int, m: int, n: int, k: int) -> int:
  """How many slices the kernel cuts K into at this shape (1: none).

  Decode shapes give few output tiles (a [2, 2560] x [2560, 2560] product
  has 40); splitting K multiplies the blocks until the card has about two
  an SM, each slice at least one 64-deep tile.
  """
  tiles = -(-n // _BLOCK_N) * -(-m // block_rows(m)) * batches
  if tiles >= _TARGET_BLOCKS // 2:
    return 1
  return max(1, min(-(-_TARGET_BLOCKS // tiles), -(-k // _BLOCK_K)))


def _check(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
  if a.ndim != 3 or q.ndim != 3 or scale.ndim != 2:
    raise ValueError(
        f"Expected a [B, M, K], q [B, N, K] and scale [B, N], got "
        f"{tuple(a.shape)}, {tuple(q.shape)} and {tuple(scale.shape)}."
    )
  batches, _, k = a.shape
  if q.shape[0] != batches or q.shape[2] != k:
    raise ValueError(f"`q` {tuple(q.shape)} does not match `a` "
                     f"{tuple(a.shape)}.")
  if tuple(scale.shape) != tuple(q.shape[:2]):
    raise ValueError(f"`scale` must be {tuple(q.shape[:2])}, got "
                     f"{tuple(scale.shape)}.")
  if q.dtype != torch.int8:
    raise ValueError(f"`q` must be int8, got {q.dtype}.")


def int8_weight_matmul(a: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
  """The weight-only product: the CUDA kernel on the card, the plain
  version on CPU tensors.

  Args:
    a: Activations ``[B, M, K]`` (bfloat16 on the card), K contiguous; the
      batch and row strides are free (batch stride 0 shares one activation).
    q: int8 weights ``[B, N, K]``.
    scale: float32 per-output-channel scales ``[B, N]``.

  Returns:
    ``[B, M, N]`` in ``a.dtype``, contiguous.
  """
  global launches
  _check(a, q, scale)
  if a.device.type == "cpu":
    return int8_weight_matmul_plain(a, q, scale)
  if a.device.type != "cuda":
    raise ValueError(f"int8_weight_matmul runs on CUDA or CPU tensors, not "
                     f"{a.device}.")
  if a.dtype != torch.bfloat16:
    raise ValueError(f"The CUDA int8 kernel takes bfloat16 activations, got "
                     f"{a.dtype}.")
  batches, m, k = a.shape
  n = q.shape[1]
  if k % 16:
    raise ValueError(f"The CUDA int8 kernel needs a depth that is a multiple "
                     f"of 16, got {k}.")
  if a.stride(2) != 1 or a.stride(1) % 8 or a.stride(0) % 8:
    a = a.contiguous()
  q = q.contiguous()
  scale = scale.float().contiguous()
  for name, t in (("a", a), ("q", q), ("scale", scale)):
    if t.data_ptr() % 16:
      raise ValueError(f"The CUDA int8 kernel needs `{name}` 16-byte "
                       "aligned.")
  y = torch.empty(batches, m, n, dtype=torch.bfloat16, device=a.device)
  splits = split_k(batches, m, n, k)
  partial = (torch.empty(splits, batches, m, n, dtype=torch.float32,
                         device=a.device) if splits > 1 else None)
  fn = _build.function("int8_matmul", "cg_int8_weight_matmul",
                       "pppppiiiillip")
  with torch.cuda.device(a.device):
    err = fn(
        a.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(), batches, m, n, k,
        a.stride(0), a.stride(1), splits,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
  launches += 1
  if err:
    raise RuntimeError(f"int8_weight_matmul CUDA kernel failed: cudaError_t "
                       f"{err}.")
  return y
