"""Weight-only int8 product and its input gradient: CUDA kernels and their
plain versions.

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
  * the fused ``ffw_up`` ``Einsum``: ``B = 2`` over one activation (``a``
    of batch 1, or batch stride 0);
  * ``BlockDiagonalLinear``: ``B`` = heads, the heads of the activation
    read in place (batch stride ``i``, row stride ``h * i``);
  * ``Embedder.decode``: ``B = 1``, ``N`` = the vocabulary.

Its gradient with respect to ``a`` (the weight and its scale are frozen:
int8 serving, and the base of a QLoRA fine-tune) is JAX's autodiff of that
expression, ``da = bf16(dy * bf16(scale)) @ q.astype(bf16)``, contracting
along N; a shared activation's gradient sums over the batches too.
``cg_int8_wgmma_dgrad`` (``csrc/int8_wgmma.cu``) computes it from the int8
weight as stored, with no bf16 copy of it, at every shape.

The forward has two designs, chosen by :func:`uses_wgmma` from the rows: at
decode rows (the step, the batcher's tick, captured graphs) the ``mma.sync``
kernel of ``csrc/int8_matmul.cu`` with split-K; at prefill and training
rows, where the tensor cores set the pace, the Hopper kernel of
``csrc/int8_wgmma.cu`` (a TMA ring, the int8 tile widened once a block in
shared memory, ``wgmma``). Each kernel has its launch counter.

:func:`int8_weight_matmul` calls the ``int8_weight_matmul`` operator (the
forward, both routes; :mod:`ops.library`) and, when autograd asks for the
input gradient, the ``int8_weight_matmul_dgrad`` operator. Their CUDA
implementations launch the kernels, and their CPU implementations are
:func:`int8_weight_matmul_plain` and :func:`int8_weight_matmul_dgrad_plain`.
A kernel that fails to build or launch raises; nothing falls back. They launch on the current stream and allocate only through
torch, so CUDA graphs capture them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cadence_gemma_tpu_torch import _build
from cadence_gemma_tpu_torch.ops import library

# Kernel launches in this process (a split-K call's two kernels count once):
# the mma.sync forward's, the wgmma forward's and the wgmma input
# gradient's. Callers reset them to count one run.
launches = 0
wgmma_launches = 0
dgrad_wgmma_launches = 0

# The kernel's output tile is 64 columns wide and its K tile 64 deep; K is
# split when the output tiles would not give each of the card's SMs two
# blocks.
_BLOCK_N = 64
_BLOCK_K = 64
_TARGET_BLOCKS = 2 * 132

# Rows from which the forward goes to the wgmma kernel: from 256 rows it
# matches or beats the mma.sync kernel at every layout of the 2B but the
# gates' (10 x [256 x 256], ~5 us slower up to 1024 rows); at 192 rows the
# [7680 -> 2560] forward takes 1.55 x the mma.sync kernel's time
# (tools/int8_crossover.py on an H100, PERF.md row 10).
WGMMA_MIN_ROWS = 256


def int8_weight_matmul_plain(a: torch.Tensor, q: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
  """JAX's expression: ``(a @ q.to(a.dtype).T) * scale.to(a.dtype)``.

  Widens the whole weight; the tests and the CPU use it, the card never
  does on its serving path.
  """
  y = a @ q.to(a.dtype).transpose(-1, -2)
  return y * scale.to(a.dtype)[..., None, :]


def int8_weight_matmul_dgrad_plain(g: torch.Tensor, q: torch.Tensor,
                                   scale: torch.Tensor,
                                   reduce_batches: bool = False
                                   ) -> torch.Tensor:
  """JAX's input gradient: ``(g * scale.to(g.dtype)) @ q.to(g.dtype)``.

  ``g`` is the cotangent ``[B, M, N]``; the result is ``[B, M, K]``, or
  ``[1, M, K]`` summed over the batches (in float32, rounded once) with
  ``reduce_batches``. Widens the whole weight; the tests, the CPU and the
  smoke's comparisons use it.
  """
  scaled = g * scale.to(g.dtype)[..., None, :]
  if not reduce_batches:
    return scaled @ q.to(g.dtype)
  return torch.einsum("bmn,bnk->mk", scaled.float(),
                      q.float()).to(g.dtype)[None]


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


def uses_wgmma(m: int) -> bool:
  """Whether a forward of ``m`` rows of ``a`` goes to the wgmma kernel
  (prefill, training) or to the mma.sync kernel with split-K (decode, the
  batcher's tick, captured decode graphs). The input gradient takes the
  wgmma kernel at every shape."""
  return m >= WGMMA_MIN_ROWS


class ALayout(NamedTuple):
  """The 3D tensor map through which the wgmma forward reads ``a``:
  ``dims`` innermost first (elements), ``strides`` of dims 1 and 2 in
  bytes. ``heads``: dim 1 is the batch (coordinates (k, b, m)), else dim 1
  is the row and dim 2 the batch (coordinates (k, m, b)); ``shared``: one
  activation for every batch, read at batch 0."""
  heads: bool
  shared: bool
  dims: tuple[int, int, int]
  strides: tuple[int, int]


def a_layout(a: torch.Tensor, batches: int) -> ALayout:
  """The tensor map of ``a`` ``[B or 1, M, K]`` (K contiguous, strides
  multiples of 8) for ``batches`` products: a shared activation (batch 1
  or batch stride 0) maps its one [M, K]; heads read in place (batch
  stride below the row stride: the block-diagonal gates' [M, H, I]) map
  as [M, H, K] with H innermost after K; otherwise [B, M, K]. Needs no
  device: the tests check it on meta tensors."""
  _, m, k = a.shape
  size = a.element_size()
  batch_stride, row_stride = a.stride(0), a.stride(1)
  if a.shape[0] == 1 or batch_stride == 0:
    return ALayout(False, True, (k, m, 1),
                   (row_stride * size, row_stride * size * m))
  if batch_stride < row_stride:
    return ALayout(True, False, (k, batches, m),
                   (batch_stride * size, row_stride * size))
  return ALayout(False, False, (k, m, batches),
                 (row_stride * size, batch_stride * size))


def _check(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
  if a.ndim != 3 or q.ndim != 3 or scale.ndim != 2:
    raise ValueError(
        f"Expected a [B, M, K], q [B, N, K] and scale [B, N], got "
        f"{tuple(a.shape)}, {tuple(q.shape)} and {tuple(scale.shape)}."
    )
  batches, _, k = a.shape
  if (q.shape[0] != batches and batches != 1) or q.shape[2] != k:
    raise ValueError(f"`q` {tuple(q.shape)} does not match `a` "
                     f"{tuple(a.shape)}.")
  if tuple(scale.shape) != tuple(q.shape[:2]):
    raise ValueError(f"`scale` must be {tuple(q.shape[:2])}, got "
                     f"{tuple(scale.shape)}.")
  if q.dtype != torch.int8:
    raise ValueError(f"`q` must be int8, got {q.dtype}.")


def padded_rows(t: torch.Tensor, unit: int) -> torch.Tensor:
  """``t`` [..., k] as a view of zeroed [..., k rounded up to ``unit``]
  storage: its rows' stride a multiple of ``unit`` elements, for the wgmma
  forward's tensor maps."""
  k = t.shape[-1]
  storage = t.new_zeros(*t.shape[:-1], k + -k % unit)
  return storage[..., :k].copy_(t)


def _forward_cpu(a, q, scale):
  return int8_weight_matmul_plain(a, q, scale).contiguous()


def _forward_cuda(a, q, scale):
  """Both routes of the forward; :func:`uses_wgmma` picks one from the
  rows, and the wgmma route's :class:`ALayout` of ``a`` is worked out
  here, from its strides."""
  global launches, wgmma_launches
  if a.dtype != torch.bfloat16:
    raise ValueError(f"The CUDA int8 kernel takes bfloat16 activations, got "
                     f"{a.dtype}.")
  m, k = a.shape[1:]
  batches, n = q.shape[:2]
  wgmma = uses_wgmma(m)
  if not wgmma and k % 16:
    # The mma.sync kernel reads whole 16-byte units of a row: zero columns
    # in both operands add nothing to the sums.
    a = torch.nn.functional.pad(a, (0, -k % 16))
    q = torch.nn.functional.pad(q, (0, -k % 16))
    k += -k % 16
  if a.stride(2) != 1 or a.stride(1) % 8 or a.stride(0) % 8:
    a = a.contiguous() if k % 8 == 0 else padded_rows(a, 8)
  if not wgmma:
    q = q.contiguous()
  elif q.stride(2) != 1 or q.stride(1) % 16 or (batches > 1
                                                and q.stride(0) % 16):
    # The tensor map steps through q's rows in place where their stride
    # allows (a depth off 16 stored by padded_rows, as the tensor-parallel
    # towers' int8 pieces are); else a copy that does, made every call.
    q = padded_rows(q, 16)
  scale = scale.float().contiguous()
  for name, t in (("a", a), ("q", q), ("scale", scale)):
    if t.data_ptr() % 16:
      raise ValueError(f"The CUDA int8 kernel needs `{name}` 16-byte "
                       "aligned.")
  y = torch.empty(batches, m, n, dtype=torch.bfloat16, device=a.device)
  stream = torch.cuda.current_stream(a.device).cuda_stream
  if wgmma:
    layout = a_layout(a, batches)
    q_batch = q.stride(0) if batches > 1 else n * q.stride(1)
    fn = _build.function("int8_wgmma", "cg_int8_wgmma_forward",
                         "ppppiiiilllllliip")
    with torch.cuda.device(a.device):
      err = fn(a.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
               batches, m, n, k, *layout.dims[1:], *layout.strides,
               q.stride(1), q_batch, int(layout.heads), int(layout.shared),
               stream)
    wgmma_launches += 1
    if err:
      raise RuntimeError(f"int8_weight_matmul wgmma CUDA kernel failed: "
                         f"cudaError_t {err}.")
    return y
  splits = split_k(batches, m, n, k)
  partial = (torch.empty(splits, batches, m, n, dtype=torch.float32,
                         device=a.device) if splits > 1 else None)
  fn = _build.function("int8_matmul", "cg_int8_weight_matmul",
                       "pppppiiiillip")
  with torch.cuda.device(a.device):
    err = fn(
        a.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(), batches, m, n, k,
        a.stride(0) if a.shape[0] == batches else 0, a.stride(1), splits,
        stream,
    )
  launches += 1
  if err:
    raise RuntimeError(f"int8_weight_matmul CUDA kernel failed: cudaError_t "
                       f"{err}.")
  return y


def _forward_fake(a, q, scale):
  del scale
  return a.new_empty((q.shape[0], a.shape[1], q.shape[1]))


_FORWARD = library.define(
    "int8_weight_matmul(Tensor a, Tensor q, Tensor scale) -> Tensor",
    cpu=_forward_cpu, cuda=_forward_cuda, fake=_forward_fake)


def _aligned(t: torch.Tensor) -> torch.Tensor:
  """``t`` contiguous and 16-byte aligned (a view may start anywhere)."""
  t = t.contiguous()
  return t if t.data_ptr() % 16 == 0 else t.clone()


def _dgrad_cpu(g, q, scale, reduce_batches):
  return int8_weight_matmul_dgrad_plain(g, q, scale,
                                        reduce_batches).contiguous()


def _dgrad_cuda(g, q, scale, reduce_batches):
  global dgrad_wgmma_launches
  if g.dtype != torch.bfloat16:
    raise ValueError(f"The CUDA int8 input-gradient kernel takes a bfloat16 "
                     f"cotangent, got {g.dtype}.")
  batches, m, n = g.shape
  k = q.shape[2]
  if n % 8 or k % 16:
    raise ValueError(f"The CUDA int8 input-gradient kernel needs N a "
                     f"multiple of 8 and K of 16, got N {n}, K {k}.")
  g, q, scale = _aligned(g), _aligned(q), _aligned(scale.float())
  out_batches = 1 if reduce_batches else batches
  out = torch.empty(out_batches, m, k, dtype=torch.bfloat16, device=g.device)
  stream = torch.cuda.current_stream(g.device).cuda_stream
  fn = _build.function("int8_wgmma", "cg_int8_wgmma_dgrad", "ppppiiiiip")
  with torch.cuda.device(g.device):
    err = fn(g.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             batches, m, n, k, int(reduce_batches), stream)
  dgrad_wgmma_launches += 1
  if err:
    raise RuntimeError(f"int8_weight_matmul_dgrad wgmma CUDA kernel failed: "
                       f"cudaError_t {err}.")
  return out


def _dgrad_fake(g, q, scale, reduce_batches):
  del scale
  batches, m, _ = g.shape
  return g.new_empty((1 if reduce_batches else batches, m, q.shape[2]))


_DGRAD = library.define(
    "int8_weight_matmul_dgrad(Tensor g, Tensor q, Tensor scale, "
    "bool reduce_batches) -> Tensor",
    cpu=_dgrad_cpu, cuda=_dgrad_cuda, fake=_dgrad_fake)


def int8_weight_matmul_dgrad(g: torch.Tensor, q: torch.Tensor,
                             scale: torch.Tensor,
                             reduce_batches: bool = False) -> torch.Tensor:
  """The input gradient through its operator: the wgmma kernel for CUDA
  tensors, the plain version for CPU tensors.

  Args:
    g: The cotangent of the product, ``[B, M, N]`` (bfloat16 on the card).
    q: int8 weights ``[B, N, K]``, as the forward took them.
    scale: float32 per-output-channel scales ``[B, N]``.
    reduce_batches: Sum over the batches too (a shared activation).

  Returns:
    ``[B, M, K]`` in ``g.dtype``, contiguous; ``[1, M, K]`` with
    ``reduce_batches``.
  """
  if g.ndim != 3 or tuple(g.shape[::2]) != (q.shape[0], q.shape[1]):
    raise ValueError(f"`g` must be [B, M, N] for q {tuple(q.shape)}, got "
                     f"{tuple(g.shape)}.")
  return _DGRAD(g, q, scale, bool(reduce_batches))


class _Int8WeightMatmul(torch.autograd.Function):
  """The product with a gradient for ``a`` only: the weight and its scale
  are frozen (``requires_grad=False`` parameters)."""

  @staticmethod
  def forward(ctx, a, q, scale):  # pylint: disable=arguments-differ
    ctx.save_for_backward(q, scale)
    ctx.reduce_batches = a.shape[0] == 1 and q.shape[0] > 1
    return _FORWARD(a, q, scale)

  @staticmethod
  def backward(ctx, g):  # pylint: disable=arguments-differ
    q, scale = ctx.saved_tensors
    return int8_weight_matmul_dgrad(g, q, scale, ctx.reduce_batches), None, None


def int8_weight_matmul(a: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
  """The weight-only product: the CUDA kernel on the card, the plain
  version on CPU tensors; differentiable in ``a``.

  Args:
    a: Activations ``[B, M, K]`` (bfloat16 on the card), K contiguous; the
      batch and row strides are free. ``[1, M, K]`` (or batch stride 0)
      shares one activation between the B products.
    q: int8 weights ``[B, N, K]``.
    scale: float32 per-output-channel scales ``[B, N]``.

  Returns:
    ``[B, M, N]`` in ``a.dtype``, contiguous. When autograd records and
    ``a`` requires a gradient, the backward computes it with
    :func:`int8_weight_matmul_dgrad` (summed over the B products for a
    batch-1 ``a``); ``q`` and ``scale`` get none.
  """
  _check(a, q, scale)
  if torch.is_grad_enabled() and a.requires_grad:
    return _Int8WeightMatmul.apply(a, q, scale)
  return _FORWARD(a, q, scale)
