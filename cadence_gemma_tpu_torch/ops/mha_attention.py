"""Bidirectional multi-head flash attention of the vision towers.

Counterpart of the JAX package's ``flash_mha_attention`` with its
``custom_vjp`` (``cadence_gemma_tpu/ops/pallas_attention.py``): the
whole-sequence ``_mha_onepass_kernel`` and the tiled ``_mha_kernel``, which
compute one function and differ only in how much of it fits in a TPU core's
memory. ``csrc/mha_attention.cu`` computes it for any length with an online
softmax over 64-key tiles, so one CUDA kernel replaces both.

Queries, keys and values are ``[b, t, n, h]`` with one key/value head per
query head. Every query sees every key; the only mask is key padding, which
the kernel adds itself. Logits are scaled by ``h ** -0.5`` of the real head
dim; softmax statistics and the accumulator are float32, the unnormalized
probabilities are rounded to the value dtype before ``PV`` (as the Pallas
kernels round them), and the output comes back in ``q.dtype``.

:func:`flash_mha_attention` is differentiable: the towers are frozen in the
reference recipe, so its backward recomputes through :func:`reference_mha`
as ``_mha_bwd`` does. Its forward :func:`mha_attention_forward` launches the
kernel for CUDA tensors and takes :func:`mha_attention_plain` only for CPU
tensors. A kernel that fails to build or launch raises; nothing falls back.
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch import _build

# Kernel launches in this process; callers reset it to count one run.
launches = 0
# Inputs the kernel could not read in place and took as contiguous copies.
strided_copies = 0

KERNEL_HEAD_DIMS = (64, 72)  # DINOv2-L/14 and SigLIP-so400m/14


def mha_attention_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
  """The kernel's arithmetic on the full ``[t, t]`` square.

  float32 logits and softmax statistics; ``exp(s - max)`` rounded to
  ``v.dtype`` before a float32-accumulated ``PV``, divided by the float32
  normalizer, cast to ``q.dtype``.
  """
  head_dim = q.shape[-1]
  logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float())
  logits = logits * (head_dim**-0.5)
  p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
  l = p.sum(dim=-1, keepdim=True)
  out = torch.einsum("bnqk,bknh->bnqh", p.to(v.dtype).float(), v.float()) / l
  return out.transpose(1, 2).to(q.dtype)


def reference_mha(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
  """The einsum formulation of the ViT block (``_reference_mha``): float32
  logits and softmax, probabilities cast to ``q.dtype`` before ``PV``."""
  head_dim = q.shape[-1]
  logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float())
  probs = torch.softmax(logits * (head_dim**-0.5), dim=-1).to(q.dtype)
  return torch.einsum("bnqk,bknh->bqnh", probs, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
  if q.ndim != 4:
    raise ValueError(f"Expected [b, t, n, h] queries, got {tuple(q.shape)}.")
  for name, t in (("k", k), ("v", v)):
    if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
      raise ValueError(
          f"`{name}` must match `q` in shape, dtype and device: "
          f"{tuple(t.shape)} {t.dtype} {t.device} vs {tuple(q.shape)} "
          f"{q.dtype} {q.device}."
      )


def _strided_heads(t: torch.Tensor) -> torch.Tensor:
  """``t`` itself if its heads are dense rows the kernel can read with
  16-byte loads (as the views of a fused qkv projection are), else a
  contiguous copy."""
  global strided_copies
  head_dim, elem = t.shape[-1], t.element_size()
  if not (t.stride(3) == 1 and t.stride(2) == head_dim
          and (t.stride(1) * elem) % 16 == 0
          and (t.stride(0) * elem) % 16 == 0 and t.data_ptr() % 16 == 0):
    t = t.contiguous()
    strided_copies += 1
  if t.data_ptr() % 16:
    raise ValueError("The MHA kernel needs 16-byte aligned tensors.")
  if max(t.stride(0), t.stride(1)) >= 2**31:
    raise ValueError("The MHA kernel takes strides below 2**31 elements.")
  return t


def mha_attention_forward(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
  """The forward: its CUDA kernel on the card, the plain version on CPU.

  ``q``, ``k``, ``v`` are ``[b, t, n, h]``; on the card they may be strided
  views over the token axis (the three thirds of a fused qkv projection).
  Returns contiguous ``[b, t, n, h]`` outputs in ``q.dtype``.
  """
  global launches
  _check(q, k, v)
  if q.device.type == "cpu":
    return mha_attention_plain(q, k, v)
  if q.device.type != "cuda":
    raise ValueError(f"mha_attention runs on CUDA or CPU tensors, not "
                     f"{q.device}.")
  if q.dtype != torch.bfloat16:
    raise ValueError(
        f"The CUDA MHA kernel takes bfloat16, got {q.dtype}; run the towers "
        "in bfloat16 or pass use_flash_attention=False."
    )
  batch, seq_len, num_heads, head_dim = q.shape
  if head_dim not in KERNEL_HEAD_DIMS:
    raise ValueError(f"The CUDA MHA kernel takes head_dim in "
                     f"{KERNEL_HEAD_DIMS}, got {head_dim}.")
  q, k, v = (_strided_heads(t) for t in (q, k, v))
  out = torch.empty(batch, seq_len, num_heads, head_dim, dtype=q.dtype,
                    device=q.device)
  fn = _build.function("mha_attention", "cg_mha_attention_forward",
                       "ppppiiiiiiiiiifp")
  with torch.cuda.device(q.device):
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), batch, seq_len, num_heads, head_dim,
        float(head_dim**-0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
  launches += 1
  if err:
    raise RuntimeError(f"mha_attention CUDA kernel failed: cudaError_t {err}.")
  return out


class _FlashMHA(torch.autograd.Function):
  """``flash_mha_attention``'s ``custom_vjp``: the kernel forward, the
  backward by autograd of :func:`reference_mha` on the saved inputs."""

  @staticmethod
  def forward(ctx, q, k, v):
    ctx.save_for_backward(q, k, v)
    return mha_attention_forward(q, k, v)

  @staticmethod
  def backward(ctx, g):
    q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
    with torch.enable_grad():
      out = reference_mha(q, k, v)
    return torch.autograd.grad(out, (q, k, v), g)


def flash_mha_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
  """Differentiable bidirectional MHA: the kernel on the card, plain on CPU.

  Args:
    q, k, v: ``[b, t, n, h]`` per-head queries, keys and values; any ``t``.

  Returns:
    ``[b, t, n, h]`` attention outputs in ``q.dtype``.
  """
  return _FlashMHA.apply(q, k, v)
