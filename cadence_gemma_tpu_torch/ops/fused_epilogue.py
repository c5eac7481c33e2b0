"""Fused residual add + RMSNorm: the CUDA kernel, its plain version, autograd.

Counterpart of the JAX package's ``fused_add_rmsnorm`` with its
``custom_vjp`` (``cadence_gemma_tpu/ops/fused_epilogue.py``)::

    y      = x + residual                 (new residual, input dtype)
    normed = y * rsqrt(mean_f32(y^2) + eps) * (scale + 1)

The mean of squares and the gain are float32 even for bfloat16 inputs (the
unfused ``RMSNorm`` reduces in the activation dtype); ``normed`` comes back
in the input dtype.

:func:`fused_add_rmsnorm` is differentiable: its backward recomputes
through :func:`reference_add_rmsnorm` as ``_bwd`` does. Its forward
:func:`add_rmsnorm_forward` launches ``csrc/add_rmsnorm.cu`` for CUDA
tensors and takes the plain version only for CPU tensors. A kernel that
fails to build or launch raises; nothing falls back.
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch import _build

# Kernel launches in this process; callers reset it to count one run.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_add_rmsnorm(
    x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The unfused composition with the kernel's float32 accumulation."""
  y = x + residual
  yf = y.float()
  var = yf.square().mean(dim=-1, keepdim=True)
  normed = yf * torch.rsqrt(var + eps) * (scale.float() + 1.0)
  return y, normed.to(x.dtype)


def add_rmsnorm_forward(
    x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The forward: its CUDA kernel on the card, the plain version on CPU.

  ``x`` and ``residual`` are ``[..., width]`` of one dtype; ``scale`` is
  ``[width]``. Returns ``(y, normed)`` in ``x.dtype``.
  """
  global launches
  width = x.shape[-1]
  if residual.shape != x.shape or residual.dtype != x.dtype:
    raise ValueError(f"`residual` must match `x`: {tuple(residual.shape)} "
                     f"{residual.dtype} vs {tuple(x.shape)} {x.dtype}.")
  if scale.shape != (width,):
    raise ValueError(f"`scale` must be [{width}], got {tuple(scale.shape)}.")
  if x.device.type == "cpu":
    return reference_add_rmsnorm(x, residual, scale, eps)
  if x.device.type != "cuda":
    raise ValueError(f"add_rmsnorm runs on CUDA or CPU tensors, not "
                     f"{x.device}.")
  if x.dtype not in _DTYPE_CODES:
    raise ValueError(f"The CUDA add_rmsnorm kernel takes float32 or bfloat16, "
                     f"got {x.dtype}.")
  if (width * x.element_size()) % 16:
    raise ValueError(f"The CUDA add_rmsnorm kernel needs rows of a multiple "
                     f"of 16 bytes, got width {width} of {x.dtype}.")
  x, residual = x.contiguous(), residual.contiguous()
  scale = scale.to(x.dtype).contiguous()
  for t in (x, residual, scale):
    if t.data_ptr() % 16:
      raise ValueError("The add_rmsnorm kernel needs 16-byte alignment.")
  y = torch.empty_like(x)
  normed = torch.empty_like(x)
  fn = _build.function("add_rmsnorm", "cg_add_rmsnorm", "pppppiiifp")
  with torch.cuda.device(x.device):
    err = fn(
        x.data_ptr(), residual.data_ptr(), scale.data_ptr(), y.data_ptr(),
        normed.data_ptr(), x.numel() // width, width, _DTYPE_CODES[x.dtype],
        float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
  launches += 1
  if err:
    raise RuntimeError(f"add_rmsnorm CUDA kernel failed: cudaError_t {err}.")
  return y, normed


class _FusedAddRMSNorm(torch.autograd.Function):
  """``fused_add_rmsnorm``'s ``custom_vjp``: the kernel forward, the
  backward by autograd of :func:`reference_add_rmsnorm`."""

  @staticmethod
  def forward(ctx, x, residual, scale, eps):
    ctx.save_for_backward(x, residual, scale)
    ctx.eps = eps
    return add_rmsnorm_forward(x, residual, scale, eps)

  @staticmethod
  def backward(ctx, dy, dnormed):
    inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
    with torch.enable_grad():
      outs = reference_add_rmsnorm(*inputs, ctx.eps)
    grads = torch.autograd.grad(outs, inputs, (dy, dnormed))
    return (*grads, None)


def fused_add_rmsnorm(
    x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
  """``(x + residual, rmsnorm(x + residual) * (scale + 1))`` in one pass.

  Args:
    x: ``[..., width]`` activations.
    residual: The residual stream, like ``x``.
    scale: ``[width]`` RMSNorm gain (the ``+ 1`` is applied here).
    eps: Variance epsilon.

  Returns:
    ``(y, normed)``: the new residual stream and the normed MLP input, both
    in ``x.dtype``.
  """
  return _FusedAddRMSNorm.apply(x, residual, scale, eps)
