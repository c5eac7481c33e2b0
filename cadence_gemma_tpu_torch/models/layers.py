"""Primitive layers: Dense, RMSNorm, block-diagonal linear, RG-LRU, Conv1D.

Counterparts of the JAX package's ``cadence_gemma_tpu/models/layers.py``
with the same parameter names (``scale``, ``kernel``/``bias``, ``w``/``b``,
``a_param``, ``input_gate``/``a_gate``), so ``convert.py`` carries a flax
tree across leaf by leaf. Only ``Dense.kernel`` changes layout: PyTorch's
``[out, in]`` instead of flax's ``[in, out]``.

Modules allocate their parameters uninitialized; ``Griffin`` fills them from
an explicit ``torch.Generator`` or ``convert.py`` loads them.

Numerics follow the JAX layers: RMSNorm's ``(scale + 1)`` gain, the RG-LRU's
``log_a = -8 * sigmoid(W_a x) * softplus(a_param)`` with a float32 carry and
``a`` zeroed at document starts, and the document-masked causal Conv1D.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.ops import fused_epilogue
from cadence_gemma_tpu_torch.ops import scan
from cadence_gemma_tpu_torch.parallel import sharding


def gelu(x: torch.Tensor) -> torch.Tensor:
  """tanh-approximated GeLU, matching ``jax.nn.gelu``'s default."""
  return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
  """A linear layer with flax's parameter names.

  ``kernel`` is stored ``[out, in]`` (PyTorch's layout; flax keeps
  ``[in, out]``) so the forward is one ``F.linear``. Parameters are cast to
  the input's dtype, as flax's ``Dense(dtype=...)`` casts them (the vision
  towers keep float32 weights and compute in bfloat16).
  """

  def __init__(self, in_features: int, out_features: int,
               use_bias: bool = True, device=None, dtype=None):
    super().__init__()
    kw = dict(device=device, dtype=dtype)
    self.kernel = nn.Parameter(torch.empty(out_features, in_features, **kw))
    self.bias = (
        nn.Parameter(torch.empty(out_features, **kw)) if use_bias else None
    )

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    bias = None if self.bias is None else self.bias.to(x.dtype)
    return F.linear(x, self.kernel.to(x.dtype), bias)


class RMSNorm(nn.Module):
  """Root-mean-square normalization with a ``(scale + 1)`` learned gain.

  With ``residual`` given, the preceding residual add is fused into the norm
  (:func:`fused_epilogue.fused_add_rmsnorm`, a CUDA kernel on the card) and
  the call returns ``(normed, y)`` where ``y = x + residual`` is the new
  residual stream. That path accumulates the mean of squares in float32; the
  plain path reduces in the activation dtype, as the JAX layer does.
  """

  def __init__(self, width: int, eps: float = 1e-6, device=None, dtype=None):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.empty(width, device=device, dtype=dtype))

  def forward(
      self, x: torch.Tensor, residual: torch.Tensor | None = None
  ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    if residual is not None:
      y, normed = fused_epilogue.fused_add_rmsnorm(
          x, residual, self.scale, self.eps
      )
      return normed, y
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + self.eps) * (self.scale + 1)


class BlockDiagonalLinear(nn.Module):
  """Per-head block-diagonal projection used by the RG-LRU gates."""

  def __init__(self, width: int, num_blocks: int, device=None, dtype=None):
    super().__init__()
    if width % num_blocks:
      raise ValueError(f"width {width} is not a multiple of {num_blocks}.")
    self.num_blocks = num_blocks
    block = width // num_blocks
    kw = dict(device=device, dtype=dtype)
    self.w = nn.Parameter(torch.empty(num_blocks, block, block, **kw))
    self.b = nn.Parameter(torch.empty(num_blocks, block, **kw))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.unflatten(-1, (self.num_blocks, -1))
    y = torch.einsum("...hi,hij->...hj", x, self.w) + self.b
    return y.flatten(-2)


class _SqrtBoundDerivative(torch.autograd.Function):
  """``sqrt`` whose backward evaluates the derivative at
  ``max(x, 1 / (4 max_gradient^2))``, as the JAX ``custom_vjp`` does."""

  @staticmethod
  def forward(ctx, x, max_gradient):
    ctx.save_for_backward(x)
    ctx.max_gradient = max_gradient
    return torch.sqrt(x)

  @staticmethod
  def backward(ctx, g):
    (x,) = ctx.saved_tensors
    x_clamped = torch.clamp_min(x, 1.0 / (4.0 * ctx.max_gradient**2))
    return g * 0.5 * torch.rsqrt(x_clamped), None


def sqrt_bound_derivative(x: torch.Tensor, max_gradient: float) -> torch.Tensor:
  """``sqrt(x)`` whose gradient is clamped to ``max_gradient``.

  Near x=0 the true derivative 1/(2 sqrt x) explodes and produces NaNs in
  bfloat16 training; the backward evaluates it at
  ``max(x, 1 / (4 max_gradient^2))`` instead.
  """
  return _SqrtBoundDerivative.apply(x, max_gradient)


class RGLRU(nn.Module):
  """Real-Gated Linear Recurrent Unit (arXiv:2402.19427, section 2.4).

  ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (x_t * sigmoid(W_x x_t))`` with
  ``a_t = exp(-8 sigmoid(W_a x_t) softplus(a_param))``; the state resets at
  ``segment_pos == 0``. The scan goes through :func:`scan.linear_scan`,
  which launches the CUDA kernels on the card (the forward scan, and the
  cotangent scan in the backward); with ``scan_sharding_spec`` it runs
  sequence-parallel over the spec's mesh (``layers.py:437-443`` in JAX).
  """

  def __init__(
      self,
      width: int,
      num_heads: int,
      scan_type: common.ScanType = common.ScanType.AUTO,
      scan_sharding_spec: sharding.ShardingSpec | None = None,
      device=None,
      dtype=None,
  ):
    super().__init__()
    self.scan_type = scan_type
    self.scan_sharding_spec = scan_sharding_spec
    self.a_param = nn.Parameter(torch.empty(width, device=device, dtype=dtype))
    self.input_gate = BlockDiagonalLinear(
        width, num_heads, device=device, dtype=dtype
    )
    self.a_gate = BlockDiagonalLinear(
        width, num_heads, device=device, dtype=dtype
    )

  def forward(
      self,
      x: torch.Tensor,
      segment_pos: torch.Tensor,
      cache: torch.Tensor | None = None,
      return_cache: bool = True,
  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Runs the RG-LRU over ``x``; returns outputs and the final fp32 state."""
    reset = (segment_pos == 0)[..., None]

    gate_x = torch.sigmoid(self.input_gate(x))
    gate_a = torch.sigmoid(self.a_gate(x))

    log_a = -8.0 * gate_a * F.softplus(self.a_param)
    a = torch.exp(log_a)
    a_squared = torch.exp(2.0 * log_a)

    gated_x = x * gate_x
    # Gamma normalization; at document starts the multiplier is 1.
    multiplier = sqrt_bound_derivative(1 - a_squared, 1000)
    multiplier = torch.where(reset, torch.ones_like(multiplier), multiplier)
    normed_x = gated_x * multiplier

    y, h_last = scan.linear_scan(
        x=normed_x,
        a=torch.where(reset, torch.zeros_like(a), a),
        h0=cache,
        scan_type=self.scan_type,
        sharding_spec=self.scan_sharding_spec,
    )
    return y, (h_last if return_cache else None)

  @staticmethod
  def init_cache(batch_size: int, width: int, device=None) -> torch.Tensor:
    """Empty recurrent state -- always float32."""
    return torch.zeros(batch_size, width, dtype=torch.float32, device=device)


class Conv1D(nn.Module):
  """Causal depthwise temporal convolution with document masking.

  ``temporal_width`` shift-and-scale accumulations, so decode reduces to a
  stencil over the cached ``temporal_width - 1`` inputs and the per-shift
  document mask (no mixing across ``segment_pos == 0``) stays elementwise.
  """

  def __init__(self, width: int, temporal_width: int, device=None,
               dtype=None):
    super().__init__()
    self.temporal_width = temporal_width
    kw = dict(device=device, dtype=dtype)
    self.w = nn.Parameter(torch.empty(temporal_width, width, **kw))
    self.b = nn.Parameter(torch.empty(width, **kw))

  def forward(
      self,
      x: torch.Tensor,
      segment_pos: torch.Tensor,
      cache: torch.Tensor | None = None,
      return_cache: bool = True,
  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    output_len = x.shape[1]
    if cache is not None:
      # Decode / chunked prefill: the previous temporal_width - 1 inputs.
      state_dtype = cache.dtype
      prompt_len = self.temporal_width - 1
      x = torch.cat([cache.to(x.dtype), x], dim=1)
    else:
      state_dtype = x.dtype
      prompt_len = 0

    out = self.b.expand(x.shape[0], output_len, -1)
    effective_width = min(self.temporal_width, prompt_len + output_len)
    for shift in range(effective_width):
      start = max(prompt_len - shift, 0)
      end = prompt_len + output_len - shift
      window = x[:, start:end]
      if cache is None and shift > 0:
        # A source token `shift` steps back contributes only if no document
        # boundary lies between it and the query.
        not_boundary = (segment_pos != 0).to(x.dtype)
        mask = torch.ones_like(window[..., 0])
        for look_ahead in range(1, shift + 1):
          mask = mask * not_boundary[:, start + look_ahead:end + look_ahead]
        window = window * mask[..., None]
      elif cache is not None and output_len > 1 and shift > 0:
        # Chunked prefill continues one document per row, so "no boundary in
        # between" reduces to "the source is at a non-negative position";
        # this keeps cached padding out of a left-padded row's first chunk.
        valid = (segment_pos - shift >= 0).to(x.dtype)
        window = window * valid[..., None]
      if window.shape[1] < output_len:
        window = F.pad(window, (0, 0, output_len - window.shape[1], 0))
      out = out + window * self.w[self.temporal_width - shift - 1]

    if not return_cache:
      return out, None
    new_cache = x[:, 1 - self.temporal_width:].to(state_dtype)
    missing = self.temporal_width - 1 - new_cache.shape[1]
    if missing > 0:
      new_cache = F.pad(new_cache, (0, 0, missing, 0))
    return out, new_cache

  @staticmethod
  def init_cache(batch_size: int, width: int, dtype, temporal_width: int = 4,
                 device=None) -> torch.Tensor:
    return torch.zeros(
        batch_size, temporal_width - 1, width, dtype=dtype, device=device
    )


class Einsum(nn.Module):
  """A parameterized einsum with bias (the fused MLP up-projection)."""

  def __init__(self, w_shape, b_shape, eqn: str, device=None, dtype=None):
    super().__init__()
    self.eqn = eqn
    kw = dict(device=device, dtype=dtype)
    self.w = nn.Parameter(torch.empty(*w_shape, **kw))
    self.b = nn.Parameter(torch.empty(*b_shape, **kw))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum(self.eqn, x, self.w) + self.b
