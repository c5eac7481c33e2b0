"""Primitive layers: Dense, RMSNorm, block-diagonal linear, RG-LRU, Conv1D.

Counterparts of the JAX package's ``cadence_gemma_tpu/models/layers.py``
with the same parameter names (``scale``, ``kernel``/``bias``, ``w``/``b``,
``a_param``, ``input_gate``/``a_gate``), so ``convert.py`` carries a flax
tree across leaf by leaf. Only ``Dense.kernel`` changes layout: PyTorch's
``[out, in]`` instead of flax's ``[in, out]``.

Modules allocate their parameters uninitialized; ``Griffin`` fills them from
an explicit ``torch.Generator`` or ``convert.py`` loads them.

``quantized=True`` layers hold int8 weights (``kernel_q`` / ``w_q``, stored
contraction-last) and float32 per-output-channel scales (``kernel_scale`` /
``w_scale``), as :func:`ops.quantization.quantize_params` makes them, and
contract through the CUDA kernel of :mod:`ops.int8_matmul` on the card.
``act_quant=True`` (``Dense`` and ``Einsum``) also quantizes the activations
per row and contracts int8 x int8 into int32
(:func:`ops.quantization.int8_act_matmul`). The roundings follow JAX's
order: weight-only, the product in the compute dtype, times the scale in
the compute dtype, plus the bias in the compute dtype; ``act_quant``, the
int32 product times the activation scale times the weight scale in float32,
then the bias (in float32 in ``Einsum``, after the cast in ``Dense``).
The weight-only product has a gradient for its input (a second CUDA
kernel), so a quantized model back-propagates to adapters upstream of it;
``act_quant`` has none (``torch._int_mm``) and refuses a gradient.

``lora_rank > 0`` (``Dense`` and ``Einsum``) adds a LoRA adapter pair,
``lora_a`` drawn normal(fan_in^-0.5) and ``lora_b`` zero, and adds
``((x @ a) @ b) * alpha / r`` (``alpha`` is ``lora_alpha``, the rank when
``None``; 0.0 nulls the term) in the compute dtype, over a
bf16 base or a ``quantized`` one (JAX's ``lora_term``,
``layers.py:108-140``). The adapters keep flax's layouts: ``Dense``
``lora_a`` ``[in, r]`` and ``lora_b`` ``[r, out]`` (not transposed as
``kernel`` is), ``Einsum`` ``[c, d, r]`` and ``[c, r, D]``, one pair per
leading index. ``lora_rows = R`` (multi-LoRA serving, JAX
``layers.py:61-68,127-140``) stacks the pair per batch row, ``lora_a``
``[R, ...]`` and ``lora_b`` ``[R, ...]``: batch row i contracts against
adapter row i. The base product stays one product over every row; only the
rank-r hop is batched, and an all-zero row gives the base model's output
exactly, so empty serving slots need no mask.

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
from cadence_gemma_tpu_torch.ops import int8_matmul
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import quantization
from cadence_gemma_tpu_torch.ops import scan
from cadence_gemma_tpu_torch.parallel import sharding


def gelu(x: torch.Tensor) -> torch.Tensor:
  """tanh-approximated GeLU, matching ``jax.nn.gelu``'s default."""
  return F.gelu(x, approximate="tanh")


def _check_quant_flags(quantized: bool, act_quant: bool) -> None:
  if act_quant and not quantized:
    raise ValueError("act_quant=True requires quantized=True (it contracts "
                     "against the int8 weights).")


def _refuse_act_quant_gradient(*tensors) -> None:
  if torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in tensors):
    raise ValueError(
        "act_quant has no gradient (torch._int_mm); train a quantized model "
        "weight-only (act_quant=False), as JAX's LoRA does.")


LORA_LEAF_NAMES = ("lora_a", "lora_b")


@torch.no_grad()
def init_lora_(name: str, p: torch.Tensor,
               generator: torch.Generator) -> None:
  """Draws the adapter leaf ``name`` in place as JAX's initializers do:
  ``lora_a`` (its input axis second to last) normal(fan_in^-0.5),
  ``lora_b`` zeros."""
  if name.rsplit(".", 1)[-1] == "lora_b":
    p.zero_()
  else:
    p.normal_(0.0, p.shape[-2] ** -0.5, generator=generator)


class _LoRA:
  """The adapter pair of ``Dense`` and ``Einsum`` (JAX's ``lora_term``)."""

  def _init_lora(self, lora_rank: int, lora_alpha: float | None,
                 a_shape, b_shape, device, dtype, lora_rows: int = 0) -> None:
    self.lora_rank = lora_rank
    self.lora_alpha = lora_alpha
    self.lora_rows = lora_rows
    if not lora_rank:
      self.lora_a = self.lora_b = None
      return
    kw = dict(device=device, dtype=dtype)
    rows = (lora_rows,) if lora_rows else ()
    self.lora_a = nn.Parameter(torch.empty(*rows, *a_shape, **kw))
    self.lora_b = nn.Parameter(torch.empty(*rows, *b_shape, **kw))

  def _check_rows(self, x: torch.Tensor) -> None:
    if x.shape[0] != self.lora_rows:
      raise ValueError(f"lora_rows={self.lora_rows} adapters take a batch of "
                       f"that many rows; got {tuple(x.shape)}.")

  @property
  def lora_scaling(self) -> float:
    alpha = (self.lora_alpha if self.lora_alpha is not None
             else float(self.lora_rank))
    return alpha / self.lora_rank


class Dense(nn.Module, _LoRA):
  """A linear layer with flax's parameter names.

  ``kernel`` is stored ``[out, in]`` (PyTorch's layout; flax keeps
  ``[in, out]``) so the forward is one ``F.linear``. Parameters are cast to
  the input's dtype, as flax's ``Dense(dtype=...)`` casts them (the vision
  towers keep float32 weights and compute in bfloat16).

  ``quantized=True`` holds ``kernel_q`` (int8 ``[out, in]``) and
  ``kernel_scale`` (float32 ``[out]``) instead of ``kernel``, the
  ``QuantizableDense`` of JAX; ``act_quant=True`` also quantizes the input
  per row (see the module docstring for both). ``lora_rank > 0`` adds
  ``lora_a`` ``[in, r]`` and ``lora_b`` ``[r, out]`` (flax's layouts);
  ``lora_rows = R`` stacks them ``[R, in, r]`` and ``[R, r, out]``, one
  pair a batch row.
  """

  def __init__(self, in_features: int, out_features: int,
               use_bias: bool = True, device=None, dtype=None,
               quantized: bool = False, act_quant: bool = False,
               lora_rank: int = 0, lora_rows: int = 0,
               lora_alpha: float | None = None):
    super().__init__()
    _check_quant_flags(quantized, act_quant)
    self.quantized = quantized
    self.act_quant = act_quant
    kw = dict(device=device, dtype=dtype)
    if quantized:
      self.kernel_q = nn.Parameter(
          torch.empty(out_features, in_features, device=device,
                      dtype=torch.int8), requires_grad=False)
      self.kernel_scale = nn.Parameter(
          torch.empty(out_features, device=device, dtype=torch.float32),
          requires_grad=False)
    else:
      self.kernel = nn.Parameter(torch.empty(out_features, in_features, **kw))
    self.bias = (
        nn.Parameter(torch.empty(out_features, **kw)) if use_bias else None
    )
    self._init_lora(lora_rank, lora_alpha, (in_features, lora_rank),
                    (lora_rank, out_features), device, dtype, lora_rows)

  def _lora_term(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    a, b = self.lora_a.to(dtype), self.lora_b.to(dtype)
    if not self.lora_rows:
      return ((x.to(dtype) @ a) @ b) * self.lora_scaling
    # Batch row i against adapter row i (JAX's vmap): [R, tokens, in].
    self._check_rows(x)
    rows = x.to(dtype).reshape(self.lora_rows, -1, x.shape[-1])
    return ((rows @ a) @ b).view(*x.shape[:-1], -1) * self.lora_scaling

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    bias = None if self.bias is None else self.bias.to(x.dtype)
    if not self.quantized:
      if not self.lora_rank:
        return F.linear(x, self.kernel.to(x.dtype), bias)
      y = F.linear(x, self.kernel.to(x.dtype))
      y = y + self._lora_term(x, y.dtype)
      return y if bias is None else y + bias
    lead, n = x.shape[:-1], self.kernel_q.shape[0]
    if self.act_quant:
      _refuse_act_quant_gradient(x, self.lora_a, self.lora_b)
      xq, x_scale = quantization.quantize_activations(x)
      y = quantization.int8_act_matmul(xq.reshape(-1, x.shape[-1]),
                                       self.kernel_q).view(*lead, n)
      y = (y.float() * x_scale * self.kernel_scale).to(x.dtype)
    else:
      y = int8_matmul.int8_weight_matmul(
          x.reshape(1, -1, x.shape[-1]), self.kernel_q[None],
          self.kernel_scale[None],
      ).view(*lead, n)
    if self.lora_rank:
      y = y + self._lora_term(x, y.dtype)
    return y if bias is None else y + bias


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
  """Per-head block-diagonal projection used by the RG-LRU gates.

  ``quantized=True`` holds ``w_q`` (int8, stored ``(h, j, i)``, the
  contraction axis last) and ``w_scale`` (float32 ``(h, j)``) instead of
  ``w`` ``(h, i, j)``; the heads run as one batched launch of the int8
  kernel that reads each head's slice of the input in place.
  """

  def __init__(self, width: int, num_blocks: int, device=None, dtype=None,
               quantized: bool = False):
    super().__init__()
    if width % num_blocks:
      raise ValueError(f"width {width} is not a multiple of {num_blocks}.")
    self.num_blocks = num_blocks
    self.quantized = quantized
    block = width // num_blocks
    kw = dict(device=device, dtype=dtype)
    if quantized:
      self.w_q = nn.Parameter(
          torch.empty(num_blocks, block, block, device=device,
                      dtype=torch.int8), requires_grad=False)
      self.w_scale = nn.Parameter(
          torch.empty(num_blocks, block, device=device, dtype=torch.float32),
          requires_grad=False)
    else:
      self.w = nn.Parameter(torch.empty(num_blocks, block, block, **kw))
    self.b = nn.Parameter(torch.empty(num_blocks, block, **kw))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.unflatten(-1, (self.num_blocks, -1))
    if not self.quantized:
      y = torch.einsum("...hi,hij->...hj", x, self.w) + self.b
      return y.flatten(-2)
    lead = x.shape[:-2]
    # [h, rows, i]: batch stride i, row stride h * i, read in place.
    a = x.reshape(-1, *x.shape[-2:]).transpose(0, 1)
    y = int8_matmul.int8_weight_matmul(a, self.w_q, self.w_scale)
    y = y + self.b.to(y.dtype)[:, None, :]
    return y.transpose(0, 1).reshape(*lead, -1)


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
      quantized: bool = False,
  ):
    super().__init__()
    self.scan_type = scan_type
    self.scan_sharding_spec = scan_sharding_spec
    self.a_param = nn.Parameter(torch.empty(width, device=device, dtype=dtype))
    self.input_gate = BlockDiagonalLinear(
        width, num_heads, device=device, dtype=dtype, quantized=quantized
    )
    self.a_gate = BlockDiagonalLinear(
        width, num_heads, device=device, dtype=dtype, quantized=quantized
    )

  def forward(
      self,
      x: torch.Tensor,
      segment_pos: torch.Tensor,
      cache: torch.Tensor | None = None,
      return_cache: bool = True,
      pending_cache: bool = False,
  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Runs the RG-LRU over ``x``; returns outputs and the final fp32 state.

    ``pending_cache`` returns the per-step fp32 states ``[b, t, d]`` instead
    of the final one (``layers.py:390-444`` in JAX): the speculative verify
    commits the state at the accepted draft index
    (``modules.commit_pending_cache``). The scan is then
    :func:`lru_scan.lru_scan_carries` whatever ``scan_type`` says, the
    forward kernel with float32 outputs on the card, so the states are the
    carries plain decode would have produced.
    """
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
    a = torch.where(reset, torch.zeros_like(a), a)

    if pending_cache:
      y_acc, _ = lru_scan.lru_scan_carries(normed_x, a, cache)
      return y_acc.to(x.dtype), (y_acc if return_cache else None)
    y, h_last = scan.linear_scan(
        x=normed_x,
        a=a,
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
      pending_cache: bool = False,
  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The convolution over ``x`` and the new tail of inputs.

    ``pending_cache`` (speculative verify, needs ``cache``) returns the whole
    ``[old tail | chunk inputs]`` in the state dtype instead of the tail:
    ``modules.commit_pending_cache`` slices the ``temporal_width - 1``
    inputs that end at the accepted index, which may reach back into the
    old tail (``layers.py:538-545`` in JAX).
    """
    if pending_cache and cache is None:
      raise ValueError("pending_cache needs a cache (decode mode).")
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
    if pending_cache:
      return out, x.to(state_dtype)
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


class Einsum(nn.Module, _LoRA):
  """A parameterized einsum with bias (the fused MLP up-projection).

  ``quantized=True`` (the 3-D ``(c, d, D)`` layout contracting axis 1)
  holds ``w_q`` (int8, stored ``(c, D, d)``) and ``w_scale`` (float32
  ``(c, D)``) instead of ``w``; the ``c`` projections of the shared input
  run as one batched launch of the int8 kernel, or with ``act_quant`` as one
  int8 x int8 product of width ``c * D``.

  ``lora_rank > 0`` (the 3-D layout only) adds one adapter pair per leading
  index, ``lora_a`` ``[c, d, r]`` and ``lora_b`` ``[c, r, D]`` (flax's
  layouts): the low-rank hop reuses ``eqn`` with ``D -> r``. ``lora_rows =
  R`` stacks them ``[R, c, d, r]`` and ``[R, c, r, D]``, batch row i
  against adapter row i (the output's batch axis is its second).
  """

  def __init__(self, w_shape, b_shape, eqn: str, device=None, dtype=None,
               quantized: bool = False, act_quant: bool = False,
               lora_rank: int = 0, lora_rows: int = 0,
               lora_alpha: float | None = None):
    super().__init__()
    _check_quant_flags(quantized, act_quant)
    if lora_rank and len(w_shape) != 3:
      raise ValueError(f"Einsum LoRA supports the fused (c, d, D) layout "
                       f"only; got {tuple(w_shape)}.")
    self.eqn = eqn
    self.quantized = quantized
    self.act_quant = act_quant
    kw = dict(device=device, dtype=dtype)
    if quantized:
      if len(w_shape) != 3:
        raise ValueError(f"A quantized Einsum takes a 3-D (c, d, D) weight, "
                         f"got {tuple(w_shape)}.")
      c, d, out = w_shape
      self.w_q = nn.Parameter(
          torch.empty(c, out, d, device=device, dtype=torch.int8),
          requires_grad=False)
      self.w_scale = nn.Parameter(
          torch.empty(c, out, device=device, dtype=torch.float32),
          requires_grad=False)
    else:
      self.w = nn.Parameter(torch.empty(*w_shape, **kw))
    self.b = nn.Parameter(torch.empty(*b_shape, **kw))
    if lora_rank:
      c, d, out = w_shape
      self._init_lora(lora_rank, lora_alpha, (c, d, lora_rank),
                      (c, lora_rank, out), device, dtype, lora_rows)
    else:
      self._init_lora(0, lora_alpha, None, None, device, dtype)

  def _lora_term(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    a, b = self.lora_a.to(dtype), self.lora_b.to(dtype)
    if not self.lora_rows:
      xa = torch.einsum(self.eqn, x.to(dtype), a)
      return torch.einsum("g...r,grD->g...D", xa, b) * self.lora_scaling
    # Both of the model's equations contract x's last axis with the
    # weight's second and put the projection index first: row by row that
    # is ``eqn``, and the output keeps the batch as its second axis.
    self._check_rows(x)
    xa = torch.einsum("n...d,ngdr->gn...r", x.to(dtype), a)
    return torch.einsum("gn...r,ngrD->gn...D", xa, b) * self.lora_scaling

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if not self.quantized:
      y = torch.einsum(self.eqn, x, self.w)
      if self.lora_rank:
        y = y + self._lora_term(x, y.dtype)
      return y + self.b
    c, out, d = self.w_q.shape
    lead = x.shape[:-1]
    # The output is c...tD; the scale broadcasts as (c, 1, ..., 1, D).
    scale = self.w_scale.view(c, *([1] * len(lead)), out)
    if self.act_quant:
      _refuse_act_quant_gradient(x, self.lora_a, self.lora_b)
      xq, x_scale = quantization.quantize_activations(x)
      y = quantization.int8_act_matmul(xq.reshape(-1, d),
                                       self.w_q.reshape(c * out, d))
      y = y.view(-1, c, out).transpose(0, 1).reshape(c, *lead, out)
      y = y.float() * x_scale * scale
      if self.lora_rank:
        y = y + self._lora_term(x, x.dtype).float()
      return (y + self.b.float()).to(x.dtype)
    # One activation for the c products: its gradient sums over them.
    y = int8_matmul.int8_weight_matmul(x.reshape(1, -1, d), self.w_q,
                                       self.w_scale).view(c, *lead, out)
    if self.lora_rank:
      y = y + self._lora_term(x, y.dtype)
    return y + self.b.to(y.dtype)
