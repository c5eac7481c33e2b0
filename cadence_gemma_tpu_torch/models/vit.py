"""The vision towers: SigLIP-so400m and DINOv2-L(reg4) ViTs, fused encoder.

Counterpart of the JAX package's ``cadence_gemma_tpu/models/vit.py``, with
its parameter names (``patch_embed``, ``pos_embed``, ``prefix_tokens``,
``block{i}`` holding ``norm1``, ``attn_qkv``, ``attn_proj``, ``ls1``,
``norm2``, ``mlp_fc1``, ``mlp_fc2``, ``ls2``), so ``convert.py`` carries a
flax tree across leaf by leaf. Both towers run at 384x384 with patch 14
(27 x 27 = 729 patches), up to block 22, and the encoder concatenates their
un-normed patch tokens DINO first: ``[b, 729, 1024 + 1152 = 2176]``.

As in JAX, parameters are kept in ``param_dtype`` (float32) and every
matrix product runs in ``dtype`` (bfloat16): weights are cast at use, and
the LayerNorms compute their statistics and affine map in float32 with
flax's ``E[x^2] - E[x]^2`` variance. The attention runs through the CUDA
MHA kernel on the card (``use_flash_attention=None``) and through the
einsum, with the token count padded to a multiple of ``pad_tokens_to`` and
the padded keys masked, on the CPU. ``quantized`` towers hold int8 weights
in every ``Dense`` (the patch embedding's convolution stays float), and
``act_quant`` also quantizes their activations (``vit.py:127-194,225-228``
in JAX); ``softmax_bf16`` keeps the einsum path's logits in bfloat16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.models import layers
from cadence_gemma_tpu_torch.ops import mha_attention

# Preprocessing constants (timm data configs for the two models).
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
DINO_MEAN = (0.485, 0.456, 0.406)
DINO_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
  """Architecture of one tower (timm-compatible)."""

  embed_dim: int
  depth: int
  num_heads: int
  mlp_hidden_dim: int
  patch_size: int = 14
  image_size: int = 384
  num_prefix_tokens: int = 0   # cls + register tokens
  use_layer_scale: bool = False
  output_layer: int | None = None  # block index whose output is returned
  # SigLIP was trained with tanh-approximated GELU, DINOv2 with exact GELU.
  gelu_approximate: bool = False

  @property
  def grid(self) -> int:
    return self.image_size // self.patch_size

  @property
  def num_patches(self) -> int:
    return self.grid * self.grid

  @property
  def last_block(self) -> int:
    return self.depth - 1 if self.output_layer is None else self.output_layer


# Block 22 of both towers, as the reference reads it (the index is computed
# from the DINO tower for both: 22 of 24 and of 27).
SIGLIP_SO400M_384 = ViTConfig(
    embed_dim=1152,
    depth=27,
    num_heads=16,
    mlp_hidden_dim=4304,
    num_prefix_tokens=0,
    use_layer_scale=False,
    output_layer=22,
    gelu_approximate=True,
)
DINOV2_LARGE_REG4_384 = ViTConfig(
    embed_dim=1024,
    depth=24,
    num_heads=16,
    mlp_hidden_dim=4096,
    num_prefix_tokens=5,  # 1 cls + 4 registers
    use_layer_scale=True,
    output_layer=22,
)


def _use_flash(override: bool | None, device: torch.device) -> bool:
  """``None``: the CUDA kernel on the card, the einsum on the CPU."""
  return override if override is not None else device.type == "cuda"


class LayerNorm(nn.Module):
  """flax's ``LayerNorm``: float32 statistics by ``E[x^2] - E[x]^2``, the
  affine map in float32, the result in the input dtype."""

  def __init__(self, width: int, eps: float = 1e-6, device=None, dtype=None):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.empty(width, device=device, dtype=dtype))
    self.bias = nn.Parameter(torch.empty(width, device=device, dtype=dtype))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0)
    mul = torch.rsqrt(var + self.eps) * self.scale.float()
    return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class PatchEmbed(nn.Module):
  """The patch embedding: a patch-sized strided convolution (``kernel``
  ``[d, 3, p, p]``, PyTorch's OIHW; flax keeps HWIO)."""

  def __init__(self, patch_size: int, embed_dim: int, device=None,
               dtype=None):
    super().__init__()
    self.patch_size = patch_size
    kw = dict(device=device, dtype=dtype)
    self.kernel = nn.Parameter(
        torch.empty(embed_dim, 3, patch_size, patch_size, **kw)
    )
    self.bias = nn.Parameter(torch.empty(embed_dim, **kw))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    """[b, 3, H, W] -> [b, (H // p) * (W // p), d]; trailing pixels drop."""
    x = F.conv2d(x, self.kernel.to(x.dtype), self.bias.to(x.dtype),
                 stride=self.patch_size)
    # Contiguous tokens: elementwise ops keep a transposed layout, which
    # would send every later matrix product down a strided GEMM.
    return x.flatten(2).transpose(1, 2).contiguous()


class ViTBlock(nn.Module):
  """Pre-norm transformer block with optional LayerScale (DINOv2).

  ``key_bias`` (``[1, 1, 1, t]`` additive logits bias: 0 for real tokens,
  -inf for padding) masks the padded keys of the einsum path.
  ``quantized`` / ``act_quant`` go to the four ``Dense`` layers.
  ``softmax_bf16`` rounds the einsum path's logits to bfloat16 before the
  softmax, whose max, exponentials and sum stay float32 (JAX
  ``vit.py:185-194``); the MHA kernel path ignores it, as JAX's flash
  branch does.
  """

  def __init__(self, config: ViTConfig, device=None,
               dtype: torch.dtype = torch.float32,
               use_flash_attention: bool | None = None,
               quantized: bool = False, act_quant: bool = False,
               softmax_bf16: bool = False):
    super().__init__()
    self.config = config
    self.use_flash_attention = use_flash_attention
    self.softmax_bf16 = softmax_bf16
    d = config.embed_dim
    kw = dict(device=device, dtype=dtype)
    qkw = dict(kw, quantized=quantized, act_quant=act_quant)
    self.norm1 = LayerNorm(d, **kw)
    self.attn_qkv = layers.Dense(d, 3 * d, **qkw)
    self.attn_proj = layers.Dense(d, d, **qkw)
    self.norm2 = LayerNorm(d, **kw)
    self.mlp_fc1 = layers.Dense(d, config.mlp_hidden_dim, **qkw)
    self.mlp_fc2 = layers.Dense(config.mlp_hidden_dim, d, **qkw)
    if config.use_layer_scale:
      self.ls1 = nn.Parameter(torch.empty(d, **kw))
      self.ls2 = nn.Parameter(torch.empty(d, **kw))

  def _layer_scale(self, name: str, value: torch.Tensor) -> torch.Tensor:
    if not self.config.use_layer_scale:
      return value
    return value * getattr(self, name).to(value.dtype)

  def forward(self, x: torch.Tensor,
              key_bias: torch.Tensor | None = None) -> torch.Tensor:
    cfg = self.config
    head_dim = cfg.embed_dim // cfg.num_heads
    b, t, _ = x.shape
    qkv = self.attn_qkv(self.norm1(x))
    # Views into qkv: the kernel reads the three thirds in place.
    q, k, v = (z.unflatten(-1, (cfg.num_heads, head_dim))
               for z in qkv.split(cfg.embed_dim, dim=-1))
    out = attend(q, k, v, key_bias, self.use_flash_attention,
                 self.softmax_bf16)
    out = self.attn_proj(out.reshape(b, t, cfg.embed_dim))
    x = x + self._layer_scale("ls1", out)

    h = self.mlp_fc1(self.norm2(x))
    h = F.gelu(h, approximate="tanh" if cfg.gelu_approximate else "none")
    return x + self._layer_scale("ls2", self.mlp_fc2(h))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           key_bias: torch.Tensor | None, use_flash_attention: bool | None,
           softmax_bf16: bool) -> torch.Tensor:
  """A block's attention over ``[b, t, n, h]`` heads: the MHA kernel (on
  the card, unpadded), or the einsum with the padded keys masked by
  ``key_bias`` (see :class:`ViTBlock`)."""
  if _use_flash(use_flash_attention, q.device) and key_bias is None:
    return mha_attention.flash_mha_attention(q, k, v)
  head_dim = q.shape[-1]
  logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float())
  logits = logits * (head_dim**-0.5)
  if key_bias is not None:
    logits = logits + key_bias
  if softmax_bf16:
    # bfloat16-resident logits, float32 exponentials and sum; the -inf key
    # bias survives the cast.
    logits = logits.to(torch.bfloat16)
    e = torch.exp((logits - logits.amax(dim=-1, keepdim=True)).float())
    probs = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
  else:
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
  return torch.einsum("bnqk,bknh->bqnh", probs, v)


class VisionTransformer(nn.Module):
  """timm-compatible ViT returning an intermediate block's patch tokens.

  Args:
    config: The tower.
    device: Where the weights live (``"meta"`` allocates nothing).
    dtype: Compute dtype (bfloat16 by default).
    param_dtype: Parameter dtype (float32 by default, as in JAX).
    use_flash_attention: ``None``: the CUDA MHA kernel on the card, the
      einsum on the CPU; ``True`` / ``False`` force one path.
    pad_tokens_to: On the einsum path, pad the token count to this multiple
      and mask the padded keys (0 disables). The kernel masks by itself.
    quantized, act_quant, softmax_bf16: As :class:`ViTBlock`, for every
      block.
  """

  def __init__(
      self,
      config: ViTConfig,
      device=None,
      dtype: torch.dtype = torch.bfloat16,
      param_dtype: torch.dtype = torch.float32,
      use_flash_attention: bool | None = None,
      pad_tokens_to: int = 128,
      quantized: bool = False,
      act_quant: bool = False,
      softmax_bf16: bool = False,
  ):
    super().__init__()
    self.config = config
    self.dtype = dtype
    self.use_flash_attention = use_flash_attention
    self.pad_tokens_to = pad_tokens_to
    d = config.embed_dim
    kw = dict(device=device, dtype=param_dtype)
    self.patch_embed = PatchEmbed(config.patch_size, d, **kw)
    self.pos_embed = nn.Parameter(torch.empty(1, config.num_patches, d, **kw))
    if config.num_prefix_tokens:
      self.prefix_tokens = nn.Parameter(
          torch.empty(1, config.num_prefix_tokens, d, **kw)
      )
    self.blocks = []
    for i in range(config.last_block + 1):
      block = ViTBlock(config, use_flash_attention=use_flash_attention,
                       quantized=quantized, act_quant=act_quant,
                       softmax_bf16=softmax_bf16, **kw)
      self.add_module(f"block{i}", block)
      self.blocks.append(block)

  def embed(self, pixels: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor | None, int]:
    """The blocks' input: ``(tokens, key_bias, real token count)``, the
    tokens padded on the einsum path and ``key_bias`` masking the pads."""
    cfg = self.config
    x = self.patch_embed(pixels.to(self.dtype))
    x = x + self.pos_embed.to(x.dtype)
    if cfg.num_prefix_tokens:
      prefix = self.prefix_tokens.to(x.dtype).expand(x.shape[0], -1, -1)
      x = torch.cat([prefix, x], dim=1)

    t_real = x.shape[1]
    key_bias = None
    pad = (0 if _use_flash(self.use_flash_attention, x.device)
           else self.pad_tokens_to)
    if pad and t_real % pad:
      t_pad = -(-t_real // pad) * pad
      x = F.pad(x, (0, 0, 0, t_pad - t_real))
      key_bias = torch.where(
          torch.arange(t_pad, device=x.device) < t_real, 0.0, float("-inf")
      )[None, None, None, :]
    return x, key_bias, t_real

  def forward(self, pixels: torch.Tensor) -> torch.Tensor:
    """[b, 3, H, W] normalized pixels -> [b, patches, embed_dim]."""
    x, key_bias, t_real = self.embed(pixels)
    for block in self.blocks:
      x = block(x, key_bias)
    # Un-normed, prefix tokens (and padding) dropped.
    return x[:, self.config.num_prefix_tokens:t_real]


def preprocess(images: torch.Tensor, mean: Sequence[float],
               std: Sequence[float], size: int = 384) -> torch.Tensor:
  """[b, 3, h, w] floats in [0, 1] -> resized, normalized [b, 3, size, size].

  The antialiased bicubic resize (Keys' a = -0.5) that ``jax.image.resize``
  applies; without antialiasing a downsample differs by up to 0.6.
  """
  resized = F.interpolate(images, size=(size, size), mode="bicubic",
                          antialias=True, align_corners=False)
  mean_t = torch.tensor(mean, dtype=images.dtype, device=images.device)
  std_t = torch.tensor(std, dtype=images.dtype, device=images.device)
  return (resized - mean_t[None, :, None, None]) / std_t[None, :, None, None]


def load_image(path: str, size: int | None = None) -> np.ndarray:
  """Decodes an image file to [1, 3, h, w] float32 in [0, 1] on the host;
  with ``size`` PIL resizes it bicubically first."""
  from PIL import Image  # pylint: disable=import-outside-toplevel

  with open(path, "rb") as f:
    img = Image.open(f).convert("RGB")
  if size is not None:
    img = img.resize((size, size), Image.BICUBIC)
  arr = np.asarray(img, dtype=np.float32) / 255.0
  return np.transpose(arr, (2, 0, 1))[None]


class DinoSigLIPEncoder(nn.Module):
  """The fused DINOv2 || SigLIP encoder: raw pixels -> [b, 729, 2176].

  DINO features first, SigLIP second; both towers take the same raw pixels
  and normalize them their own way on the device.

  Args:
    dino_config, siglip_config: The towers.
    device: Where the weights live; ``None`` means CUDA and raises when
      there is none. ``"meta"`` allocates nothing (``convert.py`` loads).
    dtype, param_dtype, use_flash_attention, pad_tokens_to: As
      :class:`VisionTransformer`.
    generator: The ``torch.Generator`` (on ``device``) that draws the random
      weights; ``None`` draws them from one seeded with 0.
    quantized, act_quant, softmax_bf16: As :class:`ViTBlock`, for both
      towers (the int8 serving encoder of JAX's
      ``benchmarks/multimodal_bench.py`` is ``quantized=True,
      act_quant=True``).
  """

  def __init__(
      self,
      dino_config: ViTConfig = DINOV2_LARGE_REG4_384,
      siglip_config: ViTConfig = SIGLIP_SO400M_384,
      device=None,
      dtype: torch.dtype = torch.bfloat16,
      param_dtype: torch.dtype = torch.float32,
      use_flash_attention: bool | None = None,
      pad_tokens_to: int = 128,
      generator: torch.Generator | None = None,
      quantized: bool = False,
      act_quant: bool = False,
      softmax_bf16: bool = False,
  ):
    super().__init__()
    device = griffin.resolve_device(device)
    self.dino_config = dino_config
    self.siglip_config = siglip_config
    self.quantized = quantized
    kw = dict(device=device, dtype=dtype, param_dtype=param_dtype,
              use_flash_attention=use_flash_attention,
              pad_tokens_to=pad_tokens_to, quantized=quantized,
              act_quant=act_quant, softmax_bf16=softmax_bf16)
    self.dino = VisionTransformer(dino_config, **kw)
    self.siglip = VisionTransformer(siglip_config, **kw)
    if device.type != "meta":
      if generator is None:
        generator = torch.Generator(device).manual_seed(0)
      self.init_weights(generator)

  @property
  def feature_width(self) -> int:
    return self.dino_config.embed_dim + self.siglip_config.embed_dim

  @property
  def device(self) -> torch.device:
    return self.dino.pos_embed.device

  @torch.no_grad()
  def init_weights(self, generator: torch.Generator) -> None:
    """Draws random weights as the JAX initializers scale them: normals of
    variance ``1 / fan_in`` for the dense and conv kernels, ``pos_embed``
    normal with std 0.02, zero prefix tokens and biases, unit LayerNorm
    scales, LayerScale 1e-5; a quantized tower's int8 kernels zeros and
    their scales ones (JAX's initializers)."""
    for name, p in self.named_parameters():
      leaf = name.rsplit(".", 1)[-1]
      if leaf == "kernel_q":
        p.zero_()
      elif leaf == "kernel_scale":
        p.fill_(1.0)
      elif leaf == "pos_embed":
        p.normal_(0.0, 0.02, generator=generator)
      elif leaf in ("ls1", "ls2"):
        p.fill_(1e-5)
      elif leaf == "scale":
        p.fill_(1.0)
      elif leaf == "kernel":
        fan_in = math.prod(p.shape[1:])
        p.normal_(0.0, math.sqrt(1.0 / fan_in), generator=generator)
      else:  # biases and prefix tokens
        p.zero_()

  def forward(self, pixels: torch.Tensor) -> torch.Tensor:
    """[b, 3, h, w] raw pixels in [0, 1] -> fused features."""
    size = self.dino_config.image_size
    dino_in = preprocess(pixels, DINO_MEAN, DINO_STD, size)
    siglip_in = preprocess(pixels, SIGLIP_MEAN, SIGLIP_STD, size)
    return torch.cat([self.dino(dino_in), self.siglip(siglip_in)], dim=-1)

  def preprocess_path(self, img_path: str) -> torch.Tensor:
    """Host-side decode only; the resize and normalization run on the
    encoder's device."""
    return torch.tensor(load_image(img_path), device=self.device)
