"""The Griffin backbone with its image splice.

Counterpart of the JAX package's ``cadence_gemma_tpu/models/griffin.py``
with the same parameter names (``embedder``, ``blocks.{i}``,
``final_norm``, ``vl_connector``), so ``convert.py`` loads a flax tree leaf
by leaf. With ``image=`` the connector's projection of the fused vision
features is spliced in after the first (BOS) token, at positions
``[p0, p0+1 .. p0+n, old + n]``.

The model lives on the card unless the caller asks for another device:
``device=None`` means CUDA, and raises when there is none.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import layers
from cadence_gemma_tpu_torch.models import modules
from cadence_gemma_tpu_torch.parallel import sharding

Cache = dict[str, modules.ResidualBlockCache]


def resolve_device(device=None) -> torch.device:
  """``None`` means CUDA; a CUDA device without a card raises."""
  device = torch.device("cuda" if device is None else device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "No CUDA device is available. The port runs on the card by default; "
        "pass device='cpu' to run on the CPU."
    )
  return device


# Each block's output projections, drawn with variance 2 / num_layers.
_OUTPUT_PROJECTIONS = ("proj_final", "linear_out", "ffw_down")


class Griffin(nn.Module):
  """Griffin: a hybrid RG-LRU / local-attention language model.

  Args:
    config: Model hyper-parameters.
    device: Where the weights live; ``None`` means CUDA. ``"meta"``
      allocates nothing (``convert.py`` builds models that way, then loads).
    dtype: Parameter and activation dtype (bfloat16 by default).
    generator: The ``torch.Generator`` (on ``device``) that draws the random
      initial weights; ``None`` draws them from a generator seeded with 0.
    use_flash_attention: ``None`` routes prompts longer than the window
      through the CUDA window-attention kernel on the card; ``True`` /
      ``False`` force the kernel path / the einsum path.
    gradient_checkpointing: Recompute each residual block in the backward
      instead of keeping its activations (the JAX ``nn.remat``); applies
      only while autograd records, so inference is unchanged.
    fused_epilogue: Fuse each block's residual add and channel pre-norm
      into one pass (the CUDA ``add_rmsnorm`` kernel on the card).
    scan_sharding_spec: Runs every RG-LRU scan and every prompt's attention
      sequence-parallel over the spec's mesh (``griffin.py:41-47,100`` in
      JAX): the prompt's length must divide into the sequence shards. Adds
      no weights; prefill and training both run sharded.
  """

  def __init__(
      self,
      config: common.GriffinConfig,
      device=None,
      dtype: torch.dtype = torch.bfloat16,
      generator: torch.Generator | None = None,
      use_flash_attention: bool | None = None,
      gradient_checkpointing: bool = True,
      fused_epilogue: bool = False,
      scan_sharding_spec: sharding.ShardingSpec | None = None,
  ):
    super().__init__()
    device = resolve_device(device)
    self.config = config
    self.gradient_checkpointing = gradient_checkpointing
    self.scan_sharding_spec = scan_sharding_spec
    kw = dict(device=device, dtype=dtype)
    self.embedder = modules.Embedder(
        config.vocab_size, config.width,
        config.embeddings_scale_by_sqrt_dim, **kw,
    )
    self.blocks = nn.ModuleList([
        modules.ResidualBlock(
            width=config.width,
            mlp_expanded_width=config.mlp_expanded_width,
            num_heads=config.num_heads,
            attention_window_size=config.attention_window_size,
            temporal_block_type=block_type,
            lru_width=config.lru_width,
            scan_type=config.scan_type,
            use_flash_attention=use_flash_attention,
            fused_epilogue=fused_epilogue,
            scan_sharding_spec=scan_sharding_spec,
            **kw,
        )
        for block_type in config.block_types
    ])
    self.final_norm = layers.RMSNorm(config.width, **kw)
    # Registered last: init_weights draws in registration order, so the text
    # model's weights do not depend on the connector.
    self.vl_connector = modules.VisionLanguageConnector(
        config.width, config.vl_expanded_width, config.vision_width, **kw
    )
    if device.type != "meta":
      if generator is None:
        generator = torch.Generator(device).manual_seed(0)
      self.init_weights(generator)

  @torch.no_grad()
  def init_weights(self, generator: torch.Generator) -> None:
    """Draws random weights as the flax initializers scale them.

    Normals of variance ``scale / fan_in`` (scale ``2 / num_layers`` for each
    block's output projection, 0.01 for the conv), zero biases and norm
    scales, and the RG-LRU ``a_param`` drawn so that ``a`` is uniform in
    radius on the ring [0.9, 0.999].
    """
    final_scale = 2.0 / self.config.num_layers
    for name, p in self.named_parameters():
      leaf = name.rsplit(".", 1)[-1]
      parent = name.rsplit(".", 2)[-2] if name.count(".") else ""
      if leaf in ("scale", "bias", "b"):
        p.zero_()
      elif leaf == "a_param":
        u = torch.rand(p.shape, generator=generator, device=p.device)
        min_rad, max_rad = 0.9, 0.999
        a_real = 0.5 * torch.log(
            u * (max_rad**2 - min_rad**2) + min_rad**2 + 1e-8
        )
        p.copy_(torch.log(torch.exp(-a_real) - 1.0))
      elif parent == "conv_1d":  # w [temporal_width, width]
        p.normal_(0.0, math.sqrt(0.01 / p.shape[0]), generator=generator)
      else:
        # Dense [out, in], embedding [vocab, width], block-diagonal
        # [h, i, j] and fused up-projection [c, d, D]: fan-in is dim 1.
        # The connector's projections keep scale 1.
        scale = (final_scale if parent in _OUTPUT_PROJECTIONS
                 and not name.startswith("vl_connector.") else 1.0)
        p.normal_(0.0, math.sqrt(scale / p.shape[1]), generator=generator)

  def _splice_image(
      self, x: torch.Tensor, segment_pos: torch.Tensor, image: torch.Tensor
  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Projects image features and inserts them after the BOS token."""
    if image.shape[-1] != self.config.vision_width:
      raise ValueError(
          f"image feature width {image.shape[-1]} != config.vision_width "
          f"{self.config.vision_width}; check the vision encoder pairing."
      )
    visual = self.vl_connector(image.to(x.dtype))
    n = visual.shape[1]
    x = torch.cat([x[:, :1], visual, x[:, 1:]], dim=1)
    p0 = segment_pos[:, :1]
    visual_pos = p0 + torch.arange(
        1, n + 1, dtype=segment_pos.dtype, device=segment_pos.device
    )[None]
    segment_pos = torch.cat([p0, visual_pos, segment_pos[:, 1:] + n], dim=-1)
    return x, segment_pos

  def forward(
      self,
      tokens: torch.Tensor,
      segment_pos: torch.Tensor,
      cache: Cache | None = None,
      return_logits: bool = True,
      return_cache: bool = True,
      last_logits_only: bool = False,
      return_hidden: bool = False,
      image: torch.Tensor | None = None,
  ) -> tuple[torch.Tensor | None, Cache | None]:
    """Runs the model over ``tokens``.

    Args:
      tokens: Input token ids [b, t].
      segment_pos: Per-token positions [b, t]; 0 marks a document start,
        negative marks left padding.
      cache: Per-layer decode caches keyed ``blocks.{i}``.
      return_logits: Compute logits (skip for cache-only prefill).
      return_cache: Compute the updated cache.
      last_logits_only: Return logits only for the final position -- the
        prefill path, which never builds the [b, t, vocab] logits tensor.
      return_hidden: Return the final-normed hidden states [b, t, width]
        instead of logits; the trainer's chunked loss decodes them in time
        chunks through :meth:`decode_hidden`.
      image: Fused vision features [b, vision_tokens, vision_width],
        projected by the connector and spliced in after BOS.

    Returns:
      ``(logits | None, cache | None)``; with an image the logits include
      the visual positions.
    """
    if not return_logits and not return_cache:
      return None, None

    x = self.embedder.encode(tokens)
    if image is not None:
      x, segment_pos = self._splice_image(x, segment_pos, image)
    remat = self.gradient_checkpointing and torch.is_grad_enabled()
    new_cache = {}
    for i, block in enumerate(self.blocks):
      name = f"blocks.{i}"
      args = (x, segment_pos, None if cache is None else cache[name],
              return_cache)
      if remat:
        x, new_cache[name] = checkpoint_lib.checkpoint(
            block, *args, use_reentrant=False
        )
      else:
        x, new_cache[name] = block(*args)

    if not return_logits:
      return None, new_cache
    if last_logits_only:
      x = x[:, -1:]
    x = self.final_norm(x)
    if return_hidden:
      return x, (new_cache if return_cache else None)
    return self.decode_hidden(x), (new_cache if return_cache else None)

  def decode_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden states -> soft-capped vocabulary logits."""
    logits = self.embedder.decode(hidden)
    cap = self.config.logits_soft_cap
    if cap:
      logits = torch.tanh(logits / cap) * cap
    return logits

  def init_cache(self, batch_size: int, dtype: torch.dtype | None = None
                 ) -> Cache:
    """Empty per-layer caches on the model's device."""
    device = self.final_norm.scale.device
    dtype = dtype or self.final_norm.scale.dtype
    cfg = self.config
    lru_width = cfg.lru_width or cfg.width
    cache = {}
    for i, block_type in enumerate(cfg.block_types):
      if block_type is common.TemporalBlockType.RECURRENT:
        cache[f"blocks.{i}"] = modules.RecurrentBlock.init_cache(
            batch_size, lru_width, dtype, device=device
        )
      else:
        cache[f"blocks.{i}"] = modules.LocalAttentionBlock.init_cache(
            batch_size, cfg.attention_window_size,
            cfg.width // cfg.num_heads, dtype, device=device,
        )
    return cache
