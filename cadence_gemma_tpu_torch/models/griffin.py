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

import copy
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


def _share_parameters(module: nn.Module) -> nn.Module:
  """A copy of ``module``'s tree of module objects whose parameters and
  buffers are the original's tensors (so flags set on the copy's modules
  leave the original alone)."""
  clone = copy.copy(module)
  clone._parameters = dict(module._parameters)  # pylint: disable=protected-access
  clone._buffers = dict(module._buffers)  # pylint: disable=protected-access
  clone._modules = {  # pylint: disable=protected-access
      name: None if child is None else _share_parameters(child)
      for name, child in module._modules.items()  # pylint: disable=protected-access
  }
  return clone


def splice_visual(x: torch.Tensor, segment_pos: torch.Tensor,
                  visual: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Inserts projected visual tokens after the BOS token, at positions
  ``[p0, p0+1 .. p0+n, old + n]``."""
  n = visual.shape[1]
  x = torch.cat([x[:, :1], visual, x[:, 1:]], dim=1)
  p0 = segment_pos[:, :1]
  visual_pos = p0 + torch.arange(
      1, n + 1, dtype=segment_pos.dtype, device=segment_pos.device
  )[None]
  segment_pos = torch.cat([p0, visual_pos, segment_pos[:, 1:] + n], dim=-1)
  return x, segment_pos


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
    quantized: int8 weights with float32 per-output-channel scales in every
      projection, the gates' block-diagonals and the embedding table
      (``griffin.py:49,75,95,116`` in JAX); load them with
      ``load_state_dict(quantize_params(...))`` or
      ``convert.griffin_from_flax_params``. The weight-only products run
      through the int8 CUDA kernel on the card.
    act_quant: int8 activations too in every ``Dense`` and ``Einsum``
      (requires ``quantized``; adds no weights). :meth:`act_quant_view`
      gives this mode over an existing quantized model's own weights.
    lora_rank: A LoRA adapter pair of this rank on every ``Dense`` and
      ``Einsum`` projection, the connector's included (``griffin.py:53-61``
      in JAX; 0 = none), over a bf16 or a ``quantized`` base.
      ``training.lora`` trains the adapters alone.
    lora_alpha: The adapters' scale is ``lora_alpha / lora_rank``
      (``None``: 1).
    lora_rows: Stack the adapters per batch row (``griffin.py:58-61`` in
      JAX): ``[lora_rows, ...]`` leaves, batch row i against adapter row i,
      the decode side of multi-LoRA serving. :meth:`adapter_twin` builds
      such a model over an existing model's base weights.
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
      quantized: bool = False,
      act_quant: bool = False,
      lora_rank: int = 0,
      lora_alpha: float | None = None,
      lora_rows: int = 0,
  ):
    super().__init__()
    if act_quant and not quantized:
      raise ValueError("act_quant=True requires quantized=True.")
    device = resolve_device(device)
    if scan_sharding_spec is not None:
      if scan_sharding_spec.mesh is None:
        raise NotImplementedError(
            "Sequence parallelism in the model under JAX's pmap regime (a "
            "ShardingSpec without a mesh) holds only the local sequence shard "
            f"from the embedder to the loss: {sharding.PROCESS_PER_CARD_ITEM}.")
      sharding.refuse_processes(scan_sharding_spec.mesh,
                                "Sequence parallelism in the model")
    self.config = config
    self.gradient_checkpointing = gradient_checkpointing
    self.scan_sharding_spec = scan_sharding_spec
    self.quantized = quantized
    self.act_quant = act_quant
    self.lora_rank = lora_rank
    self.lora_alpha = lora_alpha
    self.lora_rows = lora_rows
    kw = dict(device=device, dtype=dtype)
    qkw = dict(kw, quantized=quantized, act_quant=act_quant,
               lora_rank=lora_rank, lora_alpha=lora_alpha, lora_rows=lora_rows)
    self.embedder = modules.Embedder(
        config.vocab_size, config.width,
        config.embeddings_scale_by_sqrt_dim, quantized=quantized, **kw,
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
            **qkw,
        )
        for block_type in config.block_types
    ])
    self.final_norm = layers.RMSNorm(config.width, **kw)
    # Registered last: init_weights draws in registration order, so the text
    # model's weights do not depend on the connector.
    self.vl_connector = modules.VisionLanguageConnector(
        config.width, config.vl_expanded_width, config.vision_width, **qkw
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
    radius on the ring [0.9, 0.999]. A quantized model's int8 weights are
    zeros and their scales ones, as the flax initializers of JAX's
    ``quantized=True`` layers draw them. LoRA adapters are drawn after every
    other weight (so the base equals a ``lora_rank=0`` model's from the same
    generator): ``lora_a`` normal(fan_in^-0.5), ``lora_b`` zeros.
    """
    final_scale = 2.0 / self.config.num_layers
    adapters = []
    for name, p in self.named_parameters():
      leaf = name.rsplit(".", 1)[-1]
      parent = name.rsplit(".", 2)[-2] if name.count(".") else ""
      if leaf in layers.LORA_LEAF_NAMES:
        adapters.append((name, p))
      elif leaf.endswith("_q"):
        p.zero_()
      elif leaf.endswith("_scale"):
        p.fill_(1.0)
      elif leaf in ("scale", "bias", "b"):
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
    for name, p in adapters:
      layers.init_lora_(name, p, generator)

  def act_quant_view(self) -> "Griffin":
    """This quantized model with int8 activations in every ``Dense`` and
    ``Einsum``: the counterpart of flax's ``model.clone(act_quant=True)``.

    The view is a new tree of module objects over the same parameter
    tensors (no weight is copied), sharing this model's hooks; changing a
    parameter of one changes the other.
    """
    if not self.quantized:
      raise ValueError("act_quant_view requires a quantized=True model.")
    view = _share_parameters(self)
    for module in view.modules():
      if getattr(module, "quantized", False) and hasattr(module, "act_quant"):
        module.act_quant = True
    return view

  def adapter_twin(self, lora_rows: int = 0) -> "Griffin":
    """A model over this one's base tensors with adapters of its own: the
    counterpart of flax's ``model.clone(lora_rows=...)``.

    Every parameter but the adapters is this model's own tensor (the same
    storage, nothing copied); each ``lora_a`` / ``lora_b`` is a new zero
    tensor, stacked ``[lora_rows, ...]`` when ``lora_rows > 0`` (one pair a
    batch row) and shaped as this model's otherwise. Writing a twin's
    adapters in place leaves this model's alone.
    """
    if not self.lora_rank or self.lora_rows:
      raise ValueError("adapter_twin needs a lora_rank > 0 model with one "
                       "adapter pair a layer (lora_rows=0).")
    twin = _share_parameters(self)
    twin.lora_rows = lora_rows
    rows = (lora_rows,) if lora_rows else ()
    for module in twin.modules():
      if isinstance(module, (layers.Dense, layers.Einsum)) and module.lora_rank:
        module.lora_rows = lora_rows
        for name in layers.LORA_LEAF_NAMES:
          leaf = getattr(module, name)
          module._parameters[name] = nn.Parameter(  # pylint: disable=protected-access
              leaf.new_zeros(*rows, *leaf.shape), requires_grad=False)
    return twin

  def adapter_leaves(self) -> dict[str, torch.Tensor]:
    """The ``lora_a`` / ``lora_b`` tensors by name (a twin's are written in
    place)."""
    return {name: p.detach() for name, p in self.named_parameters()
            if name.rsplit(".", 1)[-1] in layers.LORA_LEAF_NAMES}

  def refresh_adapters(self) -> None:
    """Nothing to do: one device holds every adapter (a tensor-parallel
    model copies them to its shards' devices here)."""

  def _splice_image(
      self, x: torch.Tensor, segment_pos: torch.Tensor, image: torch.Tensor
  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Projects image features and inserts them after the BOS token."""
    if image.shape[-1] != self.config.vision_width:
      raise ValueError(
          f"image feature width {image.shape[-1]} != config.vision_width "
          f"{self.config.vision_width}; check the vision encoder pairing."
      )
    return splice_visual(x, segment_pos, self.vl_connector(image.to(x.dtype)))

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
      pending_cache: bool = False,
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
      pending_cache: Return each layer's pending material instead of its
        updated cache (``griffin.py:149-214`` in JAX): the speculative
        verify runs a draft chunk once and then commits the accepted prefix
        with :func:`modules.commit_pending_cache` (the RG-LRU's per-step
        fp32 carries, the conv's inputs, the chunk's rotated keys and
        values). Needs ``cache`` and contiguous positions per row.

    Returns:
      ``(logits | None, cache | None)``; with an image the logits include
      the visual positions.
    """
    if not return_logits and not return_cache:
      return None, None
    if pending_cache and cache is None:
      raise ValueError("pending_cache needs a cache (decode mode).")

    x = self.embedder.encode(tokens)
    if image is not None:
      x, segment_pos = self._splice_image(x, segment_pos, image)
    remat = self.gradient_checkpointing and torch.is_grad_enabled()
    new_cache = {}
    for i, block in enumerate(self.blocks):
      name = f"blocks.{i}"
      args = (x, segment_pos, None if cache is None else cache[name],
              return_cache, pending_cache)
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
