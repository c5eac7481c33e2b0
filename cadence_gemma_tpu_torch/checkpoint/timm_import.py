"""timm ViT state dicts -> the port's DINOv2 and SigLIP towers.

Counterpart of the JAX package's ``cadence_gemma_tpu/checkpoint/
timm_import.py``: the state dicts of ``vit_so400m_patch14_siglip_384`` and
``vit_large_patch14_reg4_dinov2.lvd142m`` (a live timm model's
``state_dict()`` or saved tensors; timm is needed only to make them) become
the state dict of :class:`models.vit.VisionTransformer`, and of a
:class:`models.vit.DinoSigLIPEncoder` for the pair. Nothing is downloaded.

The port keeps PyTorch's layouts, so the weights carry over as they are
(the patch convolution stays OIHW, every dense weight ``[out, in]``); what
changes is the naming, the fusion of the cls and register tokens into
``prefix_tokens`` (with the positional rows timm keeps for them), and the
position embedding, resized bicubically when the checkpoint's grid differs
from the tower's (DINOv2's 37 x 37 at 518 px to 27 x 27 at 384), with the
antialiased Keys kernel (a = -0.5) of ``jax.image.resize``.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch.nn import functional as F

from cadence_gemma_tpu_torch.models import vit as vit_lib

_DENSE = (("attn_qkv", "attn.qkv"), ("attn_proj", "attn.proj"),
          ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2"))


def _to_tensor(x) -> torch.Tensor:
  """A float32 (or the source's integer) CPU tensor of a torch or numpy
  value."""
  t = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(
      np.asarray(x))
  return t.float() if t.is_floating_point() else t


def _resize_pos_embed(pos: torch.Tensor, num_prefix: int,
                      target_patches: int
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
  """Splits off ``num_prefix`` leading rows and resizes the patch grid to
  ``target_patches`` (JAX ``timm_import.py:36``)."""
  prefix = pos[:, :num_prefix] if num_prefix else None
  grid_part = pos[:, num_prefix:]
  src = math.isqrt(grid_part.shape[1])
  dst = math.isqrt(target_patches)
  if src != dst:
    grid = grid_part.reshape(1, src, src, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(dst, dst), mode="bicubic",
                         antialias=True, align_corners=False)
    grid_part = grid.permute(0, 2, 3, 1).reshape(1, dst * dst, -1)
  return grid_part, prefix


def timm_vit_to_state_dict(
    state_dict: Mapping[str, Any],
    config: vit_lib.ViTConfig) -> dict[str, torch.Tensor]:
  """A timm ViT state dict -> ``VisionTransformer``'s state dict (JAX's
  ``timm_vit_to_flax``, ``timm_import.py:53``), float32 on the CPU.

  Handles the patch embedding, the cls / register tokens' fusion into
  ``prefix_tokens``, the position embedding (its resize, and prefix rows
  inside it folded into the prefix tokens), the fused qkv and DINOv2's
  LayerScale gammas; blocks past ``config``'s output layer are dropped.
  """
  sd = {k: _to_tensor(v) for k, v in state_dict.items()}
  out = {"patch_embed.kernel": sd["patch_embed.proj.weight"],
         "patch_embed.bias": sd["patch_embed.proj.bias"]}

  # Prefix tokens: cls first, then the registers (timm's order).
  parts = [sd[k] for k in ("cls_token", "reg_token", "register_tokens")
           if k in sd]
  if parts:
    prefix = torch.cat(parts, dim=1)
    if prefix.shape[1] != config.num_prefix_tokens:
      raise ValueError(f"{prefix.shape[1]} prefix tokens in the checkpoint, "
                       f"the config has {config.num_prefix_tokens}.")
    out["prefix_tokens"] = prefix

  # timm keeps positional rows for the prefix only where pos_embed covers
  # them (DINOv2's cls, not its registers): count the leading rows that
  # leave a square patch grid (0 for SigLIP, 1 for DINOv2).
  pos = sd["pos_embed"]
  prefix_rows = 0
  while prefix_rows <= 8:
    n = pos.shape[1] - prefix_rows
    if math.isqrt(n) ** 2 == n:
      break
    prefix_rows += 1
  grid_pos, prefix_pos = _resize_pos_embed(pos, prefix_rows,
                                           config.num_patches)
  out["pos_embed"] = grid_pos
  if prefix_pos is not None and "prefix_tokens" in out:
    # The prefix tokens and their positional rows are always summed.
    pad = config.num_prefix_tokens - prefix_pos.shape[1]
    if pad >= 0:
      out["prefix_tokens"] = out["prefix_tokens"] + F.pad(
          prefix_pos, (0, 0, 0, pad))

  for i in range(config.last_block + 1):
    src, dst = f"blocks.{i}.", f"block{i}."
    for norm in ("norm1", "norm2"):
      out[f"{dst}{norm}.scale"] = sd[f"{src}{norm}.weight"]
      out[f"{dst}{norm}.bias"] = sd[f"{src}{norm}.bias"]
    for name, timm_name in _DENSE:
      out[f"{dst}{name}.kernel"] = sd[f"{src}{timm_name}.weight"]
      out[f"{dst}{name}.bias"] = sd[f"{src}{timm_name}.bias"]
    if config.use_layer_scale:
      out[f"{dst}ls1"] = sd[f"{src}ls1.gamma"]
      out[f"{dst}ls2"] = sd[f"{src}ls2.gamma"]
  return {k: v.contiguous() for k, v in out.items()}


def load_dino_siglip_encoder_params(
    dino_state_dict: Mapping[str, Any],
    siglip_state_dict: Mapping[str, Any],
    dino_config: vit_lib.ViTConfig = vit_lib.DINOV2_LARGE_REG4_384,
    siglip_config: vit_lib.ViTConfig = vit_lib.SIGLIP_SO400M_384,
) -> dict[str, torch.Tensor]:
  """The state dict of a ``DinoSigLIPEncoder`` from the two towers' timm
  state dicts (JAX ``timm_import.py:151``); load it with
  ``encoder.load_state_dict``."""
  out = {}
  for tower, sd, config in (("dino", dino_state_dict, dino_config),
                            ("siglip", siglip_state_dict, siglip_config)):
    for name, value in timm_vit_to_state_dict(sd, config).items():
      out[f"{tower}.{name}"] = value
  return out
