"""Carries the JAX package's flax parameters into the port's modules.

A flax parameter tree -- nested dicts whose leaves are numpy arrays, keyed
``embedder`` / ``blocks.{i}`` / ``final_norm`` / ``vl_connector`` as the JAX
``Griffin`` names them, or ``dino`` / ``siglip`` as the JAX
``DinoSigLIPEncoder`` does -- maps leaf by leaf onto the port's
``state_dict``: the dotted path is the PyTorch name, every dense ``kernel``
(flax ``[in, out]``) is transposed to PyTorch's ``[out, in]`` and every
convolution ``kernel`` (flax HWIO) to PyTorch's OIHW. A missing, unexpected
or misshaped leaf raises.

A quantized tree (JAX's ``quantize_params``) carries ``name_q`` (int8) and
``name_scale`` (float32) leaves: ``kernel_q`` is transposed as ``kernel``
is, and the 3-D ``w_q`` of the fused up-projection ``(c, d, D)`` and of the
gates' block-diagonal ``(h, i, j)`` to the contraction-last ``(c, D, d)``
and ``(h, j, i)`` the port's int8 kernel reads. int8 leaves keep their
dtype. LoRA adapters (``lora_a`` / ``lora_b``) keep flax's layouts in the
port and cross unchanged, beside a bf16 or an int8 base.
:func:`flax_params_from_state_dict` goes the other way (the tests hand a
port's weights back to the JAX package with it).

:func:`read_npz_params` reads the flattened ``p['blocks.0']['...']`` key
scheme of ``np.savez`` files written from ``jax.tree_util.keystr`` paths
(``tests/fixtures/golden_tiny.npz``), with numpy only.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.models import vit
from cadence_gemma_tpu_torch.parallel import sharding


def read_npz_params(path: str, prefix: str = "p") -> dict[str, Any]:
  """Nested dict of numpy arrays from an ``.npz`` of ``p['a']['b']`` keys."""
  tree: dict[str, Any] = {}
  with np.load(path) as npz:
    for key in npz.files:
      if not key.startswith(prefix + "["):
        continue
      parts = re.findall(r"\['([^']+)'\]", key[len(prefix):])
      node = tree
      for part in parts[:-1]:
        node = node.setdefault(part, {})
      node[parts[-1]] = npz[key]
  return tree


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
  flat = {}
  for key, value in tree.items():
    name = f"{prefix}{key}"
    if isinstance(value, Mapping):
      flat.update(_flatten(value, name + "."))
    else:
      flat[name] = value
  return flat


def _to_tensor(value) -> torch.Tensor:
  array = np.asarray(value)
  if array.dtype.name == "bfloat16":  # ml_dtypes arrays: torch cannot wrap
    return torch.tensor(array.astype(np.float32)).to(torch.bfloat16)
  return torch.tensor(array)


def state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
  """The port's state dict (CPU tensors, source dtypes) for a flax tree."""
  params = params.get("params", params)
  out = {}
  for name, value in _flatten(params).items():
    tensor = _to_tensor(value)
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w_q" and tensor.ndim == 3:
      tensor = tensor.transpose(1, 2)
    elif leaf in ("kernel", "kernel_q"):
      if tensor.ndim == 2:
        tensor = tensor.T
      elif tensor.ndim == 4:  # HWIO -> OIHW
        tensor = tensor.permute(3, 2, 0, 1)
      else:
        raise ValueError(
            f"{name}: expected a 2-D or 4-D kernel, got {tuple(tensor.shape)}."
        )
    out[name] = tensor.contiguous()
  return out


def flax_params_from_state_dict(
    state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
  """The flax tree (nested dicts of numpy arrays) of a port's state dict:
  the inverse of :func:`state_dict_from_flax`'s layout changes. A numeric
  part of a name belongs to the key before it (flax's ``blocks.0``).
  bfloat16 leaves come back as float32 (numpy has no bfloat16 of its
  own)."""
  tree: dict[str, Any] = {}
  for name, tensor in state_dict.items():
    tensor = tensor.detach().cpu()
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w_q" and tensor.ndim == 3:
      tensor = tensor.transpose(1, 2)
    elif leaf in ("kernel", "kernel_q"):
      tensor = tensor.T if tensor.ndim == 2 else tensor.permute(2, 3, 1, 0)
    if tensor.dtype == torch.bfloat16:
      tensor = tensor.float()
    keys = []
    for part in name.split("."):
      if part.isdigit() and keys:
        keys[-1] += f".{part}"
      else:
        keys.append(part)
    node = tree
    *parents, last = keys
    for part in parents:
      node = node.setdefault(part, {})
    node[last] = tensor.contiguous().numpy()
  return tree


@torch.no_grad()
def load_flax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> None:
  """Copies a flax tree into ``model`` in place, casting to its dtypes."""
  source = state_dict_from_flax(params)
  target = model.state_dict()
  missing = sorted(set(target) - set(source))
  unexpected = sorted(set(source) - set(target))
  if missing or unexpected:
    raise ValueError(
        f"Parameter trees differ: missing {missing}, unexpected {unexpected}."
    )
  for name, dest in target.items():
    if source[name].shape != dest.shape:
      raise ValueError(
          f"{name}: flax leaf has shape {tuple(source[name].shape)} after "
          f"layout conversion, the model expects {tuple(dest.shape)}."
      )
    if (source[name].dtype == torch.int8) != (dest.dtype == torch.int8):
      raise ValueError(
          f"{name}: flax leaf is {source[name].dtype}, the model holds "
          f"{dest.dtype}; int8 weights load only into int8 parameters."
      )
    dest.copy_(source[name])


def is_quantized(params: Mapping[str, Any]) -> bool:
  """Whether a flax tree holds int8 leaves of ``quantize_params``."""
  params = params.get("params", params)
  return any(name.endswith("_q") for name in _flatten(params))


def griffin_from_flax_params(
    params: Mapping[str, Any],
    config: common.GriffinConfig | None = None,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    use_flash_attention: bool | None = None,
    fused_epilogue: bool = False,
    scan_sharding_spec: sharding.ShardingSpec | None = None,
    quantized: bool | None = None,
    act_quant: bool = False,
    lora_rank: int = 0,
    lora_alpha: float | None = None,
    lora_rows: int = 0,
) -> griffin.Griffin:
  """Builds a ``Griffin`` holding a flax tree's weights.

  ``config`` defaults to the one the tree's shapes imply
  (``GriffinConfig.from_flax_params_or_variables``); ``device=None`` means
  CUDA, and raises when there is none. ``scan_sharding_spec`` adds no
  weights; it is passed to the ``Griffin``. ``quantized=None`` builds a
  quantized model when the tree holds int8 (``_q``) leaves. A quantized
  tree has no ``input_embedding`` to read the config from, so it needs
  ``config`` (JAX's ``examples/serve.py`` reads it from the bfloat16 tree
  before quantizing). ``lora_rank`` / ``lora_alpha`` / ``lora_rows`` build
  the adapters of JAX's ``Griffin(lora_rank=..., lora_rows=...)``; the tree
  must then carry them (a bf16 or a quantized base with its ``lora_a`` /
  ``lora_b`` leaves, stacked with ``lora_rows``).
  """
  device = griffin.resolve_device(device)
  if quantized is None:
    quantized = is_quantized(params)
  if config is None:
    if is_quantized(params):
      raise ValueError(
          "A quantized parameter tree has no input_embedding to infer the "
          "config from; pass config= (read it from the bfloat16 tree before "
          "quantizing)."
      )
    config = common.GriffinConfig.from_flax_params_or_variables(params)
  model = griffin.Griffin(
      config, device="meta", dtype=dtype,
      use_flash_attention=use_flash_attention, fused_epilogue=fused_epilogue,
      scan_sharding_spec=scan_sharding_spec, quantized=quantized,
      act_quant=act_quant, lora_rank=lora_rank, lora_alpha=lora_alpha,
      lora_rows=lora_rows,
  )
  model.to_empty(device=device)
  load_flax_params(model, params)
  return model


def encoder_from_flax_params(
    vparams: Mapping[str, Any],
    dino_config: vit.ViTConfig = vit.DINOV2_LARGE_REG4_384,
    siglip_config: vit.ViTConfig = vit.SIGLIP_SO400M_384,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool | None = None,
    act_quant: bool = False,
    softmax_bf16: bool = False,
) -> vit.DinoSigLIPEncoder:
  """Builds a ``DinoSigLIPEncoder`` holding a JAX encoder's weights
  (``read_npz_params(path, "v")`` reads them from an ``.npz``) in float32,
  computing in ``dtype``; ``device=None`` means CUDA, and raises when there
  is none. ``quantized=None`` builds int8 towers when the tree holds int8
  leaves (JAX's ``quantize_params(vparams)``); ``act_quant`` and
  ``softmax_bf16`` are :class:`vit.DinoSigLIPEncoder`'s."""
  device = griffin.resolve_device(device)
  if quantized is None:
    quantized = is_quantized(vparams)
  encoder = vit.DinoSigLIPEncoder(
      dino_config, siglip_config, device="meta", dtype=dtype,
      quantized=quantized, act_quant=act_quant, softmax_bf16=softmax_bf16,
  )
  encoder.to_empty(device=device)
  load_flax_params(encoder, vparams)
  return encoder
