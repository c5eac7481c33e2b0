"""Carries the JAX package's flax parameters into the port's modules.

A flax parameter tree -- nested dicts whose leaves are numpy arrays, keyed
``embedder`` / ``blocks.{i}`` / ``final_norm`` / ``vl_connector`` as the JAX
``Griffin`` names them, or ``dino`` / ``siglip`` as the JAX
``DinoSigLIPEncoder`` does -- maps leaf by leaf onto the port's
``state_dict``: the dotted path is the PyTorch name, every dense ``kernel``
(flax ``[in, out]``) is transposed to PyTorch's ``[out, in]`` and every
convolution ``kernel`` (flax HWIO) to PyTorch's OIHW. A missing, unexpected
or misshaped leaf raises.

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
    if name.endswith(".kernel"):
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
    dest.copy_(source[name])


def griffin_from_flax_params(
    params: Mapping[str, Any],
    config: common.GriffinConfig | None = None,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    use_flash_attention: bool | None = None,
    fused_epilogue: bool = False,
    scan_sharding_spec: sharding.ShardingSpec | None = None,
) -> griffin.Griffin:
  """Builds a ``Griffin`` holding a flax tree's weights.

  ``config`` defaults to the one the tree's shapes imply
  (``GriffinConfig.from_flax_params_or_variables``); ``device=None`` means
  CUDA, and raises when there is none. ``scan_sharding_spec`` adds no
  weights; it is passed to the ``Griffin``.
  """
  device = griffin.resolve_device(device)
  if config is None:
    config = common.GriffinConfig.from_flax_params_or_variables(params)
  model = griffin.Griffin(
      config, device="meta", dtype=dtype,
      use_flash_attention=use_flash_attention, fused_epilogue=fused_epilogue,
      scan_sharding_spec=scan_sharding_spec,
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
) -> vit.DinoSigLIPEncoder:
  """Builds a ``DinoSigLIPEncoder`` holding a JAX encoder's weights
  (``read_npz_params(path, "v")`` reads them from an ``.npz``) in float32,
  computing in ``dtype``; ``device=None`` means CUDA, and raises when there
  is none."""
  device = griffin.resolve_device(device)
  encoder = vit.DinoSigLIPEncoder(
      dino_config, siglip_config, device="meta", dtype=dtype
  )
  encoder.to_empty(device=device)
  load_flax_params(encoder, vparams)
  return encoder
