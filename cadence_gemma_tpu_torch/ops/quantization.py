"""int8 quantization for serving: weights, activations, the int8 product.

Counterpart of the JAX package's ``cadence_gemma_tpu/ops/quantization.py``.
Decode of a 2B model is bound by streaming its weights from device memory;
storing the heavy matrices as int8 with per-output-channel float32 scales
halves those bytes. The weight-only product runs through the hand-written
CUDA kernel of :mod:`cadence_gemma_tpu_torch.ops.int8_matmul`, which widens
the int8 tiles to bfloat16 on chip, so only int8 crosses device memory. The
prefill's int8 x int8 product (``act_quant``) is :func:`int8_act_matmul`.

Usage::

    qsd = quantize_params(model.state_dict())
    qmodel = Griffin(config, device="meta", quantized=True)
    qmodel.to_empty(device="cuda")
    qmodel.load_state_dict(qsd)

:func:`quantize_params` works on the port's state dict, whose names are
flax's dotted paths. Each eligible leaf ``name`` becomes ``name_q`` (int8)
and ``name_scale`` (float32), as in JAX. The int8 values and scales are
JAX's bit for bit: float32 division, round half to even, clip to +-127.
Layouts are the port's, which the kernel reads with the contraction axis
last: a ``Dense`` ``kernel`` is already ``[out, in]``; the 3-D ``w`` of the
fused up-projection ``(c, d, D)`` and of the gates' block-diagonal
``(h, i, j)`` store their int8 values as ``(c, D, d)`` and ``(h, j, i)``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# Einsum weights are quantized when the *parent* module matches:
# ffw_up w (2, d, D) and vl_connector ffw_up w (1, vis, D) contract axis 1.
_EINSUM_PARENTS = ("ffw_up",)
# BlockDiagonalLinear gate weights (h, i, j) contract axis 1.
_BLOCKDIAG_PARENTS = ("input_gate", "a_gate")


def contract_axes(name: str, value: torch.Tensor) -> tuple[int, ...] | None:
  """The contraction axes of leaf ``name`` in the port's layout, or None for
  a leaf that stays unquantized (``_contract_axes`` in JAX, whose flax
  ``kernel`` ``[in, out]`` contracts axis 0 where the port's ``[out, in]``
  contracts axis 1)."""
  parts = name.split(".")
  leaf = parts[-1]
  parent = parts[-2] if len(parts) > 1 else ""
  if leaf == "kernel" and value.ndim == 2:
    return (1,)
  if leaf == "input_embedding":
    return (1,)
  if leaf == "w" and value.ndim == 3 and parent in (
      _EINSUM_PARENTS + _BLOCKDIAG_PARENTS):
    return (1,)
  return None


def quantize_tensor(
    w: torch.Tensor, contract_axes: tuple[int, ...]
) -> tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-output-channel int8 quantization -> ``(q, scale)``.

  ``q`` keeps ``w``'s layout; ``scale`` (float32) drops the contraction
  axes.
  """
  w32 = w.float()
  absmax = w32.abs().amax(dim=contract_axes, keepdim=True)
  scale = torch.clamp_min(absmax / 127.0, 1e-12)
  q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
  return q, scale.squeeze(contract_axes)


def dequantize_tensor(
    q: torch.Tensor,
    scale: torch.Tensor,
    contract_axes: tuple[int, ...],
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
  """int8 -> ``dtype`` weights of ``q``'s layout (tests and references only;
  the serving path never materializes them)."""
  shape = list(q.shape)
  for ax in contract_axes:
    shape[ax] = 1
  return (q.float() * scale.reshape(shape)).to(dtype)


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Dynamic symmetric per-row int8 activation quantization.

  Returns ``(q, scale)``: ``q`` int8 of ``x``'s shape and ``scale`` float32
  of shape ``x.shape[:-1] + (1,)``, with ``q * scale ~ x``.
  """
  x32 = x.float()
  absmax = x32.abs().amax(dim=-1, keepdim=True)
  scale = torch.clamp_min(absmax, 1e-12) / 127.0
  q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
  return q, scale


def _stored_layout(name: str, q: torch.Tensor) -> torch.Tensor:
  """The int8 values in the layout the port's module stores: the 3-D
  ``w`` leaves put their contraction axis last."""
  if name.rsplit(".", 1)[-1] == "w":
    return q.transpose(1, 2).contiguous()
  return q


def _flax_contract_axes(path: tuple[str, ...], value) -> tuple[int, ...] | None:
  """JAX's ``_contract_axes`` on a flax tree's layout (``kernel`` is
  ``[in, out]`` there)."""
  name = path[-1]
  parent = path[-2] if len(path) > 1 else ""
  if name == "kernel" and value.ndim == 2:
    return (0,)
  if name == "input_embedding":
    return (1,)
  if name == "w" and value.ndim == 3 and parent in (
      _EINSUM_PARENTS + _BLOCKDIAG_PARENTS):
    return (1,)
  return None


def _quantize_flax_tree(tree: Mapping, path: tuple[str, ...] = ()) -> dict:
  out = {}
  for key, value in tree.items():
    sub_path = path + (key,)
    if isinstance(value, Mapping):
      out[key] = _quantize_flax_tree(value, sub_path)
      continue
    array = np.asarray(value)
    axes = _flax_contract_axes(sub_path, array)
    if axes is None:
      out[key] = value
      continue
    q, scale = quantize_tensor(torch.from_numpy(array.astype(np.float32)),
                               axes)
    out[key + "_q"] = q.numpy()
    out[key + "_scale"] = scale.numpy()
  return out


def quantize_params(params: Mapping) -> dict:
  """Quantizes every heavy matrix of a parameter tree (``quantize_params``).

  Args:
    params: A ``Griffin`` or ``DinoSigLIPEncoder`` state dict (dotted flax
      names, the port's layouts, torch tensors), e.g. ``model.state_dict()``;
      or a flax tree (nested dicts of arrays in flax's layouts, as
      :func:`convert.read_npz_params` reads them).

  Returns:
    For a state dict, a new state dict: each eligible ``name`` replaced by
    ``name_q`` (int8, the quantized module's layout) and ``name_scale``
    (float32); every other leaf as it was. It loads into the same model
    built with ``quantized=True``. For a flax tree, the tree JAX's
    ``quantize_params`` returns (numpy ``_q`` and ``_scale`` leaves), which
    :func:`convert.griffin_from_flax_params` and
    :func:`convert.encoder_from_flax_params` load.
  """
  if any(isinstance(v, Mapping) for v in params.values()):
    return _quantize_flax_tree(params)
  out = {}
  for name, value in params.items():
    axes = contract_axes(name, value)
    if axes is None:
      out[name] = value
      continue
    q, scale = quantize_tensor(value, axes)
    out[name + "_q"] = _stored_layout(name, q)
    out[name + "_scale"] = scale
  return out


def quantized_bytes(params: Mapping[str, torch.Tensor]) -> int:
  """Total bytes of a state dict's tensors (for roofline estimates; meta
  tensors count too)."""
  return sum(t.numel() * t.element_size() for t in params.values())


# torch._int_mm on CUDA takes more than 16 rows and a depth and width that
# are multiples of 8.
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8

# Products :func:`int8_act_matmul` sent to ``torch._int_mm``; callers reset
# it to count one run.
int_mm_calls = 0


def int8_act_matmul(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
  """``xq @ q.T`` of int8 ``[m, k]`` and ``[n, k]`` into int32 ``[m, n]``.

  The contraction of an ``act_quant`` layer, a plain XLA ``dot_general``
  with an int32 result in JAX. On the card it is ``torch._int_mm``, whose
  int8 tensor-core product needs more than 16 rows: a shorter ``xq`` (a
  short admission prefill) is padded with zero rows and the result sliced.
  A depth or width that is not a multiple of 8 raises; nothing takes a
  float path. On the CPU the product is exact in int64, then int32.
  """
  global int_mm_calls
  if xq.dtype != torch.int8 or q.dtype != torch.int8:
    raise ValueError(f"int8_act_matmul takes int8 operands, got {xq.dtype} "
                     f"and {q.dtype}.")
  if xq.ndim != 2 or q.ndim != 2 or xq.shape[1] != q.shape[1]:
    raise ValueError(f"Expected [m, k] and [n, k], got {tuple(xq.shape)} and "
                     f"{tuple(q.shape)}.")
  if xq.device.type == "cpu":
    return (xq.long() @ q.long().T).to(torch.int32)
  if xq.device.type != "cuda":
    raise ValueError(f"int8_act_matmul runs on CUDA or CPU tensors, not "
                     f"{xq.device}.")
  m, k = xq.shape
  n = q.shape[0]
  if k % _INT_MM_MULTIPLE or n % _INT_MM_MULTIPLE:
    raise ValueError(
        f"torch._int_mm needs a depth and width that are multiples of "
        f"{_INT_MM_MULTIPLE}, got k={k}, n={n}."
    )
  rows = max(m, _INT_MM_MIN_ROWS)
  if rows != m:
    xq = torch.nn.functional.pad(xq, (0, 0, 0, rows - m))
  y = torch._int_mm(xq.contiguous(), q.T)  # pylint: disable=protected-access
  int_mm_calls += 1
  return y[:m] if rows != m else y
