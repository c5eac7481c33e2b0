"""LoRA fine-tuning: a frozen base and trainable low-rank adapters.

Counterpart of the JAX package's ``cadence_gemma_tpu/training/lora.py``
over the port's state dicts (flat, dotted flax names). With
``Griffin(config, lora_rank=r)`` every ``Dense`` and ``Einsum`` projection
carries a ``lora_a`` / ``lora_b`` pair (``lora_b`` zero, so the adapters
change nothing until they train) and only those pairs train here. The frozen
base may be the bf16 model or its ``quantize_params`` copy
(``Griffin(quantized=True, lora_rank=r)``, QLoRA): the weight-only int8
product back-propagates to its input through a CUDA kernel on the card
(``ops/int8_matmul.py``), so no bf16 copy of an int8 weight is made.

  * :func:`split_lora` / :func:`merge_params` move between a combined state
    dict and its (adapters, base) halves, stacked trees
    (``Griffin(lora_rows=...)``, multi-LoRA serving) included;
    :func:`scatter_adapters` writes one request's adapters into a stack's
    row in place;
  * :func:`lora_train_step` differentiates the adapters alone: only they
    require a gradient in its forward and backward, so gradients and Adam's
    moments exist at adapter size only;
  * :func:`merge_lora` folds trained adapters into the bf16 weights for
    adapter-free serving;
  * :func:`init_adapters` draws fresh adapters for a model from a
    ``torch.Generator`` without building any model weight;
  * :func:`make_sharded_lora_step` trains the adapters over a DP x TP mesh.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch

from cadence_gemma_tpu_torch.models import layers
from cadence_gemma_tpu_torch.parallel import data_parallel
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.training import trainer

LORA_LEAF_NAMES = layers.LORA_LEAF_NAMES


def is_lora_path(path: str | tuple[str, ...]) -> bool:
  """Whether a parameter's name (dotted, or a tuple of its parts) is an
  adapter leaf."""
  if isinstance(path, str):
    path = tuple(path.split("."))
  return bool(path) and path[-1] in LORA_LEAF_NAMES


def split_lora(
    params: Mapping[str, torch.Tensor]
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
  """Splits a combined state dict into (adapters, frozen base)."""
  lora, base = {}, {}
  for name, value in params.items():
    (lora if is_lora_path(name) else base)[name] = value
  return lora, base


def merge_params(base: Mapping[str, torch.Tensor],
                 lora: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
  """Recombines the halves of :func:`split_lora` (``lora`` wins a clash)."""
  return {**base, **lora}


@torch.no_grad()
def scatter_adapters(stacked: Mapping[str, torch.Tensor],
                     adapters: Mapping[str, torch.Tensor], row: int) -> None:
  """Writes ``adapters`` into row ``row`` of each ``[rows, ...]`` leaf of
  ``stacked`` in place, cast to the stack's dtype (JAX's
  ``_scatter_adapters``, ``serving.py:656-663``): a captured CUDA graph
  that reads the stacks sees the new row."""
  torch._foreach_copy_([leaf[row] for leaf in stacked.values()],  # pylint: disable=protected-access
                       [adapters[name] for name in stacked])


def lora_mask(params: Mapping[str, torch.Tensor]) -> dict[str, bool]:
  """True on adapter leaves, by name."""
  return {name: is_lora_path(name) for name in params}


def lora_parameters(model: torch.nn.Module) -> list[torch.nn.Parameter]:
  """The adapter parameters of ``model``, in its order."""
  return [p for name, p in model.named_parameters() if is_lora_path(name)]


def make_optimizer(params: Iterable[torch.Tensor],
                   learning_rate: float = 1e-4) -> torch.optim.Adam:
  """Adam over the adapters: b1 0.9, b2 0.999, eps 1e-8, no weight decay
  (the usual LoRA setup); :func:`trainer.apply_update` clips their
  gradients' global norm to 1.0 first (optax's
  ``chain(clip_by_global_norm(1.0), adam)``)."""
  return torch.optim.Adam(list(params), lr=learning_rate, betas=(0.9, 0.999),
                          eps=1e-8)


def lora_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    pad_id: int,
    input_tokens: torch.Tensor,
    input_mask: torch.Tensor,
    img_embed: torch.Tensor | None = None,
) -> torch.Tensor:
  """One adapter-only step; returns the loss (detached).

  ``optimizer`` is :func:`make_optimizer` of :func:`lora_parameters`; only
  its parameters require a gradient during the step, so the base (bf16 or
  int8) keeps none and stays bit-identical.
  """
  if ({id(p) for p in trainer.optimizer_parameters(optimizer)}
      != {id(p) for p in lora_parameters(model)}):
    raise ValueError("lora_train_step trains the model's adapters alone: "
                     "build its optimizer with "
                     "make_optimizer(lora_parameters(model)).")
  return trainer.train_step(model, optimizer, pad_id, input_tokens,
                            input_mask, img_embed)


@torch.no_grad()
def merge_lora(params: Mapping[str, torch.Tensor],
               lora_alpha: float | None = None) -> dict[str, torch.Tensor]:
  """Folds trained adapters into the base weights; drops the adapter leaves.

  Returns a state dict for a ``lora_rank=0`` model that reproduces the LoRA
  model: ``kernel += (a @ b * s).T`` for a ``Dense`` (the port's kernel is
  ``[out, in]``), ``w[c] += a[c] @ b[c] * s`` for the fused ``Einsum``, with
  ``s = alpha / rank`` (``alpha`` defaults to the rank), in float32 and
  rounded once to the weight's dtype. A quantized base (``kernel_q``)
  cannot be folded losslessly and raises.
  """
  out = {name: value for name, value in params.items()
         if not is_lora_path(name)}
  for name, a in params.items():
    if not name.endswith(".lora_a"):
      continue
    prefix = name[:-len("lora_a")]
    b = params[prefix + "lora_b"]
    rank = a.shape[-1]
    scaling = (lora_alpha if lora_alpha is not None else float(rank)) / rank
    delta = torch.matmul(a.float(), b.float()) * scaling
    if prefix + "kernel" in out:
      target, delta = prefix + "kernel", delta.T
    elif prefix + "w" in out:
      target = prefix + "w"
    else:
      keys = sorted(k[len(prefix):] for k in params if k.startswith(prefix))
      raise ValueError(
          "LoRA adapters found beside neither 'kernel' nor 'w' — "
          f"keys: {keys}. Quantized trees ('kernel_q') cannot be folded "
          "losslessly; merge into the bf16 tree and requantize with "
          "ops.quantization.quantize_params instead.")
    weight = out[target]
    out[target] = (weight.float() + delta.to(weight.device)).to(weight.dtype)
  return out


@torch.no_grad()
def init_adapters(model: torch.nn.Module,
                  generator: torch.Generator) -> dict[str, torch.Tensor]:
  """Fresh adapters for a ``lora_rank > 0`` model, on the generator's
  device, in the model's adapter dtype: ``lora_a`` normal(fan_in^-0.5),
  ``lora_b`` zeros, drawn in the model's parameter order. Reads only the
  adapters' shapes (the model may live on ``meta``); load them with
  ``model.load_state_dict(..., strict=False)`` or :func:`merge_params`."""
  adapters = {}
  for name, p in model.named_parameters():
    if is_lora_path(name):
      leaf = torch.empty(p.shape, dtype=p.dtype, device=generator.device)
      layers.init_lora_(name, leaf, generator)
      adapters[name] = leaf
  if not adapters:
    raise ValueError("The model has no lora_a/lora_b leaves: build it with "
                     "lora_rank > 0.")
  return adapters


def lora_parameter_count(lora_params: Mapping[str, torch.Tensor]) -> int:
  return sum(leaf.numel() for leaf in lora_params.values())


def make_sharded_lora_step(
    model: torch.nn.Module,
    optimizer,
    mesh,
    pad_id: int,
    example_adapters: Mapping[str, torch.Tensor],
    example_base: Mapping[str, torch.Tensor],
    batch_axis: str | None = None,
    model_axis: str | None = None,
):
  """The adapter-only step over a mesh, DP x TP (JAX ``lora.py:167-243``).

  The frozen base (bf16, or int8 for QLoRA: its pieces contiguous copies
  for the kernels) takes the Megatron layouts and the adapters JAX's LoRA
  layouts (a column parent shards ``lora_b``'s output, a row parent
  ``lora_a``'s input); the batch splits over ``batch_axis``, and only the
  adapters' gradients exist and are all-reduced over it.

  Returns ``(step_fn, shard_fn)``. ``shard_fn(adapters, base)`` places the
  two halves of ``model``'s state dict (:func:`split_lora` of its
  ``state_dict()``, whose tensors are views of the model's, so the model
  holds the trained adapters) as one
  :class:`~cadence_gemma_tpu_torch.parallel.data_parallel.ShardedGriffin`,
  since torch's optimizer keeps references to the adapters' pieces; and
  ``step_fn(params, opt_state, input_tokens, input_mask, img_embed=None)``
  takes that object where JAX takes ``(adapters, base)``, and returns
  ``(loss, params, opt_state)``. ``optimizer`` builds the optimizer over it
  (e.g. ``lambda p: make_optimizer(lora_parameters(p), 1e-4)``), as
  :func:`trainer.make_sharded_train_step`'s does.
  """
  batch_axis = batch_axis or partitioning.BATCH_AXIS
  model_axis = model_axis or partitioning.MODEL_AXIS
  shardings = {
      **partitioning.param_shardings_or_replicated(mesh, example_base,
                                                   model_axis),
      **partitioning.param_shardings_or_replicated(mesh, example_adapters,
                                                   model_axis)}
  if not callable(optimizer):
    raise TypeError("optimizer must build the optimizer over the sharded "
                    "parameters: optimizer(shard_fn(adapters, base)).")

  def shard_fn(adapters, base):
    return data_parallel.ShardedGriffin(
        model, merge_params(base, adapters), mesh, shardings, batch_axis,
        model_axis, trains=is_lora_path)

  def step_fn(params, opt_state, input_tokens, input_mask, img_embed=None):
    adapters = {id(t) for name, t in params.named_parameters()
                if is_lora_path(name)}
    if not all(id(p) in adapters
               for p in trainer.optimizer_parameters(opt_state)):
      raise ValueError("The sharded LoRA step trains the adapters alone: "
                       "build its optimizer over lora_parameters(params).")
    loss = trainer.sharded_train_step(params, opt_state, pad_id, input_tokens,
                                      input_mask, img_embed)
    return loss, params, opt_state

  return step_fn, shard_fn
