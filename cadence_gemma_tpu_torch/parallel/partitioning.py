"""Parameter partitioning rules for tensor parallelism (TP).

Counterpart of the JAX package's ``cadence_gemma_tpu/parallel/partitioning.py``
with its names. Rules map a parameter's dotted state-dict name to a
:class:`PartitionSpec` over the canonical mesh axes:

  * ``data``      -- batch (DP),
  * ``sequence``  -- time (SP),
  * ``model``     -- hidden features (TP).

The rules are JAX's Megatron column -> row pairs, spoken in the port's
layouts: a ``Dense`` kernel is ``[out, in]`` (flax keeps ``[in, out]``), so
JAX's column ``P(None, m)`` is ``P(m, None)`` here and its row ``P(m, None)``
is ``P(None, m)``; an int8 ``w_q`` is stored contraction-last (``(c, D, d)``
for the fused up-projection, ``(h, j, i)`` for the gates), so its last two
entries swap against ``w``'s. Every other leaf keeps JAX's layout and spec.

  * MLP: ``ffw_up.w (2, d, D)`` shards D (column), ``ffw_down.kernel
    [d, D]`` shards D (row).
  * Recurrent: ``linear_x`` / ``linear_y`` shard lru (column); the conv,
    ``a_param`` and the gates' heads shard with the lru features;
    ``linear_out`` shards lru (row).
  * Attention: ``proj_q`` shards the query heads (column); the single-head
    ``proj_k`` / ``proj_v`` replicate; ``proj_final`` shards its input (row).
  * Embedder: the vocabulary.
  * Vision towers: ``attn_qkv`` / ``mlp_fc1`` column (their biases shard
    with the output), ``attn_proj`` / ``mlp_fc2`` row.

JAX hands the shardings to GSPMD; the port's tensor-parallel model
(``parallel/tensor_parallel.py``) places the leaves by them and runs the
sharded forward itself, forward and backward; ``opt_state_shardings`` gives
the layouts of the optimizer state, keyed by leaf name and state key.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from cadence_gemma_tpu_torch.parallel import sharding as sharding_lib

BATCH_AXIS = sharding_lib.BATCH_AXIS
SEQUENCE_AXIS = sharding_lib.SEQUENCE_AXIS
MODEL_AXIS = sharding_lib.MODEL_AXIS

PartitionSpec = sharding_lib.PartitionSpec
P = PartitionSpec
NamedSharding = sharding_lib.NamedSharding

_COLUMN = ("linear_x", "linear_y", "proj_q")
_ROW = ("linear_out", "proj_final", "ffw_down")


def _entries(spec: P, ndim: int) -> list:
  return list(spec) + [None] * (ndim - len(spec))


def _spec_for(path: tuple[str, ...], value: Any, model_axis: str) -> P:
  """PartitionSpec for one parameter, by its name's parts and its rank."""
  name = path[-1]
  parent = path[-2] if len(path) >= 2 else ""
  grandparent = path[-3] if len(path) >= 3 else ""
  m = model_axis

  # Quantized twins: ``_q`` takes its base leaf's layout (the contraction
  # axis of a 3-D ``w`` moved last, as the port stores it), ``_scale`` that
  # layout minus the contracted entry. Before the ndim <= 1 rule: the 1-D
  # kernel_scale of a column-parallel kernel shards.
  if name.endswith("_q") or name.endswith("_scale"):
    is_scale = name.endswith("_scale")
    base = name[: -len("_scale") if is_scale else -len("_q")]
    # The contracted axis of each base leaf in the port's layout.
    contract = {"kernel": 1, "input_embedding": 1, "w": 1}.get(base)
    if contract is not None:
      base_ndim = value.ndim + (1 if is_scale else 0)
      entries = _entries(
          _spec_for(path[:-1] + (base,), _NdimOnly(base_ndim), m), base_ndim)
      if is_scale:
        return P(*(a for i, a in enumerate(entries) if i != contract))
      if base == "w" and base_ndim == 3:
        entries = [entries[0], entries[2], entries[1]]
      return P(*entries)

  # LoRA adapters keep flax's layouts (``lora_a`` [.., in, r], ``lora_b``
  # [.., r, out]) and mirror their parent's Megatron layout: a column
  # parent shards lora_b's output, a row parent lora_a's input.
  if name in ("lora_a", "lora_b"):
    if name == "lora_b" and parent in _COLUMN:
      return P(None, m)
    if name == "lora_a" and parent in _ROW:
      return P(m, None)
    if name == "lora_b" and parent == "ffw_up" and value.ndim == 3:
      return P(None, None, m)  # fused (c, r, D): shard D like w
    return P(*([None] * value.ndim))

  if name == "input_embedding":
    return P(m, None)

  if value.ndim <= 1:
    if name == "a_param":
      return P(m)
    if name == "b" and parent == "conv_1d":
      return P(m)
    if name == "bias" and parent in ("attn_qkv", "mlp_fc1"):
      return P(m)
    return P()

  if parent == "ffw_up" and grandparent == "mlp_block":
    return P(None, None, m) if value.ndim == 3 else P(*([None] * value.ndim))
  if parent == "ffw_down" and name == "kernel":
    return P(None, m)
  if parent == "ffw_up":  # the connector's up-projection (1, vis, D)
    return P(None, None, m) if value.ndim == 3 else P()

  if name == "b" and value.ndim == 4:  # ffw_up bias (2, 1, 1, D)
    return P(None, None, None, m)

  if parent in ("linear_x", "linear_y") and name == "kernel":
    return P(m, None)
  if parent == "linear_out" and name == "kernel":
    return P(None, m)
  if parent == "conv_1d" and name == "w":
    return P(None, m)
  if parent in ("input_gate", "a_gate"):
    return P(m, None, None) if value.ndim == 3 else P(m, None)

  if parent == "proj_q" and name == "kernel":
    return P(m, None)
  if parent == "proj_final" and name == "kernel":
    return P(None, m)
  if parent in ("proj_k", "proj_v"):
    return P(*([None] * value.ndim))

  # The vision towers' column -> row pairs (``tensor_parallel.
  # TensorParallelEncoder`` runs them); patch_embed, pos_embed,
  # prefix_tokens, the norms and the layer scales replicate.
  if parent in ("attn_qkv", "mlp_fc1") and name == "kernel":
    return P(m, None)
  if parent in ("attn_proj", "mlp_fc2") and name == "kernel":
    return P(None, m)

  return P(*([None] * value.ndim))


class _NdimOnly:
  """Shape-free stand-in for re-deriving a base leaf's spec by rank."""

  def __init__(self, ndim: int):
    self.ndim = ndim


def _parts(name: str) -> tuple[str, ...]:
  return tuple(name.split("."))


def griffin_param_specs(params: Mapping[str, torch.Tensor],
                        model_axis: str = MODEL_AXIS) -> dict[str, P]:
  """PartitionSpec for every leaf of a state dict, for TP over
  ``model_axis``."""
  return {name: _spec_for(_parts(name), value, model_axis)
          for name, value in params.items()}


def _drop_indivisible(spec: P, shape: tuple,
                      mesh: sharding_lib.Mesh) -> P:
  """Replicates the entries whose dimension does not divide by the axis size
  (the 2B's 10 gate heads on a 4-way axis), trailing ``None``s removed so a
  replicated leaf comes out ``P()``, as JAX's does."""
  out = []
  for dim, name in zip(shape, _entries(spec, len(shape))):
    if name is None:
      out.append(None)
      continue
    axes = name if isinstance(name, tuple) else (name,)
    size = 1
    for a in axes:
      size *= mesh.shape[a]
    out.append(name if dim % size == 0 else None)
  while out and out[-1] is None:
    out.pop()
  return P(*out)


def griffin_param_shardings(mesh: sharding_lib.Mesh,
                            params: Mapping[str, torch.Tensor],
                            model_axis: str = MODEL_AXIS
                            ) -> dict[str, NamedSharding]:
  """NamedSharding for every leaf of ``params`` on ``mesh``."""
  if model_axis not in mesh.axis_names:
    raise ValueError(f"The mesh {mesh} has no axis {model_axis!r}.")
  return {name: NamedSharding(mesh, _drop_indivisible(spec,
                                                      tuple(params[name].shape),
                                                      mesh))
          for name, spec in griffin_param_specs(params, model_axis).items()}


def param_shardings_or_replicated(mesh: sharding_lib.Mesh,
                                  params: Mapping[str, torch.Tensor],
                                  model_axis: str = MODEL_AXIS
                                  ) -> dict[str, NamedSharding]:
  """TP layouts when ``model_axis`` names a mesh axis, else every leaf
  replicated."""
  if model_axis in mesh.axis_names:
    return griffin_param_shardings(mesh, params, model_axis)
  return {name: NamedSharding(mesh, P()) for name in params}


def griffin_cache_specs(cache: Mapping[str, Any],
                        model_axis: str = MODEL_AXIS) -> dict[str, Any]:
  """PartitionSpec tree of a decode cache (``{"blocks.i": NamedTuple}``)
  under the TP layouts: the recurrent state and the conv tail are lru-width
  features from the column-parallel ``linear_x`` and shard over
  ``model_axis``; the attention ring comes from the replicated single-head
  ``proj_k`` / ``proj_v`` and replicates. The batch (slot) dimension never
  shards."""

  def block_specs(entry):
    if hasattr(entry, "rg_lru_state"):
      return type(entry)(
          rg_lru_state=P(*([None] * (entry.rg_lru_state.ndim - 1)),
                         model_axis),
          conv1d_state=P(*([None] * (entry.conv1d_state.ndim - 1)),
                         model_axis),
      )
    return type(entry)(*(P(*([None] * leaf.ndim)) for leaf in entry))

  return {name: block_specs(entry) for name, entry in cache.items()}


def griffin_cache_shardings(mesh: sharding_lib.Mesh, cache: Mapping[str, Any],
                            model_axis: str = MODEL_AXIS) -> dict[str, Any]:
  """NamedSharding tree of a decode cache on ``mesh`` (TP layouts)."""
  specs = griffin_cache_specs(cache, model_axis)
  return {
      name: type(entry)(*(
          NamedSharding(mesh, _drop_indivisible(s, tuple(leaf.shape), mesh))
          for s, leaf in zip(specs[name], entry)))
      for name, entry in cache.items()
  }


class _StandIn:
  """Parameters of one element under a state dict's names: what an
  optimizer factory builds over to show its state's keys and shapes."""

  def __init__(self, names):
    self.params = {name: torch.zeros(1, requires_grad=True) for name in names}

  def named_parameters(self):
    return iter(self.params.items())

  def parameters(self):
    return iter(self.params.values())


def opt_state_shardings(mesh: sharding_lib.Mesh, optimizer,
                        example_params: Mapping[str, torch.Tensor],
                        model_axis: str = MODEL_AXIS
                        ) -> dict[str, dict[str, NamedSharding]]:
  """The layouts of the optimizer state over ``example_params``: ``{leaf
  name: {state key: NamedSharding}}`` (JAX ``partitioning.py:280-313``).

  torch keeps an optimizer's state per parameter, so the tree is keyed by
  the parameter's name and the state's key, where optax nests the
  parameter tree under each of its states. ``optimizer`` builds the
  optimizer over a model-like object (``optimizer(params)``, as
  ``trainer.make_optimizer`` does; the counterpart of optax's
  ``optimizer.init``): it is run for one step over one-element stand-ins
  of the leaves, to read which state each leaf takes. A state the shape of
  its parameter (Adam's ``exp_avg`` and ``exp_avg_sq``) takes the leaf's
  spec by the parameters' rules and ``_drop_indivisible``; any other (the
  ``step`` counter) replicates, as every leaf does when ``model_axis``
  names no axis of ``mesh``. Leaves the optimizer does not hold (a LoRA
  optimizer's base) have no entry.
  """
  stand_in = _StandIn(example_params)
  opt = optimizer(stand_in)
  for p in stand_in.parameters():
    p.grad = torch.zeros_like(p)
  opt.step()
  tp = model_axis in mesh.axis_names
  out = {}
  for name, p in stand_in.named_parameters():
    if not opt.state.get(p):
      continue
    value = example_params[name]
    spec = (_drop_indivisible(_spec_for(_parts(name), value, model_axis),
                              tuple(value.shape), mesh) if tp else P())
    out[name] = {key: NamedSharding(mesh, spec if torch.is_tensor(v)
                                    and v.shape == p.shape else P())
                 for key, v in opt.state[p].items()}
  return out


def data_sharding(mesh: sharding_lib.Mesh, batch_axis: str = BATCH_AXIS,
                  sequence_axis: str | None = None) -> NamedSharding:
  """Sharding for [batch, time] token arrays."""
  return NamedSharding(mesh, P(batch_axis, sequence_axis))
