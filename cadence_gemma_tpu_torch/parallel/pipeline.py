"""Pipeline parallelism (GPipe and interleaved) for the Griffin block stack.

Counterpart of the JAX package's ``cadence_gemma_tpu/parallel/pipeline.py``,
with its names, schedule and parameter layout. JAX runs the whole pipeline as
one ``shard_map`` program: a ``lax.scan`` over the schedule's steps, each
device applying one of its chunks and handing its activation one hop round
the ``stage`` ring by ``ppermute``. The port is single-controller, as its
other parallel paths are (``parallel/sharding.py``): one program holds the
whole batch, a Python loop walks the same schedule, and at each step the
controller runs every busy stage's chunk on that stage's device, then moves
the activations one hop with :func:`sharding.ppermute` and JAX's cyclic
permutation. A device may repeat in the mesh, so a ``(stage=4,)`` mesh of
``["cuda:0"] * 4`` runs every stage on one card.

  * The stack splits into ``C = S * v`` chunks of ``layers_per_chunk``
    blocks; chunk ``j`` lives on stage position ``j % S``. At step ``t``
    stage ``d`` runs its lap ``((t - d) mod C) // S`` on microbatch ``m``
    (JAX's formulas, ``pipeline.py:366-371``); stage 0 injects on lap 0 and
    the last stage retires on its last lap. ``interleave=1`` is GPipe.
  * A single controller knows the bubble slots statically (those whose
    ``m`` falls outside ``[0, M)``) and skips them: JAX computes on zeros
    there and masks the result, so both give the same numbers, and the port
    launches nothing in a bubble.
  * Each chunk runs its blocks through the port's own
    :class:`~models.modules.ResidualBlock` (``torch.func.functional_call``
    of one template block a pattern slot, built on the ``meta`` device, over
    the chunk's piece of the stacked weights), so the scan and window
    attention route to the kernels as in ``Griffin.forward``. While autograd
    records, each chunk runs under ``torch.utils.checkpoint`` as JAX wraps
    ``chunk_fn`` in ``jax.checkpoint``.
  * PP x DP: the batch splits over every mesh axis but ``stage`` (row-major
    over those axes, JAX's batch sharding); each data slice runs its own
    pipeline on its devices, and the results concatenate in JAX's batch
    order.
  * A stack that does not split into equal stages pipelines its largest
    prefix whose stages share one pattern and runs the tail blocks after the
    pipeline, on the full batch (24 of the 2B's 26 blocks at 2 or 4
    stages).

The stacked weights are ``{"layer_{j}.<leaf>": [C, ...]}`` in JAX's position
order (:meth:`GriffinPipeline.stack_params`); placed by
:meth:`~GriffinPipeline.stage_sharding` with :func:`sharding.place_state_dict`
they become one ``[v, ...]`` piece a stage position, a view where the
position's device is the stacked tensor's. The embedder, the connector, the
final norm and the tail blocks stay in ``shared`` under their own names and
run outside the pipeline, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import griffin as griffin_lib
from cadence_gemma_tpu_torch.models import modules
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.training import trainer

STAGE_AXIS = "stage"

# ``{name: tensor}``; a placed stacked tree holds ``{name: [piece, ...]}``.
Params = dict[str, Any]


def _is_uniform(
    block_types: tuple[common.TemporalBlockType, ...], num_stages: int
) -> bool:
  per_stage = len(block_types) // num_stages
  pattern = block_types[:per_stage]
  return all(
      block_types[s * per_stage:(s + 1) * per_stage] == pattern
      for s in range(1, num_stages)
  )


def pipelined_prefix_length(
    block_types: tuple[common.TemporalBlockType, ...], num_stages: int
) -> int:
  """Largest ``m`` so blocks [0, m) split into identical-pattern stages.

  Blocks [m, num_layers) become the unpipelined tail: 24 of the 2B preset's
  26 blocks at 2 or 4 stages.
  """
  if num_stages < 1:
    raise ValueError(f"num_stages must be >= 1, got {num_stages}.")
  n = len(block_types)
  for m in range(n - n % num_stages, 0, -num_stages):
    if _is_uniform(block_types[:m], num_stages):
      return m
  raise ValueError(
      f"No prefix of {block_types} splits into {num_stages} "
      "identical-pattern stages."
  )


def stage_block_types(
    block_types: tuple[common.TemporalBlockType, ...], num_stages: int
) -> tuple[common.TemporalBlockType, ...]:
  """The per-stage block-type pattern of the pipelined prefix."""
  m = pipelined_prefix_length(block_types, num_stages)
  return block_types[:m // num_stages]


class _Method(nn.Module):
  """``fn(module, *args)`` as a module's forward, so
  ``torch.func.functional_call`` can run a method (``Embedder.encode``,
  ``Griffin.decode_hidden``) over parameters passed in."""

  def __init__(self, module: nn.Module, fn: Callable[..., Any]):
    super().__init__()
    self.module = module
    self.fn = fn

  def forward(self, *args):
    return self.fn(self.module, *args)


def _trains(name: str, tensor: torch.Tensor) -> bool:
  """Whether a leaf trains: floating point, and not an int8 layer's
  weight or scale."""
  return (tensor.is_floating_point()
          and not name.endswith(("_q", "_scale")))


@dataclasses.dataclass(frozen=True)
class GriffinPipeline:
  """GPipe (or interleaved) execution of a ``Griffin`` over a mesh axis.

  Attributes:
    model: The unpipelined model: its config and flags (dtype, quantized,
      the attention kernel's routing) and the embedder / connector / final
      norm code. Its own weights are not read; ``shared`` and the stacked
      tree hold the weights.
    mesh: A :class:`sharding.Mesh` holding ``axis_name``; the batch splits
      over every other axis (DP: each data slice runs its own pipeline on
      its 1/dp of the batch).
    num_microbatches: ``M`` a data slice; the global batch must divide by
      ``M x dp``.
    axis_name: The mesh axis carrying the stages.
    interleave: Chunks a stage ``v`` (the circular schedule); 1 is GPipe.
  """

  model: griffin_lib.Griffin
  mesh: sharding.Mesh
  num_microbatches: int
  axis_name: str = STAGE_AXIS
  interleave: int = 1

  @property
  def num_stages(self) -> int:
    return self.mesh.shape[self.axis_name]

  @property
  def num_chunks(self) -> int:
    """Total pipeline chunks ``C = S * v``; chunk j lives on stage j % S."""
    return self.num_stages * self.interleave

  @property
  def pipelined_layers(self) -> int:
    """Blocks [0, pipelined_layers) run in the pipeline; the rest is tail."""
    return pipelined_prefix_length(
        self.model.config.block_types, self.num_chunks)

  @property
  def layers_per_stage(self) -> int:
    """Blocks resident a stage position (v chunks of layers_per_chunk)."""
    return self.pipelined_layers // self.num_stages

  @property
  def layers_per_chunk(self) -> int:
    return self.pipelined_layers // self.num_chunks

  @property
  def schedule_steps(self) -> int:
    """Steps until the last microbatch retires: microbatch ``m = q*S + r``
    injects at step ``q*C + r`` and runs its ``C`` chunks on consecutive
    steps, so the schedule runs ``q*C + r + C`` steps for ``q, r =
    divmod(M - 1, S)`` (``M*v + S - 1`` when ``S`` divides ``M``, and
    ``M + S - 1`` at v=1 for any ``M``)."""
    q, r = divmod(self.num_microbatches - 1, self.num_stages)
    return q * self.num_chunks + r + self.num_chunks

  @property
  def bubble_fraction(self) -> float:
    """Idle share of the schedule's stage-steps: ``1 - M*C / (steps*S)``,
    ``(S-1)/(M*v + S-1)`` when ``S | M``."""
    total = self.schedule_steps * self.num_stages
    useful = self.num_microbatches * self.num_chunks
    return 1.0 - useful / total

  @property
  def tail_layers(self) -> tuple[int, ...]:
    """Indices of the unpipelined tail blocks (often empty)."""
    return tuple(range(self.pipelined_layers, self.model.config.num_layers))

  def __post_init__(self):
    if self.interleave < 1:
      raise ValueError(f"interleave must be >= 1, got {self.interleave}.")
    model = self.model
    for flag, reason in (
        (model.lora_rank, "LoRA adapters (lora_rank)"),
        (model.lora_rows, "per-row adapters (lora_rows)"),
        (model.scan_sharding_spec is not None,
         "a sequence-parallel scan (scan_sharding_spec)")):
      if flag:
        raise ValueError(
            f"GriffinPipeline builds its blocks as JAX's pipeline does "
            f"(pipeline.py:282-298), without {reason}; pipeline the base "
            f"model.")
    sharding.refuse_processes(self.mesh, "Pipeline parallelism (its hops)")
    for dev in set(self.mesh.devices.flat):
      griffin_lib.resolve_device(dev)  # a CUDA mesh raises without a card
    pattern = stage_block_types(model.config.block_types, self.num_chunks)
    templates = {block_type: self._make_block(block_type)
                 for block_type in set(model.config.block_types)}
    object.__setattr__(self, "_templates", templates)
    object.__setattr__(self, "_chunk_blocks",
                       [templates[block_type] for block_type in pattern])
    if len(self.tail_layers) > self.layers_per_stage:
      warnings.warn(
          f"Pipeline split is poor: only {self.pipelined_layers} of "
          f"{model.config.num_layers} blocks pipeline over "
          f"{self.num_stages} stages; {len(self.tail_layers)} tail "
          "blocks run unpipelined (replicated). Pick a stage count "
          "aligned with the block-type cycle.",
          stacklevel=3,
      )

  def _make_block(self, block_type) -> modules.ResidualBlock:
    """A weightless (``meta``) block of ``block_type`` with the model's
    flags: unfused, as JAX's ``_make_block`` builds it."""
    cfg, model = self.model.config, self.model
    attention = [b.attention_block.use_flash_attention for b in model.blocks
                 if b.temporal_block_type is common.TemporalBlockType.ATTENTION]
    return modules.ResidualBlock(
        width=cfg.width,
        mlp_expanded_width=cfg.mlp_expanded_width,
        num_heads=cfg.num_heads,
        attention_window_size=cfg.attention_window_size,
        temporal_block_type=block_type,
        lru_width=cfg.lru_width,
        scan_type=cfg.scan_type,
        use_flash_attention=attention[0] if attention else None,
        quantized=model.quantized,
        act_quant=model.act_quant,
        device="meta",
        dtype=model.final_norm.scale.dtype,
    )

  # -- parameter layout -----------------------------------------------------

  def _chunk_of_position(self, p: int) -> int:
    """Chunk index at stacking position ``p``: ``(p % v)*S + p // v``, so
    stage ``d``'s chunks ``d, d+S, ..., d+(v-1)S`` sit in its contiguous
    piece [d*v, (d+1)*v). At v=1 the identity (GPipe)."""
    return (p % self.interleave) * self.num_stages + p // self.interleave

  def stack_params(self, params: Mapping[str, torch.Tensor]
                   ) -> tuple[Params, Params]:
    """Splits a state dict into (chunk-stacked blocks, shared rest).

    Stacked leaf ``layer_{j}.<leaf>`` gains a leading ``[num_chunks]`` axis:
    position ``p`` holds ``blocks.{_chunk_of_position(p) * layers_per_chunk
    + j}.<leaf>`` (a new tensor on the blocks' device). Place it with
    :meth:`stage_sharding` so each stage position holds only its chunks.
    The tail blocks, embedder, final norm and connector stay in ``shared``
    as the same tensors, under their own names.
    """
    lpc = self.layers_per_chunk
    stacked = {}
    with torch.no_grad():
      for j in range(lpc):
        prefixes = [f"blocks.{self._chunk_of_position(p) * lpc + j}."
                    for p in range(self.num_chunks)]
        for name in params:
          if name.startswith(prefixes[0]):
            leaf = name[len(prefixes[0]):]
            stacked[f"layer_{j}.{leaf}"] = torch.stack(
                [params[prefix + leaf] for prefix in prefixes])
    pipelined = tuple(f"blocks.{i}." for i in range(self.pipelined_layers))
    shared = {k: v for k, v in params.items() if not k.startswith(pipelined)}
    return stacked, shared

  @staticmethod
  def _whole(value) -> torch.Tensor:
    """A stacked leaf as one ``[C, ...]`` tensor: placed pieces are
    concatenated on the first piece's device."""
    if torch.is_tensor(value):
      return value
    return torch.cat([p.to(value[0].device) for p in value])

  def unstack_params(self, stacked: Params, shared: Params) -> Params:
    """Inverse of :meth:`stack_params` (e.g. to save a checkpoint, or to
    read gradients by block); takes the stacked tree placed or not."""
    params = dict(shared)
    lpc = self.layers_per_chunk
    for name, value in stacked.items():
      slot, leaf = name.split(".", 1)
      j = int(slot[len("layer_"):])
      whole = self._whole(value)
      for p in range(self.num_chunks):
        block = self._chunk_of_position(p) * lpc + j
        params[f"blocks.{block}.{leaf}"] = whole[p]
    return params

  def stage_sharding(self, stacked: Params
                     ) -> dict[str, sharding.NamedSharding]:
    """``NamedSharding(mesh, PartitionSpec(axis_name))`` a stacked leaf:
    ``sharding.place_state_dict(stacked, pipe.stage_sharding(stacked))``
    gives each stage position its ``[v, ...]`` piece."""
    spec = sharding.NamedSharding(self.mesh,
                                  sharding.PartitionSpec(self.axis_name))
    return {name: spec for name in stacked}

  def _placed(self, stacked: Params) -> Params:
    """The stacked tree as pieces a stage position (a tensor leaf is
    placed here, as views on its own device)."""
    spec = sharding.NamedSharding(self.mesh,
                                  sharding.PartitionSpec(self.axis_name))
    return {name: (sharding.place(value, spec, self.axis_name)
                   if torch.is_tensor(value) else list(value))
            for name, value in stacked.items()}

  def parameters(self, stacked: Params, shared: Params
                 ) -> list[torch.Tensor]:
    """The trained tensors, each marked as requiring a gradient: every
    placed stage piece and every floating-point shared leaf but an int8
    layer's scales. A ``torch.optim`` optimizer of :meth:`make_train_step`
    is built over them."""
    out = []
    for name, value in stacked.items():
      if torch.is_tensor(value):
        raise ValueError(
            f"{name} is not placed: train the placed tree, "
            "sharding.place_state_dict(stacked, pipe.stage_sharding("
            "stacked)), whose pieces the optimizer holds.")
      if _trains(name, value[0]):
        out += value
    out += [t for name, t in shared.items() if _trains(name, t)]
    return [t.requires_grad_(True) for t in out]

  @staticmethod
  def gradients(stacked: Params, shared: Params) -> tuple[Params, Params]:
    """``(stacked, shared)`` gradients after a backward: each piece's on
    its own position, each shared leaf's (where it has one);
    :meth:`unstack_params` of them gives the gradient by block."""
    g_stacked = {name: [p.grad for p in value]
                 for name, value in stacked.items()
                 if not torch.is_tensor(value) and value[0].grad is not None}
    g_shared = {name: t.grad for name, t in shared.items()
                if t.grad is not None}
    return g_stacked, g_shared

  # -- the schedule ---------------------------------------------------------

  def _data_slices(self) -> list[list[torch.device]]:
    """``[i][d]``: the device of data slice ``i``'s stage ``d``, the slices
    row-major over every axis but the stage axis."""
    names = self.mesh.axis_names
    batch_axes = [a for a in names if a != self.axis_name]
    shape = [self.mesh.shape[a] for a in batch_axes]
    out = []
    for i in range(math.prod(shape)):
      index = dict(zip(batch_axes, np.unravel_index(i, shape)))
      row = []
      for d in range(self.num_stages):
        index[self.axis_name] = d
        row.append(self.mesh.devices[tuple(int(index[a]) for a in names)])
      out.append(row)
    return out

  def _chunk(self, piece: Mapping[str, torch.Tensor], lap: int,
             h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Chunk ``lap`` of a stage's ``[v, ...]`` piece on one microbatch."""
    slots = [{} for _ in self._chunk_blocks]
    for name, leaf in piece.items():
      slot, rest = name.split(".", 1)
      slots[int(slot[len("layer_"):])][rest] = leaf[lap].to(h.device)
    for block, params in zip(self._chunk_blocks, slots):
      h, _ = torch.func.functional_call(block, params, (h, pos, None, False))
    return h

  def _run_chunk(self, piece, lap, h, pos):
    if torch.is_grad_enabled():
      return checkpoint_lib.checkpoint(self._chunk, piece, lap, h, pos,
                                       use_reentrant=False)
    return self._chunk(piece, lap, h, pos)

  def _pipeline(self, placed: Params, devices: list[torch.device],
                x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One data slice's pipeline over ``devices``; [b, t, d] on x's
    device."""
    n_mb, n_stages = self.num_microbatches, self.num_stages
    v, n_chunks = self.interleave, self.num_chunks
    mb = x.shape[0] // n_mb
    x_mb, pos_mb = x.split(mb), pos.split(mb)
    pieces = [{name: value[d] for name, value in placed.items()}
              for d in range(n_stages)]
    ring = [(d, (d + 1) % n_stages) for d in range(n_stages)]
    held: list[torch.Tensor | None] = [None] * n_stages
    outputs: list[torch.Tensor | None] = [None] * n_mb
    for t in range(self.schedule_steps):
      incoming = sharding.ppermute(held, devices, ring)
      held = [None] * n_stages
      for d, dev in enumerate(devices):
        lap = ((t - d) % n_chunks) // n_stages
        t0 = t - (lap * n_stages + d)  # the step microbatch m injected
        m = (t0 // n_chunks) * n_stages + t0 % n_chunks
        if not 0 <= m < n_mb:
          continue  # a bubble slot
        h = x_mb[m].to(dev) if d == 0 and lap == 0 else incoming[d]
        held[d] = self._run_chunk(pieces[d], lap, h, pos_mb[m].to(dev))
        if d == n_stages - 1 and lap == v - 1:
          outputs[m] = held[d]
    return torch.cat([o.to(x.device) for o in outputs])

  def apply_blocks(self, stacked: Params, x: torch.Tensor,
                   segment_pos: torch.Tensor) -> torch.Tensor:
    """Runs the pipelined blocks; [b, t, d] -> [b, t, d] on ``x``'s device.

    ``b`` must divide by ``num_microbatches`` times the data slices; ``x``
    is the embedded (and image-spliced) activations.
    """
    batch = x.shape[0]
    slices = self._data_slices()
    dp = len(slices)
    if batch % (self.num_microbatches * dp):
      raise ValueError(
          f"batch {batch} % (num_microbatches {self.num_microbatches} x "
          f"data-parallel {dp}) != 0")
    placed = self._placed(stacked)
    outs = [self._pipeline(placed, devices, xs, ps)
            for devices, xs, ps in zip(slices, x.chunk(dp),
                                       segment_pos.chunk(dp))]
    return torch.cat(outs) if dp > 1 else outs[0]

  # -- the whole model ------------------------------------------------------

  def _apply(self, shared: Params, prefix: str, fn, *args):
    """``fn(model, *args)`` with the model's weights under ``prefix`` taken
    from ``shared``."""
    params = {f"module.{k}": v for k, v in shared.items()
              if k.startswith(prefix)}
    return torch.func.functional_call(_Method(self.model, fn), params, args)

  def _decode_hidden(self, shared: Params, hidden: torch.Tensor
                     ) -> torch.Tensor:
    """Final-normed hidden states -> logits, with ``shared``'s embedder."""
    return self._apply(shared, "embedder.", lambda m, h: m.decode_hidden(h),
                       hidden)

  def __call__(
      self,
      stacked: Params,
      shared: Params,
      tokens: torch.Tensor,
      segment_pos: torch.Tensor,
      image: torch.Tensor | None = None,
      return_hidden: bool = False,
  ) -> torch.Tensor:
    """Embeds, pipelines the blocks, runs the tail and projects to logits
    ([b, t, vocab]; with an image the visual positions included), or the
    final-normed hidden states with ``return_hidden``."""
    x = self._apply(shared, "embedder.", lambda m, t: m.embedder.encode(t),
                    tokens)
    if image is not None:
      x, segment_pos = self._apply(
          shared, "vl_connector.", lambda m, *a: m._splice_image(*a),  # pylint: disable=protected-access
          x, segment_pos, image)
    x = self.apply_blocks(stacked, x, segment_pos)
    # The tail: blocks past the pattern-aligned prefix, sequentially on the
    # full batch, as JAX runs them after its shard_map.
    for i in self.tail_layers:
      prefix = f"blocks.{i}."
      params = {k[len(prefix):]: v for k, v in shared.items()
                if k.startswith(prefix)}
      block = self._templates[self.model.config.block_types[i]]
      x, _ = torch.func.functional_call(block, params,
                                        (x, segment_pos, None, False))
    x = self._apply(shared, "final_norm.", lambda m, h: m.final_norm(h), x)
    if return_hidden:
      return x
    return self._decode_hidden(shared, x)

  # -- training -------------------------------------------------------------

  def loss_fn(
      self,
      stacked: Params,
      shared: Params,
      input_tokens: torch.Tensor,
      input_mask: torch.Tensor,
      positions: torch.Tensor,
      image: torch.Tensor | None = None,
  ) -> torch.Tensor:
    """Masked next-token NLL with the trainer's visual-row semantics: the
    pipeline returns hidden states and ``trainer.chunked_masked_nll``
    projects them to the vocabulary a time chunk at a time; with an image
    the targets and mask are left-padded by the visual tokens."""
    hidden = self(stacked, shared, input_tokens, positions, image=image,
                  return_hidden=True)
    hidden = hidden[:, :-1]
    targets = input_tokens[:, 1:]
    target_mask = input_mask[:, 1:]
    if image is not None:
      n_img = hidden.shape[1] - targets.shape[1]
      targets = torch.nn.functional.pad(targets, (n_img, 0))
      target_mask = torch.nn.functional.pad(target_mask, (n_img, 0))
    return trainer.chunked_masked_nll(
        hidden, targets, target_mask,
        lambda h: self._decode_hidden(shared, h))

  def make_train_step(self, optimizer: Callable[[list[torch.Tensor]],
                                                torch.optim.Optimizer]):
    """An SFT step over placed ``(stacked, shared)`` weights, unclipped as
    JAX's.

    torch's optimizer holds the tensors it updates, so ``optimizer`` is a
    factory, as ``trainer.make_sharded_train_step`` takes it: the caller
    builds the state once, ``opt_state = optimizer(pipe.parameters(stacked,
    shared))``, where JAX calls ``optimizer.init``. ``step(stacked, shared,
    opt_state, input_tokens, input_mask, positions, image=None)`` returns
    ``(loss, stacked, shared, opt_state)`` with JAX's names: the weights
    and the optimizer's state are updated in place and returned. Every
    stage piece, its gradient and its state stay on the piece's position.
    """
    if not callable(optimizer):
      raise TypeError("optimizer must build the optimizer over the "
                      "pipeline's tensors: optimizer(pipe.parameters("
                      "stacked, shared)).")

    def step(stacked, shared, opt_state, input_tokens, input_mask,
             positions, image=None):
      params = self.parameters(stacked, shared)
      for p in params:
        p.grad = None
      loss = self.loss_fn(stacked, shared, input_tokens, input_mask,
                          positions, image)
      loss.backward()
      opt_state.step()
      for p in params:
        p.grad = None
      return loss.detach(), stacked, shared, opt_state

    return step
