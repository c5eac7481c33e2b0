"""The SFT loop for one device: the two-stage multimodal recipe.

Counterpart of the JAX package's ``cadence_gemma_tpu/training/train_loop.py``
(``TrainingConfig``, ``train_loop``, ``two_stage_sft``) with the same
configuration fields and loop semantics: ``num_epochs`` over the data,
``max_steps`` counting loop steps (microbatches), ``eval_every_n`` metrics
and validation, ``gradient_accumulation_steps`` averaging the gradients of K
microbatches into one update (``optax.MultiSteps``) and
``skip_nonfinite_updates`` (``optax.apply_if_finite`` with 3 consecutive
skips allowed), around any of the three steps: full fine-tuning,
``freeze_llm`` (the connector alone, stage 1 of ``two_stage_sft``) and
``lora`` (the adapters alone, over a bf16 or an int8 base).

Images: ``encode_image`` maps a batch's pixels (or its paths) to features,
under ``torch.no_grad()`` (the towers are frozen and keep no graph). A batch
that carries images when no ``encode_image`` is given raises, where JAX
trains its text alone: a multimodal SFT that silently dropped its images
would be a different run.

Checkpoints (JAX ``train_loop.py:56-113``, ``:219-345``), in the port's own
format (``checkpoint/io.py``): ``checkpoint_every_n`` with
``checkpoint_dir`` writes ``step_{k}`` (on a thread with
``async_checkpoints``), a ``preemption`` handler that has fired makes the
loop write ``preempted_step_{k}`` and return, and ``resume_from`` restores a
fresh model and optimizer to a saved step: the parameters (a LoRA run's
combined tree), the optimizer's state, the gradients accumulated so far in
an accumulation window, and the count of consecutive non-finite steps, so a
resumed run equals the uninterrupted one bit for bit. A resumed run skips
the first ``step`` batches of the stream once; JAX skips them again in
every epoch, so its later epochs train nothing (ROADMAP queue 3).
``prefetch_batches`` moves batches to the device ahead of the step
(``data.prefetch_to_device``).

With ``mesh`` (JAX ``train_loop.py:152-206``) the full and LoRA stages run
the DP x TP steps (``trainer.make_sharded_train_step``,
``lora.make_sharded_lora_step``): the weights placed over the mesh's
``model`` axis, each batch split over its ``data`` axis, the gradients
reduced at each update, so accumulation, validation, checkpoints and
preemption work unchanged. The train state is saved as the logical tree by
leaf name, whole leaves (the optimizer's state under ``optimizer_leaves``),
and a resume on the mesh places it again (JAX ``:223-248``). The frozen
stage refuses a mesh, as JAX's does. Sequence-parallel training needs no
mesh here: as in JAX it is a model built with ``scan_sharding_spec``, which
this loop trains like any other.

One process a card (JAX's multi-process ``train_loop(mesh=)``): with a mesh
whose ``data`` axis spans processes (``multihost.make_hybrid_mesh(...,
dcn_axis_names=("data",))``, after ``multihost.initialize()``), every
process runs this loop on its own replica and feeds it the same global
batches; each takes its rows, the gradients are all-reduced over the data
axis, and the replicas stay identical. Process 0 alone writes checkpoints
and the preemption state, the others waiting at a barrier
(``checkpoint/io.py``); a preemption seen by any process stops every one
at the same step; ``resume_from`` loads on every process.

The model trains where its parameters live, on the card unless the caller
passes ``device="cpu"``; ``device=None`` without a card raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from typing import Any, Callable, Iterable
import warnings

import numpy as np
import torch
from torch import distributed as dist

from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.training import data as data_lib
from cadence_gemma_tpu_torch.training import lora as lora_lib
from cadence_gemma_tpu_torch.training import trainer
from cadence_gemma_tpu_torch.utils import resilience

# optax.apply_if_finite's max_consecutive_errors in the JAX loop.
_MAX_CONSECUTIVE_NONFINITE = 3


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
  """Hyper-parameters for one SFT stage (the JAX ``TrainingConfig``)."""

  learning_rate: float = 1e-5
  num_epochs: int = 1
  eval_every_n: int = 200
  batch_size: int = 1
  max_steps: int | None = None
  weight_decay: float = 0.1
  freeze_llm: bool = False
  lora: bool = False
  gradient_accumulation_steps: int = 1
  checkpoint_every_n: int | None = 1000
  checkpoint_dir: str | None = None
  resume_from: str | None = None
  skip_nonfinite_updates: bool = False
  prefetch_batches: int = 0
  async_checkpoints: bool = False


def _check_config(config: TrainingConfig, mesh) -> None:
  if config.gradient_accumulation_steps < 1:
    raise ValueError("gradient_accumulation_steps must be at least 1.")
  if mesh is not None and config.freeze_llm:
    raise ValueError(
        "mesh is not supported with freeze_llm=True: the frozen stage "
        "trains only the (tiny) vision-language connector -- run it "
        "single-device and pass the mesh to the full stage.")


def _optimizer_factory(model, config: TrainingConfig
                       ) -> Callable[[Any], torch.optim.Optimizer]:
  """What builds the stage's optimizer over a model or its sharded pieces
  (JAX ``train_loop.py:116-206``): Adam over the adapters with ``lora``,
  AdamW over the connector with ``freeze_llm``, AdamW over every parameter
  otherwise. The stage's configuration is checked here."""
  if config.lora:
    if config.freeze_llm:
      raise ValueError(
          "config.lora and config.freeze_llm are mutually exclusive: the "
          "frozen stage trains the vl_connector with everything else "
          "frozen, LoRA trains adapters with the base frozen — pick one "
          "per stage (two_stage_sft runs freeze_llm first, then lora)."
      )
    if config.weight_decay != TrainingConfig.weight_decay:
      warnings.warn(
          "TrainingConfig.weight_decay is ignored when lora=True: LoRA "
          "adapters train with plain Adam (lora.make_optimizer), the "
          "standard no-decay setup for low-rank adapters.",
          stacklevel=3,
      )
    if not lora_lib.lora_parameters(model):
      raise ValueError(
          "config.lora=True but the parameter tree has no lora_a/lora_b "
          "leaves — build the model with lora_rank > 0 and initialize "
          "adapters (training.lora.init_adapters)."
      )
    return lambda params: lora_lib.make_optimizer(
        lora_lib.lora_parameters(params), config.learning_rate)
  if config.freeze_llm:
    return lambda params: trainer.make_optimizer(
        params.vl_connector, config.learning_rate,
        weight_decay=config.weight_decay)
  return lambda params: trainer.make_optimizer(
      params, config.learning_rate, weight_decay=config.weight_decay)


def _tensor(x, device: torch.device) -> torch.Tensor:
  """A batch field (numpy, or a tensor ``prefetch_to_device`` moved) on
  ``device``."""
  if isinstance(x, torch.Tensor):
    return x.to(device)
  return torch.as_tensor(np.asarray(x), device=device)


def _to_device(batch, device: torch.device, encode_image):
  """Token ids, loss mask and image features of a batch on ``device``."""
  tokens = _tensor(batch.input_tokens, device).long()
  mask = _tensor(batch.target_mask, device)
  return tokens, mask, _features_for(batch, encode_image, device)


def _features_for(batch, encode_image, device):
  """``encode_image`` of the batch's pixels, else of its paths (JAX
  ``train_loop.py:349-356``), under ``torch.no_grad()``."""
  pixels = getattr(batch, "pixels", None)
  paths = getattr(batch, "image_paths", None)
  if pixels is None and not paths:
    return None
  if encode_image is None:
    raise ValueError(
        "The batch carries images but train_loop was given no encode_image; "
        "pass encode_image= (e.g. a DinoSigLIPEncoder) to train on them.")
  with torch.no_grad():
    if pixels is not None:
      return encode_image(_tensor(pixels, device))
    return encode_image(paths)


class _Local:
  """One device: the model's own parameters, the optimizer over them."""

  def __init__(self, model, optimizer):
    self.model = model
    self.optimizer = optimizer
    self.params = trainer.optimizer_parameters(optimizer)

  def accumulate(self, pad_id, tokens, mask, scale, img) -> torch.Tensor:
    with trainer.trainable_only(self.model, self.params):
      return trainer.accumulate_gradients(self.model, pad_id, tokens, mask,
                                          scale=scale, img_embed=img)

  def finish_window(self, skip_nonfinite: bool) -> bool:
    """Ends a window's accumulation; returns whether its update applies:
    ``skip_nonfinite`` is off, or every gradient is finite."""
    return not skip_nonfinite or trainer.grads_finite(self.model)

  def apply(self) -> None:
    trainer.apply_update(self.model, self.optimizer)

  def clear(self) -> None:
    self.model.zero_grad(set_to_none=True)

  def validation_loss(self, pad_id, tokens, mask, img) -> torch.Tensor:
    return trainer.validation_step(self.model, pad_id, tokens, mask, img)

  def train_state(self, step: int, accumulate: int, nonfinite: int) -> dict:
    """What a resume needs besides the parameters: the optimizer's state,
    the gradients of an accumulation window in progress (by parameter
    name), the micro-step and the count of consecutive non-finite steps."""
    names = {id(p): n for n, p in self.model.named_parameters()}
    return {
        "optimizer": self.optimizer.state_dict(),
        "grads": {names[id(p)]: p.grad for p in self.params
                  if p.grad is not None},
        "micro_step": step % accumulate,
        "nonfinite": nonfinite,
    }

  @torch.no_grad()
  def resume(self, state: dict) -> None:
    """Restores the optimizer's state and a window's gradients in place."""
    self.optimizer.load_state_dict(state["optimizer"])
    named = dict(self.model.named_parameters())
    for name, grad in state["grads"].items():
      named[name].grad = grad.to(named[name].device, copy=True)


class _Mesh(_Local):
  """DP x TP over a mesh: the sharded pieces, the optimizer over them; the
  rows' gradients are reduced at the end of each window."""

  def __init__(self, model, sharded, optimizer, opt_shardings):
    super().__init__(model, optimizer)
    self.sharded = sharded
    self.opt_shardings = opt_shardings

  def accumulate(self, pad_id, tokens, mask, scale, img) -> torch.Tensor:
    return trainer.sharded_accumulate_gradients(self.sharded, pad_id, tokens,
                                                mask, scale, img)

  def finish_window(self, skip_nonfinite: bool) -> bool:
    self.sharded.reduce_gradients()
    self.sharded.all_reduce_gradients()
    return not skip_nonfinite or trainer.grads_finite(self.sharded)

  def apply(self) -> None:
    trainer.sharded_apply_update(self.sharded, self.optimizer)

  def clear(self) -> None:
    self.sharded.zero_grad()

  def validation_loss(self, pad_id, tokens, mask, img) -> torch.Tensor:
    return trainer.sharded_validation_step(self.sharded, pad_id, tokens, mask,
                                           img)

  def train_state(self, step: int, accumulate: int, nonfinite: int) -> dict:
    """The logical tree: the optimizer's state and a window's gradients as
    whole leaves by name (across processes, the sum of every process's
    window so far; each process goes on accumulating its own)."""
    self.sharded.reduce_gradients()
    return {
        "optimizer_leaves": self.sharded.optimizer_state(self.optimizer),
        "grads": {name: self.sharded.all_reduce(grad.clone())
                  for name, grad in self.sharded.gradients().items()},
        "micro_step": step % accumulate,
        "nonfinite": nonfinite,
    }

  @torch.no_grad()
  def resume(self, state: dict) -> None:
    """Places the saved whole leaves on the pieces again
    (``partitioning.opt_state_shardings``)."""
    if "optimizer_leaves" not in state:
      raise ValueError("The checkpoint holds a single-device run's optimizer "
                       "state; resume it without a mesh.")
    self.sharded.load_optimizer_state(self.optimizer,
                                      state["optimizer_leaves"],
                                      self.opt_shardings)
    # Across processes the saved window is the processes' sum: the process
    # of data row 0 carries it on, so the window's all-reduce counts it once.
    if not self.sharded.spans_processes or 0 in self.sharded.row_ids:
      self.sharded.load_gradients(state["grads"])


def _sharded(model, config: TrainingConfig, mesh, pad_id: int,
             make_optimizer) -> _Mesh:
  """The stage's sharded steps' placement of ``model`` over ``mesh`` (JAX
  ``train_loop.py:152-206``) and its optimizer."""
  example = model.state_dict()
  if config.lora:
    adapters, base = lora_lib.split_lora(example)
    _, shard_fn = lora_lib.make_sharded_lora_step(model, make_optimizer, mesh,
                                                  pad_id, adapters, base)
    sharded = shard_fn(adapters, base)
  else:
    _, shard_params = trainer.make_sharded_train_step(
        model, make_optimizer, mesh, pad_id, example_params=example)
    sharded = shard_params(example)
  return _Mesh(model, sharded, make_optimizer(sharded),
               partitioning.opt_state_shardings(mesh, make_optimizer,
                                                example))


def _load_resume(model, config: TrainingConfig) -> tuple[int, dict]:
  """Loads ``config.resume_from``'s parameters into ``model`` in place;
  returns its step and train state."""
  params, state, step = checkpoint_io.load_train_state(config.resume_from,
                                                       device="cpu")
  if state["micro_step"] != step % config.gradient_accumulation_steps:
    raise ValueError(
        f"{config.resume_from} was saved {state['micro_step']} microbatches "
        f"into an accumulation window at step {step}; resume it with the "
        "gradient_accumulation_steps it was saved with.")
  with torch.no_grad():
    model.load_state_dict(params)
  return step, state


def train_loop(
    model: griffin.Griffin,
    train_data: Iterable,
    config: TrainingConfig,
    validation_data: Iterable | None = None,
    encode_image: Callable[[Any], torch.Tensor] | None = None,
    log_metrics: Callable[[dict[str, float], int], None] | None = None,
    pad_id: int = 0,
    device=None,
    mesh: Any | None = None,
    preemption: resilience.PreemptionHandler | None = None,
) -> griffin.Griffin:
  """Runs one SFT stage; returns the model, trained in place.

  Args:
    model: The ``Griffin`` to train; its parameters must live on ``device``.
      With ``config.lora`` it must carry adapters (``lora_rank > 0``).
    train_data: Iterable of ``TrainingInput`` batches (numpy arrays),
      iterated once per epoch.
    config: Stage hyper-parameters (``freeze_llm`` and ``lora`` select the
      step).
    validation_data: Optional iterable, re-iterated at each eval point.
    encode_image: ``pixels [b, 3, h, w] on device | paths -> [b, n,
      vision_width]`` features (e.g. a ``DinoSigLIPEncoder``, or its
      ``preprocess_path``-based wrapper); run under ``torch.no_grad()``.
    log_metrics: Optional callback ``(metrics, step)``; metrics are printed
      when it is absent.
    pad_id: Tokenizer pad id.
    device: Where to train; ``None`` means CUDA and raises without a card.
    mesh: A device mesh for the DP x TP steps of the full and LoRA stages
      (JAX's ``train_loop(mesh=)``): the weights take the Megatron layouts
      over its ``model`` axis, every batch splits over its ``data`` axis
      (the batch must divide into it), and the model returned holds the
      trained weights. The ``data`` axis may span processes (one a card;
      every process calls this with the same batches). A model with
      ``scan_sharding_spec`` trains sequence-parallel without it.
    preemption: Optional :class:`resilience.PreemptionHandler`; once it has
      fired, the loop finishes the step in flight, saves a resumable state
      as ``preempted_step_{k}`` under ``config.checkpoint_dir`` (when set;
      synchronously, since it must be on disk before the process exits)
      and returns (restart with ``resume_from`` pointing at it).
  """
  _check_config(config, mesh)
  make_optimizer = _optimizer_factory(model, config)
  device = griffin.resolve_device(device)
  if any(p.device.type != device.type for p in model.parameters()):
    raise ValueError(f"The model's parameters must live on {device}.")

  model.train()
  model.zero_grad(set_to_none=True)
  step, state = 0, None
  if config.resume_from:
    step, state = _load_resume(model, config)
  if mesh is None:
    trainee = _Local(model, make_optimizer(model))
  else:
    trainee = _sharded(model, config, mesh, pad_id, make_optimizer)
  if state is not None:
    trainee.resume(state)
  nonfinite = 0 if state is None else state["nonfinite"]
  group = getattr(getattr(trainee, "sharded", None), "process_group", None)
  saver = (checkpoint_io.AsyncTrainStateSaver(group)
           if config.async_checkpoints else contextlib.nullcontext(None))
  with saver as saver:
    _run(model, trainee, train_data, config, step, nonfinite, saver,
         validation_data, encode_image, log_metrics, pad_id, device,
         preemption, group)
  return model


def _run(model, trainee, train_data, config: TrainingConfig, step: int,
         nonfinite: int, saver, validation_data, encode_image, log_metrics,
         pad_id: int, device, preemption, group=None) -> None:
  """Every epoch of one stage, from a restored ``step`` (its batches
  skipped once, at the start of the stream)."""
  accumulate = config.gradient_accumulation_steps
  to_skip = step
  t_start = time.perf_counter()
  for _ in range(config.num_epochs):
    source = iter(train_data)
    # Fast-forward over the batches the restored steps consumed.
    to_skip -= sum(1 for _ in itertools.islice(source, to_skip))
    if config.prefetch_batches:
      batches = contextlib.closing(data_lib.prefetch_to_device(
          source, config.prefetch_batches, device))
    else:
      batches = contextlib.nullcontext(source)
    # ``closing`` stops the prefetch producer on every way out.
    with batches as batches:
      for batch in batches:
        tokens, mask, img = _to_device(batch, device, encode_image)
        loss = trainee.accumulate(pad_id, tokens, mask, 1.0 / accumulate, img)
        step += 1
        if step % accumulate == 0:
          finite = trainee.finish_window(config.skip_nonfinite_updates)
          nonfinite = 0 if finite else nonfinite + 1
          if finite or nonfinite > _MAX_CONSECUTIVE_NONFINITE:
            trainee.apply()
          else:
            trainee.clear()

        if preemption is not None and _preempted(preemption, device, group):
          if config.checkpoint_dir:
            path = os.path.join(config.checkpoint_dir,
                                f"preempted_step_{step}")
            checkpoint_io.save_train_state(
                path, model.state_dict(),
                trainee.train_state(step, accumulate, nonfinite), step, group)
            if log_metrics is not None:
              log_metrics({"preempted_at": float(step)}, step)
            print(f"preemption: saved resumable state at {path}")
          return

        if step % config.eval_every_n == 0:
          metrics = {
              "train_loss": float(loss),
              "steps_per_sec": step / (time.perf_counter() - t_start),
          }
          if nonfinite:
            metrics["consecutive_nonfinite_steps"] = float(nonfinite)
          if validation_data is not None:
            metrics["val_loss"] = _validate(trainee, validation_data, pad_id,
                                            device, encode_image)
          if log_metrics is not None:
            log_metrics(metrics, step)
          else:
            print(f"step {step}: {metrics}")

        if (config.checkpoint_every_n and config.checkpoint_dir
            and step % config.checkpoint_every_n == 0):
          path = os.path.join(config.checkpoint_dir, f"step_{step}")
          state = trainee.train_state(step, accumulate, nonfinite)
          if saver is None:
            checkpoint_io.save_train_state(path, model.state_dict(), state,
                                           step, group)
          else:
            saver.save(path, model.state_dict(), state, step)

        if config.max_steps is not None and step >= config.max_steps:
          return


def _preempted(preemption, device, group) -> bool:
  """Whether the handler fired here or, one process a card, on any
  process of the training's ``group``: all of them then stop at this
  step."""
  fired = preemption.triggered
  if group is None:
    return fired
  flag = torch.tensor([float(fired)],
                      device=device if dist.get_backend(group) == "nccl"
                      else "cpu")
  dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
  return bool(flag.item())


def _validate(trainee, validation_data, pad_id, device, encode_image
              ) -> float:
  losses = [
      float(trainee.validation_loss(pad_id,
                                    *_to_device(batch, device, encode_image)))
      for batch in validation_data
  ]
  return float(np.mean(losses)) if losses else float("nan")


def two_stage_sft(
    model: griffin.Griffin,
    train_data_factory: Callable[[], Iterable],
    stage1: TrainingConfig,
    stage2: TrainingConfig,
    **kwargs,
) -> griffin.Griffin:
  """The reference's two-stage schedule (JAX ``train_loop.py:376-399``):
  the connector alone with the LM frozen, then ``stage2`` (a full fine-tune,
  or LoRA with ``stage2.lora``). ``train_data_factory`` makes each stage's
  data afresh; ``kwargs`` go to both :func:`train_loop` calls, but a
  ``mesh`` to stage 2 alone (JAX ``train_loop.py:386-399``): the frozen
  stage trains the connector alone, on one device."""
  mesh = kwargs.pop("mesh", None)
  train_loop(model, train_data_factory(),
             dataclasses.replace(stage1, freeze_llm=True), **kwargs)
  return train_loop(model, train_data_factory(),
                    dataclasses.replace(stage2, freeze_llm=False), mesh=mesh,
                    **kwargs)
