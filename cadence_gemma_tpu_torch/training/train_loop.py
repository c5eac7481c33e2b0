"""The SFT loop for one device: full fine-tuning of a ``Griffin``.

Counterpart of the JAX package's ``cadence_gemma_tpu/training/train_loop.py``
(``TrainingConfig``, ``train_loop``) with the same configuration fields and
loop semantics: ``num_epochs`` over the data, ``max_steps`` counting loop
steps (microbatches), ``eval_every_n`` metrics and validation,
``gradient_accumulation_steps`` averaging the gradients of K microbatches
into one update (``optax.MultiSteps``) and ``skip_nonfinite_updates``
(``optax.apply_if_finite`` with 3 consecutive skips allowed).

Not ported, and refused with ``NotImplementedError`` rather than ignored:
LoRA, the frozen-connector stage, a device mesh (the pjit DP/TP regime),
checkpoints and resume, prefetching, asynchronous saves and image batches.
Preemption handling and the image encoder are not parameters yet.
Sequence-parallel training needs no mesh here: as in JAX it is a model built
with ``scan_sharding_spec``, which this loop trains like any other.

The model trains where its parameters live, on the card unless the caller
passes ``device="cpu"``; ``device=None`` without a card raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.training import trainer

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


def _refuse_unported(config: TrainingConfig, mesh) -> None:
  if mesh is not None:
    raise NotImplementedError(
        "train_loop(mesh=...) is the pjit DP/TP regime, which is not ported "
        "to the PyTorch trainer yet. For sequence parallelism build the model "
        "with scan_sharding_spec and pass no mesh."
    )
  unported = {
      "lora": config.lora,
      "freeze_llm": config.freeze_llm,
      "resume_from": config.resume_from,
      "checkpoint_dir": config.checkpoint_dir,
      "prefetch_batches": config.prefetch_batches,
      "async_checkpoints": config.async_checkpoints,
  }
  asked = sorted(name for name, value in unported.items() if value)
  if asked:
    raise NotImplementedError(
        f"Not ported to the PyTorch trainer yet: {', '.join(asked)}."
    )
  if config.gradient_accumulation_steps < 1:
    raise ValueError("gradient_accumulation_steps must be at least 1.")


def _to_device(batch, device: torch.device):
  if batch.image_paths or batch.pixels is not None:
    raise NotImplementedError(
        "Image batches need image SFT, which is not ported yet (ROADMAP "
        "queue 1 item 5)."
    )
  return (torch.as_tensor(np.asarray(batch.input_tokens), device=device).long(),
          torch.as_tensor(np.asarray(batch.target_mask), device=device))


def train_loop(
    model: griffin.Griffin,
    train_data: Iterable,
    config: TrainingConfig,
    validation_data: Iterable | None = None,
    log_metrics: Callable[[dict[str, float], int], None] | None = None,
    pad_id: int = 0,
    device=None,
    mesh: Any | None = None,
) -> griffin.Griffin:
  """Runs one full fine-tuning stage; returns the model, trained in place.

  Args:
    model: The ``Griffin`` to train; its parameters must live on ``device``.
    train_data: Iterable of ``TrainingInput`` batches (numpy arrays),
      iterated once per epoch.
    config: Stage hyper-parameters.
    validation_data: Optional iterable, re-iterated at each eval point.
    log_metrics: Optional callback ``(metrics, step)``; metrics are printed
      when it is absent.
    pad_id: Tokenizer pad id.
    device: Where to train; ``None`` means CUDA and raises without a card.
    mesh: A device mesh for the pjit-sharded (DP/TP) steps; not ported,
      must be ``None``. A model with ``scan_sharding_spec`` trains
      sequence-parallel without it.
  """
  _refuse_unported(config, mesh)
  device = griffin.resolve_device(device)
  if any(p.device.type != device.type for p in model.parameters()):
    raise ValueError(f"The model's parameters must live on {device}.")

  model.train()
  optimizer = trainer.make_optimizer(
      model, config.learning_rate, weight_decay=config.weight_decay
  )
  optimizer.zero_grad(set_to_none=True)
  accumulate = config.gradient_accumulation_steps
  step = 0
  nonfinite = 0
  t_start = time.perf_counter()
  for _ in range(config.num_epochs):
    for batch in train_data:
      tokens, mask = _to_device(batch, device)
      loss = trainer.accumulate_gradients(
          model, pad_id, tokens, mask, scale=1.0 / accumulate
      )
      step += 1
      if step % accumulate == 0:
        finite = (not config.skip_nonfinite_updates
                  or trainer.grads_finite(model))
        nonfinite = 0 if finite else nonfinite + 1
        if finite or nonfinite > _MAX_CONSECUTIVE_NONFINITE:
          trainer.apply_update(model, optimizer)
        else:
          optimizer.zero_grad(set_to_none=True)

      if step % config.eval_every_n == 0:
        metrics = {
            "train_loss": float(loss),
            "steps_per_sec": step / (time.perf_counter() - t_start),
        }
        if nonfinite:
          metrics["consecutive_nonfinite_steps"] = float(nonfinite)
        if validation_data is not None:
          metrics["val_loss"] = _validate(model, validation_data, pad_id,
                                          device)
        if log_metrics is not None:
          log_metrics(metrics, step)
        else:
          print(f"step {step}: {metrics}")

      if config.max_steps is not None and step >= config.max_steps:
        return model
  return model


def _validate(model, validation_data, pad_id, device) -> float:
  losses = [
      float(trainer.validation_step(model, pad_id,
                                    *_to_device(batch, device)))
      for batch in validation_data
  ]
  return float(np.mean(losses)) if losses else float("nan")
