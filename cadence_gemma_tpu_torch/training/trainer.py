"""SFT training: the chunked loss, train and validation steps, the optimizer.

Counterpart of the JAX package's ``cadence_gemma_tpu/training/trainer.py``
for full fine-tuning on one device, text only:

  * the masked next-token NLL, with the vocabulary projection run per time
    chunk under ``torch.utils.checkpoint`` so the [b, t, vocab] logits never
    exist (the JAX ``lax.map`` over ``jax.checkpoint(chunk_nll)``);
  * ``train_step``: one step of AdamW with the Griffin weight-decay mask,
    global-norm clipping before the update, b2 = 0.96;
  * ``validation_step``: the loss only.

The backward runs the CUDA backward kernels of the RG-LRU scan and of the
windowed attention through their autograd Functions. A model built with
``scan_sharding_spec`` trains sequence-parallel behind the same steps, as in
JAX: its scans and attention split the time axis over the spec's mesh, and
their backwards run the sharded cotangent scan and the halo attention's
gradient. The frozen-connector step, LoRA and the pjit-sharded (DP/TP) step
are not ported.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.utils import checkpoint as checkpoint_lib

# Sequences longer than this compute the loss in time chunks of this size;
# below it, one chunk is the whole sequence (the same math either way).
_VOCAB_CHUNK = 2048

# The JAX trainer's AdamW second-moment decay and global-norm clip.
_ADAM_B2 = 0.96
_GRAD_CLIP_NORM = 1.0

# The Griffin weight-decay mask: no decay under ``rg_lru`` or ``embedder``,
# nor on leaves named ``b``, ``bias`` or ``scale``.
_NO_DECAY_PARTS = ("rg_lru", "embedder")
_NO_DECAY_LEAVES = ("b", "bias", "scale")


def get_positions(tokens: torch.Tensor, pad_id: int) -> torch.Tensor:
  """0-indexed positions over non-pad tokens; pads before the start get -1.

  Right padding repeats the last position.
  """
  positions = torch.cumsum(tokens != pad_id, dim=-1)
  return positions - (positions >= 1).to(positions.dtype)


def _chunk_nll(decode_fn, hidden, targets, mask) -> torch.Tensor:
  logits = decode_fn(hidden).float()
  logp = F.log_softmax(logits, dim=-1)
  picked = torch.gather(logp, -1, targets[..., None].long())[..., 0]
  return -(picked * mask.to(picked.dtype)).sum()


def chunked_masked_nll(
    hidden: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    decode_fn,
    vocab_chunk_size: int | None = None,
) -> torch.Tensor:
  """Masked mean NLL with the vocabulary projection run per time chunk.

  ``decode_fn`` maps [b, c, width] hidden states to [b, c, vocab] logits.
  Each chunk runs under ``torch.utils.checkpoint``, so the backward
  recomputes its logits instead of keeping them: loss memory is
  O(b * chunk * vocab).
  """
  norm = 1.0 / (target_mask.sum() + 1e-8)
  t = hidden.shape[1]
  chunk = min(vocab_chunk_size or _VOCAB_CHUNK, t)
  pad = -t % chunk
  if pad:
    hidden = F.pad(hidden, (0, 0, 0, pad))
    targets = F.pad(targets, (0, pad))
    target_mask = F.pad(target_mask, (0, pad))
  n_chunks = (t + pad) // chunk
  if n_chunks == 1:
    total = _chunk_nll(decode_fn, hidden, targets, target_mask)
  else:
    total = sum(
        checkpoint_lib.checkpoint(
            _chunk_nll, decode_fn, hidden[:, i:i + chunk],
            targets[:, i:i + chunk], target_mask[:, i:i + chunk],
            use_reentrant=False,
        )
        for i in range(0, t + pad, chunk)
    )
  return total * norm


def forward_and_loss_fn(
    model,
    input_tokens: torch.Tensor,
    input_mask: torch.Tensor,
    positions: torch.Tensor,
    vocab_chunk_size: int | None = None,
) -> torch.Tensor:
  """Masked next-token NLL of a text batch.

  The model returns final hidden states; the last step has no target and
  the first token is never predicted. A sequence-parallel model's batch must
  divide into its mesh: its scans raise ``ValueError`` otherwise, as
  ``shard_map`` would, before any update.
  """
  hidden, _ = model(
      input_tokens, positions, None, return_logits=True, return_cache=False,
      return_hidden=True,
  )
  return chunked_masked_nll(
      hidden[:, :-1], input_tokens[:, 1:], input_mask[:, 1:],
      model.decode_hidden, vocab_chunk_size=vocab_chunk_size,
  )


def decays(name: str) -> bool:
  """Whether AdamW weight decay applies to the parameter ``name``."""
  parts = name.split(".")
  if any(part in parts for part in _NO_DECAY_PARTS):
    return False
  return parts[-1] not in _NO_DECAY_LEAVES


def weight_decay_param_groups(
    model: torch.nn.Module, weight_decay: float
) -> list[dict]:
  """AdamW parameter groups realizing the Griffin decay mask."""
  decay, no_decay = [], []
  for name, param in model.named_parameters():
    if param.requires_grad:
      (decay if decays(name) else no_decay).append(param)
  return [
      {"params": decay, "weight_decay": weight_decay},
      {"params": no_decay, "weight_decay": 0.0},
  ]


def make_optimizer(
    model: torch.nn.Module,
    learning_rate: float,
    weight_decay: float = 0.1,
) -> torch.optim.AdamW:
  """AdamW with the JAX trainer's settings: b1 0.9, b2 0.96, eps 1e-8 and
  decoupled weight decay under the Griffin mask. :func:`apply_update` clips
  the gradients' global norm to 1.0 before each step."""
  return torch.optim.AdamW(
      weight_decay_param_groups(model, weight_decay), lr=learning_rate,
      betas=(0.9, _ADAM_B2), eps=1e-8,
  )


def grads_finite(model: torch.nn.Module) -> bool:
  """Whether every gradient of ``model`` is finite (one host sync)."""
  grads = [p.grad for p in model.parameters() if p.grad is not None]
  if not grads:
    return True
  return bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
  """``optax.clip_by_global_norm`` in place: where the global norm of
  ``grads`` reaches ``max_norm``, each gradient is divided by ``norm /
  max_norm`` (optax's ``g / norm * max_norm``, the same bits at the trainer's
  ``max_norm`` of 1.0); below it they stay as they are. Tensor ops only, no
  host sync.
  """
  # Each leaf's norm accumulates in float64: a float32 sum over millions of
  # elements drifts by 1e-4 on the CPU, where optax's pairwise sum does not.
  norms = torch._foreach_norm(grads, 2, dtype=torch.float64)  # pylint: disable=protected-access
  total = torch.linalg.vector_norm(torch.stack(norms)).float()
  divisor = torch.where(total >= max_norm, total / max_norm,
                        torch.ones_like(total))
  for dtype in {g.dtype for g in grads}:
    # optax divides by the norm in the gradient's dtype.
    torch._foreach_div_([g for g in grads if g.dtype == dtype],  # pylint: disable=protected-access
                        divisor.to(dtype))


def apply_update(model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer) -> None:
  """Clips the accumulated gradients' global norm to 1.0 as optax does,
  steps the optimizer, then clears the gradients.

  A trainable parameter the loss does not reach (the vision-language
  connector in a text-only step) takes a zero gradient, so AdamW still
  decays it, as the JAX update of the whole parameter tree does.
  """
  for param in model.parameters():
    if param.requires_grad and param.grad is None:
      param.grad = torch.zeros_like(param)
  clip_by_global_norm_(
      [p.grad for p in model.parameters() if p.grad is not None],
      _GRAD_CLIP_NORM,
  )
  optimizer.step()
  optimizer.zero_grad(set_to_none=True)


def accumulate_gradients(
    model: torch.nn.Module,
    pad_id: int,
    input_tokens: torch.Tensor,
    input_mask: torch.Tensor,
    scale: float = 1.0,
) -> torch.Tensor:
  """Adds ``scale`` times the gradient of one batch's loss to ``.grad``;
  returns the loss (detached)."""
  loss = forward_and_loss_fn(
      model, input_tokens, input_mask, get_positions(input_tokens, pad_id)
  )
  (loss * scale).backward()
  return loss.detach()


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    pad_id: int,
    input_tokens: torch.Tensor,
    input_mask: torch.Tensor,
) -> torch.Tensor:
  """One full fine-tuning step; returns the loss (detached)."""
  optimizer.zero_grad(set_to_none=True)
  loss = accumulate_gradients(model, pad_id, input_tokens, input_mask)
  apply_update(model, optimizer)
  return loss


@torch.no_grad()
def validation_step(
    model: torch.nn.Module,
    pad_id: int,
    input_tokens: torch.Tensor,
    input_mask: torch.Tensor,
) -> torch.Tensor:
  """The loss only."""
  return forward_and_loss_fn(
      model, input_tokens, input_mask, get_positions(input_tokens, pad_id)
  )
