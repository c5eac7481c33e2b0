"""SFT training: the chunked loss, train and validation steps, the optimizer.

Counterpart of the JAX package's ``cadence_gemma_tpu/training/trainer.py``
on one device, with or without an image:

  * the masked next-token NLL, with the vocabulary projection run per time
    chunk under ``torch.utils.checkpoint`` so the [b, t, vocab] logits never
    exist (the JAX ``lax.map`` over ``jax.checkpoint(chunk_nll)``); with an
    image the targets and mask are left-padded by the spliced visual
    tokens, which take no loss (``trainer.py:86-93`` in JAX);
  * ``train_step``: one step of AdamW with the Griffin weight-decay mask,
    global-norm clipping before the update, b2 = 0.96;
  * ``frozen_train_step``: stage 1 of the recipe, which trains the
    vision-language connector alone (``trainer.py:184-210``);
  * ``validation_step``: the loss only.

A step differentiates only what its optimizer updates: the others'
``requires_grad`` is off for its forward and backward
(:func:`trainable_only`), so a frozen LM or a frozen base keeps no gradient,
as JAX's ``value_and_grad`` of the connector's or the adapters' subtree
gives none. The clip sees the optimizer's gradients alone, and a parameter
of the optimizer that the loss does not reach takes a zero gradient (AdamW
still decays it and counts the step, as optax does).

The backward runs the CUDA backward kernels of the RG-LRU scan and of the
windowed attention through their autograd Functions. A model built with
``scan_sharding_spec`` trains sequence-parallel behind the same steps, as in
JAX: its scans and attention split the time axis over the spec's mesh, and
their backwards run the sharded cotangent scan and the halo attention's
gradient. LoRA's step is ``training.lora.lora_train_step``.

DP x TP over a mesh (JAX's pjit-ted step): :func:`make_sharded_train_step`
places the weights on a ``parallel.data_parallel.ShardedGriffin`` (one
tensor-parallel model a data position, the batch split over the data axis)
and its step takes JAX's global token-weighted mean: every row's loss is
normalized by the whole batch's target count, never a mean of per-row
means. With one process a card the data axis crosses processes: each
process runs its rows of the global batch, the row losses and the
gradients are summed over the processes (``ShardedGriffin.sum_rows``,
``all_reduce_gradients``), and the clip sees the same reduced gradients on
every process.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F
from torch.utils import checkpoint as checkpoint_lib

from cadence_gemma_tpu_torch.parallel import data_parallel
from cadence_gemma_tpu_torch.parallel import partitioning

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
    target_count: torch.Tensor | None = None,
) -> torch.Tensor:
  """Masked mean NLL with the vocabulary projection run per time chunk.

  ``decode_fn`` maps [b, c, width] hidden states to [b, c, vocab] logits.
  Each chunk runs under ``torch.utils.checkpoint``, so the backward
  recomputes its logits instead of keeping them: loss memory is
  O(b * chunk * vocab). ``target_count`` (default: this mask's) is the
  number of targets the mean divides by: a data-parallel row passes the
  whole batch's.
  """
  if target_count is None:
    target_count = target_mask.sum()
  norm = 1.0 / (target_count + 1e-8)
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
    image: torch.Tensor | None = None,
    vocab_chunk_size: int | None = None,
    target_count: torch.Tensor | None = None,
) -> torch.Tensor:
  """Masked next-token NLL of a batch, with zero loss on spliced visual
  positions (divided by ``target_count`` targets where it is given).

  The model returns final hidden states; the last step has no target and
  the first token is never predicted. ``image`` ([b, vision_tokens,
  vision_width] features) is spliced in after BOS; the targets and mask
  are left-padded by the visual tokens so the text lines up. A
  sequence-parallel model's batch must divide into its mesh: its scans
  raise ``ValueError`` otherwise, as ``shard_map`` would, before any update.
  """
  hidden, _ = model(
      input_tokens, positions, None, return_logits=True, return_cache=False,
      return_hidden=True, image=image,
  )
  hidden = hidden[:, :-1]
  targets = input_tokens[:, 1:]
  target_mask = input_mask[:, 1:]
  if image is not None:
    n_img = hidden.shape[1] - targets.shape[1]
    targets = F.pad(targets, (n_img, 0))
    target_mask = F.pad(target_mask, (n_img, 0))
  return chunked_masked_nll(
      hidden, targets, target_mask, model.decode_hidden,
      vocab_chunk_size=vocab_chunk_size, target_count=target_count,
  )


def decays(name: str) -> bool:
  """Whether AdamW weight decay applies to the parameter ``name``."""
  parts = name.split(".")
  if any(part in parts for part in _NO_DECAY_PARTS):
    return False
  return parts[-1] not in _NO_DECAY_LEAVES


def weight_decay_param_groups(
    model: torch.nn.Module, weight_decay: float, use_decay_mask: bool = True,
) -> list[dict]:
  """AdamW parameter groups realizing the Griffin decay mask (every
  trainable parameter decays without it)."""
  decay, no_decay = [], []
  for name, param in model.named_parameters():
    if param.requires_grad:
      (decay if decays(name) or not use_decay_mask
       else no_decay).append(param)
  return [
      {"params": decay, "weight_decay": weight_decay},
      {"params": no_decay, "weight_decay": 0.0},
  ]


def make_optimizer(
    model: torch.nn.Module,
    learning_rate: float,
    weight_decay: float = 0.1,
    use_decay_mask: bool = True,
) -> torch.optim.AdamW:
  """AdamW with the JAX trainer's settings: b1 0.9, b2 0.96, eps 1e-8 and
  decoupled weight decay under the Griffin mask (``use_decay_mask=False``:
  on every parameter). :func:`apply_update` clips the gradients' global
  norm to 1.0 before each step. For the frozen stage pass
  ``model.vl_connector``: the optimizer then holds the connector alone."""
  return torch.optim.AdamW(
      weight_decay_param_groups(model, weight_decay, use_decay_mask),
      lr=learning_rate, betas=(0.9, _ADAM_B2), eps=1e-8,
  )


def optimizer_parameters(
    optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
  """The parameters ``optimizer`` updates, in its groups' order."""
  return [p for group in optimizer.param_groups for p in group["params"]]


@contextlib.contextmanager
def trainable_only(model: torch.nn.Module, params):
  """Within the block, only ``params`` of ``model`` require a gradient; the
  flags are restored after it."""
  keep = {id(p) for p in params}
  saved = [(p, p.requires_grad) for p in model.parameters()
           if p.is_floating_point()]
  try:
    for p, _ in saved:
      p.requires_grad_(id(p) in keep)
    yield
  finally:
    for p, flag in saved:
      p.requires_grad_(flag)


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
  """Clips the accumulated gradients of the optimizer's parameters to a
  global norm of 1.0 as optax does, steps the optimizer, then clears every
  gradient of ``model``.

  A parameter of the optimizer the loss does not reach (the connector in a
  text-only step) takes a zero gradient, so AdamW still decays it and its
  moments, as the JAX update of the whole tree does.
  """
  params = optimizer_parameters(optimizer)
  for param in params:
    if param.grad is None:
      param.grad = torch.zeros_like(param)
  clip_by_global_norm_([p.grad for p in params], _GRAD_CLIP_NORM)
  optimizer.step()
  model.zero_grad(set_to_none=True)


def accumulate_gradients(
    model: torch.nn.Module,
    pad_id: int,
    input_tokens: torch.Tensor,
    input_mask: torch.Tensor,
    scale: float = 1.0,
    img_embed: torch.Tensor | None = None,
) -> torch.Tensor:
  """Adds ``scale`` times the gradient of one batch's loss to ``.grad`` of
  every parameter that requires one; returns the loss (detached)."""
  loss = forward_and_loss_fn(
      model, input_tokens, input_mask, get_positions(input_tokens, pad_id),
      image=img_embed,
  )
  if loss.requires_grad:  # a frozen stage's text-only batch reaches nothing
    (loss * scale).backward()
  return loss.detach()


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    pad_id: int,
    input_tokens: torch.Tensor,
    input_mask: torch.Tensor,
    img_embed: torch.Tensor | None = None,
) -> torch.Tensor:
  """One fine-tuning step of the optimizer's parameters (every parameter,
  from :func:`make_optimizer` of the model); returns the loss (detached)."""
  model.zero_grad(set_to_none=True)
  with trainable_only(model, optimizer_parameters(optimizer)):
    loss = accumulate_gradients(model, pad_id, input_tokens, input_mask,
                                img_embed=img_embed)
  apply_update(model, optimizer)
  return loss


def _check_connector_optimizer(model, optimizer) -> None:
  """Raises unless ``optimizer`` updates ``model.vl_connector`` alone."""
  connector = {id(p) for p in model.vl_connector.parameters()}
  if not all(id(p) in connector for p in optimizer_parameters(optimizer)):
    raise ValueError(
        "frozen_train_step trains the vision-language connector alone: "
        "build its optimizer with make_optimizer(model.vl_connector, ...).")


def frozen_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    pad_id: int,
    input_tokens: torch.Tensor,
    input_mask: torch.Tensor,
    img_embed: torch.Tensor | None,
) -> torch.Tensor:
  """Stage-1 step: only the vision-language connector trains, the LM stays
  frozen (``optimizer`` from ``make_optimizer(model.vl_connector, ...)``).
  Without an image the connector gets a zero gradient and is still
  decayed. Returns the loss (detached)."""
  _check_connector_optimizer(model, optimizer)
  return train_step(model, optimizer, pad_id, input_tokens, input_mask,
                    img_embed)


@torch.no_grad()
def validation_step(
    model: torch.nn.Module,
    pad_id: int,
    input_tokens: torch.Tensor,
    input_mask: torch.Tensor,
    img_embed: torch.Tensor | None = None,
) -> torch.Tensor:
  """The loss only."""
  return forward_and_loss_fn(
      model, input_tokens, input_mask, get_positions(input_tokens, pad_id),
      image=img_embed,
  )


def _sharded_loss(params: data_parallel.ShardedGriffin, pad_id: int,
                  input_tokens: torch.Tensor, input_mask: torch.Tensor,
                  img_embed: torch.Tensor | None, scale: float | None):
  """The batch's loss over the data rows, each row's divided by the whole
  batch's target count; with ``scale``, each row's ``scale`` times loss is
  back-propagated as the row's loss is computed. Every process reads the
  whole global batch (its count is the global one) and computes its own
  rows; the rows' losses are summed over the processes
  (``params.sum_rows``), so a batch whose rows hold different target counts
  gives the one-process loss."""
  rows = zip(params.rows, params.split(input_tokens), params.split(input_mask),
             params.split(img_embed))
  count = input_mask[:, 1:].sum()
  losses = []
  for tp, tokens, mask, img in rows:
    loss = forward_and_loss_fn(tp, tokens, mask, get_positions(tokens, pad_id),
                               image=img, target_count=count.to(tp.device))
    if scale is not None and loss.requires_grad:
      (loss * scale).backward()
    losses.append(loss.detach())
  return params.sum_rows(losses)


def sharded_accumulate_gradients(
    params: data_parallel.ShardedGriffin, pad_id: int,
    input_tokens: torch.Tensor, input_mask: torch.Tensor, scale: float = 1.0,
    img_embed: torch.Tensor | None = None) -> torch.Tensor:
  """:func:`accumulate_gradients` over a mesh: each data row's model runs
  its slice of the batch and adds ``scale`` times its gradient to its own
  pieces' ``.grad`` (``params.reduce_gradients`` sums them); returns the
  batch's loss (detached, on ``params.device``)."""
  return _sharded_loss(params, pad_id, input_tokens, input_mask, img_embed,
                       scale)


@torch.no_grad()
def sharded_validation_step(
    params: data_parallel.ShardedGriffin, pad_id: int,
    input_tokens: torch.Tensor, input_mask: torch.Tensor,
    img_embed: torch.Tensor | None = None) -> torch.Tensor:
  """The loss only, over the mesh."""
  return _sharded_loss(params, pad_id, input_tokens, input_mask, img_embed,
                       None)


def sharded_apply_update(params: data_parallel.ShardedGriffin,
                         optimizer: torch.optim.Optimizer) -> None:
  """:func:`apply_update` of the reduced gradients (call
  ``params.reduce_gradients()`` first), then the updated pieces copied
  wherever they are not views (``params.refresh()``)."""
  apply_update(params, optimizer)
  params.refresh()


def sharded_train_step(
    params: data_parallel.ShardedGriffin, optimizer: torch.optim.Optimizer,
    pad_id: int, input_tokens: torch.Tensor, input_mask: torch.Tensor,
    img_embed: torch.Tensor | None = None) -> torch.Tensor:
  """One step over a mesh; returns the batch's loss (detached)."""
  params.zero_grad()
  loss = sharded_accumulate_gradients(params, pad_id, input_tokens,
                                      input_mask, img_embed=img_embed)
  params.reduce_gradients()
  params.all_reduce_gradients()
  sharded_apply_update(params, optimizer)
  return loss


def make_sharded_train_step(
    model,
    optimizer,
    mesh,
    pad_id: int,
    batch_axis: str = partitioning.BATCH_AXIS,
    model_axis: str | None = partitioning.MODEL_AXIS,
    example_params=None,
):
  """The train step over ``mesh`` (JAX ``trainer.py:265-347``): DP over
  ``batch_axis``, the Megatron TP layouts over ``model_axis`` where it names
  a mesh axis (derived from ``example_params``, a state dict, which that
  case needs), every leaf replicated otherwise.

  Returns ``(step_fn, shard_params)``, as JAX does.
  ``shard_params(params)`` places a state dict of ``model`` (its
  ``state_dict()``: the pieces are views of the model's parameters, so the
  model holds the trained weights) and returns a
  :class:`~data_parallel.ShardedGriffin`. ``step_fn(params, opt_state,
  input_tokens, input_mask, img_embed=None)`` runs one step on it and
  returns ``(loss, params, opt_state)``.

  torch's optimizer holds references to the tensors it updates, so
  ``optimizer`` is not a transformation to ``init`` but a factory:
  ``optimizer(params)`` builds it over the sharded pieces (``params.
  named_parameters()``, by their leaves' names), e.g.
  ``functools.partial(make_optimizer, learning_rate=1e-3)``, and the
  caller builds it (``opt_state = optimizer(shard_params(params))``, where
  JAX calls ``optimizer.init``); its state is the optimizer itself, updated
  in place.
  """
  if (model_axis is not None and model_axis in mesh.axis_names
      and example_params is None):
    raise ValueError("example_params needed to build TP layouts.")
  shardings = None if example_params is None else (
      partitioning.param_shardings_or_replicated(mesh, example_params,
                                                 model_axis or ""))

  def shard_params(params):
    return data_parallel.ShardedGriffin(model, params, mesh, shardings,
                                        batch_axis, model_axis)

  def step_fn(params, opt_state, input_tokens, input_mask, img_embed=None):
    loss = sharded_train_step(params, opt_state, pad_id, input_tokens,
                              input_mask, img_embed)
    return loss, params, opt_state

  if not callable(optimizer):
    raise TypeError("optimizer must build the optimizer over the sharded "
                    "parameters: optimizer(shard_params(params)).")
  return step_fn, shard_params
