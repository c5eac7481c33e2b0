"""Batch sampler for Griffin models: one-shot prefill, then an eager decode loop.

Counterpart of the JAX package's ``Sampler``
(``cadence_gemma_tpu/inference/sampler.py``) for a batch of text prompts:

  * prompts are left-padded; padded positions carry ``segment_pos == -1``
    and the first real token resets the recurrence at position 0, so a
    row's result does not depend on its padding;
  * one prefill forward builds the cache and the last position's logits
    (the prompt's [b, t, vocab] logits exist only for ``echo`` with
    ``return_logits``) and samples the first token;
  * the decode loop feeds one token per step through the O(1) cache until
    the step budget is spent or every row has emitted a stop token;
  * greedy argmax, or categorical sampling with temperature, top-k and
    top-p from an explicit ``torch.Generator``;
  * with ``img_embed`` (fused vision features) the model splices the
    projected image in after BOS; such prompts must share one length, and
    decode positions continue after the visual tokens unless
    ``reference_position_quirk`` asks for the reference's text-only
    positions.

JAX buckets prompt lengths to powers of two to bound recompilation; eager
PyTorch compiles nothing, so the port pads only to the longest prompt.

A model built with ``scan_sharding_spec`` (sequence parallelism) prefills
sequence-parallel when the padded prompt length -- the longest prompt's --
divides into the mesh's sequence shards; pad the prompt text to such a
length. When it does not, each attention block falls back to its unsharded
path (``can_sequence_shard`` is false), as in JAX, but the RG-LRU scan
raises ``ValueError``, as JAX's ``shard_map`` does. Decode steps (one token)
never shard.
Chunked prefill, prefix and conversational state, grammar constraints,
per-row sampling overrides, the repetition penalty and CUDA-graph decode
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import griffin


@dataclasses.dataclass
class SamplerOutput:
  """Generated text plus per-sequence tokens and (optionally) logits."""

  text: list[str]
  tokens: list[torch.Tensor]
  logits: list[torch.Tensor]


@dataclasses.dataclass
class _SamplingState:
  """The decode loop's state (buffers on the model's device)."""

  tokens_buffer: torch.Tensor  # [b, steps (+ prompt if echo)]
  step: int  # buffer index of the last sampled token
  total_steps: int
  positions: torch.Tensor  # [b, 1] position of the token fed next
  cache: Any
  done: torch.Tensor  # [b] rows that emitted a stop token
  logits_buffer: torch.Tensor | None  # [b, steps (+ prompt), vocab]


def filter_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
  """Temperature, then top-k, then top-p filtering of [b, vocab] logits.

  Top-k keeps every logit at least the k-th largest (ties kept); top-p keeps
  a token if the probability mass before it in descending order is below
  ``top_p``, so the first token is always kept. Dropped logits become -inf.
  """
  if temperature != 1.0:
    logits = logits / temperature
  neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                         device=logits.device)
  if top_k is not None and top_k < logits.shape[-1]:
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    logits = torch.where(logits < kth, neg_inf, logits)
  if top_p is not None and top_p < 1.0:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    keep = cumulative - probs < top_p
    min_kept = torch.where(
        keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))
    ).amin(dim=-1, keepdim=True)
    logits = torch.where(logits < min_kept, neg_inf, logits)
  return logits


class Sampler:
  """Greedy / categorical sampler for a Griffin model.

  Args:
    model: A ``Griffin`` (or any module with its call contract and
      ``init_cache``), already on ``device``.
    vocab: Tokenizer implementing the ``Vocabulary`` protocol.
    device: Where sampling runs; ``None`` means CUDA and raises when there
      is none. Must be the model's device.
    deterministic_sampling: Greedy argmax when True, else categorical.
    is_it_model: Wrap prompts in the Gemma chat template.
    temperature: Softmax temperature of categorical sampling (> 0).
    top_k: Keep the ``k`` most likely tokens (None = all).
    top_p: Nucleus sampling threshold in (0, 1] (None = off).
    stop_token_ids: Token ids that end a row like EOS does.
    reference_position_quirk: Reproduce the reference's multimodal decode
      positions, which ignore the spliced visual tokens.
  """

  def __init__(
      self,
      model: torch.nn.Module,
      vocab: Any,
      device=None,
      deterministic_sampling: bool = True,
      is_it_model: bool = False,
      temperature: float = 1.0,
      top_k: int | None = None,
      top_p: float | None = None,
      stop_token_ids: Sequence[int] | None = None,
      reference_position_quirk: bool = False,
  ):
    self.device = griffin.resolve_device(device)
    param = next(model.parameters())
    if param.device.type != self.device.type or (
        self.device.index is not None and param.device != self.device
    ):
      raise ValueError(
          f"The model lives on {param.device}, the sampler on {self.device}."
      )
    if temperature <= 0.0:
      raise ValueError(
          f"temperature must be > 0 (got {temperature}); use "
          "deterministic_sampling=True for greedy decoding."
      )
    if top_k is not None and top_k < 1:
      raise ValueError(f"top_k must be >= 1 (got {top_k}).")
    if top_p is not None and not 0.0 < top_p <= 1.0:
      raise ValueError(f"top_p must be in (0, 1] (got {top_p}).")
    self.model = model
    self.vocab = vocab
    self.dtype = param.dtype
    self.deterministic_sampling = deterministic_sampling
    self.temperature = float(temperature)
    self.top_k = top_k
    self.top_p = top_p
    self._is_it_model = is_it_model
    self.reference_position_quirk = reference_position_quirk
    stop_ids = {int(vocab.eos_id())} | {int(i) for i in stop_token_ids or ()}
    self._stop_ids = torch.tensor(sorted(stop_ids), device=self.device)

  @property
  def vocab_size(self) -> int:
    return self.model.config.vocab_size

  def tokenize(self, input_string: str) -> list[int]:
    """BOS + encoded prompt (optionally chat-templated)."""
    if self._is_it_model:
      input_string = common.apply_it_formatter(input_string)
    return [self.vocab.bos_id()] + list(self.vocab.EncodeAsIds(input_string))

  def _sample(
      self, logits: torch.Tensor, generator: torch.Generator | None
  ) -> torch.Tensor:
    if self.deterministic_sampling:
      return torch.argmax(logits, dim=-1)
    filtered = filter_logits(logits, self.temperature, self.top_k, self.top_p)
    probs = torch.softmax(filtered.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]

  def _is_stop_token(self, tokens: torch.Tensor) -> torch.Tensor:
    return torch.isin(tokens, self._stop_ids)

  def _prefill(
      self,
      tokens: torch.Tensor,
      input_lengths: torch.Tensor,
      total_generation_steps: int,
      return_logits: bool,
      echo: bool,
      generator: torch.Generator | None,
      img_embed: torch.Tensor | None = None,
  ) -> _SamplingState:
    """Builds the cache, samples the first token, allocates the buffers."""
    batch_size, prompt_length = tokens.shape
    # Left-aligned positions ending at input_length - 1; padding gets -1.
    positions = torch.arange(prompt_length, device=self.device)[None]
    positions = (positions - prompt_length + input_lengths[:, None]).clamp(
        min=-1
    )

    cache = None
    if total_generation_steps == 0:
      prev_logits, _ = self.model(
          tokens, positions, return_logits=return_logits and echo,
          return_cache=False, image=img_embed,
      )
      logits = None
    elif prompt_length == 1:
      logits, cache = self.model(tokens, positions, image=img_embed)
      # With an image only the last position's logits seed decoding.
      logits = logits[:, -1:]
      prev_logits = logits[:, :0]
    else:
      want_prompt_logits = return_logits and echo
      all_logits, cache = self.model(
          tokens, positions, last_logits_only=not want_prompt_logits,
          image=img_embed,
      )
      if want_prompt_logits:
        if img_embed is not None:
          # Drop the visual positions' logits so the echoed logits align
          # with the text tokens.
          n_img = img_embed.shape[1]
          all_logits = torch.cat(
              [all_logits[:, :1], all_logits[:, 1 + n_img:]], dim=1
          )
        prev_logits, logits = all_logits[:, :-1], all_logits[:, -1:]
      else:
        prev_logits, logits = all_logits[:, :0], all_logits

    tokens_buffer = torch.full(
        (batch_size, total_generation_steps), self.vocab.pad_id(),
        dtype=torch.long, device=self.device,
    )
    if logits is not None:
      tokens_buffer[:, 0] = self._sample(logits[:, 0], generator)

    logits_buffer = None
    if return_logits:
      logits_buffer = torch.zeros(
          batch_size, total_generation_steps, self.vocab_size,
          dtype=self.dtype, device=self.device,
      )
      if logits is not None:
        logits_buffer[:, 0] = logits[:, 0]

    step, total_steps = 0, total_generation_steps
    if echo:
      tokens_buffer = torch.cat([tokens, tokens_buffer], dim=1)
      if return_logits:
        logits_buffer = (
            prev_logits if logits is None
            else torch.cat([prev_logits, logits, logits_buffer], dim=1)
        )
      step += prompt_length
      total_steps += prompt_length

    next_positions = positions[:, -1:] + 1
    if (img_embed is not None and prompt_length > 1
        and not self.reference_position_quirk):
      next_positions = next_positions + img_embed.shape[1]

    return _SamplingState(
        tokens_buffer=tokens_buffer,
        step=step,
        total_steps=total_steps,
        positions=next_positions,
        cache=cache,
        done=torch.zeros(batch_size, dtype=torch.bool, device=self.device),
        logits_buffer=logits_buffer,
    )

  def _decode(
      self,
      state: _SamplingState,
      end_sampling_at_eos_token: bool,
      generator: torch.Generator | None,
  ) -> _SamplingState:
    """Feeds one token per step until the budget or every row is done."""
    if end_sampling_at_eos_token:
      # A prompt whose first sampled token is a stop token decodes no more.
      state.done |= self._is_stop_token(state.tokens_buffer[:, state.step])
    # total_steps - 1: the first token was sampled from the prompt.
    while state.step < state.total_steps - 1 and not bool(state.done.all()):
      last_token = state.tokens_buffer[:, state.step][:, None]
      logits, state.cache = self.model(
          last_token, state.positions, state.cache
      )
      next_token = self._sample(logits[:, 0], generator)
      state.tokens_buffer[:, state.step + 1] = next_token
      if state.logits_buffer is not None:
        state.logits_buffer[:, state.step + 1] = logits[:, 0]
      if end_sampling_at_eos_token:
        state.done |= self._is_stop_token(next_token)
      state.step += 1
      state.positions = state.positions + 1
    return state

  @torch.inference_mode()
  def __call__(
      self,
      input_strings: Sequence[str],
      total_generation_steps: int,
      generator: torch.Generator | None = None,
      echo: bool = False,
      return_logits: bool = False,
      end_sampling_at_eos_token: bool = True,
      img_embed: torch.Tensor | None = None,
  ) -> SamplerOutput:
    """Generates completions for a batch of prompts.

    Args:
      input_strings: Prompts.
      total_generation_steps: Tokens to generate (0 = prefill only).
      generator: ``torch.Generator`` on the sampler's device; required for
        categorical sampling.
      echo: Include the prompt in the output buffers.
      return_logits: Return each generated step's logits.
      end_sampling_at_eos_token: Stop once every row has emitted EOS or a
        stop token (rows that stopped keep sampling until all have).
      img_embed: Fused vision features [b, vision_tokens, vision_width],
        spliced in after each prompt's BOS; the prompts must then have
        equal lengths.

    Returns:
      A :class:`SamplerOutput`.
    """
    if not self.deterministic_sampling and generator is None:
      raise ValueError(
          "A torch.Generator must be given for non-deterministic sampling."
      )
    if total_generation_steps < 0:
      raise ValueError("total_generation_steps must be at least 0.")

    all_ids = [self.tokenize(s) for s in input_strings]
    lengths = [len(ids) for ids in all_ids]
    if img_embed is not None and len(set(lengths)) != 1:
      # The image splices in after token 0, which must be the real BOS:
      # left padding would put it after a pad token.
      raise ValueError(
          "Multimodal sampling requires equal-length prompts per batch "
          f"(got lengths {lengths}); split the batch or pad the prompt "
          "text itself."
      )
    max_len = max(lengths)
    pad = self.vocab.pad_id()
    padded = torch.tensor(
        [[pad] * (max_len - len(ids)) + ids for ids in all_ids],
        dtype=torch.long, device=self.device,
    )
    input_lengths = torch.tensor(lengths, device=self.device)

    state = self._prefill(
        padded, input_lengths, total_generation_steps, return_logits, echo,
        generator, img_embed,
    )
    if total_generation_steps > 1:
      state = self._decode(state, end_sampling_at_eos_token, generator)

    # Echoed buffers start with the (padded) prompt: drop each row's padding.
    pad_lengths = [max_len - n if echo else 0 for n in lengths]
    tokens = [seq[p:] for seq, p in zip(state.tokens_buffer, pad_lengths)]
    logits = (
        [seq[p:] for seq, p in zip(state.logits_buffer, pad_lengths)]
        if return_logits else []
    )
    return SamplerOutput(
        text=[self.vocab.DecodeIds(seq.tolist()) for seq in tokens],
        tokens=tokens,
        logits=logits,
    )
