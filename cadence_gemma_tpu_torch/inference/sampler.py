"""Batch sampler for Griffin models: prefill, then a decode loop on the card.

Counterpart of the JAX package's ``Sampler``
(``cadence_gemma_tpu/inference/sampler.py``) for a batch of text prompts:

  * prompts are left-padded; padded positions carry ``segment_pos == -1``
    and the first real token resets the recurrence at position 0, so a
    row's result does not depend on its padding;
  * one prefill forward builds the cache and the last position's logits
    (the prompt's [b, t, vocab] logits exist only for ``echo`` with
    ``return_logits``) and samples the first token; with
    ``prefill_chunk_size`` a longer prompt streams through the cache in
    chunks of that size first, which bounds the activation memory;
  * the decode loop feeds one token per step through the O(1) cache until
    the step budget is spent or every row has emitted a stop token. On the
    card (``jit_compile=True``, the default) one decode step is captured
    as a CUDA graph and replayed once per step, the counterpart of JAX's
    jitted ``lax.while_loop``; ``jit_compile=False`` and the CPU run the
    same step eagerly;
  * greedy argmax, or categorical sampling with temperature, top-k and
    top-p from an explicit ``torch.Generator``; an optional repetition
    penalty over the tokens generated so far;
  * :class:`PrefixState` carries a cache across calls: a shared prefix
    prefilled once (:meth:`Sampler.prefill_prefix`) or the state after a
    turn (``return_state=True``), continued by ``prefix_state=``;
  * with ``img_embed`` (fused vision features) the model splices the
    projected image in after BOS; such prompts must share one length, and
    decode positions continue after the visual tokens unless
    ``reference_position_quirk`` asks for the reference's text-only
    positions.

JAX buckets prompt lengths to powers of two to bound recompilation; eager
PyTorch compiles nothing, so the port pads only to the longest prompt
(:func:`_next_bucket` stays for callers that size buffers by it).

A model built with ``scan_sharding_spec`` (sequence parallelism) prefills
sequence-parallel when the padded prompt length -- the longest prompt's --
divides into the mesh's sequence shards; pad the prompt text to such a
length. When it does not, each attention block falls back to its unsharded
path (``can_sequence_shard`` is false), as in JAX, but the RG-LRU scan
raises ``ValueError``, as JAX's ``shard_map`` does. Decode steps (one token)
never shard.

With ``prefill_act_quant`` a quantized model runs every prefill forward --
the single-shot prompt, each chunk, a prefix, a continuation, and the
continuous batcher's admissions, which go through the same methods -- with
int8 activations as well (:meth:`Griffin.act_quant_view`, over the same
weights), while every decode step, the captured ones included, stays
weight-only.

``constraint=`` (an :class:`~constrain.TokenDFA` compiled for the sampler's
vocabulary) masks every generated token to keep the output inside a
grammar, as JAX's: the mask comes last, after the repetition penalty, and the
sampled token advances each row's DFA state; the first token is masked
before the per-row overrides of the continuous batcher. The captured decode
step masks and advances inside its graph, on tables it owns. The returned
logits stay unmasked.

``mesh=`` serves tensor-parallel, as JAX's ``Sampler(mesh=, model_axis=)``:
the model's weights are placed by ``partitioning.griffin_param_shardings``
over the mesh's ``model_axis`` and every call -- single-shot, chunked,
prefix, continuation, conversation -- runs the Megatron-sharded forward of
``parallel/tensor_parallel.py``, whose cache keeps each recurrent block's
state split over the shards. A decode step is captured when every device
of the mesh is the sampler's card; a mesh over several cards needs the
process-per-card backend for that and raises unless ``jit_compile=False``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence
import warnings

import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel


@dataclasses.dataclass
class SamplerOutput:
  """Generated text plus per-sequence tokens and (optionally) logits.

  ``state`` is set by ``__call__(..., return_state=True)``: pass it as the
  next call's ``prefix_state`` to continue without prefilling the history
  again.
  """

  text: list[str]
  tokens: list[torch.Tensor]
  logits: list[torch.Tensor]
  state: Any = None


@dataclasses.dataclass
class PrefixState:
  """Cached model context, reusable across calls.

  Produced by :meth:`Sampler.prefill_prefix` (a shared prompt prefix) or by
  ``__call__(..., return_state=True)`` (a conversation after a turn), and
  consumed by ``__call__(..., prefix_state=...)``. No call changes it.

  Attributes:
    cache: The model cache after the context; a batch-1 cache broadcasts to
      a larger request batch.
    length: Position of the next token: an int for a text prefix, a [b]
      tensor after a turn (rows may stop at different lengths).
    pending_token: [b, 1] token sampled last and never fed to the model; it
      leads the next turn's tokens. None for a text prefix.
  """

  cache: Any
  length: int | torch.Tensor
  pending_token: torch.Tensor | None = None


@dataclasses.dataclass
class _SamplingState:
  """The decode loop's state (buffers on the model's device)."""

  tokens_buffer: torch.Tensor  # [b, steps (+ prompt if echo)]
  step: torch.Tensor  # int64 scalar: buffer index of the last sampled token
  total_steps: int
  positions: torch.Tensor  # [b, 1] position of the token fed next
  cache: Any
  done: torch.Tensor  # [b] rows that emitted a stop token
  logits_buffer: torch.Tensor | None  # [b, steps (+ prompt), vocab]
  # int64 scalar: first buffer index of a generated token (the repetition
  # penalty's scope, whatever ``echo`` puts before it).
  gen_start: torch.Tensor
  # [b] int32 grammar-DFA state of each row, when the call carries a
  # ``constraint`` (``inference/constrain.py``); None otherwise.
  constraint_state: torch.Tensor | None = None


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
  if top_k is not None and top_k < logits.shape[-1]:
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    logits = logits.masked_fill(logits < kth, float("-inf"))
  if top_p is not None and top_p < 1.0:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    keep = cumulative - probs < top_p
    min_kept = sorted_logits.masked_fill(~keep, float("inf")).amin(
        dim=-1, keepdim=True
    )
    logits = logits.masked_fill(logits < min_kept, float("-inf"))
  return logits


def filter_logits_rows(
    logits: torch.Tensor,
    temp: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
  """Row-wise temperature / top-k / top-p, as :func:`filter_logits` composes
  them.

  ``temp``, ``top_k`` (0 = off) and ``top_p`` (1 = off) are [b]. One
  descending sort serves both filters: top-k's threshold is the k-th sorted
  value (ties kept); top-p's kept mass is computed on the top-k-filtered
  distribution. Rows at the defaults pass through unchanged.
  """
  lg = logits / temp[:, None]
  sorted_lg = torch.sort(lg, dim=-1, descending=True).values
  k = top_k.long().clamp(0, lg.shape[-1])
  kth = sorted_lg.gather(1, (k - 1).clamp(min=0)[:, None])
  thr_k = kth.masked_fill((k <= 0)[:, None], float("-inf"))
  lg = lg.masked_fill(lg < thr_k, float("-inf"))
  # Top-p over the top-k-filtered distribution: entries below the k
  # threshold become -inf in place, which keeps the order.
  sorted2 = sorted_lg.masked_fill(sorted_lg < thr_k, float("-inf"))
  probs = torch.softmax(sorted2, dim=-1)
  cumulative = torch.cumsum(probs, dim=-1)
  keep = cumulative - probs < top_p[:, None]
  min_kept = sorted2.masked_fill(~keep, float("inf")).amin(
      dim=-1, keepdim=True
  )
  return lg.masked_fill(lg < min_kept, float("-inf"))


def _categorical(probs: torch.Tensor, generator: torch.Generator | None):
  """One draw a row: ``torch.multinomial(probs, 1)``'s own method (argmax of
  ``probs / q`` with ``q ~ Exp(1)``), the same draws from the same
  generator, without its host-side checks of ``probs``, which a CUDA graph
  cannot capture."""
  q = torch.empty_like(probs).exponential_(1.0, generator=generator)
  return (probs / q).argmax(dim=-1)


def _next_bucket(n: int, minimum: int = 16) -> int:
  """Smallest power of two >= max(n, minimum)."""
  b = minimum
  while b < n:
    b *= 2
  return b


def _cache_leaves(cache) -> list[torch.Tensor]:
  return [t for block in cache.values() for t in block]


def _map_cache(fn, cache):
  return {name: type(block)(*(fn(t) for t in block))
          for name, block in cache.items()}


# Eager decode steps a new graph runs on its own buffers before capture.
_GRAPH_WARMUP_STEPS = 3


class _DecodeGraph:
  """One decode step captured as a CUDA graph, replayed once per step.

  The graph owns its buffers: :meth:`load` copies a call's state into them
  before the replays and :meth:`store` copies it out after, so a cached
  graph serves every later call of its shapes and never writes a tensor
  the caller still holds (a :class:`PrefixState`'s cache). The step's
  logits come out in one [b, vocab] buffer (:attr:`logits`); the caller
  copies them into its own logits buffer, so ``return_logits`` needs no
  graph of its own.

  Categorical sampling draws from a generator registered with the graph:
  :meth:`load` gives it the caller's generator's seed and offset, and
  :meth:`store` hands the advanced offset back, so the replays draw what
  eager steps would have drawn from the caller's generator.

  A constrained step (``tables``, a ``constrain.ConstraintTables``) masks
  and advances on the graph's own copy of the tables and of the rows' DFA
  states; :meth:`load` copies a call's tables in, so one graph serves every
  grammar of the same table shapes.
  """

  def __init__(self, sampler: "Sampler", state: _SamplingState, eos: bool,
               categorical: bool, tables=None):
    # The sampler is not kept: it holds this graph, and a reference back
    # would keep both (and the graph's memory pool) alive until a garbage
    # collection. Replays run no Python.
    self._eos = eos
    device = state.tokens_buffer.device
    self.tokens_buffer = state.tokens_buffer.clone()
    self.step = state.step.clone()
    self.positions = state.positions.clone()
    self.done = state.done.clone()
    self.gen_start = state.gen_start.clone()
    self.cache = _map_cache(torch.clone, state.cache)
    self.tables = self.constraint_state = None
    if tables is not None:
      self.tables = tables.clone()
      self.constraint_state = state.constraint_state.clone()
    self.generator = None
    if categorical:
      if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise NotImplementedError(
            f"torch {torch.__version__} cannot register a generator with a "
            "CUDA graph, which captured categorical decoding needs; pass "
            "jit_compile=False."
        )
      self.generator = torch.Generator(device)
    self.replays = 0
    # Warm-up on a side stream, as capture requires, on the graph's own
    # buffers (reloaded from the state each time) and generator, so the
    # caller's state and generator do not move.
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
      for _ in range(_GRAPH_WARMUP_STEPS):
        self.load(state, None, tables)
        self._step(sampler)
    torch.cuda.current_stream(device).wait_stream(side)
    self.graph = torch.cuda.CUDAGraph()
    if self.generator is not None:
      self.graph.register_generator_state(self.generator)
    with torch.cuda.graph(self.graph):
      self.logits = self._step(sampler)

  def _step(self, sampler: "Sampler") -> torch.Tensor:
    logits, cache = sampler._decode_step(
        self.tokens_buffer, self.step, self.positions, self.done,
        self.gen_start, self.cache, self.generator, self._eos,
        self.constraint_state, self.tables,
    )
    for dst, src in zip(_cache_leaves(self.cache), _cache_leaves(cache)):
      dst.copy_(src)
    return logits

  def load(self, state: _SamplingState,
           generator: torch.Generator | None, tables=None) -> None:
    """Copies a call's state (generator position and constraint tables
    included) into the buffers."""
    for dst, src in zip(
        [self.tokens_buffer, self.step, self.positions, self.done,
         self.gen_start, *_cache_leaves(self.cache)],
        [state.tokens_buffer, state.step, state.positions, state.done,
         state.gen_start, *_cache_leaves(state.cache)],
    ):
      dst.copy_(src)
    if self.tables is not None:
      self.tables.copy_(tables)
      self.constraint_state.copy_(state.constraint_state)
    if self.generator is not None and generator is not None:
      self.generator.set_state(generator.get_state())

  def replay(self) -> torch.Tensor:
    """Runs one step; returns the step's logits (the graph's buffer)."""
    self.graph.replay()
    self.replays += 1
    return self.logits

  def store(self, state: _SamplingState, generator: torch.Generator | None,
            keep_cache: bool) -> None:
    """Copies the buffers out into ``state`` (the cache if ``keep_cache``)."""
    state.tokens_buffer = self.tokens_buffer.clone()
    state.step = self.step.clone()
    state.positions = self.positions.clone()
    state.done = self.done.clone()
    if self.constraint_state is not None:
      state.constraint_state = self.constraint_state.clone()
    state.cache = (_map_cache(torch.clone, self.cache) if keep_cache
                   else None)
    if self.generator is not None and generator is not None:
      generator.set_state(self.generator.get_state())


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
    jit_compile: On a CUDA device, capture one decode step as a CUDA graph
      and replay it (graphs are cached by batch, buffer length, stopping
      rule, penalty and sampling mode, and hold the model's code path and
      parameter storage as captured); False runs every step eagerly. The
      CPU always runs eagerly. A capture that fails raises.
    prefill_chunk_size: Prefill prompts longer than this in chunks of this
      many tokens through the cache (left-padded to a multiple of it);
      prompts with an image stay single-shot. None = single-shot.
    repetition_penalty: > 1 penalizes tokens generated so far in this call
      (positive logits divided by it, negative multiplied); the prompt and
      the first sampled token are never penalized. 1.0 = off.
    prefill_act_quant: Run every prefill forward with int8 activations as
      well as int8 weights (``sampler.py:232-259`` in JAX); decode stays
      weight-only. Requires a ``quantized=True`` model, whose weights both
      phases share.
    mesh: A device mesh (``parallel.sharding.make_mesh``) to serve
      tensor-parallel over (``sampler.py:180-181,261-269`` in JAX): the
      model -- a ``Griffin`` on any device, or a
      ``tensor_parallel.TensorParallelGriffin`` already placed -- is placed
      by ``partitioning.griffin_param_shardings`` over ``model_axis`` and
      runs sharded. ``device=None`` then means the first device of the
      mesh's model axis. None = one device.
    model_axis: The mesh axis of the tensor-parallel layouts.
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
      jit_compile: bool = True,
      prefill_chunk_size: int | None = None,
      repetition_penalty: float = 1.0,
      prefill_act_quant: bool = False,
      mesh: sharding.Mesh | None = None,
      model_axis: str = partitioning.MODEL_AXIS,
  ):
    self.mesh = mesh
    self.model_axis = model_axis
    if mesh is not None:
      model, device = self._place_on_mesh(model, mesh, model_axis, device,
                                          jit_compile)
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
    if repetition_penalty <= 0.0:
      raise ValueError(
          f"repetition_penalty must be > 0 (got {repetition_penalty})."
      )
    if prefill_act_quant and not getattr(model, "quantized", False):
      raise ValueError(
          "prefill_act_quant requires a quantized=True model (the int8 "
          "product contracts against int8 weights)."
      )
    self.model = model
    # The prefill forwards' model: an act_quant view over the same weights.
    self._prefill_model = (model.act_quant_view() if prefill_act_quant
                           else model)
    self.prefill_act_quant = prefill_act_quant
    self.vocab = vocab
    # The activations' dtype: a quantized model's first parameter is its
    # int8 table, its embedder knows the compute dtype.
    self.dtype = (model.embedder.dtype if getattr(model, "quantized", False)
                  else param.dtype)
    self.deterministic_sampling = deterministic_sampling
    self.temperature = float(temperature)
    self.top_k = top_k
    self.top_p = top_p
    self.repetition_penalty = float(repetition_penalty)
    self.jit_compile = jit_compile
    self.prefill_chunk_size = prefill_chunk_size
    self._is_it_model = is_it_model
    self.reference_position_quirk = reference_position_quirk
    stop_ids = {int(vocab.eos_id())} | {int(i) for i in stop_token_ids or ()}
    self._stop_ids_host = tuple(sorted(stop_ids))
    self._stop_ids = torch.tensor(self._stop_ids_host, device=self.device)
    self._graphs: dict[tuple, _DecodeGraph] = {}

  @staticmethod
  def _place_on_mesh(model, mesh, model_axis, device, jit_compile):
    """The tensor-parallel model over ``mesh`` and the sampler's device
    (the first device of the model axis, which must be ``device``'s)."""
    sharding.refuse_processes(mesh, "A tensor-parallel Sampler")
    devices = sharding.axis_devices(mesh, model_axis)
    first = griffin.resolve_device(devices[0])
    if device is not None and griffin.resolve_device(device) not in (
        first, torch.device(first.type)):
      raise ValueError(f"The sampler runs on {device}, the first device of "
                       f"the mesh's {model_axis!r} axis is {first}.")
    if (jit_compile and first.type == "cuda"
        and len({str(d) for d in mesh.devices.flat}) > 1):
      raise NotImplementedError(
          f"A captured decode step over a mesh of several cards "
          f"({mesh}) needs {sharding.PROCESS_PER_CARD_ITEM}; pass "
          "jit_compile=False to run the steps eagerly, or a mesh that "
          "repeats one card.")
    if not isinstance(model, tensor_parallel.TensorParallelGriffin):
      model = tensor_parallel.tensor_parallel(model, mesh, model_axis)
    elif model.mesh is not mesh or model.model_axis != model_axis:
      raise ValueError("The tensor-parallel model was placed over another "
                       "mesh or axis.")
    return model, first

  @property
  def vocab_size(self) -> int:
    return self.model.config.vocab_size

  def tokenize(self, input_string: str) -> list[int]:
    """BOS + encoded prompt (optionally chat-templated)."""
    if self._is_it_model:
      input_string = common.apply_it_formatter(input_string)
    return [self.vocab.bos_id()] + list(self.vocab.EncodeAsIds(input_string))

  # -- sampling ---------------------------------------------------------------

  def _sample(
      self, logits: torch.Tensor, generator: torch.Generator | None,
      row_overrides=None,
  ) -> torch.Tensor:
    """Greedy argmax or filtered categorical; ``row_overrides`` is an
    optional ``(temp[b], top_k[b], top_p[b])`` triple replacing the
    sampler's filters row by row."""
    if self.deterministic_sampling:
      return torch.argmax(logits, dim=-1)
    if row_overrides is not None:
      filtered = filter_logits_rows(logits, *row_overrides)
    else:
      filtered = filter_logits(logits, self.temperature, self.top_k,
                               self.top_p)
    return _categorical(torch.softmax(filtered.float(), dim=-1), generator)

  def _apply_repetition_penalty(
      self,
      logits: torch.Tensor,
      tokens_buffer: torch.Tensor,
      written: torch.Tensor,
  ) -> torch.Tensor:
    """Penalizes every token that ``tokens_buffer`` holds where ``written``
    ([b, l] bool) is set: positive logits divided by the penalty, negative
    multiplied."""
    p = self.repetition_penalty
    seen = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    seen = seen.scatter_add_(1, tokens_buffer, written.to(torch.int32)) > 0
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(seen, penalized, logits)

  def _is_stop_token(self, tokens: torch.Tensor) -> torch.Tensor:
    """True where ``tokens`` is EOS or a configured stop token."""
    return (tokens[..., None] == self._stop_ids).any(dim=-1)

  # -- prefill ----------------------------------------------------------------

  def _prefill(
      self,
      tokens: torch.Tensor,
      input_lengths: torch.Tensor,
      total_generation_steps: int,
      return_logits: bool,
      echo: bool,
      generator: torch.Generator | None,
      img_embed: torch.Tensor | None = None,
      initial_cache=None,
      start_positions: torch.Tensor | None = None,
      sampling_overrides=None,
      constraint_tables=None,
  ) -> _SamplingState:
    """Builds the cache, samples the first token, allocates the buffers.

    ``initial_cache`` / ``start_positions`` continue from a cache (a chunked
    prefill's earlier chunks, a prefix, a previous turn): positions are then
    ``start + arange``, clamped at the -1 padding sentinel.
    ``sampling_overrides``, a ``(temp[b], top_k[b], top_p[b],
    suppress_stops[b], extra_stop_cols[b, k], bias_ids[b, m],
    bias_vals[b, m])`` tuple, samples the first token with per-row filters:
    the logit bias is added (id -1 = unused entry), and the stop tokens of
    ``suppress_stops`` rows are masked to -inf. ``constraint_tables`` masks
    the first token with the grammar, before the overrides, and the state
    carries each row's DFA state after it (``constraint_state``).
    """
    batch_size, prompt_length = tokens.shape
    steps = torch.arange(prompt_length, device=self.device)[None]
    if start_positions is not None:
      positions = (steps + start_positions[:, None]).clamp(min=-1)
    else:
      # Left-aligned positions ending at input_length - 1; padding gets -1.
      positions = (steps - prompt_length + input_lengths[:, None]).clamp(
          min=-1
      )

    cache = None
    if total_generation_steps == 0:
      prev_logits, _ = self._prefill_model(
          tokens, positions, initial_cache,
          return_logits=return_logits and echo, return_cache=False,
          image=img_embed,
      )
      logits = None
    elif prompt_length == 1:
      logits, cache = self._prefill_model(tokens, positions, initial_cache,
                                          image=img_embed)
      # With an image only the last position's logits seed decoding.
      logits = logits[:, -1:]
      prev_logits = logits[:, :0]
    else:
      want_prompt_logits = return_logits and echo
      all_logits, cache = self._prefill_model(
          tokens, positions, initial_cache,
          last_logits_only=not want_prompt_logits, image=img_embed,
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
    constraint_state = None
    if constraint_tables is not None:
      constraint_state = constraint_tables.start.expand(batch_size).clone()
    if logits is not None:
      seed_logits, row_overrides = logits[:, 0], None
      if constraint_tables is not None:
        seed_logits = constraint_tables.mask(constraint_state, seed_logits)
      if sampling_overrides is not None:
        seed_logits, row_overrides = self._override_seed_logits(
            seed_logits, sampling_overrides
        )
      tokens_buffer[:, 0] = self._sample(seed_logits, generator,
                                         row_overrides)
      if constraint_tables is not None:
        constraint_state = constraint_tables.advance(constraint_state,
                                                     tokens_buffer[:, 0])

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

    step = torch.tensor(step, dtype=torch.long, device=self.device)
    return _SamplingState(
        tokens_buffer=tokens_buffer,
        step=step,
        total_steps=total_steps,
        positions=next_positions,
        cache=cache,
        done=torch.zeros(batch_size, dtype=torch.bool, device=self.device),
        logits_buffer=logits_buffer,
        gen_start=step.clone(),
        constraint_state=constraint_state,
    )

  def _override_seed_logits(self, seed_logits, sampling_overrides):
    """The first token's logits under per-row overrides, and the row-wise
    filters to sample them with (see :meth:`_prefill`)."""
    (temp_r, top_k_r, top_p_r, suppress, extra_cols, bias_ids,
     bias_vals) = sampling_overrides
    bias_add = torch.where(bias_ids >= 0, bias_vals, 0.0).to(seed_logits.dtype)
    seed_logits = seed_logits.scatter_add(1, bias_ids.long().clamp(min=0),
                                          bias_add)
    stop_cols = list(self._stop_ids_host)
    seed_logits[:, stop_cols] = seed_logits[:, stop_cols].masked_fill(
        suppress[:, None], float("-inf")
    )
    cols = extra_cols.long().clamp(min=0)
    vals = seed_logits.gather(1, cols).masked_fill(
        (extra_cols >= 0) & suppress[:, None], float("-inf")
    )
    return seed_logits.scatter(1, cols, vals), (temp_r, top_k_r, top_p_r)

  def _prefill_chunk_step(self, tokens, positions, cache,
                          return_logits: bool = False):
    """One chunk of a long prompt through the cache; its per-token logits
    only with ``return_logits`` (echo with return_logits)."""
    return self._prefill_model(tokens, positions, cache,
                               return_logits=return_logits)

  # -- decode -----------------------------------------------------------------

  def _decode_step(
      self,
      tokens_buffer: torch.Tensor,
      step: torch.Tensor,
      positions: torch.Tensor,
      done: torch.Tensor,
      gen_start: torch.Tensor,
      cache,
      generator: torch.Generator | None,
      end_sampling_at_eos_token: bool,
      constraint_state: torch.Tensor | None = None,
      constraint_tables=None,
  ):
    """One decode step: feeds the token at ``step``, writes the next at
    ``step + 1``. Advances ``tokens_buffer``, ``step``, ``positions`` and
    ``done`` in place and reads nothing back to the host, so a CUDA graph
    can capture it; returns the step's logits [b, vocab] (unmasked) and the
    new cache. With ``constraint_tables`` the grammar mask comes last,
    after the penalty, and the sampled token advances ``constraint_state``
    in place.
    """
    rows = tokens_buffer.shape[0]
    last_token = tokens_buffer.gather(1, step.expand(rows, 1))
    logits, cache = self.model(last_token, positions, cache)
    logits = logits[:, 0]
    step_logits = logits
    if self.repetition_penalty != 1.0:
      # Generated tokens only, [gen_start, step]: the echoed prompt before
      # gen_start is not penalized, so echo does not change the tokens.
      idx = torch.arange(tokens_buffer.shape[1], device=step.device)
      written = (idx >= gen_start) & (idx <= step)
      step_logits = self._apply_repetition_penalty(
          logits, tokens_buffer, written.expand_as(tokens_buffer)
      )
    if constraint_tables is not None:
      step_logits = constraint_tables.mask(constraint_state, step_logits)
    next_token = self._sample(step_logits, generator)
    if constraint_tables is not None:
      constraint_state.copy_(constraint_tables.advance(constraint_state,
                                                       next_token))
    step.add_(1)
    tokens_buffer.scatter_(1, step.expand(rows, 1), next_token[:, None])
    positions.add_(1)
    if end_sampling_at_eos_token:
      done |= self._is_stop_token(next_token)
    return logits, cache

  @property
  def _captures_decode(self) -> bool:
    """Decode replays a captured step (graphs are a CUDA facility)."""
    return self.jit_compile and self.device.type == "cuda"

  def _graph_for(self, state: _SamplingState, eos: bool,
                 constraint_tables=None) -> _DecodeGraph:
    key = (*state.tokens_buffer.shape, eos, self.repetition_penalty != 1.0,
           self.deterministic_sampling,
           constraint_tables.shapes if constraint_tables is not None
           else None)
    graph = self._graphs.get(key)
    if graph is None:
      graph = _DecodeGraph(self, state, eos, not self.deterministic_sampling,
                           constraint_tables)
      self._graphs[key] = graph
    return graph

  def _decode(
      self,
      state: _SamplingState,
      end_sampling_at_eos_token: bool,
      generator: torch.Generator | None,
      keep_cache: bool = False,
      constraint_tables=None,
  ) -> _SamplingState:
    """Runs steps until the budget is spent or every row is done.

    As JAX's loop: rows that stopped keep sampling until every row has, and
    no step runs after that. With ``jit_compile`` on the card each step is
    one replay of the captured step; the host reads ``done`` after each
    (only when stop tokens end rows) and otherwise only enqueues.
    ``keep_cache`` keeps the final cache in the state (``return_state``).
    """
    rows = state.tokens_buffer.shape[0]
    if end_sampling_at_eos_token:
      # A prompt whose first sampled token is a stop token decodes no more.
      first = state.tokens_buffer.gather(1, state.step.expand(rows, 1))
      state.done |= self._is_stop_token(first[:, 0])
    step = int(state.step)
    graph = None
    if self._captures_decode:
      graph = self._graph_for(state, end_sampling_at_eos_token,
                              constraint_tables)
      graph.load(state, generator, constraint_tables)
    done = graph.done if graph else state.done
    # total_steps - 1: the first token was sampled from the prompt.
    while step < state.total_steps - 1:
      if end_sampling_at_eos_token and bool(done.all()):
        break
      if graph:
        logits = graph.replay()
      else:
        logits, state.cache = self._decode_step(
            state.tokens_buffer, state.step, state.positions, state.done,
            state.gen_start, state.cache, generator,
            end_sampling_at_eos_token, state.constraint_state,
            constraint_tables,
        )
      step += 1
      if state.logits_buffer is not None:
        state.logits_buffer[:, step] = logits
    if graph:
      graph.store(state, generator, keep_cache)
    return state

  # -- prefix caching ---------------------------------------------------------

  @torch.inference_mode()
  def prefill_prefix(self, prefix: str, batch_size: int = 1) -> PrefixState:
    """Prefills a shared prompt prefix once, for any number of later
    ``__call__(..., prefix_state=...)`` requests.

    Args:
      prefix: Prefix text; BOS is added here. For IT models only the user
        turn's opening wraps it: continuations extend that turn, and
        :meth:`encode_continuation` closes it, so prefix + continuation
        tokenizes like one templated prompt.
      batch_size: Batch of the cache. Keep 1 and let requests broadcast
        unless the prefix differs per row.
    """
    if self._is_it_model:
      ids = [self.vocab.bos_id()] + list(
          self.vocab.EncodeAsIds(common.IT_USER_OPEN + prefix)
      )
    else:
      ids = self.tokenize(prefix)
    tokens = torch.tensor([ids] * batch_size, dtype=torch.long,
                          device=self.device)
    real_len = tokens.shape[1]
    cache = self.model.init_cache(batch_size, self.dtype)
    chunk = self.prefill_chunk_size
    if chunk is not None and real_len > chunk:
      # As __call__ chunks a prompt: left-pad to a chunk multiple (padded
      # positions carry -1) and stream the chunks through the cache.
      extra = -real_len % chunk
      tokens = torch.nn.functional.pad(tokens, (extra, 0),
                                       value=self.vocab.pad_id())
      positions = (torch.arange(tokens.shape[1], device=self.device)
                   - extra).clamp(min=-1).expand(batch_size, -1)
      for start in range(0, tokens.shape[1], chunk):
        _, cache = self._prefill_chunk_step(
            tokens[:, start:start + chunk],
            positions[:, start:start + chunk], cache,
        )
    else:
      positions = torch.arange(real_len, device=self.device).expand(
          batch_size, -1
      )
      _, cache = self._prefill_chunk_step(tokens, positions, cache)
    return PrefixState(cache=cache, length=real_len)

  def _continue_from_prefix(self, prefix_state: PrefixState,
                            batch_size: int):
    """The prefix cache, broadcast to the request batch if needed."""
    prefix_batch = _cache_leaves(prefix_state.cache)[0].shape[0]
    if prefix_batch == batch_size:
      return prefix_state.cache
    if prefix_batch != 1:
      raise ValueError(
          f"Prefix cache batch {prefix_batch} != request batch "
          f"{batch_size}; prefill the prefix with batch_size=1 (broadcast) "
          "or the exact request batch."
      )
    return _map_cache(
        lambda x: torch.repeat_interleave(x, batch_size, dim=0),
        prefix_state.cache,
    )

  def encode_continuation(
      self, input_strings: Sequence[str], prefix_state: PrefixState
  ) -> tuple[torch.Tensor, Any, torch.Tensor]:
    """Tokens, cache and start positions of a prefix continuation.

    Continuations are encoded without BOS (it lives in the prefix) and must
    share one length: left padding would write pad tokens into the cache
    after real context. A pending token (sampled last turn, never fed)
    leads the tokens.

    IT chat template: a text prefix left the user turn open, so the
    continuation closes it and opens the model turn. A conversational
    state ended inside the model's reply, so the continuation closes that
    turn (only the newline if the pending token already is a stop token)
    and wraps the new text as a user turn; a batch mixing the two cases
    raises.
    """
    if self._is_it_model:
      if prefix_state.pending_token is not None:
        closed = self._is_stop_token(prefix_state.pending_token).reshape(-1)
        if bool(closed.all()):
          turn_close = "\n"
        elif bool(closed.any()):
          raise ValueError(
              "Mixed conversational batch: some rows ended on a stop "
              "token and some were budget-truncated; their continuation "
              "templates differ in length. Split the batch."
          )
        else:
          turn_close = common.IT_TURN_CLOSE
        input_strings = [turn_close + common.apply_it_formatter(s)
                         for s in input_strings]
      else:
        input_strings = [f"{s}{common.IT_TURN_CLOSE}{common.IT_MODEL_OPEN}"
                         for s in input_strings]
    ids = [list(self.vocab.EncodeAsIds(s)) for s in input_strings]
    lengths = {len(i) for i in ids}
    if 0 in lengths:
      raise ValueError("Continuation prompts must be non-empty.")
    if len(lengths) != 1:
      raise ValueError(
          "Prefix continuation requires equal-length prompts per batch "
          f"(got {sorted(len(i) for i in ids)}): ragged left-padding "
          "would write pad tokens into the cache after real prefix "
          "content. Split the batch by length."
      )
    tokens = torch.tensor(ids, dtype=torch.long, device=self.device)
    batch = tokens.shape[0]
    cache = self._continue_from_prefix(prefix_state, batch)
    start = torch.as_tensor(
        prefix_state.length, dtype=torch.long, device=self.device
    ).reshape(-1).expand(batch)
    if prefix_state.pending_token is not None:
      pending = prefix_state.pending_token.expand(batch, 1)
      tokens = torch.cat([pending, tokens], dim=1)
    return tokens, cache, start

  def plan_prompt_chunks(self, padded_tokens: torch.Tensor,
                         input_lengths: torch.Tensor):
    """Chunk plan of a fresh (BOS-leading, left-padded) prompt.

    Left-pads to a ``prefill_chunk_size`` multiple (padded positions carry
    -1, as in a single-shot prefill); every chunk but the last goes through
    the cache alone, and the last runs the sampling prefill from per-row
    ``start`` positions (negative for rows whose prompt begins inside it).

    Returns ``(mid_chunks, cache, final_tokens, final_start,
    padded_tokens)``: ``mid_chunks`` is a list of (tokens, positions)
    slices and ``cache`` a fresh one.
    """
    chunk = self.prefill_chunk_size
    batch, total_len = padded_tokens.shape
    extra = -total_len % chunk
    padded_tokens = torch.nn.functional.pad(padded_tokens, (extra, 0),
                                            value=self.vocab.pad_id())
    total_len += extra
    positions = (torch.arange(total_len, device=self.device)[None]
                 - total_len + input_lengths[:, None]).clamp(min=-1)
    num_chunks = total_len // chunk
    mid = [(padded_tokens[:, i * chunk:(i + 1) * chunk],
            positions[:, i * chunk:(i + 1) * chunk])
           for i in range(num_chunks - 1)]
    final_start = (num_chunks - 1) * chunk - total_len + input_lengths
    cache = self.model.init_cache(batch, self.dtype)
    return mid, cache, padded_tokens[:, -chunk:], final_start, padded_tokens

  def plan_continuation_chunks(self, input_strings: Sequence[str],
                               prefix_state: PrefixState):
    """:meth:`encode_continuation` plus the chunk plan of a long one.

    Continuations are never padded (pads after real context would enter
    the cache): full-size middle chunks, then the remainder. When middle
    chunks exist the returned cache is a copy, never the prefix's own, so
    a caller may update it in place while other requests still read the
    prefix.

    Returns ``(mid_chunks, cache, final_tokens, final_start, tokens)``.
    """
    tokens, cache, start = self.encode_continuation(input_strings,
                                                    prefix_state)
    chunk = self.prefill_chunk_size
    length = tokens.shape[1]
    if chunk is None or length <= chunk:
      return [], cache, tokens, start, tokens
    if cache is prefix_state.cache:
      cache = _map_cache(torch.clone, cache)
    positions = start[:, None] + torch.arange(length, device=self.device)
    n_mid = (length - 1) // chunk
    mid = [(tokens[:, i * chunk:(i + 1) * chunk],
            positions[:, i * chunk:(i + 1) * chunk]) for i in range(n_mid)]
    return mid, cache, tokens[:, n_mid * chunk:], start + n_mid * chunk, tokens

  # -- public entry -----------------------------------------------------------

  def _validate_sampling_args(self, total_generation_steps: int,
                              generator) -> None:
    if not self.deterministic_sampling and generator is None:
      raise ValueError(
          "A torch.Generator must be given for non-deterministic sampling."
      )
    if total_generation_steps < 0:
      raise ValueError("total_generation_steps must be at least 0.")

  def _resolve_constraint(self, constraint):
    """``constraint`` (a ``TokenDFA`` or its tables) -> tables on the
    sampler's device, checked against the model's vocabulary."""
    if constraint is None:
      return None
    tables = constraint
    if callable(getattr(constraint, "tables", None)):
      tables = constraint.tables(device=self.device)
    table_vocab = tables.token_lengths.shape[0]
    if table_vocab != self.vocab_size:
      raise ValueError(
          f"Constraint was compiled for a {table_vocab}-token vocabulary; "
          f"this sampler's model has {self.vocab_size}. Rebuild the "
          "TokenDFA with token_strings_from_vocab(vocab, vocab_size)."
      )
    return tables

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
      prefix_state: PrefixState | None = None,
      return_state: bool = False,
      constraint: Any | None = None,
  ) -> SamplerOutput:
    """Generates completions for a batch of prompts.

    Args:
      input_strings: Prompts.
      total_generation_steps: Tokens to generate (0 = prefill only).
      generator: ``torch.Generator`` on the sampler's device; required for
        categorical sampling, and advanced as eager sampling would.
      echo: Include the prompt in the output buffers.
      return_logits: Return each generated step's logits.
      end_sampling_at_eos_token: Stop once every row has emitted EOS or a
        stop token (rows that stopped keep sampling until all have).
      img_embed: Fused vision features [b, vision_tokens, vision_width],
        spliced in after each prompt's BOS; the prompts must then have
        equal lengths.
      prefix_state: Cached context (:meth:`prefill_prefix`, or a previous
        call's ``state``); ``input_strings`` are then continuations, raw
        text without BOS of one length per batch (IT turn markers are
        added here), and ``echo`` covers the continuation only. Not with
        ``img_embed``.
      return_state: Attach the state after this call as ``state``, to
        continue from. Exact for batch 1; in a larger batch rows that
        stopped early keep decoding until all have. Needs
        ``total_generation_steps >= 1``.
      constraint: A grammar: a :class:`~constrain.TokenDFA` (or its
        ``tables(device=...)``) compiled for this sampler's vocabulary.
        Every generated token is masked to keep the output inside the
        grammar, and stop tokens are allowed only once the output matches
        it (a generation that spends its budget may end on an incomplete
        prefix). The batch shares one grammar; each row has its own DFA
        state, which restarts at the grammar's start each call (with
        ``prefix_state`` it scopes the new generation, not the history).
        Returned ``logits`` are the model's, before the mask; ``echo``
        does not constrain the prompt.

    Returns:
      A :class:`SamplerOutput`.
    """
    self._validate_sampling_args(total_generation_steps, generator)
    tables = self._resolve_constraint(constraint)
    if return_state and total_generation_steps < 1:
      raise ValueError(
          "return_state requires total_generation_steps >= 1 (a prefill-"
          "only call builds no reusable cache; use prefill_prefix)."
      )
    if prefix_state is not None:
      return self._call_with_prefix(
          prefix_state, input_strings, total_generation_steps, generator,
          echo, return_logits, end_sampling_at_eos_token, img_embed,
          return_state, tables,
      )

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

    chunk = self.prefill_chunk_size
    long_prompt = chunk is not None and max_len > chunk
    if long_prompt and img_embed is not None:
      # The image splices in after BOS, which a chunk's cache path cannot
      # represent.
      warnings.warn(
          "prefill_chunk_size is set but chunking was skipped: the chunked "
          "path does not support the in-prompt image splice.",
          stacklevel=2,
      )
    if long_prompt and img_embed is None:
      mid, cache, final_tokens, start, padded = self.plan_prompt_chunks(
          padded, input_lengths
      )
      want_chunk_logits = echo and return_logits
      chunk_logits = []
      for tok_c, pos_c in mid:
        logits_c, cache = self._prefill_chunk_step(tok_c, pos_c, cache,
                                                   want_chunk_logits)
        chunk_logits.append(logits_c)
      state = self._prefill(
          final_tokens, input_lengths, total_generation_steps,
          return_logits, echo, generator, None, cache, start,
          constraint_tables=tables,
      )
      if echo:
        # The final prefill echoed its own chunk only: prepend the earlier
        # chunks' tokens and logits and shift the bookkeeping with them.
        earlier = padded[:, :-chunk]
        if return_logits:
          state.logits_buffer = torch.cat(
              chunk_logits + [state.logits_buffer], dim=1
          )
        state.tokens_buffer = torch.cat([earlier, state.tokens_buffer],
                                        dim=1)
        state.step += earlier.shape[1]
        state.total_steps += earlier.shape[1]
        state.gen_start += earlier.shape[1]
    else:
      state = self._prefill(
          padded, input_lengths, total_generation_steps, return_logits,
          echo, generator, img_embed, constraint_tables=tables,
      )
    pad_lengths = [padded.shape[1] - n for n in lengths]
    return self._finish_sampling(
        state, pad_lengths, total_generation_steps, echo, return_logits,
        end_sampling_at_eos_token, return_state, generator, tables,
    )

  def _call_with_prefix(
      self,
      prefix_state: PrefixState,
      input_strings: Sequence[str],
      total_generation_steps: int,
      generator,
      echo: bool,
      return_logits: bool,
      end_sampling_at_eos_token: bool,
      img_embed,
      return_state: bool,
      constraint_tables=None,
  ) -> SamplerOutput:
    """Continues prompts from cached context (a prefix or a last turn). A
    constraint restarts at the grammar's start state: it scopes the new
    generation, not the cached history."""
    if img_embed is not None:
      raise ValueError(
          "prefix_state cannot be combined with img_embed: the image "
          "splices in after the BOS token, which lives in the prefix."
      )
    tokens, cache, start = self.encode_continuation(input_strings,
                                                    prefix_state)
    batch = tokens.shape[0]
    state = self._prefill(
        tokens, None, total_generation_steps, return_logits, echo,
        generator, None, cache, start, constraint_tables=constraint_tables,
    )
    # A pending token belongs to the previous turn (already returned):
    # echoed buffers drop it, so echo covers the continuation only.
    lead = 1 if prefix_state.pending_token is not None else 0
    return self._finish_sampling(
        state, [lead] * batch, total_generation_steps, echo, return_logits,
        end_sampling_at_eos_token, return_state, generator, constraint_tables,
    )

  def _finish_sampling(
      self,
      state: _SamplingState,
      pad_lengths: Sequence[int],
      total_generation_steps: int,
      echo: bool,
      return_logits: bool,
      end_sampling_at_eos_token: bool,
      return_state: bool,
      generator,
      constraint_tables=None,
  ) -> SamplerOutput:
    """Runs the decode loop and slices the buffers into a SamplerOutput."""
    if total_generation_steps > 1:
      state = self._decode(state, end_sampling_at_eos_token, generator,
                           keep_cache=return_state,
                           constraint_tables=constraint_tables)

    next_state = None
    if return_state:
      # The token at buffer[step] was sampled but never fed to the model:
      # it leads the next turn, whose positions start where this one's
      # decode loop stopped.
      rows = state.tokens_buffer.shape[0]
      next_state = PrefixState(
          cache=state.cache,
          length=state.positions[:, 0],
          pending_token=state.tokens_buffer.gather(
              1, state.step.expand(rows, 1)
          ),
      )

    # Echoed buffers start with the (padded) prompt: drop each row's padding.
    cut = pad_lengths if echo else [0] * len(pad_lengths)
    tokens = [seq[p:] for seq, p in zip(state.tokens_buffer, cut)]
    logits = (
        [seq[p:] for seq, p in zip(state.logits_buffer, cut)]
        if return_logits else []
    )
    return SamplerOutput(
        text=[self.vocab.DecodeIds(seq.tolist()) for seq in tokens],
        tokens=tokens,
        logits=logits,
        state=next_state,
    )
