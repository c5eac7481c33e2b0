"""Continuous batching: requests join and leave a running decode batch.

Counterpart of the JAX package's ``ContinuousBatcher``
(``cadence_gemma_tpu/inference/serving.py``). A batcher owns ``num_slots``
cache rows on the sampler's device; a slot is a fixed byte budget whatever
the length of its sequence (the RG-LRU state, the conv tail and the ring KV
cache are O(1)):

  * ``add_request`` queues a prompt host-side. Its prefill runs at the start
    of later ``step`` ticks as batch-1 calls of the sampler's own
    ``_prefill_chunk_step`` (the chunks of a prompt longer than the
    sampler's ``prefill_chunk_size``) and ``_prefill`` (the last chunk, which
    samples the first token), and the result is copied into the slot's rows
    of every cache leaf. ``admission_chunks_per_tick`` bounds the prefill
    work of one tick, so a long newcomer stalls the running slots by at most
    that many chunks a tick. A request may continue from a
    :class:`~sampler.PrefixState` (a shared prefix, or the state a finished
    request handed back with ``return_state``), or carry an image.
  * ``step(n)`` advances every slot ``n`` decode steps: rows feed their own
    last token at their own position; finished and empty rows compute too,
    but their writes, positions and done flags are masked. On the card
    (``jit_compile=True``, the sampler's default) one step of all the slots
    is captured as a CUDA graph with buffers the graph owns, per slot count,
    out-buffer length and flags, and replayed ``n`` times between one copy
    of the batcher's state into the graph's buffers and one copy back; the
    CPU, and ``jit_compile=False``, run the same step eagerly. Each tick
    ends with one host fetch: the done flags, the write indices and the
    tokens (what ``stream_callback`` and ``pop_finished`` read).
  * Categorical sampling draws each slot's row from a ``torch.Generator`` of
    its own: a request's generator draws its first token in the prefill,
    and its state then moves into the slot's generator (a captured graph
    registers all ``num_slots`` of them). A request's tokens are therefore a
    function of its own generator's seed alone, whoever its neighbors are
    and whenever it joined, and they are the tokens of a batch-1
    ``Sampler`` call with a generator seeded alike; ``pop_finished`` leaves
    the request's generator where that call would leave it.
  * ``multi_lora=True`` serves a different LoRA fine-tune per request over
    the sampler's one base (JAX ``serving.py:176-187``). A request's
    ``adapters`` run its admission prefill at batch 1 on a twin of the
    sampler's model that holds them (``Griffin.adapter_twin``), and are
    written into its slot's row of a ``[num_slots, ...]`` stack at insertion;
    the tick runs a ``lora_rows=num_slots`` twin, whose base products stay
    one product over every slot and whose rank-r hop is batched. Twins share
    every base tensor with the sampler's model. A captured tick owns its own
    stacks, as it owns its state: an insertion writes the batcher's stack in
    place and :meth:`_TickGraph.run` copies the stacks in after a change
    (read-only in the step, they are never copied back).

  * ``draft_len > 0`` runs speculative decoding in the batch (JAX
    ``serving.py:127-136``): a tick's step is one ``draft_len + 1``-token
    verify pass of every slot through
    :func:`speculative.prompt_lookup_spec_step`, drafting from the slot's
    own history (its prompt and generated tokens, seeded at admission), so
    a slot emits one to ``draft_len + 1`` tokens a step. Greedy tokens are
    a solo ``Sampler``'s up to the rounding of near ties (see
    ``speculative``); categorical slots accept stochastically, from their
    own generators, and their tokens are a batch-1 ``SpeculativeSampler``
    call's. The verify step is captured like the plain one and composes
    with ``multi_lora`` and ``preserve_states``.
  * ``constraints=`` / ``dynamic_grammar_slots=`` keep a grammar registry
    on the device (``constrain.stack_constraints``, JAX
    ``serving.py:153-222, 362-401``): each slot carries a grammar id (0 is
    allow-all, for free requests) and a DFA state, and the one decode step
    masks and advances every slot by its own row, so constrained and free
    requests share a tick. A request's admission prefill masks its first
    token with its grammar's tables; the speculative verify masks every
    position through the draft chain. ``register_grammar`` (and
    ``add_request(constraint=<TokenDFA>)``) writes a grammar into a
    reserved slot in place, on the driver thread's stream, so the tick
    queued after it reads the new tables; a captured tick owns a copy of the
    registry, refreshed as the adapter stacks are.

A tensor-parallel sampler (``Sampler(mesh=)``) serves as any other: its
model's cache, which the batcher owns, is placed by
``partitioning.griffin_cache_shardings`` (each recurrent block's state split
over the model axis, one entry a shard; the attention ring replicated), and
every other per-slot buffer stays on the sampler's device, replicated (JAX
``serving.py:435-455``); the captured tick runs the sharded step. With
``multi_lora`` the twins are ``TensorParallelGriffin.adapter_twin``'s, whose
stacks are replicated and read by each shard through views on a mesh that
repeats one device (copies refreshed after each write on other devices).
A tensor-parallel ``ModalSampler``'s requests encode ``pixels=`` through its
sharded towers.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import threading
from typing import Any, NamedTuple
import warnings
import weakref

import torch

from cadence_gemma_tpu_torch.inference import constrain
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import speculative
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.training import lora as lora_lib

_cache_leaves = sampler_lib._cache_leaves
_map_cache = sampler_lib._map_cache

# Captured ticks shared by batchers of one configuration over one sampler
# (``reuse_programs``): sampler -> LRU of {config key: {out length: graph}}.
# Keyed weakly, so a sampler and the graphs captured for it go together; a
# graph keeps no reference to its sampler.
_PROGRAM_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_PROGRAM_CACHE_SIZE = 8

# Eager steps a new tick graph runs on its own buffers before its capture.
_GRAPH_WARMUP_STEPS = 3


def _check_device(asked: torch.device, actual: torch.device, what: str,
                  other: str) -> torch.device:
  """``actual`` if ``asked`` names it ("cuda" names "cuda:0"), else raises."""
  if asked.type != actual.type or (
      asked.index is not None and actual.index is not None
      and asked.index != actual.index):
    raise ValueError(f"The {what} runs on {asked}, its {other} on {actual}.")
  return actual


@dataclasses.dataclass
class _Request:
  """Host-side bookkeeping for one admitted prompt."""

  request_id: int
  slot: int
  max_steps: int
  prompt: str
  started: bool = False   # prefill inserted into the slot yet?
  emitted: int = 0        # tokens already delivered via stream_callback
  want_state: bool = False  # extract a PrefixState when finished
  generator: torch.Generator | None = None  # the caller's (categorical)
  generator_state: torch.Tensor | None = None  # its state after the prefill
  gid: int = 0            # grammar id (0 = unconstrained)


@dataclasses.dataclass
class _Pending:
  """A queued admission: prefill work that future ticks perform.

  ``chunks`` holds the (tokens, positions) slices still to feed through the
  cache alone; the last one runs through ``Sampler._prefill`` (which samples
  the first token) and then fills the slot.
  """

  request: _Request
  chunks: list
  input_length: int
  cache: Any          # running prefill cache (None for a single shot)
  start: torch.Tensor | None  # start positions of the last chunk
  img_embed: torch.Tensor | None = None
  sampling: tuple | None = None  # per-request sampling row (host values)
  adapters: dict | None = None   # the request's LoRA leaves (multi_lora)
  prompt_tokens: torch.Tensor | None = None  # [1, P] history seed (draft_len)
  gid: int = 0        # grammar id (0 = unconstrained)


class _TickFlags(NamedTuple):
  """What a decode step's code depends on besides the sampler."""

  preserve_states: bool
  per_request_sampling: bool
  record_logprobs: int
  multi_lora: bool
  draft_len: int
  ngram: int
  grammars: tuple | None  # the grammar registry's table shapes, if any


def _tick_step(sampler, flags: _TickFlags, state: dict, cache,
               generators: list, model=None, grammars=None) -> None:
  """One decode step of every slot, in place (``_step_n``'s body in JAX).

  Reads nothing back to the host, so a CUDA graph can capture it. Rows that
  are not live (empty, finished, cancelled) compute too; their token,
  position, buffers, flags and DFA state do not change, and with
  ``preserve_states`` neither does their cache. ``model`` (multi-LoRA: a
  ``lora_rows`` twin) replaces the sampler's. ``grammars`` (a
  ``constrain.StackedConstraintTables``) masks each slot's logits with its
  own grammar row after the penalty and the logit bias, before
  ``min_tokens`` holds the stops off.
  """
  s = state
  out = s["out"]
  slots, length = out.shape
  rows = torch.arange(slots, device=out.device)
  live = s["active"] & ~s["done"]
  model = sampler.model if model is None else model
  if flags.draft_len:
    _spec_tick_step(sampler, flags, s, cache, generators, model, live,
                    grammars)
    return
  logits, new_cache = model(s["last_token"][:, None], s["positions"], cache)
  for name, block in cache.items():
    for dst, src in zip(block, new_cache[name]):
      if flags.preserve_states:
        # Freeze finished rows at their own stop: a re-fed token would
        # shift the conv tail and advance the LRU carry of a state that a
        # request hands back.
        src = torch.where(live.view(-1, *[1] * (src.dim() - 1)), src, dst)
      dst.copy_(src)
  step_logits = logits[:, 0]
  raw_lp = None
  if flags.record_logprobs:
    # The model's distribution before the penalty, bias and filters (the
    # OpenAI logprobs meaning), in float32.
    raw_lp = torch.log_softmax(step_logits.float(), dim=-1)
  written = None
  if flags.per_request_sampling or sampler.repetition_penalty != 1.0:
    written = (torch.arange(length, device=out.device)[None]
               < s["write_idx"][:, None])
  if flags.per_request_sampling:
    # Row-wise repetition penalty (rows at 1.0 keep their bits), then the
    # logit bias (unused entries, id -1, add 0.0 to column 0).
    seen = torch.zeros(step_logits.shape, dtype=torch.int32,
                       device=out.device)
    seen = seen.scatter_add_(1, out, written.to(torch.int32)) > 0
    p = s["rep_penalty"][:, None]
    step_logits = torch.where(
        seen, torch.where(step_logits > 0, step_logits / p, step_logits * p),
        step_logits,
    )
    bias_cols = s["bias_ids"].clamp(min=0)
    bias_vals = torch.where(s["bias_ids"] >= 0, s["bias_vals"], 0.0)
    step_logits = step_logits.scatter_add(1, bias_cols,
                                          bias_vals.to(step_logits.dtype))
  elif sampler.repetition_penalty != 1.0:
    # The solo sampler's scope: the tokens this request emitted.
    step_logits = sampler._apply_repetition_penalty(step_logits, out, written)
  if grammars is not None:
    # Each slot's own grammar row; the allow-all grammar (gid 0) masks
    # nothing. After the bias, so a bias cannot bring back a banned token.
    step_logits = grammars.mask(s["gid"], s["cstate"], step_logits)
  if flags.per_request_sampling:
    # min_tokens: every stop token is illegal until the request has emitted
    # that many tokens (after the grammar: a forced-long generation
    # overrides the grammar's permission to stop).
    suppress = (s["write_idx"] < s["min_tokens"])[:, None]
    stop_cols = sampler._stop_ids[None].expand(slots, -1)
    vals = step_logits.gather(1, stop_cols).masked_fill(suppress,
                                                        float("-inf"))
    step_logits = step_logits.scatter(1, stop_cols, vals)
    extra = s["extra_stops"]
    extra_cols = extra.clamp(min=0)
    vals = step_logits.gather(1, extra_cols).masked_fill(
        (extra >= 0) & suppress, float("-inf"))
    step_logits = step_logits.scatter(1, extra_cols, vals)
  if sampler.deterministic_sampling:
    sampled = torch.argmax(step_logits, dim=-1)
  else:
    if flags.per_request_sampling:
      filtered = sampler_lib.filter_logits_rows(step_logits, s["temp"],
                                                s["top_k"], s["top_p"])
    else:
      filtered = sampler_lib.filter_logits(step_logits, sampler.temperature,
                                           sampler.top_k, sampler.top_p)
    # ``_categorical`` a row, each from its slot's generator.
    probs = torch.softmax(filtered.float(), dim=-1)
    q = torch.empty_like(probs)
    for row, generator in enumerate(generators):
      q[row].exponential_(1.0, generator=generator)
    sampled = (probs / q).argmax(dim=-1)
  next_token = torch.where(live, sampled, s["last_token"])
  if grammars is not None:
    s["cstate"].copy_(torch.where(
        live, grammars.advance(s["gid"], s["cstate"], next_token),
        s["cstate"]))
  idx = s["write_idx"].clamp(max=length - 1)
  out[rows, idx] = torch.where(live, next_token, out[rows, idx])
  if raw_lp is not None:
    chosen = raw_lp.gather(1, next_token[:, None])[:, 0]
    top_vals, top_ids = torch.topk(raw_lp, flags.record_logprobs, dim=-1)
    for key, new, live_b in (("chosen_lp", chosen, live),
                             ("top_lp_ids", top_ids, live[:, None]),
                             ("top_lp_vals", top_vals, live[:, None])):
      s[key][rows, idx] = torch.where(live_b, new, s[key][rows, idx])
  write_idx = s["write_idx"] + live
  stop_hit = sampler._is_stop_token(next_token)
  if flags.per_request_sampling:
    extra = s["extra_stops"]
    stop_hit = stop_hit | ((next_token[:, None] == extra)
                           & (extra >= 0)).any(dim=1)
  s["done"].copy_(s["done"] | (live & (stop_hit | (write_idx >= s["budget"]))))
  s["last_token"].copy_(next_token)
  s["positions"].add_(live[:, None])
  s["write_idx"].copy_(write_idx)


def _spec_tick_step(sampler, flags: _TickFlags, s: dict, cache,
                    generators: list, model, live: torch.Tensor,
                    grammars=None) -> None:
  """One verify step of every slot, in place (``serving.py:809-867`` in
  JAX): rows that are not live keep their cache, history, buffers and DFA
  state. With ``grammars`` each slot's registry row binds into the
  grammar-agnostic verify (gid 0 = allow-all)."""
  loop_state = dict(
      hist=s["hist"], valid_from=s["valid_from"], cur_len=s["cur_len"],
      cache=cache, positions=s["positions"], live=live, out=s["out"],
      write_idx=s["write_idx"], budget=s["budget"])
  bound = None
  if grammars is not None:
    bound = constrain.BoundConstraint(tables=grammars, gid=s["gid"])
    loop_state["cstate"] = s["cstate"]
  st = speculative.prompt_lookup_spec_step(
      model, loop_state,
      draft_len=flags.draft_len, ngram=flags.ngram,
      stop_ids=sampler._stop_ids,
      logits_filter=speculative.sampler_filter(sampler),
      generators=generators or None,
      constraint=bound,
  )
  for name, block in cache.items():
    for dst, src in zip(block, st["cache"][name]):
      dst.copy_(src)
  keys = ("hist", "cur_len", "positions", "out", "write_idx")
  if grammars is not None:
    keys += ("cstate",)
  for key in keys:
    s[key].copy_(st[key])
  s["done"].copy_(s["done"] | st["eos_hit"]
                  | (live & (st["write_idx"] >= s["budget"])))
  # The verify steps each request took (its generator's draws).
  s["verify_steps"].add_(live)


class _TickGraph:
  """One decode step of all the slots captured as a CUDA graph.

  As the sampler's ``_DecodeGraph``: the graph owns its buffers (state,
  cache and one generator a slot, registered with the graph); :meth:`run`
  copies a batcher's state into them, replays the step ``n`` times and
  copies the state back into the batcher's own tensors, so batchers of one
  configuration can share a graph (a lock keeps their runs apart when they
  tick on different threads). The graph keeps no reference to the sampler
  (a shared cache keyed by the sampler holds it).

  With ``flags.multi_lora`` the step runs a ``lora_rows`` twin of the
  sampler's model whose ``[num_slots, ...]`` adapter stacks the graph owns;
  :meth:`run` copies a batcher's stacks into them when they differ from the
  last ones copied (another batcher's, or an older version) and never back.
  A batcher's grammar registry (``flags.grammars``) is copied in the same
  way, after a ``register_grammar`` wrote it.
  """

  def __init__(self, sampler, flags: _TickFlags, state: dict, cache,
               generators: list, grammars=None):
    device = sampler.device
    self.state = {k: v.clone() for k, v in state.items()}
    self.cache = _map_cache(torch.clone, cache)
    self.model = self.adapters = self.grammars = None
    self._adapters_from = None  # (owner token, version) last copied in
    self._grammars_from = None
    if flags.multi_lora:
      self.model = sampler.model.adapter_twin(state["out"].shape[0])
      self.adapters = self.model.adapter_leaves()
    if flags.grammars:
      self.grammars = grammars.clone()
    self.generators = []
    if generators:
      if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise NotImplementedError(
            f"torch {torch.__version__} cannot register a generator with a "
            "CUDA graph, which a captured categorical tick needs; build the "
            "sampler with jit_compile=False."
        )
      self.generators = [torch.Generator(device) for _ in generators]
    self.replays = 0
    self._lock = threading.Lock()
    # Warm-up on a side stream, as capture requires, on the graph's own
    # buffers and generators: the batcher's state does not move.
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
      for _ in range(_GRAPH_WARMUP_STEPS):
        self._copy(state, cache, self.state, self.cache)
        _tick_step(sampler, flags, self.state, self.cache, self.generators,
                   self.model, self.grammars)
    torch.cuda.current_stream(device).wait_stream(side)
    self.graph = torch.cuda.CUDAGraph()
    for generator in self.generators:
      self.graph.register_generator_state(generator)
    with torch.cuda.graph(self.graph):
      _tick_step(sampler, flags, self.state, self.cache, self.generators,
                 self.model, self.grammars)

  @staticmethod
  def _copy(src_state, src_cache, dst_state, dst_cache) -> None:
    for key, dst in dst_state.items():
      dst.copy_(src_state[key])
    for dst, src in zip(_cache_leaves(dst_cache), _cache_leaves(src_cache)):
      dst.copy_(src)

  def run(self, state: dict, cache, generators: list, n: int,
          adapters: dict | None = None, adapters_from=None,
          grammars=None, grammars_from=None) -> None:
    """``n`` steps of a batcher's state, written back into its tensors.

    ``adapters`` are the batcher's stacks and ``adapters_from`` names them
    (an owner token and a version the batcher bumps at each write): they
    are copied in only when they are not the ones the graph holds; likewise
    the grammar registry ``grammars`` and ``grammars_from``."""
    with self._lock:
      self._copy(state, cache, self.state, self.cache)
      if adapters is not None and self._adapters_from != adapters_from:
        torch._foreach_copy_(list(self.adapters.values()),  # pylint: disable=protected-access
                             [adapters[n] for n in self.adapters])
        self.model.refresh_adapters()
        self._adapters_from = adapters_from
      if grammars is not None and self._grammars_from != grammars_from:
        self.grammars.copy_(grammars)
        self._grammars_from = grammars_from
      for mine, theirs in zip(self.generators, generators):
        mine.set_state(theirs.get_state())
      for _ in range(n):
        self.graph.replay()
      self.replays += n
      self._copy(self.state, self.cache, state, cache)
      for mine, theirs in zip(self.generators, generators):
        theirs.set_state(mine.get_state())


class ContinuousBatcher:
  """Slot-based continuous batching over a :class:`~sampler.Sampler`.

  Class attributes:
    MAX_REQUEST_STOPS: Per-request extra stop-token capacity when
      ``per_request_sampling`` is on.
    MAX_REQUEST_BIAS: Per-request ``logit_bias`` entry capacity when
      ``per_request_sampling`` is on.

  Args:
    sampler: The sampler whose model, vocabulary, stop tokens, penalty and
      (for categorical sampling) filters are reused. A ``ModalSampler`` with
      a vision encoder also takes ``pixels`` and ``img_path`` requests.
    num_slots: Decode batch width (fixed).
    max_steps_default: Per-request decode budget when a request names none.
      The output buffers hold the largest budget seen, rounded up to a power
      of two; a larger budget grows them (and captures a new tick graph).
    draft_len: > 0 turns on speculative decoding in the batch: each step is
      one ``draft_len + 1``-token verify pass a slot (see the module
      docstring). Not with a repetition penalty, ``record_logprobs`` or
      ``per_request_sampling`` (JAX's ``ValueError``s).
    ngram: The longest backward match speculative drafting ranks candidates
      by.
    stream_callback: Optional ``f(request_id, new_token_ids, done)`` called
      after every tick with the tokens each live request emitted since the
      last call, and once more with ``done=True`` from ``pop_finished`` (or
      ``(request_id, [], True)`` from ``cancel``).
    admission_chunks_per_tick: Bound on the prefill calls (chunks) one
      ``step`` runs before decoding (None = every pending admission).
    multi_lora: Serve a different LoRA fine-tune per request over the
      sampler's one base. The sampler's model must be built with
      ``lora_rank > 0``; a request may pass ``adapters=`` to
      :meth:`add_request`, and one without runs the sampler's own adapters.
      Costs ``num_slots`` adapter trees of device memory (twice on the card:
      the batcher's stacks and the captured tick's) and a batched rank-r hop
      in every projection of each step.
    preserve_states: Freeze each finished slot's cache at its own stop, so a
      request added with ``return_state=True`` can hand back its
      :class:`~sampler.PrefixState` (:meth:`take_state`). Costs a select
      over the cache each step.
    constraints: ``constrain.TokenDFA`` grammars available to requests
      (``add_request(..., constraint=k)`` selects ``constraints[k]``;
      omitted = free generation), stacked into one registry on the device:
      every decode step gathers each slot's own grammar row, so constrained
      and free requests mix in one batch. Composes with ``draft_len`` (the
      verify masks every position through the draft chain) and
      ``per_request_sampling`` (the grammar masks after the logit bias,
      ``min_tokens`` after the grammar).
    dynamic_grammar_slots: Registry slots reserved for grammars registered
      at run time (:meth:`register_grammar`, or ``add_request(constraint=
      <TokenDFA>)``: per-request JSON schemas). Slots are overwritten in
      place, so the table shapes, and the captured tick, never change;
      slots no live request holds are evicted least recently used first.
    dynamic_grammar_budget: ``(max_states, max_atoms, max_token_len)`` of
      the reserved slots. Defaults to the largest of ``constraints``;
      required with ``dynamic_grammar_slots`` and no ``constraints``. A
      registration beyond it raises.
    per_request_sampling: Let each request carry its own ``temperature``,
      ``top_k``, ``top_p`` (categorical samplers), ``repetition_penalty``,
      ``min_tokens``, extra ``stop_token_ids`` and ``logit_bias``, applied
      row by row in the one decode step. A request that omits a parameter
      inherits the sampler's.
    record_logprobs: > 0 records, for every emitted token, its
      log-probability under the model's distribution (before penalty, bias
      and filters; float32) and the top ``record_logprobs`` alternatives;
      :meth:`take_logprobs` hands a finished request's record over.
    reuse_programs: Share the captured tick graphs of earlier batchers of
      the same configuration over the same sampler (so a new batcher starts
      without capturing); ``False`` captures its own.
    device: Where the batcher runs: the sampler's device. ``None`` means
      CUDA and raises without a card; pass ``device="cpu"`` for a CPU
      sampler.
  """

  MAX_REQUEST_STOPS = 4
  MAX_REQUEST_BIAS = 32

  @torch.inference_mode()
  def __init__(
      self,
      sampler: sampler_lib.Sampler,
      num_slots: int,
      max_steps_default: int = 256,
      draft_len: int = 0,
      ngram: int = 4,
      stream_callback: Any | None = None,
      admission_chunks_per_tick: int | None = None,
      multi_lora: bool = False,
      preserve_states: bool = False,
      constraints: Any | None = None,
      dynamic_grammar_slots: int = 0,
      dynamic_grammar_budget: tuple[int, int, int] | None = None,
      per_request_sampling: bool = False,
      record_logprobs: int = 0,
      reuse_programs: bool = True,
      device=None,
  ):
    self.device = _check_device(griffin.resolve_device(device),
                                sampler.device, "batcher", "sampler")
    if admission_chunks_per_tick is not None and admission_chunks_per_tick < 1:
      raise ValueError(
          f"admission_chunks_per_tick must be >= 1 or None (got "
          f"{admission_chunks_per_tick})."
      )
    if draft_len:
      speculative.check_speculation(sampler, draft_len, ngram)
      if record_logprobs:
        raise ValueError(
            "record_logprobs is incompatible with draft_len > 0 (verify "
            "steps commit several tokens per program)."
        )
      if per_request_sampling:
        raise ValueError(
            "per_request_sampling is incompatible with draft_len > 0 "
            "(the speculative verify pass uses the sampler's shared "
            "filters)."
        )
    self.sampler = sampler
    self.num_slots = num_slots
    self.max_steps_default = max_steps_default
    self.draft_len = draft_len
    self.ngram = ngram
    self.stream_callback = stream_callback
    self.admission_chunks_per_tick = admission_chunks_per_tick
    self.preserve_states = preserve_states
    self.per_request_sampling = per_request_sampling
    self.record_logprobs = int(record_logprobs)
    self._requests: dict[int, _Request] = {}  # slot -> request
    self._pending: list[_Pending] = []        # FIFO admission queue
    self._next_id = 0
    self._states: dict[int, sampler_lib.PrefixState] = {}
    self._logprob_records: dict[int, dict] = {}
    self._init_grammars(constraints, dynamic_grammar_slots,
                        dynamic_grammar_budget)
    self._flags = _TickFlags(
        preserve_states, per_request_sampling, self.record_logprobs,
        bool(multi_lora), draft_len, ngram if draft_len else 0,
        None if self._constraints is None else self._constraints.shapes)
    self._captures = sampler._captures_decode
    self._fetched = None  # host copy of (done, write_idx, out) or None

    dev = self.device
    buffer_len = sampler_lib._next_bucket(max_steps_default)
    long = dict(dtype=torch.long, device=dev)
    self._cache = sampler.model.init_cache(num_slots, sampler.dtype)
    self._state = {
        "last_token": torch.zeros(num_slots, **long),
        "positions": torch.zeros(num_slots, 1, **long),
        "active": torch.zeros(num_slots, dtype=torch.bool, device=dev),
        "done": torch.zeros(num_slots, dtype=torch.bool, device=dev),
        "write_idx": torch.ones(num_slots, **long),
        "budget": torch.zeros(num_slots, **long),
        "out": torch.zeros(num_slots, buffer_len, **long),
    }
    if draft_len:
      # Each slot's token history for prompt-lookup drafting.
      self._state.update(
          hist=torch.zeros(num_slots,
                           sampler_lib._next_bucket(buffer_len + 64), **long),
          cur_len=torch.zeros(num_slots, **long),
          valid_from=torch.zeros(num_slots, **long),
          verify_steps=torch.zeros(num_slots, **long),
      )
    if self._constraints is not None:
      # Each slot's grammar id and DFA state (int32, as JAX's).
      self._state.update(
          gid=torch.zeros(num_slots, dtype=torch.int32, device=dev),
          cstate=torch.zeros(num_slots, dtype=torch.int32, device=dev),
      )
    if self.record_logprobs:
      k = self.record_logprobs
      f32 = dict(dtype=torch.float32, device=dev)
      self._state.update(
          chosen_lp=torch.zeros(num_slots, buffer_len, **f32),
          top_lp_ids=torch.zeros(num_slots, buffer_len, k, **long),
          top_lp_vals=torch.zeros(num_slots, buffer_len, k, **f32),
      )
    if per_request_sampling:
      s = sampler
      f32 = dict(dtype=torch.float32, device=dev)
      self._state.update(
          temp=torch.full((num_slots,), s.temperature, **f32),
          top_k=torch.full((num_slots,), s.top_k or 0, **long),
          top_p=torch.full(
              (num_slots,), s.top_p if s.top_p is not None else 1.0, **f32),
          rep_penalty=torch.full((num_slots,), s.repetition_penalty, **f32),
          min_tokens=torch.zeros(num_slots, **long),
          extra_stops=torch.full((num_slots, self.MAX_REQUEST_STOPS), -1,
                                 **long),
          bias_ids=torch.full((num_slots, self.MAX_REQUEST_BIAS), -1, **long),
          bias_vals=torch.zeros(num_slots, self.MAX_REQUEST_BIAS, **f32),
      )
    # One generator a slot for categorical sampling.
    self._generators = (
        [] if sampler.deterministic_sampling
        else [torch.Generator(dev) for _ in range(num_slots)]
    )
    self.multi_lora = bool(multi_lora)
    if multi_lora:
      self._init_multi_lora()
    self._programs = self._shared_programs() if reuse_programs else {}

  def _init_grammars(self, constraints, slots: int, budget) -> None:
    """The grammar registry (JAX ``serving.py:362-401``): id 0 allow-all,
    ``constraints`` at 1.., then ``slots`` reserved allow-all slots."""
    self._constraints = None
    self.dynamic_grammar_slots = int(slots)
    constraints = list(constraints or [])
    if not constraints and not self.dynamic_grammar_slots:
      return
    if self.dynamic_grammar_slots and budget is None:
      if not constraints:
        raise ValueError(
            "dynamic_grammar_slots with no constraints needs an explicit "
            "dynamic_grammar_budget=(max_states, max_atoms, max_token_len): "
            "the slot shapes are fixed in the captured tick."
        )
      budget = (1, 1, 1)  # a floor; the constraints' dims dominate
    self._n_static_grammars = len(constraints) + 1
    self._constraints = constrain.stack_constraints(
        constraints, self.sampler.vocab_size,
        extra_slots=self.dynamic_grammar_slots,
        min_dims=budget or (1, 1, 1), device=self.device)
    # Dynamic slots: key -> gid (LRU order), gid -> live requests holding it
    # (a slot is evictable at 0).
    self._dynamic_by_key: collections.OrderedDict = collections.OrderedDict()
    self._gid_refs: dict[int, int] = {}
    self._grammar_token = object()
    self._grammar_version = 0

  def _init_multi_lora(self) -> None:
    """The twins of multi-LoRA serving (JAX ``serving.py:405-430``)."""
    model = self.sampler.model
    if not getattr(model, "lora_rank", 0):
      raise ValueError(
          "multi_lora requires the sampler's model to be built with "
          "lora_rank > 0 so its params carry adapter leaves (use "
          "training.lora.init_adapters for a fresh zero tree)."
      )
    # The default row of adapter-less requests: the sampler's own leaves as
    # they are now (JAX's batcher reads the sampler's params once; a
    # tensor-parallel model's split leaves are joined copies anyway).
    self._sampler_adapters = {name: leaf.clone() for name, leaf
                              in model.adapter_leaves().items()}
    if not self._sampler_adapters:
      raise ValueError(
          "multi_lora: the sampler's model has no lora_a/lora_b leaves; "
          "build it with lora_rank > 0 before building the batcher.")
    # The tick's twin and its [num_slots, ...] stacks, written in place.
    self._model_ml = model.adapter_twin(self.num_slots)
    self._adapter_rows = self._model_ml.adapter_leaves()
    self._adapter_token = object()
    self._adapter_version = 0
    # Admissions with adapters prefill at batch 1 on a twin that holds them
    # (the sampler's own model never sees them).
    twin = model.adapter_twin()
    self._prefill_adapters = twin.adapter_leaves()
    self._prefill_twin = twin
    self._prefill_sampler = copy.copy(self.sampler)
    self._prefill_sampler.model = twin
    self._prefill_sampler._prefill_model = (  # pylint: disable=protected-access
        twin.act_quant_view() if self.sampler.prefill_act_quant else twin)
    self._prefill_loaded = None  # the request whose adapters the twin holds

  def _admission_sampler(self, p: _Pending):
    """The sampler whose prefill calls run a pending request: the batcher's
    own, or with adapters the prefill twin holding them (JAX's
    ``_admission_params``)."""
    if p.adapters is None:
      return self.sampler
    if self._prefill_loaded != p.request.request_id:
      torch._foreach_copy_(  # pylint: disable=protected-access
          list(self._prefill_adapters.values()),
          [p.adapters[n] for n in self._prefill_adapters])
      self._prefill_twin.refresh_adapters()
      self._prefill_loaded = p.request.request_id
    return self._prefill_sampler

  def _shared_programs(self) -> dict:
    """The tick graphs of this configuration over this sampler (LRU)."""
    lru = _PROGRAM_CACHE.setdefault(self.sampler, collections.OrderedDict())
    key = (self.num_slots, self._flags)
    programs = lru.setdefault(key, {})
    lru.move_to_end(key)
    while len(lru) > _PROGRAM_CACHE_SIZE:
      lru.popitem(last=False)
    return programs

  @property
  def _buffer_len(self) -> int:
    return self._state["out"].shape[1]

  @property
  def _hist_len(self) -> int:
    """The drafting history's length (0 without ``draft_len``)."""
    hist = self._state.get("hist")
    return 0 if hist is None else hist.shape[1]

  # -- slots ------------------------------------------------------------------

  def _grow(self, length: int, keys=("out", "chosen_lp", "top_lp_ids",
                                       "top_lp_vals")) -> None:
    """Pads the per-token buffers ``keys`` (the output buffers, or the
    drafting history) to ``length`` (a power of two)."""
    for key in keys:
      if key in self._state:
        buf = self._state[key]
        grow_by = length - buf.shape[1]
        pad = (0, 0, 0, grow_by) if buf.dim() == 3 else (0, grow_by)
        self._state[key] = torch.nn.functional.pad(buf, pad)

  def _insert(self, p: _Pending, prefill) -> None:
    """Copies a batch-1 prefill into slot ``p.request.slot``: every cache
    leaf's row (a whole ring row, so a longer previous occupant leaves
    nothing behind), the first token at index 0 of the slot's buffer, its
    flags and its sampling row."""
    req = p.request
    slot = req.slot
    for name, block in self._cache.items():
      for dst, src in zip(block, prefill.cache[name]):
        dst[slot].copy_(src[0])
    st = self._state
    first = prefill.tokens_buffer[0, 0]
    done = self.sampler._is_stop_token(first)
    if p.sampling is not None:
      (temp, top_k, top_p, penalty, min_tokens, stops, bias_ids,
       bias_vals) = p.sampling
      stops_t = torch.tensor(stops, device=self.device)
      done = done | ((first == stops_t) & (stops_t >= 0)).any()
      for key, value in (("temp", temp), ("top_k", top_k), ("top_p", top_p),
                         ("rep_penalty", penalty), ("min_tokens", min_tokens)):
        st[key][slot] = value
      st["extra_stops"][slot] = stops_t
      st["bias_ids"][slot] = torch.tensor(bias_ids, device=self.device)
      st["bias_vals"][slot] = torch.tensor(bias_vals, device=self.device)
    st["last_token"][slot] = first
    st["positions"][slot] = prefill.positions[0]
    st["active"][slot] = True
    st["done"][slot] = done | (req.max_steps <= 1)
    st["write_idx"][slot] = 1
    st["budget"][slot] = req.max_steps
    st["out"][slot] = 0
    st["out"][slot, 0] = first
    if self._constraints is not None:
      st["gid"][slot] = p.gid
      st["cstate"][slot] = prefill.constraint_state[0]
    if self.draft_len:
      # The (padded) prompt and the first token seed the slot's history.
      padded_len = p.prompt_tokens.shape[1]
      st["hist"][slot] = 0
      st["hist"][slot, :padded_len] = p.prompt_tokens[0]
      st["hist"][slot, padded_len] = first
      st["cur_len"][slot] = padded_len + 1
      st["valid_from"][slot] = padded_len - p.input_length
      st["verify_steps"][slot] = 0
    if self.multi_lora:
      # Always rewritten: a freed slot still holds its last occupant's
      # adapters (JAX ``serving.py:1449-1457``).
      lora_lib.scatter_adapters(
          self._adapter_rows,
          self._sampler_adapters if p.adapters is None else p.adapters, slot)
      self._model_ml.refresh_adapters()
      self._adapter_version += 1
    if self.record_logprobs:
      # The first token's record from the prefill's [1, 1, vocab] logits.
      lp0 = torch.log_softmax(prefill.logits_buffer[0, 0].float(), dim=-1)
      top_vals, top_ids = torch.topk(lp0, self.record_logprobs)
      for key, value in (("chosen_lp", lp0[first]), ("top_lp_ids", top_ids),
                         ("top_lp_vals", top_vals)):
        st[key][slot] = 0
        st[key][slot, 0] = value
    if self._generators:
      # The prefill drew the first token from the request's generator; the
      # slot's generator continues that chain.
      req.generator_state = req.generator.get_state()
      self._generators[slot].set_state(req.generator_state)
    self._fetched = None

  def _extract_state(self, slot: int) -> sampler_lib.PrefixState:
    """A copy of a finished slot as a batch-1 :class:`PrefixState`, as the
    solo sampler's ``return_state`` builds it: ``last_token`` is the token
    sampled last and never fed, ``positions`` where it would be fed."""
    st = self._state
    if self.draft_len:
      # A speculative slot's last emitted token (never fed) is its history
      # at cur_len - 1; ``last_token`` is stale.
      pending = st["hist"][slot:slot + 1].gather(
          1, st["cur_len"][slot:slot + 1, None] - 1)
    else:
      pending = st["last_token"][slot:slot + 1, None].clone()
    return sampler_lib.PrefixState(
        cache=_map_cache(lambda x: x[slot:slot + 1].clone(), self._cache),
        length=st["positions"][slot:slot + 1, 0].clone(),
        pending_token=pending,
    )

  # -- host API ---------------------------------------------------------------

  @property
  def active_count(self) -> int:
    return len(self._requests)

  @property
  def has_capacity(self) -> bool:
    return len(self._requests) < self.num_slots

  @torch.inference_mode()
  def register_grammar(self, dfa: Any) -> int:
    """Installs a grammar into a reserved dynamic slot (JAX
    ``serving.py:589-650``); returns its internal grammar id.

    Callers normally pass the :class:`~constrain.TokenDFA` itself to
    ``add_request(constraint=...)``, which registers (or reuses) it and
    counts the slot's live requests. The same (pattern, stop ids) grammar
    reuses its slot; when every slot is taken, the least recently used slot
    no live request holds is overwritten. Raises when every dynamic slot is
    held. The write runs on the calling thread's current stream (the
    frontend's driver thread, which ticks), so it lands between ticks.
    """
    if self._constraints is None or not self.dynamic_grammar_slots:
      raise ValueError(
          "register_grammar needs ContinuousBatcher(dynamic_grammar_slots=k)."
      )
    if dfa.vocab_size != self.sampler.vocab_size:
      raise ValueError(
          f"grammar compiled for a {dfa.vocab_size}-token vocabulary; "
          f"this sampler serves {self.sampler.vocab_size}."
      )
    key = (dfa.pattern, tuple(dfa.stop_ids))
    gid = self._dynamic_by_key.get(key)
    if gid is not None:
      self._dynamic_by_key.move_to_end(key)
      return gid
    used = set(self._dynamic_by_key.values())
    free = [g for g in range(self._n_static_grammars,
                             self._constraints.num_grammars)
            if g not in used]
    if free:
      gid = free[0]
    else:
      for old_key, old_gid in self._dynamic_by_key.items():
        if self._gid_refs.get(old_gid, 0) == 0:
          del self._dynamic_by_key[old_key]
          gid = old_gid
          break
      else:
        raise RuntimeError(
            f"all {self.dynamic_grammar_slots} dynamic grammar slots are "
            "referenced by live requests; raise dynamic_grammar_slots or "
            "retry after pop_finished()."
        )
    self._constraints.write(gid, dfa)
    self._grammar_version += 1
    self._dynamic_by_key[key] = gid
    self._gid_refs.setdefault(gid, 0)
    return gid

  def _release_gid(self, gid: int) -> None:
    if self._constraints is not None and gid >= self._n_static_grammars:
      self._gid_refs[gid] = max(0, self._gid_refs.get(gid, 0) - 1)

  @torch.inference_mode()
  def add_request(
      self,
      prompt: str,
      max_steps: int | None = None,
      generator: torch.Generator | None = None,
      prefix_state: sampler_lib.PrefixState | None = None,
      adapters: Any | None = None,
      img_embed: torch.Tensor | None = None,
      pixels: torch.Tensor | None = None,
      img_path: str | None = None,
      return_state: bool = False,
      constraint: Any | None = None,
      temperature: float | None = None,
      top_k: int | None = None,
      top_p: float | None = None,
      min_tokens: int = 0,
      stop_token_ids: Any | None = None,
      repetition_penalty: float | None = None,
      logit_bias: dict | None = None,
  ) -> int:
    """Queues a prompt for admission into a free slot; returns a request id.

    Host-side only: tokenization and the chunk plan happen here, the prefill
    at the start of later :meth:`step` ticks, and the request decodes from
    the tick its prefill completes in. ``generator`` (JAX's ``rng``), a
    ``torch.Generator`` on the batcher's device, seeds the request's own
    sampling chain; a categorical sampler requires one. It is advanced as a
    batch-1 ``Sampler`` call would advance it.

    ``prefix_state`` continues from cached context (a shared prefix from
    ``Sampler.prefill_prefix``, or a state from :meth:`take_state`): only the
    continuation prefills, as the solo sampler's ``prefix_state=``.
    ``return_state=True`` (``preserve_states`` batchers) keeps the request's
    state when it finishes, for :meth:`take_state`.

    ``temperature`` / ``top_k`` / ``top_p`` / ``repetition_penalty`` /
    ``min_tokens`` / ``stop_token_ids`` / ``logit_bias``
    (``per_request_sampling`` batchers) override the sampler's settings for
    this request: ``min_tokens`` suppresses every stop token until that many
    tokens are emitted; ``stop_token_ids`` adds up to ``MAX_REQUEST_STOPS``
    stops; ``logit_bias`` maps up to ``MAX_REQUEST_BIAS`` token ids to
    additive offsets in [-100, 100], applied after the penalty, to the first
    token and every decode step.

    ``img_embed`` ([1, vision_tokens, vision_width] fused features) splices
    an image in after the prompt's BOS during the admission prefill;
    ``pixels`` / ``img_path`` encode on the spot (a ``ModalSampler`` with a
    vision encoder). Not with ``prefix_state``.

    ``adapters`` (``multi_lora`` batchers) is this request's LoRA leaves,
    ``{name: tensor}`` as ``training.lora.split_lora`` gives them: the
    request decodes as the sampler's model would with them merged
    (``merge_params``), whatever its neighbors run. Omitted, the sampler's
    own adapters apply. With ``prefix_state`` the shared prefix stays as it
    was prefilled; the continuation and decode run under the adapters.

    ``constraint=k`` masks this request's generation with the registered
    grammar ``constraints[k]``; a :class:`~constrain.TokenDFA` installs it
    into a dynamic slot (:meth:`register_grammar`). Its tokens always form
    a live prefix of the grammar, and stop tokens come only where the
    output matches it. The grammar masks after the penalty and the bias;
    ``min_tokens`` holds stops off after it.
    """
    gid = self._grammar_id(constraint)
    if adapters is not None:
      adapters = self._check_adapters(adapters)
    sampling = None
    overridden = [
        a is not None
        for a in (temperature, top_k, top_p, repetition_penalty,
                  stop_token_ids, logit_bias)
    ]
    s = self.sampler
    if not self.per_request_sampling:
      if any(overridden) or min_tokens:
        raise ValueError(
            "per-request sampling parameters need ContinuousBatcher("
            "per_request_sampling=True)."
        )
    else:
      sampling = self._sampling_row(
          temperature, top_k, top_p, min_tokens, stop_token_ids,
          repetition_penalty, logit_bias,
      )
    if return_state and not self.preserve_states:
      raise ValueError(
          "return_state requires ContinuousBatcher(preserve_states=True) "
          "-- otherwise finished slots' caches keep advancing and the "
          "extracted context would be corrupt."
      )
    if sum(x is not None for x in (img_embed, pixels, img_path)) > 1:
      raise ValueError("Pass at most one of img_embed, pixels, or img_path.")
    if (img_path is not None or pixels is not None) and getattr(
        s, "vision_encoder", None) is None:
      raise ValueError(
          f"{'img_path' if pixels is None else 'pixels'}= needs a "
          "ModalSampler with a vision_encoder; pass img_embed directly "
          "otherwise."
      )
    if img_path is not None:
      img_embed = s.encode_image(img_path)
    elif pixels is not None:
      img_embed = s.encode(pixels)
    if img_embed is not None:
      if prefix_state is not None:
        raise ValueError(
            "Image requests are incompatible with prefix_state: the image "
            "splices in after the prompt's BOS, which a continuation "
            "prefill does not have (same as the solo sampler)."
        )
      img_embed = torch.as_tensor(img_embed, device=self.device)
      if img_embed.dim() != 3 or img_embed.shape[0] != 1:
        raise ValueError(
            "Per-request image features must be [1, vision_tokens, "
            f"vision_width]; got {tuple(img_embed.shape)}."
        )
    if not self.has_capacity:
      raise RuntimeError(
          f"All {self.num_slots} slots busy; pop_finished() first."
      )
    if not s.deterministic_sampling and generator is None:
      raise ValueError(
          "A torch.Generator (JAX's rng) must be provided per request for "
          "categorical sampling."
      )
    if max_steps is None:
      max_steps = self.max_steps_default
    if max_steps < 1:
      raise ValueError(f"max_steps must be >= 1 (got {max_steps}).")
    slot = next(i for i in range(self.num_slots) if i not in self._requests)
    chunk = s.prefill_chunk_size

    if prefix_state is not None:
      mid, cache, final_tokens, start, tokens = s.plan_continuation_chunks(
          [prompt], prefix_state)
      chunks = list(mid) + [(final_tokens, None)]
      input_length = tokens.shape[1]
    else:
      ids = s.tokenize(prompt)
      # One row: no padding (the port pads only to the longest prompt).
      tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
      input_length = len(ids)
      if chunk is not None and input_length > chunk and img_embed is not None:
        # As the solo sampler: a chunk cannot hold the image splice.
        warnings.warn(
            "prefill_chunk_size is set but chunking was skipped for an "
            "image admission: the chunked path does not support the "
            "in-prompt image splice.",
            stacklevel=2,
        )
        chunk = None
      if chunk is not None and input_length > chunk:
        mid, cache, final_tokens, start, tokens = s.plan_prompt_chunks(
            tokens, torch.tensor([input_length], device=self.device))
        chunks = list(mid) + [(final_tokens, None)]
      else:
        chunks, cache, start = [(tokens, None)], None, None

    request_id = self._next_id
    self._next_id += 1
    req = _Request(request_id=request_id, slot=slot, max_steps=max_steps,
                   prompt=prompt, want_state=return_state,
                   generator=generator, gid=gid)
    if self._constraints is not None and gid >= self._n_static_grammars:
      self._gid_refs[gid] = self._gid_refs.get(gid, 0) + 1
    self._requests[slot] = req
    self._pending.append(_Pending(
        request=req, chunks=chunks, input_length=input_length, cache=cache,
        start=start, img_embed=img_embed, sampling=sampling,
        adapters=adapters,
        prompt_tokens=tokens if self.draft_len else None, gid=gid,
    ))
    return request_id

  def _grammar_id(self, constraint) -> int:
    """A request's grammar id: 0 free, ``k + 1`` for ``constraints[k]``, a
    dynamic slot for a ``TokenDFA`` (JAX ``serving.py:1133-1150``)."""
    if constraint is None:
      return 0
    if self._constraints is None:
      raise ValueError(
          "constraint= requires ContinuousBatcher(constraints=[...] and/or "
          "dynamic_grammar_slots=k)."
      )
    if hasattr(constraint, "pattern"):  # a TokenDFA: a dynamic slot
      return self.register_grammar(constraint)
    n_registered = self._n_static_grammars - 1
    if not 0 <= constraint < n_registered:
      raise ValueError(
          f"constraint must index the registered grammars [0, "
          f"{n_registered}) (got {constraint}), or be a TokenDFA for a "
          "dynamic slot."
      )
    return constraint + 1

  def _check_adapters(self, adapters) -> dict:
    """A request's adapter leaves, checked against the sampler's (JAX
    ``serving.py:1280-1291``)."""
    if not self.multi_lora:
      raise ValueError(
          "Per-request adapters require ContinuousBatcher(multi_lora=True).")
    adapters = dict(adapters)
    expect = {n: tuple(t.shape) for n, t in self._sampler_adapters.items()}
    got = {n: tuple(torch.as_tensor(t).shape) for n, t in adapters.items()}
    if got != expect:
      raise ValueError(
          "adapters tree does not match the sampler's adapter leaves "
          f"(training.lora.split_lora layout): {len(got)} leaves, "
          f"{sorted(set(got) ^ set(expect))[:4]} differ in name, "
          f"{[n for n in got if n in expect and got[n] != expect[n]][:4]} "
          "in shape.")
    return adapters

  def _sampling_row(self, temperature, top_k, top_p, min_tokens,
                    stop_token_ids, repetition_penalty, logit_bias) -> tuple:
    """A request's validated sampling row (host values), JAX's tuple."""
    s = self.sampler
    if s.deterministic_sampling and any(
        a is not None for a in (temperature, top_k, top_p)):
      raise ValueError(
          "temperature/top_k/top_p are categorical-sampling knobs; this "
          "batcher's sampler is greedy (deterministic_sampling=True)."
      )
    if temperature is not None and temperature <= 0.0:
      raise ValueError(f"temperature must be > 0 (got {temperature}).")
    if top_k is not None and top_k < 1:
      raise ValueError(f"top_k must be >= 1 (got {top_k}).")
    if top_p is not None and not 0.0 < top_p <= 1.0:
      raise ValueError(f"top_p must be in (0, 1] (got {top_p}).")
    if repetition_penalty is not None and repetition_penalty <= 0.0:
      raise ValueError(
          f"repetition_penalty must be > 0 (got {repetition_penalty})."
      )
    if min_tokens < 0:
      raise ValueError(f"min_tokens must be >= 0 (got {min_tokens}).")
    stops = [int(i) for i in (stop_token_ids or ())]
    if len(stops) > self.MAX_REQUEST_STOPS:
      raise ValueError(
          f"at most {self.MAX_REQUEST_STOPS} per-request stop tokens (got "
          f"{len(stops)}); configure the rest on the sampler."
      )
    stops += [-1] * (self.MAX_REQUEST_STOPS - len(stops))
    bias_items = sorted(
        (int(t), float(b)) for t, b in (logit_bias or {}).items()
    )
    if len(bias_items) > self.MAX_REQUEST_BIAS:
      raise ValueError(
          f"at most {self.MAX_REQUEST_BIAS} logit_bias entries (got "
          f"{len(bias_items)})."
      )
    for t, b in bias_items:
      if not 0 <= t < s.vocab_size:
        raise ValueError(
            f"logit_bias token id {t} outside the vocabulary "
            f"[0, {s.vocab_size})."
        )
      if not -100.0 <= b <= 100.0:
        raise ValueError(
            f"logit_bias values must be in [-100, 100] (got {b} for token "
            f"{t})."
        )
    pad = self.MAX_REQUEST_BIAS - len(bias_items)
    return (
        temperature if temperature is not None else s.temperature,
        top_k if top_k is not None else (s.top_k or 0),
        top_p if top_p is not None else (
            s.top_p if s.top_p is not None else 1.0),
        repetition_penalty if repetition_penalty is not None
        else s.repetition_penalty,
        min_tokens,
        stops,
        [t for t, _ in bias_items] + [-1] * pad,
        [b for _, b in bias_items] + [0.0] * pad,
    )

  def _finish_admission(self, p: _Pending) -> None:
    """Runs a pending request's last prefill call and fills its slot."""
    s = self._admission_sampler(p)
    final_tokens, _ = p.chunks.pop(0)
    overrides = None
    if p.sampling is not None:
      (temp, top_k, top_p, _, min_tokens, stops, bias_ids,
       bias_vals) = p.sampling
      # Batch-1 rows; min_tokens >= 1 suppresses the stops at the first
      # token too, and the logit bias covers it like every decode step.
      dev = self.device
      overrides = (
          torch.tensor([temp], dtype=torch.float32, device=dev),
          torch.tensor([top_k], device=dev),
          torch.tensor([top_p], dtype=torch.float32, device=dev),
          torch.tensor([min_tokens > 0], device=dev),
          torch.tensor([stops], device=dev),
          torch.tensor([bias_ids], device=dev),
          torch.tensor([bias_vals], dtype=torch.float32, device=dev),
      )
    # Every admission of a registry batcher, free ones included (grammar 0,
    # the identity), masks its first token with its grammar's tables.
    tables = (None if self._constraints is None
              else self._constraints.single(p.gid))
    prefill = s._prefill(
        final_tokens, torch.tensor([p.input_length], device=self.device),
        1, bool(self.record_logprobs), False, p.request.generator,
        p.img_embed, p.cache, p.start, overrides, constraint_tables=tables,
    )
    need = sampler_lib._next_bucket(p.request.max_steps)
    if self.draft_len:
      # JAX's hist_need: the prompt and the largest budget, then a token.
      hist_need = sampler_lib._next_bucket(
          p.prompt_tokens.shape[1] + max(need, self._buffer_len) + 1)
      if hist_need > self._hist_len:
        self._grow(hist_need, ("hist",))
    if need > self._buffer_len:
      self._grow(need)
    self._insert(p, prefill)
    p.request.started = True

  def _drain_admissions(self) -> None:
    """Runs up to ``admission_chunks_per_tick`` prefill calls (FIFO)."""
    budget = self.admission_chunks_per_tick
    while self._pending and (budget is None or budget > 0):
      p = self._pending[0]
      while len(p.chunks) > 1 and (budget is None or budget > 0):
        tokens_c, pos_c = p.chunks.pop(0)
        _, p.cache = self._admission_sampler(p)._prefill_chunk_step(
            tokens_c, pos_c, p.cache)
        if budget is not None:
          budget -= 1
      if len(p.chunks) == 1 and (budget is None or budget > 0):
        self._finish_admission(p)
        self._pending.pop(0)
        if budget is not None:
          budget -= 1
      else:
        return

  def _tick(self, n: int) -> None:
    """``n`` decode steps of every slot: replays of the captured step, or
    eager steps on the CPU and with ``jit_compile=False``."""
    adapters = self._adapter_rows if self.multi_lora else None
    grammars = self._constraints
    if not self._captures:
      model = self._model_ml if self.multi_lora else None
      for _ in range(n):
        _tick_step(self.sampler, self._flags, self._state, self._cache,
                   self._generators, model, grammars)
    else:
      key = (self._buffer_len, self._hist_len)
      graph = self._programs.get(key)
      if graph is None:
        graph = _TickGraph(self.sampler, self._flags, self._state,
                           self._cache, self._generators, grammars)
        self._programs[key] = graph
      graph.run(self._state, self._cache, self._generators, n, adapters,
                (self._adapter_token, self._adapter_version)
                if self.multi_lora else None, grammars,
                (self._grammar_token, self._grammar_version)
                if grammars is not None else None)
    self._fetched = None

  def _host(self) -> tuple[list, list, list]:
    """(done, write_idx, out) on the host: one fetch after each change."""
    if self._fetched is None:
      st = self._state
      packed = torch.cat([st["done"].long(), st["write_idx"],
                          st["out"].flatten()]).tolist()
      n = self.num_slots
      out = packed[2 * n:]
      length = self._buffer_len
      self._fetched = (packed[:n], packed[n:2 * n],
                       [out[i * length:(i + 1) * length] for i in range(n)])
    return self._fetched

  def _stream(self) -> None:
    """Delivers newly decoded tokens to the stream callback."""
    if self.stream_callback is None:
      return
    live = [r for r in self._requests.values() if r.started]
    if not live:
      return
    _, write_idx, out = self._host()
    for r in live:
      upto = write_idx[r.slot]
      if upto > r.emitted:
        self.stream_callback(r.request_id, out[r.slot][r.emitted:upto], False)
        r.emitted = upto

  @torch.inference_mode()
  def step(self, n: int = 8) -> None:
    """One tick: admission prefill work, then ``n`` decode steps of every
    slot, then one host fetch (streaming delivery reads it)."""
    self._drain_admissions()
    if any(r.started for r in self._requests.values()):
      self._tick(n)
      self._host()
    self._stream()

  def _hand_back(self, req: _Request, steps: int) -> None:
    """Leaves a finished request's generator where a batch-1 ``Sampler``
    call (``SpeculativeSampler`` with ``draft_len``) would: its state after
    the prefill, advanced by one step's draws for each decode (verify) step
    the request took (its slot's generator drew on every step of the tick,
    live or not)."""
    req.generator.set_state(req.generator_state)
    vocab, k = self.sampler.vocab_size, self.draft_len
    f32 = dict(dtype=torch.float32, device=self.device)
    for _ in range(steps):
      if k:
        torch.empty(k, **f32).uniform_(generator=req.generator)
        torch.empty(k + 1, vocab, **f32).exponential_(
            1.0, generator=req.generator)
      else:
        torch.empty(vocab, **f32).exponential_(1.0, generator=req.generator)

  @torch.inference_mode()
  def pop_finished(self) -> list[tuple[int, list[int], str]]:
    """Returns ``(request_id, token_ids, text)`` for each completed request
    and frees their slots."""
    done, write_idx, out = self._host()
    records = verify_steps = None
    finished = []
    for slot, req in list(self._requests.items()):
      # A freshly reserved slot may still carry its previous occupant's done
      # flag until its prefill inserts; skip unstarted requests.
      if not req.started or not done[slot]:
        continue
      if req.want_state:
        # Copied before the slot frees; preserve_states froze the row.
        self._states[req.request_id] = self._extract_state(slot)
      upto = write_idx[slot]
      tokens = out[slot][:upto]
      if self.record_logprobs:
        if records is None:
          # One fetch of the records of every slot.
          st = self._state
          records = [st[key].tolist()
                     for key in ("chosen_lp", "top_lp_ids", "top_lp_vals")]
        chosen, top_ids, top_vals = (r[slot] for r in records)
        self._logprob_records[req.request_id] = {
            "token_logprobs": chosen[:upto],
            "top_ids": top_ids[:upto],
            "top_logprobs": top_vals[:upto],
        }
      if self._generators:
        steps = upto - 1
        if self.draft_len:
          if verify_steps is None:
            verify_steps = self._state["verify_steps"].tolist()
          steps = verify_steps[slot]
        self._hand_back(req, steps)
      if self.stream_callback is not None:
        self.stream_callback(req.request_id, tokens[req.emitted:], True)
      finished.append(
          (req.request_id, tokens, self.sampler.vocab.DecodeIds(tokens))
      )
      self._release_gid(req.gid)
      del self._requests[slot]
      self._state["active"][slot] = False
    finished.sort(key=lambda t: t[0])
    return finished

  def take_logprobs(self, request_id: int) -> dict:
    """Pops a finished request's logprob record (``record_logprobs``
    batchers; after :meth:`pop_finished` returned the request).

    Returns ``{"token_logprobs": [float], "top_ids": [[int]],
    "top_logprobs": [[float]]}`` aligned with the request's tokens.
    """
    if not self.record_logprobs:
      raise ValueError(
          "take_logprobs needs ContinuousBatcher(record_logprobs=k)."
      )
    try:
      return self._logprob_records.pop(request_id)
    except KeyError:
      raise KeyError(
          f"No logprobs for request {request_id}: not finished yet "
          "(pop_finished first) or already taken."
      ) from None

  def take_state(self, request_id: int) -> sampler_lib.PrefixState:
    """Pops the post-generation context of a finished ``return_state``
    request (states are request-sized cache copies: handed over, not
    kept)."""
    try:
      return self._states.pop(request_id)
    except KeyError:
      raise KeyError(
          f"No state for request {request_id}: it was not added with "
          "return_state=True, has not finished (pop_finished first), or "
          "its state was already taken."
      ) from None

  @torch.inference_mode()
  def cancel(self, request_id: int) -> bool:
    """Cancels a request; returns False if the id is unknown or finished.

    A cancelled request never appears in :meth:`pop_finished` and its
    decoded tokens are discarded. Its slot frees at once: a queued admission
    is dropped host-side; a started slot clears its ``active`` flag (the
    step's live mask is ``active & ~done``, so the row stops advancing and
    its neighbors are untouched) and the next admission overwrites it. With
    a ``stream_callback``, a final ``(request_id, [], True)`` closes the
    stream.
    """
    for i, p in enumerate(self._pending):
      if p.request.request_id == request_id:
        del self._pending[i]
        self._release_gid(p.request.gid)
        del self._requests[p.request.slot]
        if self.stream_callback is not None:
          self.stream_callback(request_id, [], True)
        return True
    for slot, req in list(self._requests.items()):
      if req.request_id == request_id:
        self._state["active"][slot] = False
        self._release_gid(req.gid)
        del self._requests[slot]
        if self.stream_callback is not None:
          self.stream_callback(request_id, [], True)
        return True
    return False

  def run_until_drained(self, step_size: int = 8, max_ticks: int = 10_000):
    """Convenience loop: step until every admitted request completes."""
    results = []
    for _ in range(max_ticks):
      if not self._requests:
        return results
      self.step(step_size)
      results.extend(self.pop_finished())
    err = RuntimeError(
        f"max_ticks exceeded before the batch drained; {len(results)} "
        "completed results are attached as .results."
    )
    err.results = results
    raise err
