"""Self-speculative decoding from prompt-lookup drafts.

Counterpart of the JAX package's ``cadence_gemma_tpu/inference/speculative.py``.
Decode reads every weight to produce one token; a verify step reads them
once for a chunk of ``draft_len + 1`` tokens (the pending token and
``draft_len`` drafted ones), keeps the prefix on which the model agrees with
the drafts and emits one more token of its own, so a step emits between 1
and ``draft_len + 1`` tokens. Greedy acceptance emits the tokens of plain
greedy decode, up to rounding: the verify's products run at ``b * (k + 1)``
rows and decode's at ``b``, and the library may take other algorithms for
them, which can flip an argmax whose two largest logits nearly tie (JAX
documents the same effect between its two programs). Categorical acceptance
follows the speculative-sampling rule, so the emitted tokens are distributed
as plain categorical sampling's.

Drafts come from the history itself (prompt and generated tokens): every
position is scored by how many of the last ``ngram`` tokens it matches
backwards, and the continuation of the longest, then latest, match is the
draft. Everything runs on the device: one ``[b, H, ngram]`` compare, one
verify forward with ``pending_cache=True``, the acceptance, and
:func:`modules.commit_pending_cache`, which commits exactly the emitted
prefix of each row (the RG-LRU's fp32 carries, the conv inputs, a masked
ring write). On the card (``jit_compile=True``) one verify step is captured
as a CUDA graph and replayed, the counterpart of JAX's single
``while_loop`` program; the host reads one flag a step (whether any row is
still live). ``jit_compile=False`` and the CPU run the same step eagerly.

A grammar (``constraint=``) makes the verify grammar-aware, as JAX's: each
verify position is masked with the DFA state reached through the drafts
before it, so a draft that leaves the grammar disagrees with the masked
choice and is rejected, and greedy output equals constrained plain greedy
decode. A sampler over a mesh (ROADMAP queue 1 item 14c) is not ported and
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.models import modules

SamplerOutput = sampler_lib.SamplerOutput

_cache_leaves = sampler_lib._cache_leaves
_map_cache = sampler_lib._map_cache

# Eager verify steps a new graph runs on its own buffers before capture.
_GRAPH_WARMUP_STEPS = 3


def _draw(shape, device, generators, fill):
  """A tensor of ``shape`` filled by ``fill(tensor, generator)``: from one
  generator for the whole batch, or row by row from a list of generators
  (one a row, as the batcher's slots draw)."""
  z = torch.empty(shape, dtype=torch.float32, device=device)
  if isinstance(generators, torch.Generator):
    fill(z, generators)
  else:
    for row, generator in enumerate(generators):
      fill(z[row], generator)
  return z


def _where_rows(keep: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
  return torch.where(keep.view(-1, *[1] * (new.dim() - 1)), new, old)


def _write_from(buf: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
  """``buf`` with ``values[:, i]`` at column ``start + i`` for ``i < count``
  row by row: a select over the whole buffer, so no index depends on the
  data and masked entries go nowhere (JAX's ``mode="drop"`` scatter)."""
  cols = torch.arange(buf.shape[1], device=buf.device)[None]
  rel = cols - start[:, None]
  write = (rel >= 0) & (rel < count[:, None])
  picked = values.gather(1, rel.clamp(0, values.shape[1] - 1))
  return torch.where(write, picked, buf)


def prompt_lookup_spec_step(
    model,
    state: dict[str, Any],
    *,
    draft_len: int,
    ngram: int,
    stop_ids: torch.Tensor,
    logits_filter=None,
    generators=None,
    constraint=None,
) -> dict[str, Any]:
  """One draft, verify, accept and commit step over a batch of rows
  (``speculative.py:51-277`` in JAX).

  Reads nothing back to the host, so a CUDA graph can capture it. Shared by
  :class:`SpeculativeSampler` and the continuous batcher's speculative tick.

  ``state`` holds (b rows, H history, L output): ``hist`` [b, H],
  ``valid_from`` [b], ``cur_len`` [b], ``cache``, ``positions`` [b, 1],
  ``live`` [b] bool (rows to advance; the others do not change), ``out``
  [b, L], ``write_idx`` [b] and ``budget`` [b]. With ``generators`` (one
  ``torch.Generator`` for the batch, or a list of one a row) acceptance is
  stochastic: the prompt-lookup draft is a one-hot proposal, so draft
  ``d_i`` is accepted with probability ``p_i(d_i)``, the first rejection
  resamples from ``norm(max(p - onehot(d), 0))`` and a chunk accepted
  whole samples its bonus token from ``p_k``, where ``p`` is the softmax of
  ``logits_filter(logits)``. Each step draws ``[b, k]`` uniforms, then
  ``[b, k + 1, vocab]`` exponentials. Without, greedy agreement.

  Returns the new state (new tensors; the caller's are not written) and
  ``eos_hit`` [b]: whether a row emitted a stop token in ``stop_ids``.

  ``constraint`` (the single-grammar ``mask(state, logits)`` /
  ``advance(state, token)`` interface: a ``constrain.ConstraintTables``, or
  a registry bound to each row's grammar, ``constrain.BoundConstraint``)
  needs ``state["cstate"]`` [b], the rows' DFA states after the pending
  token. Position ``i`` is masked with the state reached through ``cstate``
  and drafts ``0..i-1``; the result carries ``cstate`` advanced over the
  emitted tokens of live rows. The emitted tokens before a row's last are
  accepted drafts, so their states are the chain's, and one advance over
  the last emitted token ends the row where JAX's token-by-token fold does.
  """
  k, n = draft_len, ngram
  hist = state["hist"]
  b, hist_len = hist.shape
  dev = hist.device
  live, cur_len = state["live"], state["cur_len"]
  offs = torch.arange(k + 1, device=dev)[None]

  # The draft: for every continuation start e, how many of the last n
  # tokens match the n tokens before e (backwards); the longest match wins,
  # then the latest. Positions before a row's history (left padding) and
  # the query itself (e == cur_len) cannot match.
  lags = torch.arange(n, device=dev)[None, None]
  ends = torch.arange(hist_len, device=dev)[None, :, None]
  back_pos = ends - 1 - lags  # [1, H, n]
  back = hist.gather(1, back_pos.clamp(0, hist_len - 1).expand(
      b, -1, -1).reshape(b, -1)).view(b, hist_len, n)
  gram_pos = (cur_len[:, None] - 1 - torch.arange(n, device=dev)[None])
  gram = hist.gather(1, gram_pos.clamp(0, hist_len - 1))  # [b, n]
  eq = (back == gram[:, None]) & (back_pos >= state["valid_from"][:, None,
                                                                  None])
  length = torch.cumprod(eq.long(), dim=-1).sum(dim=-1)  # [b, H]
  e_axis = torch.arange(hist_len, device=dev)[None]
  usable = (length >= 1) & (e_axis <= cur_len[:, None] - 1)
  score = torch.where(usable, length * (hist_len + 1) + e_axis, -1)
  best_score = score.amax(dim=1)
  best_e = best_score % (hist_len + 1)
  cont = (best_e[:, None] + torch.arange(k, device=dev)[None]).clamp(
      0, hist_len - 1)
  # JAX's take_along_axis reads index -1 (an empty slot) from the end.
  pending = hist.gather(1, (cur_len[:, None] - 1) % hist_len)
  # No match: the pending token repeated (rejected unless it repeats).
  draft = torch.where((best_score >= 0)[:, None], hist.gather(1, cont),
                      pending)

  # The verify: one forward over [pending, drafts], the cache deferred.
  chunk = torch.cat([pending, draft], dim=1)  # [b, k + 1]
  logits, pending_cache = model(chunk, state["positions"] + offs,
                                state["cache"], pending_cache=True)
  if constraint is not None:
    chain = [state["cstate"]]
    for i in range(1, k + 1):
      chain.append(constraint.advance(chain[-1], chunk[:, i]))
    chain = torch.stack(chain, dim=1)  # [b, k + 1]
    logits = constraint.mask(chain, logits)
  if generators is not None:
    filtered = logits if logits_filter is None else logits_filter(logits)
    probs = torch.softmax(filtered.float(), dim=-1)
    d = chunk[:, 1:]
    p_draft = probs[:, :k].gather(-1, d[..., None])[..., 0]
    u = _draw((b, k), dev, generators,
              lambda z, g: z.uniform_(generator=g))
    j = torch.cumprod((u < p_draft).long(), dim=1).sum(dim=1)  # [b] in [0, k]
    # max(p - onehot(d), 0) is p with d's entry zeroed (p <= 1).
    resid = probs[:, :k].scatter(-1, d[..., None], 0.0)
    resid_sum = resid.sum(dim=-1, keepdim=True)
    # An all-zero residual (p is the one-hot) cannot follow a rejection, but
    # keep the draw well defined.
    resid = torch.where(resid_sum > 0, resid / resid_sum.clamp(min=1e-20),
                        probs[:, :k])
    cand = torch.cat([resid, probs[:, k:]], dim=1)  # [b, k + 1, vocab]
    # sampler._categorical's draw: argmax of p / q, q ~ Exp(1).
    q = _draw(cand.shape, dev, generators,
              lambda z, g: z.exponential_(1.0, generator=g))
    resampled = (cand / q).argmax(dim=-1)
    d_ext = torch.cat([d, d[:, -1:]], dim=1)
    emit_tok = torch.where(offs < j[:, None], d_ext, resampled)
  else:
    greedy = logits.argmax(dim=-1)  # [b, k + 1]
    agree = (chunk[:, 1:] == greedy[:, :-1]).long()
    j = torch.cumprod(agree, dim=1).sum(dim=1)
    emit_tok = greedy

  is_eos = (emit_tok[..., None] == stop_ids).any(dim=-1)
  eos_pos = is_eos.long().argmax(dim=1)
  j = torch.where(is_eos.any(dim=1), torch.minimum(j, eos_pos), j)
  emit_n = torch.minimum(j + 1, state["budget"] - state["write_idx"])
  emit_n = torch.where(live, emit_n, 0)

  # Commit the emitted prefix, not the accepted one: under a budget cut the
  # cache must end where the tokens do (a returned state continues it).
  commit_idx = (emit_n - 1).clamp(min=0)
  committed = modules.commit_pending_cache(state["cache"], pending_cache,
                                           commit_idx)
  new_cache = {name: type(block)(*(_where_rows(live, new, old) for new, old
                                   in zip(committed[name], block)))
               for name, block in state["cache"].items()}
  result = dict(
      hist=_write_from(hist, cur_len, emit_n, emit_tok),
      valid_from=state["valid_from"],
      cur_len=cur_len + emit_n,
      cache=new_cache,
      positions=state["positions"] + emit_n[:, None],
      live=live,
      out=_write_from(state["out"], state["write_idx"], emit_n, emit_tok),
      write_idx=state["write_idx"] + emit_n,
      budget=state["budget"],
      eos_hit=(is_eos & (offs < emit_n[:, None])).any(dim=1),
  )
  if constraint is not None:
    last = commit_idx[:, None]
    advanced = constraint.advance(chain.gather(1, last)[:, 0],
                                  emit_tok.gather(1, last)[:, 0])
    result["cstate"] = torch.where(emit_n > 0, advanced, state["cstate"])
  return result


def check_speculation(sampler, draft_len: int, ngram: int) -> None:
  """JAX's refusals of speculation over ``sampler`` (a penalty, a draft
  chunk wider than the ring, ``draft_len`` / ``ngram`` below 1)."""
  if sampler.repetition_penalty != 1.0:
    raise ValueError(
        "Speculative decoding does not support repetition_penalty: the "
        "verify pass scores all draft positions in one forward, but the "
        "penalty depends on which earlier chunk tokens are accepted."
    )
  if draft_len < 1 or ngram < 1:
    raise ValueError(
        f"draft_len/ngram must be >= 1, got {draft_len}/{ngram}")
  window = getattr(sampler.model.config, "attention_window_size", None)
  if window is not None and draft_len + 1 > window:
    raise ValueError(
        f"draft_len + 1 ({draft_len + 1}) exceeds the attention window "
        f"({window}); the masked ring commit needs distinct slots."
    )


def sampler_filter(sampler):
  """The categorical sampler's temperature / top-k / top-p as a function of
  logits (closing over its settings, not the sampler), or None if greedy."""
  if sampler.deterministic_sampling:
    return None
  temperature, top_k, top_p = (sampler.temperature, sampler.top_k,
                               sampler.top_p)
  return lambda logits: sampler_lib.filter_logits(logits, temperature, top_k,
                                                  top_p)


# The loop state's tensors besides the cache, in the graph's buffer order.
_LOOP_KEYS = ("hist", "valid_from", "cur_len", "positions", "live", "out",
              "write_idx", "budget")


def _loop_step(model, state: dict, draft_len: int, ngram: int, stop_ids,
               logits_filter, generator, constraint=None) -> dict:
  """One iteration of the generation loop: a verify step, then a row stays
  live while it has not stopped and has budget left."""
  st = prompt_lookup_spec_step(
      model, state, draft_len=draft_len, ngram=ngram, stop_ids=stop_ids,
      logits_filter=logits_filter, generators=generator,
      constraint=constraint)
  eos_hit = st.pop("eos_hit")
  st["live"] = st["live"] & ~eos_hit & (st["write_idx"] < st["budget"])
  return st


class _SpecGraph:
  """One verify step of the loop captured as a CUDA graph, replayed once a
  step (``sampler._DecodeGraph``'s counterpart).

  The graph owns its buffers: :meth:`load` copies a call's loop state in
  and :meth:`store` copies it out, so a cached graph serves every later
  call of its shapes. A categorical sampler's generator is registered with
  the graph; :meth:`load` gives it the caller's generator's state and
  :meth:`store` hands the advanced state back, so the replays draw what
  eager steps would have drawn. The graph keeps no reference to its sampler
  (the sampler holds the graph). A constrained loop (``tables``) carries the
  rows' DFA states (``cstate``) among the buffers and masks on the graph's
  own copy of the tables, which :meth:`load` refreshes.
  """

  def __init__(self, step, state: dict, categorical: bool, tables=None):
    device = state["hist"].device
    self.keys = _LOOP_KEYS + (("cstate",) if tables is not None else ())
    self.state = {key: state[key].clone() for key in self.keys}
    self.state["cache"] = _map_cache(torch.clone, state["cache"])
    self.tables = None if tables is None else tables.clone()
    self.generator = None
    if categorical:
      if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise NotImplementedError(
            f"torch {torch.__version__} cannot register a generator with a "
            "CUDA graph, which captured categorical speculation needs; pass "
            "jit_compile=False."
        )
      self.generator = torch.Generator(device)
    self.replays = 0
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
      for _ in range(_GRAPH_WARMUP_STEPS):
        self.load(state, None, tables)
        self._step(step)
    torch.cuda.current_stream(device).wait_stream(side)
    self.graph = torch.cuda.CUDAGraph()
    if self.generator is not None:
      self.graph.register_generator_state(self.generator)
    with torch.cuda.graph(self.graph):
      self._step(step)

  def _buffers(self, state: dict) -> list[torch.Tensor]:
    return [state[key] for key in self.keys] + _cache_leaves(state["cache"])

  def _step(self, step) -> None:
    new = step(self.state, self.generator, self.tables)
    for dst, src in zip(self._buffers(self.state), self._buffers(new)):
      dst.copy_(src)

  @property
  def live(self) -> torch.Tensor:
    return self.state["live"]

  def load(self, state: dict, generator: torch.Generator | None,
           tables=None) -> None:
    """Copies a call's loop state (generator position and constraint tables
    included) in."""
    for dst, src in zip(self._buffers(self.state), self._buffers(state)):
      dst.copy_(src)
    if self.tables is not None:
      self.tables.copy_(tables)
    if self.generator is not None and generator is not None:
      self.generator.set_state(generator.get_state())

  def replay(self) -> None:
    self.graph.replay()
    self.replays += 1

  def store(self, generator: torch.Generator | None) -> dict:
    """The loop state after the replays (copies), and the generator's."""
    if self.generator is not None and generator is not None:
      generator.set_state(self.generator.get_state())
    out = {key: self.state[key].clone() for key in self.keys}
    out["cache"] = _map_cache(torch.clone, self.state["cache"])
    return out


class SpeculativeSampler:
  """Prompt-lookup speculative decoding over a :class:`~sampler.Sampler`,
  greedy or categorical (``speculative.py:280-552`` in JAX).

  With a greedy sampler the tokens are plain greedy decode's (up to the
  rounding of near ties, see the module docstring). With a categorical one
  (``deterministic_sampling=False``) they are distributed as plain
  categorical sampling's under the same temperature / top-k / top-p; the
  acceptance draws take the generator's numbers differently from plain
  decode, so one seed gives the same distribution, not the same stream.

  Args:
    sampler: The :class:`~sampler.Sampler` whose model, vocabulary, filters,
      stop tokens, prefill (chunked too), device and ``jit_compile`` are
      reused.
    draft_len: Tokens drafted a verify step (the chunk is ``draft_len + 1``).
    ngram: The longest backward match the lookup ranks candidates by.
  """

  def __init__(self, sampler: sampler_lib.Sampler, draft_len: int = 7,
               ngram: int = 4):
    if getattr(sampler, "mesh", None) is not None:
      raise NotImplementedError(
          "Speculative decoding over a mesh (tensor-parallel serving) is not "
          "ported to the PyTorch package yet (ROADMAP queue 1 item 14c).")
    check_speculation(sampler, draft_len, ngram)
    self.sampler = sampler
    self.draft_len = draft_len
    self.ngram = ngram
    self.last_stats: dict[str, Any] = {}
    self._graphs: dict[tuple, _SpecGraph] = {}

  def _step_fn(self):
    """The loop's step over this sampler (closes over no sampler object, so
    a graph built from it does not keep the sampler alive)."""
    s = self.sampler
    model, stop_ids = s.model, s._stop_ids
    k, n = self.draft_len, self.ngram
    logits_filter = sampler_filter(s)
    return lambda state, generator, constraint=None: _loop_step(
        model, state, k, n, stop_ids, logits_filter, generator, constraint)

  def _graph_for(self, state: dict, tables=None) -> _SpecGraph:
    s = self.sampler
    key = (*state["hist"].shape, state["out"].shape[1], self.draft_len,
           self.ngram, s._stop_ids_host, not s.deterministic_sampling,
           None if tables is None else tables.shapes)
    graph = self._graphs.get(key)
    if graph is None:
      graph = _SpecGraph(self._step_fn(), state,
                         not s.deterministic_sampling, tables)
      self._graphs[key] = graph
    return graph

  def _loop(self, state: dict, generator,
            tables=None) -> tuple[dict, int]:
    """Verify steps until no row is live; the host reads ``live.any()``
    once a step. Returns the final state and the steps run."""
    s = self.sampler
    steps = 0
    if s._captures_decode:
      graph = self._graph_for(state, tables)
      graph.load(state, generator, tables)
      while bool(graph.live.any()):
        graph.replay()
        steps += 1
      return graph.store(generator), steps
    step = self._step_fn()
    while bool(state["live"].any()):
      state = step(state, generator, tables)
      steps += 1
    return state, steps

  @torch.inference_mode()
  def __call__(
      self,
      input_strings: Sequence[str],
      total_generation_steps: int,
      prefix_state: sampler_lib.PrefixState | None = None,
      img_embed: torch.Tensor | None = None,
      return_state: bool = False,
      generator: torch.Generator | None = None,
      constraint: Any | None = None,
  ) -> SamplerOutput:
    """Speculative generation (greedy: plain greedy's tokens; categorical:
    its distribution, from ``generator``, required then, as JAX's ``rng``).

    A row's buffer is padded with ``pad_id`` after its stop token.
    ``prefix_state`` continues from cached context with the plain sampler's
    contract (raw continuation text without BOS, equal lengths a batch); the
    lookup then covers the continuation and the generated tokens only.
    ``return_state`` attaches a :class:`~sampler.PrefixState` that is exact
    row by row (each row's cache stops at its own last emitted token; its
    pending token is that token). ``img_embed`` splices fused vision
    features in as the plain sampler does (equal-length prompts; not with
    ``prefix_state``); the visual tokens live in the cache, not in the
    lookup history. ``constraint`` (a :class:`~constrain.TokenDFA` or its
    tables) masks every verify position with the grammar, so greedy output
    equals constrained plain greedy decode (JAX ``speculative.py:343-382``).
    """
    s = self.sampler
    if total_generation_steps < 1:
      raise ValueError("total_generation_steps must be >= 1.")
    if img_embed is not None and prefix_state is not None:
      raise ValueError(
          "img_embed cannot be combined with prefix_state (the image "
          "splices in after BOS, which lives in the prefix)."
      )
    if not s.deterministic_sampling and generator is None:
      raise ValueError(
          "A torch.Generator must be given for non-deterministic sampling."
      )
    tables = s._resolve_constraint(constraint)
    dev = s.device
    chunk = s.prefill_chunk_size
    if prefix_state is None:
      all_ids = [s.tokenize(t) for t in input_strings]
      lengths_list = [len(i) for i in all_ids]
      if img_embed is not None and len(set(lengths_list)) != 1:
        raise ValueError(
            "Multimodal sampling requires equal-length prompts per batch "
            f"(got lengths {lengths_list})."
        )
      max_len = max(lengths_list)
      pad = s.vocab.pad_id()
      tokens = torch.tensor([[pad] * (max_len - len(i)) + i for i in all_ids],
                            dtype=torch.long, device=dev)
      lengths = torch.tensor(lengths_list, device=dev)
      cache = start = None
      if chunk is not None and max_len > chunk and img_embed is None:
        # The plain sampler's chunk plan; an image stays single shot.
        mid, cache, final_tokens, start, tokens = s.plan_prompt_chunks(
            tokens, lengths)
        for tok_c, pos_c in mid:
          _, cache = s._prefill_chunk_step(tok_c, pos_c, cache)
      else:
        final_tokens = tokens
      prompt_len = tokens.shape[1]
      valid_from = prompt_len - lengths
    else:
      mid, cache, final_tokens, start, tokens = s.plan_continuation_chunks(
          input_strings, prefix_state)
      for tok_c, pos_c in mid:
        _, cache = s._prefill_chunk_step(tok_c, pos_c, cache)
      prompt_len = tokens.shape[1]
      lengths = None
      valid_from = torch.zeros(tokens.shape[0], dtype=torch.long, device=dev)

    prefill = s._prefill(final_tokens, lengths, 1, False, False, generator,
                         img_embed, cache, start, constraint_tables=tables)
    first = prefill.tokens_buffer[:, 0]
    b = first.shape[0]
    pad_id = s.vocab.pad_id()
    hist = torch.nn.functional.pad(tokens, (0, total_generation_steps),
                                   value=pad_id)
    hist[:, prompt_len] = first
    out = torch.full((b, total_generation_steps), pad_id, dtype=torch.long,
                     device=dev)
    out[:, 0] = first
    state = dict(
        hist=hist,
        valid_from=valid_from.long(),
        cur_len=torch.full((b,), prompt_len + 1, dtype=torch.long,
                           device=dev),
        cache=prefill.cache,
        positions=prefill.positions,
        live=~s._is_stop_token(first) & (total_generation_steps > 1),
        out=out,
        write_idx=torch.ones(b, dtype=torch.long, device=dev),
        budget=torch.full((b,), total_generation_steps, dtype=torch.long,
                          device=dev),
    )
    if tables is not None:
      # The rows' DFA states after the (masked) first token.
      state["cstate"] = prefill.constraint_state
    state, steps = self._loop(state, generator, tables)

    next_state = None
    if return_state:
      # The last emitted token was never fed to the model: it leads the
      # next turn.
      next_state = sampler_lib.PrefixState(
          cache=state["cache"], length=state["positions"][:, 0],
          pending_token=state["hist"].gather(1, state["cur_len"][:, None] - 1),
      )
    emitted = state["write_idx"].tolist()
    self.last_stats = {
        "verify_steps": steps,
        "tokens_emitted": sum(emitted),
        # Tokens a weights read against plain decode's one (the prefill's
        # first token excluded); at most draft_len + 1.
        "tokens_per_verify_step": (sum(emitted) - b) / max(steps, 1),
    }
    rows = list(state["out"])
    return SamplerOutput(
        text=[s.vocab.DecodeIds(row[:m].tolist())
              for row, m in zip(rows, emitted)],
        tokens=rows,
        logits=[],
        state=next_state,
    )
