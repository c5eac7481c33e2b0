"""The port's speculative decoding against the JAX package's, on the CPU.

``tests/test_torch_port_serving.py``'s tiny Griffin (an R and an A block,
width 16, window 8, float32, seeded std-0.5 normal weights: with the
initializer's scales a model this small repeats its last token, every draft
is accepted and a broken rejection or commit would pass) in both packages.
JAX's verify runs ``lax.scan`` (no Pallas), so every JAX call runs as the
JAX tests run it.

  * ``commit_pending_cache`` of a verify chunk, per row commit indices
    0..k, across the ring's wrap: the port's committed cache against JAX's
    on the same pending material (1e-5, float32 summed in other orders) and
    against the port's own plain run of the accepted prefix (1e-5), and
    decode after it;
  * one ``prompt_lookup_spec_step`` on the same state: the drafts, ``out``,
    ``hist``, ``cur_len``, ``write_idx``, positions and ``eos_hit`` bit for
    bit, the caches within 1e-5;
  * ``SpeculativeSampler``: the tokens of JAX's and of the port's plain
    ``Sampler`` (greedy, draft_len 1/3/7, ragged, repetitive, one-step,
    stop tokens, ``prefix_state``, a conversation, ``return_state`` under a
    budget cut and after a stop, ``img_embed``, chunked prefill, int8
    through the plain kernel versions), ``last_stats`` equal to JAX's;
    categorical speculation against plain categorical by total variation;
  * the batcher with ``draft_len``: JAX's ``TestSpeculativeBatching`` and
    ``test_speculative_chat_matches_plain``, the same schedules as JAX's
    batcher, ``multi_lora`` x ``draft_len``, categorical slots against a
    batch-1 ``SpeculativeSampler`` from generators seeded alike, and every
    refusal; the HTTP front end over a speculative batcher.

A row left-padded with fewer than ``temporal_width - 1`` real prompt tokens
decodes differently in the plain sampler and in speculation, in both
packages alike: a single-token decode step reads the conv tail that the
prefill cached, pad inputs included, while a multi-token chunk masks
sources before position 0 (``layers.py:507-521`` in JAX).
The ragged case holds the port to JAX's tokens there.

Card tests (they skip here): the fp32-carry walk's bits, and captured
against eager speculation.
"""

import numpy as np
import pytest
import torch

from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import constrain as port_constrain
from cadence_gemma_tpu_torch.inference import server as server_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.inference import speculative
from cadence_gemma_tpu_torch.models import modules
from cadence_gemma_tpu_torch.ops import lru_scan

requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)

CACHE_ATOL = 1e-5


def _jax():
  """The JAX modules, imported here so the card tests run without JAX."""
  import jax  # pylint: disable=import-outside-toplevel
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.inference import speculative as jspec  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.inference import serving as jserving  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.models import modules as jmodules  # pylint: disable=import-outside-toplevel
  return jax, jnp, jspec, jserving, jmodules


@pytest.fixture(scope="module")
def pair():
  from tests.test_torch_port_serving import Pair  # pylint: disable=import-outside-toplevel
  return Pair()


def _trim(row, eos):
  row = [int(t) for t in row]
  return row[:row.index(eos) + 1] if eos in row else row


def _to_jax_cache(cache):
  jnp, jmodules = _jax()[1], _jax()[4]
  out = {}
  for name, block in cache.items():
    leaves = [jnp.asarray(t.numpy()) for t in block]
    if isinstance(block, modules.RecurrentBlockCache):
      out[name] = jmodules.RecurrentBlockCache(*leaves)
    else:
      leaves[2] = leaves[2].astype(jnp.int32)
      out[name] = jmodules.AttentionBlockCache(*leaves)
  return out


def _assert_caches_close(got, want, atol=CACHE_ATOL):
  for name in got:
    for g, w in zip(got[name], want[name]):
      np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                 atol=atol, err_msg=name)


def _prefill(pair, prompts):
  """A port cache after the (equal-length) prompt token ids."""
  tokens = torch.tensor(prompts)
  pos = torch.arange(tokens.shape[1]).expand_as(tokens)
  with torch.no_grad():
    _, cache = pair.model(tokens, pos)
  return cache


# -- the commit ----------------------------------------------------------------

# Rows of 6 prompt tokens: a 4-token chunk takes ring slots 6, 7, 0, 1 of the
# 8-slot window, so every commit index past 1 writes across the wrap.
PROMPTS = [[1, 3, 4, 5, 6, 7], [1, 9, 8, 7, 4, 2]]
CHUNK = [[7, 3, 5, 4], [2, 6, 4, 8]]


@pytest.mark.parametrize("commit", [(0, 3), (1, 2), (2, 0), (3, 3)])
def test_commit_matches_jax_and_the_plain_run(pair, commit):
  jax, jnp, _, _, jmodules = _jax()
  cache = _prefill(pair, PROMPTS)
  chunk = torch.tensor(CHUNK)
  pos = 6 + torch.arange(4).expand(2, -1)
  idx = torch.tensor(commit)
  with torch.no_grad():
    logits, pending = pair.model(chunk, pos, cache, pending_cache=True)
    got = modules.commit_pending_cache(cache, pending, idx)
    plain_logits, _ = pair.model(chunk, pos, cache)
  np.testing.assert_allclose(logits.numpy(), plain_logits.numpy(), rtol=0,
                             atol=1e-5)

  @jax.jit
  def verify_and_commit(params, cache, tokens, positions, idx):
    logits, pending = pair.jmodel.apply(
        {"params": params}, tokens=tokens, segment_pos=positions, cache=cache,
        return_logits=True, return_cache=True, pending_cache=True)
    return logits, jmodules.commit_pending_cache(cache, pending, idx)

  jlogits, want = verify_and_commit(
      pair.jparams, _to_jax_cache(cache), jnp.asarray(CHUNK),
      jnp.asarray(pos.numpy()), jnp.asarray(commit, jnp.int32))
  np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                             atol=1e-4)
  _assert_caches_close(got, want)
  for name in got:  # the counters exactly
    if isinstance(got[name], modules.AttentionBlockCache):
      np.testing.assert_array_equal(got[name].num_tokens.numpy(),
                                    np.asarray(want[name].num_tokens))

  # Row by row, the cache of a plain run of the accepted prefix.
  for row, j in enumerate(commit):
    one = {n: type(b)(*(t[row:row + 1] for t in b)) for n, b in cache.items()}
    with torch.no_grad():
      _, plain = pair.model(chunk[row:row + 1, :j + 1],
                            pos[row:row + 1, :j + 1], one)
    mine = {n: type(b)(*(t[row:row + 1] for t in b)) for n, b in got.items()}
    _assert_caches_close(mine, plain)


def test_decode_after_commit_continues_the_plain_run(pair):
  cache = _prefill(pair, PROMPTS)
  chunk = torch.tensor(CHUNK)
  pos = 6 + torch.arange(4).expand(2, -1)
  nxt, nxt_pos = torch.tensor([[5], [3]]), torch.tensor([[8], [8]])
  with torch.no_grad():
    _, pending = pair.model(chunk, pos, cache, pending_cache=True)
    committed = modules.commit_pending_cache(cache, pending,
                                             torch.tensor([1, 1]))
    _, plain = pair.model(chunk[:, :2], pos[:, :2], cache)
    got, _ = pair.model(nxt, nxt_pos, committed)
    want, _ = pair.model(nxt, nxt_pos, plain)
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_pending_cache_refused_without_a_cache(pair):
  with pytest.raises(ValueError, match="pending_cache needs a cache"):
    pair.model(torch.tensor([[1, 2]]), torch.tensor([[0, 1]]),
               pending_cache=True)


# -- one step --------------------------------------------------------------------


class _Recorder:
  """A model (or a flax module, through ``apply``) that keeps the chunk it
  was fed (a tracer under ``jit``, returned by the traced function)."""

  def __init__(self, model):
    self.model, self.chunks = model, []

  def __call__(self, tokens, *args, **kwargs):
    self.chunks.append(tokens)
    return self.model(tokens, *args, **kwargs)

  def apply(self, variables, **kwargs):
    self.chunks.append(kwargs["tokens"])
    return self.model.apply(variables, **kwargs)


@pytest.mark.parametrize("draft_len,ngram", [(3, 2), (4, 3)])
def test_spec_step_matches_jax(pair, draft_len, ngram):
  """Rows: a prompt and the first ten tokens plain greedy decode gave it,
  which end in a loop (drafts from a match, several accepted), one with no
  match, one frozen (not live), one left-padded and one token short of its
  budget. The last history token is pending: the cache holds the tokens
  before it."""
  jax, jnp, jspec, _, _ = _jax()
  looping = "gamma delta eps zeta eta"
  generated = _solo(pair.sampler, looping, 10)
  ids = [pair.sampler.tokenize(looping) + generated] + [
      pair.sampler.tokenize(p) for p in
      ("alpha beta gamma delta eps zeta eta theta alpha", REPETITIVE,
       "eps zeta eps zeta eps zeta")]
  width = max(len(i) for i in ids)
  pads = [width - len(i) for i in ids]
  b = len(ids)
  tokens = torch.tensor([[0] * p + i for p, i in zip(pads, ids)])
  pos = (torch.arange(width) - torch.tensor(pads)[:, None]).clamp(min=-1)
  with torch.no_grad():
    _, cache = pair.model(tokens[:, :-1], pos[:, :-1])
  state = dict(
      hist=torch.nn.functional.pad(tokens, (0, 12)),
      valid_from=torch.tensor(pads), cur_len=torch.full((b,), width),
      cache=cache, positions=pos[:, -1:],
      live=torch.tensor([True, True, False, True]),
      out=torch.zeros(b, 10, dtype=torch.long),
      write_idx=torch.tensor([1, 1, 1, 4]),
      budget=torch.tensor([10, 10, 10, 5]))
  stops = torch.tensor([pair.vocab.eos_id()])
  rec = _Recorder(pair.model)
  with torch.no_grad():
    got = speculative.prompt_lookup_spec_step(
        rec, state, draft_len=draft_len, ngram=ngram, stop_ids=stops)

  jstate = {k: (v if k == "cache" else jnp.asarray(v.numpy(), jnp.int32))
            for k, v in state.items()}
  jstate["cache"] = _to_jax_cache(cache)
  jstate["live"] = jnp.asarray(state["live"].numpy())
  jrec = _Recorder(pair.jmodel)

  @jax.jit
  def step(params, st):
    out = jspec.prompt_lookup_spec_step(
        jrec, params, st, draft_len=draft_len, ngram=ngram,
        stop_ids=jnp.asarray(stops.numpy(), jnp.int32))
    return out, jrec.chunks[-1]

  want, jchunk = step(pair.jparams, jstate)
  np.testing.assert_array_equal(rec.chunks[0].numpy(), np.asarray(jchunk))
  assert rec.chunks[0][0, 1:].tolist() != [int(rec.chunks[0][0, 0])] * \
      draft_len
  for key in ("hist", "out", "cur_len", "write_idx", "positions",
              "eos_hit"):
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                  err_msg=key)
  emitted = (got["write_idx"] - state["write_idx"]).tolist()
  assert emitted[2] == 0 and emitted[3] == 1 and max(emitted) > 1, emitted
  _assert_caches_close(got["cache"], want["cache"])
  for name in cache:  # the frozen row's cache bit for bit
    for new, old in zip(got["cache"][name], cache[name]):
      assert torch.equal(new[2], old[2])


# -- SpeculativeSampler ----------------------------------------------------------


def _spec_pair(pair, draft_len, ngram=2, sampler_kw=None, jax_kw=None):
  _, _, jspec, _, _ = _jax()
  sampler_kw = sampler_kw or {}
  plain = pair.port_sampler(**sampler_kw)
  jplain = pair.jax_sampler(**(sampler_kw if jax_kw is None else jax_kw))
  return (plain, speculative.SpeculativeSampler(plain, draft_len, ngram),
          jspec.SpeculativeSampler(jplain, draft_len=draft_len, ngram=ngram))


REPETITIVE = " ".join(["alpha beta gamma delta"] * 4)
# On these weights: verify steps that accept two drafts or more, and steps
# that reject (16 tokens at draft_len 4 take 7 steps); and a prompt whose
# greedy continuation repeats one token (every draft accepted).
MIXED = "eta zeta zeta theta zeta gamma"
LOOPING = "zeta eps gamma gamma"
CASES = {
    "draft_1": (1, ["alpha beta gamma"], 12),
    "draft_3": (3, ["alpha beta gamma"], 12),
    "draft_7": (7, ["alpha beta gamma"], 12),
    "ragged": (4, ["alpha beta", "gamma delta eps zeta eta", "theta"], 10),
    "repetitive": (4, [REPETITIVE], 16),
    "mixed": (4, [MIXED], 16),
    "one_step": (3, ["alpha beta"], 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampler_matches_jax_and_plain(pair, case):
  draft_len, prompts, steps = CASES[case]
  plain, spec, jspec = _spec_pair(pair, draft_len)
  got = spec(prompts, steps)
  want = jspec(prompts, total_generation_steps=steps)
  ref = plain(prompts, steps)
  eos = pair.vocab.eos_id()
  for prompt, g, w, r in zip(prompts, got.tokens, want.tokens, ref.tokens):
    assert g.tolist() == np.asarray(w).tolist()
    # A left-padded row of fewer than 3 prompt tokens: JAX's tokens only
    # (the module docstring says why plain decode differs there).
    if len(plain.tokenize(prompt)) >= 3:
      assert _trim(g, eos) == _trim(r, eos)
  assert spec.last_stats == jspec.last_stats
  if case in ("repetitive", "mixed"):
    assert spec.last_stats["tokens_per_verify_step"] > 1.0
  if case == "mixed":
    # Some step emitted 3 tokens or more (two drafts accepted) and some
    # fewer than draft_len + 1 (a rejection).
    assert 2 < spec.last_stats["tokens_per_verify_step"] < 5, spec.last_stats


def test_stop_tokens_and_pad_after_stop(pair):
  ref = pair.sampler(["alpha beta"], 10,
                     end_sampling_at_eos_token=False).tokens[0].tolist()
  stop_id = ref[2]
  plain, spec, jspec = _spec_pair(pair, 3,
                                  sampler_kw={"stop_token_ids": (stop_id,)})
  want = plain(["alpha beta"], 10).tokens[0].tolist()
  got = spec(["alpha beta"], 10).tokens[0].tolist()
  assert got == np.asarray(
      jspec(["alpha beta"], total_generation_steps=10).tokens[0]).tolist()
  cut = want.index(stop_id) + 1
  assert got[:cut] == want[:cut]
  assert all(t == pair.vocab.pad_id() for t in got[cut:])


def test_prefix_and_conversation(pair):
  plain, spec, jspec = _spec_pair(pair, 3)
  prefix = plain.prefill_prefix("alpha beta gamma")
  jprefix = pair.jax_sampler().prefill_prefix("alpha beta gamma")
  got = spec(["delta eps"], 8, prefix_state=prefix).tokens[0].tolist()
  assert got == np.asarray(jspec(["delta eps"], total_generation_steps=8,
                                 prefix_state=jprefix).tokens[0]).tolist()
  assert _trim(got, 1) == _trim(
      plain(["delta eps"], 8, prefix_state=prefix).tokens[0], 1)
  # A plain first turn, continued speculatively.
  turn1 = plain(["alpha beta"], 3, return_state=True,
                end_sampling_at_eos_token=False)
  want = plain(["gamma"], 6, prefix_state=turn1.state).tokens[0]
  got = spec(["gamma"], 6, prefix_state=turn1.state).tokens[0]
  assert _trim(got, 1) == _trim(want, 1)


def test_return_state_under_budget_cut(pair):
  """One verify step accepts more drafts than the budget allows: the state
  commits the emitted tokens only and continues like plain decode's."""
  plain, spec, _ = _spec_pair(pair, 4)
  prompt = LOOPING
  s1 = spec([prompt], 3, return_state=True)
  assert spec.last_stats["verify_steps"] == 1
  assert spec.last_stats["tokens_emitted"] == 3
  p1 = plain([prompt], 3, return_state=True, end_sampling_at_eos_token=False)
  assert s1.tokens[0].tolist() == p1.tokens[0].tolist()
  for got, want in zip(s1.state.cache.values(), p1.state.cache.values()):
    for g, w in zip(got, want):
      np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                 atol=CACHE_ATOL)
  assert s1.state.pending_token.tolist() == p1.state.pending_token.tolist()
  want = plain(["eps"], 6, prefix_state=p1.state).tokens[0].tolist()
  assert plain(["eps"], 6,
               prefix_state=s1.state).tokens[0].tolist() == want
  assert spec(["eps"], 6, prefix_state=s1.state).tokens[0].tolist()[:3] == \
      want[:3]


def test_return_state_after_stop(pair):
  ref = pair.sampler(["alpha beta"], 6,
                     end_sampling_at_eos_token=False).tokens[0].tolist()
  plain, spec, _ = _spec_pair(pair, 3, sampler_kw={"stop_token_ids":
                                                   (ref[2],)})
  p1 = plain(["alpha beta"], 6, return_state=True)
  s1 = spec(["alpha beta"], 6, return_state=True)
  assert s1.state.pending_token.tolist() == [[ref[2]]]
  want = plain(["gamma"], 5, prefix_state=p1.state).tokens[0]
  got = plain(["gamma"], 5, prefix_state=s1.state).tokens[0]
  assert _trim(got, 1) == _trim(want, 1)


def test_img_embed_matches_jax_and_plain(pair):
  jnp = _jax()[1]
  plain, spec, jspec = _spec_pair(pair, 3)
  cfg = pair.model.config
  img = np.random.default_rng(5).standard_normal(
      (1, cfg.vision_tokens, cfg.vision_width)).astype(np.float32)
  got = spec(["alpha beta"], 8, img_embed=torch.tensor(img)).tokens[0]
  want = jspec(["alpha beta"], total_generation_steps=8,
               img_embed=jnp.asarray(img)).tokens[0]
  ref = plain(["alpha beta"], 8, img_embed=torch.tensor(img)).tokens[0]
  assert got.tolist() == np.asarray(want).tolist()
  assert _trim(got, 1) == _trim(ref, 1)


def test_chunked_prefill_matches_single_shot_and_jax(pair):
  prompts = ["alpha beta gamma delta eps zeta eta theta alpha beta gamma",
             "beta gamma delta"]
  _, chunked, jchunked = _spec_pair(
      pair, 2, sampler_kw={"prefill_chunk_size": 4})
  _, single, _ = _spec_pair(pair, 2)
  got = chunked(prompts, 8)
  want = jchunked(prompts, total_generation_steps=8)
  for g, s, w in zip(got.tokens, single(prompts, 8).tokens, want.tokens):
    assert g.tolist() == s.tolist() == np.asarray(w).tolist()


def test_int8_matches_plain_int8_and_jax(pair):
  _, _, jspec, _, _ = _jax()
  from cadence_gemma_tpu.inference import sampler as jsampler  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.models import griffin as jgriffin  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import quantization as jquant  # pylint: disable=import-outside-toplevel
  jnp = _jax()[1]
  qmodel = convert.griffin_from_flax_params(
      jquant.quantize_params(pair.jparams), pair.model.config, device="cpu",
      dtype=torch.float32, quantized=True)
  plain = sampler_lib.Sampler(qmodel, pair.vocab, device="cpu")
  spec = speculative.SpeculativeSampler(plain, draft_len=3, ngram=2)
  jq = jgriffin.Griffin(pair.jmodel.config, dtype=jnp.float32,
                        param_dtype=jnp.float32, gradient_checkpointing=False,
                        quantized=True)
  jsp = jspec.SpeculativeSampler(
      jsampler.Sampler(jq, pair.jvocab, jquant.quantize_params(pair.jparams),
                       bucket_prompt_lengths=False), draft_len=3, ngram=2)
  prompt = ["alpha beta gamma delta"]
  got = spec(prompt, 8).tokens[0]
  assert got.tolist() == np.asarray(
      jsp(prompt, total_generation_steps=8).tokens[0]).tolist()
  assert _trim(got, 1) == _trim(plain(prompt, 8).tokens[0], 1)


def test_categorical_distribution_matches_plain(pair):
  """The second token's distribution over 384 rows a side: total variation
  below JAX's bound (two ~380-sample draws of one 12-way distribution sit
  near 0.07; greedy acceptance of stochastic drafts lands far above)."""
  kw = dict(deterministic_sampling=False, temperature=1.2, top_k=8)
  rnd = pair.port_sampler(**kw)
  spec = speculative.SpeculativeSampler(rnd, draft_len=3, ngram=2)
  prompts = ["alpha beta"] * 64

  def counts(fn):
    c, n = {}, 0
    for i in range(6):
      for row in fn(i).tokens:
        row = row.tolist()
        if row[1] != pair.vocab.pad_id():
          c[row[1]] = c.get(row[1], 0) + 1
          n += 1
    return c, n

  plain_c, n_p = counts(lambda i: rnd(
      prompts, 3, generator=torch.Generator().manual_seed(100 + i)))
  spec_c, n_s = counts(lambda i: spec(
      prompts, 3, generator=torch.Generator().manual_seed(900 + i)))
  assert n_p > 200 and n_s > 200
  tv = 0.5 * sum(abs(plain_c.get(t, 0) / n_p - spec_c.get(t, 0) / n_s)
                 for t in set(plain_c) | set(spec_c))
  assert tv < 0.18, (tv, plain_c, spec_c)
  # A conversation round trip, categorical.
  t1 = spec(["alpha beta"], 4, return_state=True,
            generator=torch.Generator().manual_seed(7))
  t2 = spec(["gamma"], 4, prefix_state=t1.state,
            generator=torch.Generator().manual_seed(8))
  assert t2.tokens[0].shape == (4,)


def test_sampler_refusals(pair):
  plain = pair.sampler
  with pytest.raises(ValueError, match="repetition_penalty"):
    speculative.SpeculativeSampler(pair.port_sampler(repetition_penalty=2.0))
  for k, n in ((0, 2), (2, 0)):
    with pytest.raises(ValueError, match="draft_len/ngram"):
      speculative.SpeculativeSampler(plain, draft_len=k, ngram=n)
  with pytest.raises(ValueError, match="exceeds the attention window"):
    speculative.SpeculativeSampler(plain, draft_len=8)
  spec = speculative.SpeculativeSampler(plain, draft_len=2)
  with pytest.raises(ValueError, match="img_embed"):
    spec(["beta"], 4, prefix_state=plain.prefill_prefix("alpha"),
         img_embed=torch.zeros(1, 2, 2))
  with pytest.raises(ValueError, match="total_generation_steps"):
    spec(["alpha"], 0)
  with pytest.raises(ValueError, match="Generator"):
    speculative.SpeculativeSampler(pair.port_sampler(
        deterministic_sampling=False))(["alpha"], 4)
  # A grammar is ported (test_torch_port_constrain.py holds it to JAX's):
  # one of another vocabulary is refused, one of this vocabulary gives
  # constrained plain greedy decode's tokens.
  strings = port_constrain.token_strings_from_vocab(
      pair.vocab, pair.vocab.GetPieceSize())
  with pytest.raises(ValueError, match="vocabulary"):
    spec(["alpha"], 4, constraint=port_constrain.TokenDFA(
        "(alpha)+", strings[:-1], eos_id=2))
  dfa = port_constrain.TokenDFA("(alpha|beta|gamma)+", strings, eos_id=2)
  got = spec(["alpha beta"], 6, constraint=dfa).tokens[0].tolist()
  want = plain(["alpha beta"], 6, constraint=dfa).tokens[0].tolist()
  assert _trim(got, 2) == _trim(want, 2)
  meshed = pair.port_sampler()
  meshed.mesh = object()
  with pytest.raises(NotImplementedError, match="item 14c"):
    speculative.SpeculativeSampler(meshed)


# -- the batcher -----------------------------------------------------------------


def _batcher(sampler, num_slots=2, steps=8, **kwargs):
  return serving.ContinuousBatcher(sampler, num_slots=num_slots,
                                   max_steps_default=steps, device="cpu",
                                   **kwargs)


def _solo(sampler, prompt, steps, **kwargs):
  return sampler([prompt], total_generation_steps=steps,
                 **kwargs).tokens[0].tolist()


def _check(got, solo_tokens, steps, eos_id):
  assert got == list(solo_tokens[:len(got)]), (got, list(solo_tokens))
  assert len(got) == steps or got[-1] == eos_id, (got, steps)


def _drain(batcher, n):
  return {rid: tokens for rid, tokens, _ in batcher.run_until_drained(n)}


def test_batcher_matches_solo_regardless_of_join_time(pair):
  s = pair.sampler
  b = _batcher(s, draft_len=3)
  r1 = b.add_request("alpha beta gamma", max_steps=8)
  b.step(2)
  r2 = b.add_request("gamma delta eps", max_steps=8)
  res = _drain(b, 2)
  for rid, prompt in ((r1, "alpha beta gamma"), (r2, "gamma delta eps")):
    _check(res[rid], _solo(s, prompt, 8), 8, pair.vocab.eos_id())


def test_batcher_slot_reuse_and_hist_growth(pair):
  s = pair.sampler
  b = _batcher(s, num_slots=1, steps=6, draft_len=2)
  for prompt in ["alpha beta gamma", "beta gamma delta", "delta eps zeta"]:
    rid = b.add_request(prompt, max_steps=6)
    _check(_drain(b, 2)[rid], _solo(s, prompt, 6), 6, pair.vocab.eos_id())
  b = _batcher(s, steps=4, draft_len=2)
  b.add_request("alpha beta gamma", max_steps=4)
  r_long = b.add_request(MIXED, max_steps=100)
  hist_before = b._hist_len
  _check(_drain(b, 4)[r_long], _solo(s, MIXED, 100), 100,
         pair.vocab.eos_id())
  assert b._hist_len > hist_before


def test_batcher_emits_several_tokens_a_verify_step(pair):
  b = _batcher(pair.sampler, num_slots=1, steps=16, draft_len=4)
  b.add_request(LOOPING, max_steps=16)
  b.step(1)
  assert int(b._state["write_idx"][0]) > 2


SCHEDULE = [("add", "a", "alpha beta gamma", {}),
            ("step", 2),
            ("add", "b", "delta eps zeta", {"max_steps": 12}),
            ("drain", 3),
            ("add", "c", REPETITIVE, {}),
            ("drain", 2)]


def test_batcher_matches_jax_batcher(pair):
  """Two short prompts single shot, the long one in chunks of 4 a tick."""
  from tests.test_torch_port_serving import _drive  # pylint: disable=import-outside-toplevel
  jserving = _jax()[3]
  sampler_kw = {"prefill_chunk_size": 4}
  batcher_kw = {"admission_chunks_per_tick": 1}
  jb = jserving.ContinuousBatcher(pair.jax_sampler(**sampler_kw),
                                  num_slots=2, max_steps_default=8,
                                  draft_len=3, ngram=2, **batcher_kw)
  tb = _batcher(pair.port_sampler(**sampler_kw), draft_len=3, ngram=2,
                **batcher_kw)
  assert _drive(tb, SCHEDULE, None) == _drive(jb, SCHEDULE, None)


def test_batcher_chat_and_take_state(pair):
  s = pair.sampler
  steps = 8
  solo1 = s(["alpha beta alpha beta"], steps, return_state=True)
  solo2 = s(["gamma delta"], steps, prefix_state=solo1.state)
  b = _batcher(s, steps=steps, draft_len=2, preserve_states=True)
  r1 = b.add_request("alpha beta alpha beta", return_state=True)
  _check(_drain(b, 2)[r1], solo1.tokens[0].tolist(), steps,
         pair.vocab.eos_id())
  state = b.take_state(r1)
  assert state.pending_token.tolist() == solo1.state.pending_token.tolist()
  r2 = b.add_request("gamma delta", prefix_state=state)
  _check(_drain(b, 2)[r2], solo2.tokens[0].tolist(), steps,
         pair.vocab.eos_id())


def test_batcher_categorical_matches_batch1_speculative_sampler(pair):
  """A slot draws from its own generator what a batch-1 SpeculativeSampler
  call draws, whoever its neighbours are, and hands the generator back
  where that call leaves it."""
  rnd = pair.port_sampler(deterministic_sampling=False, temperature=0.9)
  spec = speculative.SpeculativeSampler(rnd, draft_len=2, ngram=2)
  b = _batcher(rnd, num_slots=3, steps=8, draft_len=2, ngram=2)
  gens = {p: torch.Generator().manual_seed(s) for p, s in
          (("alpha beta", 5), ("gamma delta eps", 6), (REPETITIVE, 7))}
  rids = {}
  for i, (prompt, g) in enumerate(gens.items()):
    rids[b.add_request(prompt, generator=g)] = prompt
    b.step(1 + i)
  res = _drain(b, 2)
  for rid, prompt in rids.items():
    solo_gen = torch.Generator().manual_seed(gens[prompt].initial_seed())
    want = spec([prompt], 8, generator=solo_gen).tokens[0].tolist()
    _check(res[rid], want, 8, pair.vocab.eos_id())
    assert torch.equal(gens[prompt].get_state(), solo_gen.get_state())


def test_batcher_multi_lora_with_draft_len():
  from tests.test_torch_port_multi_lora import LoraPair  # pylint: disable=import-outside-toplevel
  lp = LoraPair()
  _, ad_a = lp.adapters(400)
  b = _batcher(lp.port_sampler(), steps=10, draft_len=2, multi_lora=True)
  r0 = b.add_request("alpha beta alpha beta", adapters=ad_a)
  r1 = b.add_request("gamma delta")
  res = _drain(b, 2)
  eos = lp.vocab.eos_id()
  _check(res[r0], _solo(lp.merged_sampler(400), "alpha beta alpha beta", 10),
         10, eos)
  _check(res[r1], _solo(lp.port_sampler(), "gamma delta", 10), 10, eos)


def test_batcher_refusals(pair):
  s = pair.sampler
  with pytest.raises(ValueError, match="repetition_penalty"):
    _batcher(pair.port_sampler(repetition_penalty=1.5), draft_len=2)
  with pytest.raises(ValueError, match="record_logprobs"):
    _batcher(s, draft_len=2, record_logprobs=2)
  with pytest.raises(ValueError, match="per_request_sampling"):
    _batcher(s, draft_len=2, per_request_sampling=True)
  with pytest.raises(ValueError, match="attention window"):
    _batcher(s, draft_len=8)
  # Grammars compose with draft_len now; misuse raises JAX's ValueErrors.
  strings = port_constrain.token_strings_from_vocab(
      pair.vocab, pair.vocab.GetPieceSize())
  with pytest.raises(ValueError, match="vocabulary"):
    _batcher(s, draft_len=2, constraints=[port_constrain.TokenDFA(
        "(alpha)+", strings[:-1], eos_id=2)])
  with pytest.raises(ValueError, match="constraints"):
    _batcher(s, draft_len=2).add_request("alpha", constraint=0)


# -- the HTTP front end ----------------------------------------------------------


def test_http_over_a_speculative_batcher(pair):
  """Several tokens a tick stream in order, and max_tokens cuts as on the
  plain batcher: the same tokens through both front ends."""
  import json  # pylint: disable=import-outside-toplevel
  import urllib.request  # pylint: disable=import-outside-toplevel
  from tests.test_torch_port_server import _post  # pylint: disable=import-outside-toplevel
  results = {}
  for draft_len in (0, 3):
    fe = server_lib.ServingFrontend(
        _batcher(pair.sampler, steps=12, draft_len=draft_len), step_size=2,
        device="cpu")
    srv = server_lib.ServingHTTPServer(fe, port=0)
    try:
      _, plain = _post(srv.port, "/v1/generate",
                       {"prompt": MIXED, "max_tokens": 7})
      req = urllib.request.Request(
          f"http://127.0.0.1:{srv.port}/v1/generate",
          data=json.dumps({"prompt": MIXED, "max_tokens": 12,
                           "stream": True}).encode(),
          headers={"Content-Type": "application/json"})
      with urllib.request.urlopen(req, timeout=120) as resp:
        events = [json.loads(line) for line in resp]
    finally:
      srv.close()
    assert events[-1].get("done")
    streamed = [t for e in events for t in e.get("tokens", [])]
    results[draft_len] = (plain["tokens"], streamed,
                          max(len(e.get("tokens", [])) for e in events))
  assert results[3][:2] == results[0][:2]
  assert len(results[3][0]) == 7 and len(results[3][1]) == 12
  assert results[3][2] > results[0][2]  # a tick's several tokens an event


# -- on the card -----------------------------------------------------------------


@requires_cuda
@pytest.mark.parametrize("shape", [(2, 8, 2560), (8, 8, 2560), (3, 5, 96)])
def test_carry_walk_bits_cuda(shape):
  """The fp32-carry walk on the card: its float32 y equals the plain loop's
  bit for bit, and its bf16 cast equals the bf16 walk's y."""
  dev = torch.device("cuda")
  g = torch.Generator(dev).manual_seed(0)
  x = torch.randn(shape, device=dev, generator=g).bfloat16()
  a = torch.rand(shape, device=dev, generator=g).bfloat16()
  h0 = torch.randn(shape[0], shape[2], device=dev, generator=g)
  before = lru_scan.carry_launches
  y, h = lru_scan.lru_scan_carries(x, a, h0)
  assert lru_scan.carry_launches == before + 1
  want_y, want_h = lru_scan.lru_scan_plain(x, a, h0, y_in_acc_dtype=True)
  assert y.dtype == torch.float32
  assert torch.equal(y, want_y) and torch.equal(h, want_h)
  assert torch.equal(y.bfloat16(), lru_scan.lru_scan_forward(x, a, h0)[0])


@requires_cuda
@pytest.mark.parametrize("categorical", [False, True])
def test_captured_matches_eager_speculation_cuda(categorical):
  """A small float32 Griffin with the fused epilogue (as
  ``test_torch_port_sampler_graph.py``'s): each verify step one replay of
  the captured step against eager steps, identical tokens, steps and (for
  categorical) generator state; eager, two fp32-carry walks a step."""
  from cadence_gemma_tpu_torch import common  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.models import griffin  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.tokenizers import SimpleVocab  # pylint: disable=import-outside-toplevel
  config = common.GriffinConfig(
      vocab_size=512, width=128, mlp_expanded_width=256, num_heads=2,
      block_types=(common.TemporalBlockType.RECURRENT,
                   common.TemporalBlockType.ATTENTION,
                   common.TemporalBlockType.RECURRENT),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=16,
      logits_soft_cap=30.0, lru_width=128)
  vocab = SimpleVocab([f"w{i}" for i in range(508)])
  rng = np.random.default_rng(3)
  prompts = [" ".join(f"w{i}" for i in rng.integers(0, 508, n))
             for n in (40, 27)]
  dev = torch.device("cuda")
  model = griffin.Griffin(config, device=dev, dtype=torch.float32,
                          generator=torch.Generator(dev).manual_seed(0),
                          fused_epilogue=True)
  kw = dict(deterministic_sampling=False, temperature=0.8) if categorical \
      else {}
  runs = []
  for jit_compile in (True, False):
    s = sampler_lib.Sampler(model, vocab, jit_compile=jit_compile, **kw)
    spec = speculative.SpeculativeSampler(s, draft_len=7, ngram=2)
    gen = torch.Generator(dev).manual_seed(3) if categorical else None
    before = lru_scan.carry_launches
    out = spec(prompts, 24, generator=gen)
    runs.append(([t.tolist() for t in out.tokens], spec.last_stats,
                 None if gen is None else gen.get_state()))
    if not jit_compile:
      assert (lru_scan.carry_launches - before
              == 2 * spec.last_stats["verify_steps"])
  assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
  if categorical:
    assert torch.equal(runs[0][2], runs[1][2])
