"""The port's ContinuousBatcher vs the JAX batcher and vs its own solo Sampler.

On the CPU, with ``tests/test_serving.py``'s tiny Griffin (width 16, an R
and an A block, window 8, float32): the JAX params carried over with
``griffin_from_flax_params``. Against JAX's ``ContinuousBatcher``, the same
requests and join schedule, driven by the same ``step`` sizes, must give
identical greedy tokens (plain, per-request sampling, chunked admission,
prefix admission, a two-turn chat whose states' caches agree within 1e-5,
an image request through the golden fixture's tiny towers) and recorded
log-probabilities within 1e-5 (float32 on both sides, summed in other
orders). Against the port's own solo ``Sampler``, the JAX file's invariants:
a request's tokens do not depend on when it joined, on its neighbors or on
the step size; categorical requests, drawn from their own
``torch.Generator``, match a batch-1 solo call seeded alike and leave the
generator where that call does. A tensor-parallel sampler serves (held to
JAX's in ``test_torch_port_tensor_parallel.py``); the grammar registry runs
(held to JAX's batcher in ``test_torch_port_constrain.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.inference import modal_sampler as jmodal
from cadence_gemma_tpu.inference import sampler as jsampler
from cadence_gemma_tpu.inference import serving as jserving
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.tokenizers import SimpleVocab as JaxVocab
import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.inference import modal_sampler
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.models import griffin
from tests import make_golden_fixture as gold

WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
LP_ATOL = 1e-5
CACHE_ATOL = 1e-5
LONG = "alpha beta gamma delta eps zeta eta theta alpha beta"


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types
  )
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


class Pair:
  """The tiny model in both packages, and a way to build samplers."""

  def __init__(self):
    self.jvocab = JaxVocab(WORDS)
    self.vocab = port.SimpleVocab(WORDS)
    config = jcommon.GriffinConfig(
        vocab_size=self.jvocab.GetPieceSize(), width=16,
        mlp_expanded_width=32, num_heads=2,
        block_types=(jcommon.TemporalBlockType.RECURRENT,
                     jcommon.TemporalBlockType.ATTENTION),
        embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
        logits_soft_cap=30.0, lru_width=16,
        scan_type=jcommon.ScanType.LINEAR_NATIVE,
    )
    self.jmodel = jgriffin.Griffin(config, dtype=jnp.float32,
                                   param_dtype=jnp.float32,
                                   gradient_checkpointing=False)
    # Seeded normal weights in the JAX tree's shapes: the initializer's
    # scales leave a model this small repeating its last prompt token.
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(self.jmodel.init, jax.random.PRNGKey(0),
                            jnp.ones((1, 4), jnp.int32),
                            jnp.arange(4)[None])["params"]
    params = jax.tree_util.tree_map(
        lambda x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32),
        shapes)
    self.jparams = jax.tree_util.tree_map(jnp.asarray, params)
    self.model = convert.griffin_from_flax_params(
        params, _port_config(config), device="cpu", dtype=torch.float32)
    self.sampler = self.port_sampler()
    self._jax = {}

  def port_sampler(self, **kwargs):
    return sampler_lib.Sampler(self.model, self.vocab, device="cpu", **kwargs)

  def jax_sampler(self, **kwargs):
    key = tuple(sorted(kwargs.items()))
    if key not in self._jax:  # one sampler a config: JAX reuses its programs
      self._jax[key] = jsampler.Sampler(
          self.jmodel, self.jvocab, self.jparams,
          bucket_prompt_lengths=False, **kwargs)
    return self._jax[key]


@pytest.fixture(scope="module")
def pair():
  return Pair()


def _batcher(sampler, num_slots=2, steps=8, **kwargs):
  return serving.ContinuousBatcher(sampler, num_slots=num_slots,
                                   max_steps_default=steps, device="cpu",
                                   **kwargs)


def _solo(sampler, prompt, steps, **kwargs):
  return sampler([prompt], total_generation_steps=steps,
                 **kwargs).tokens[0].tolist()


def _check(got, solo_tokens, steps, eos_id):
  """The batcher's tokens are a prefix of the solo run, of the right length
  (the solo buffer pads after a stop; the batcher stops writing)."""
  assert got == list(solo_tokens[:len(got)]), (got, list(solo_tokens))
  assert len(got) == steps or got[-1] == eos_id, (got, steps)


# -- against JAX's ContinuousBatcher ------------------------------------------


def _drive(batcher, schedule, to_port):
  """Runs a join schedule; returns {name: tokens} and the batcher."""
  names, results = {}, {}
  for op in schedule:
    if op[0] == "add":
      _, name, prompt, kwargs = op
      kwargs = {k: to_port(v) if k == "prefix_state" else v
                for k, v in kwargs.items()}
      names[batcher.add_request(prompt, **kwargs)] = name
    elif op[0] == "step":
      batcher.step(op[1])
    else:  # drain
      for rid, tokens, _ in batcher.run_until_drained(op[1]):
        results[names[rid]] = list(tokens)
  return results


PLAIN = [("add", "a", "alpha beta gamma", {}),
         ("step", 3),
         ("add", "b", "delta eps", {"max_steps": 12}),
         ("drain", 4),
         ("add", "c", "zeta eta", {}),
         ("drain", 4)]

BIAS_TOKEN = 9  # "zeta"
PER_REQUEST = [
    ("add", "penalty", "alpha beta", {"repetition_penalty": 1.8}),
    ("step", 2),
    ("add", "bias", "gamma delta", {"logit_bias": {BIAS_TOKEN: 3.0,
                                                   4: -2.0}}),
    ("drain", 4),
    # Greedy "zeta eta" emits EOS first: min_tokens holds it off.
    ("add", "min", "zeta eta", {"min_tokens": 4,
                                "stop_token_ids": [BIAS_TOKEN, 10]}),
    ("drain", 3),
]

CHUNKED = [("add", "short", "alpha", {}),
           ("step", 2),
           ("add", "long", LONG, {"max_steps": 6}),
           ("drain", 1)]

CASES = {
    "plain": (dict(), dict(), PLAIN),
    "per_request_sampling": (dict(), dict(per_request_sampling=True),
                             PER_REQUEST),
    "chunked": (dict(prefill_chunk_size=4),
                dict(admission_chunks_per_tick=1), CHUNKED),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_jax_batcher(pair, case):
  sampler_kw, batcher_kw, schedule = CASES[case]
  jb = jserving.ContinuousBatcher(pair.jax_sampler(**sampler_kw),
                                  num_slots=2, max_steps_default=8,
                                  **batcher_kw)
  tb = _batcher(pair.port_sampler(**sampler_kw), **batcher_kw)
  want = _drive(jb, schedule, None)
  got = _drive(tb, schedule, None)
  assert got == want
  assert len(got) == sum(op[0] == "add" for op in schedule)


def test_prefix_admission_matches_jax_batcher(pair):
  schedule = [("add", "free", "zeta", {}),
              ("add", "p1", "delta eps", {"prefix_state": None}),
              ("step", 2),
              ("add", "p2", "theta", {"prefix_state": None}),
              ("drain", 2)]
  got = []
  for s, b in ((pair.jax_sampler(),
                jserving.ContinuousBatcher(pair.jax_sampler(), num_slots=3,
                                           max_steps_default=6)),
               (pair.sampler, _batcher(pair.sampler, num_slots=3, steps=6))):
    state = s.prefill_prefix("alpha beta gamma")
    got.append(_drive(b, schedule, lambda _: state))
  assert got[0] == got[1]


def _cache_arrays(cache):
  if isinstance(cache, dict) and all(
      isinstance(v, tuple) for v in cache.values()) and any(
          isinstance(l, torch.Tensor) for v in cache.values() for l in v):
    return [t.numpy() for t in sampler_lib._cache_leaves(cache)]
  return [np.asarray(l) for l in jax.tree_util.tree_leaves(cache)]


def test_two_turn_chat_matches_jax_batcher(pair):
  js, ts = pair.jax_sampler(), pair.sampler
  results, states = [], []
  for b in (jserving.ContinuousBatcher(js, num_slots=2, max_steps_default=6,
                                       preserve_states=True),
            _batcher(ts, steps=6, preserve_states=True)):
    r1 = b.add_request("alpha beta", return_state=True)
    b.add_request("zeta eta theta")  # a live neighbor
    turn1 = {r: list(t) for r, t, _ in b.run_until_drained(2)}
    state = b.take_state(r1)
    r2 = b.add_request("gamma", prefix_state=state, return_state=True)
    b.add_request("delta eps")
    turn2 = {r: list(t) for r, t, _ in b.run_until_drained(2)}
    results.append((turn1, turn2))
    states.append((state, b.take_state(r2)))
  assert results[0] == results[1]
  for jstate, tstate in zip(*states):
    np.testing.assert_array_equal(tstate.length.numpy(),
                                  np.asarray(jstate.length))
    np.testing.assert_array_equal(tstate.pending_token.numpy(),
                                  np.asarray(jstate.pending_token))
    for t, j in zip(_cache_arrays(tstate.cache), _cache_arrays(jstate.cache)):
      assert t.shape == j.shape
      np.testing.assert_allclose(t, j, atol=CACHE_ATOL)


def test_record_logprobs_match_jax_batcher(pair):
  records = []
  for b in (jserving.ContinuousBatcher(pair.jax_sampler(), num_slots=2,
                                       max_steps_default=6,
                                       record_logprobs=3),
            _batcher(pair.sampler, steps=6, record_logprobs=3)):
    rids = [b.add_request(p) for p in ("alpha beta", "gamma delta eps")]
    tokens = {r: list(t) for r, t, _ in b.run_until_drained(2)}
    records.append([(tokens[r], b.take_logprobs(r)) for r in rids])
  for (jt, jrec), (tt, trec) in zip(*records):
    assert tt == jt
    assert trec["top_ids"] == jrec["top_ids"]
    for key in ("token_logprobs", "top_logprobs"):
      np.testing.assert_allclose(trec[key], jrec[key], atol=LP_ATOL)


@pytest.fixture(scope="module")
def golden_pair():
  """The golden fixture's model and tiny towers in both packages."""
  jvocab, tower, enc, jconfig, jmodel = gold.build()
  params = convert.read_npz_params(gold.FIXTURE, "p")
  vparams = convert.read_npz_params(gold.FIXTURE, "v")
  ptower = port.ViTConfig(**{f: getattr(tower, f)
                             for f in port.ViTConfig.__dataclass_fields__})
  tmodel = convert.griffin_from_flax_params(
      params, _port_config(jconfig), device="cpu", dtype=torch.float32)
  tenc = convert.encoder_from_flax_params(vparams, ptower, ptower,
                                          device="cpu", dtype=torch.float32)
  ts = modal_sampler.ModalSampler(tmodel, port.SimpleVocab(gold.WORDS), tenc,
                                  device="cpu")
  js = jmodal.ModalSampler(
      jmodel, jvocab, jax.tree_util.tree_map(jnp.asarray, params),
      vision_encoder=enc,
      vision_params=jax.tree_util.tree_map(jnp.asarray, vparams),
      bucket_prompt_lengths=False,
  )
  rng = np.random.default_rng(3)
  pixels = rng.uniform(size=(1, 3, tower.image_size, tower.image_size))
  return js, ts, pixels.astype(np.float32)


def test_image_request_matches_jax_batcher(golden_pair):
  js, ts, pixels = golden_pair
  got = []
  for b, px in ((jserving.ContinuousBatcher(js, num_slots=2,
                                            max_steps_default=6),
                 jnp.asarray(pixels)),
                (_batcher(ts, steps=6), torch.tensor(pixels))):
    r_text = b.add_request("the red car")
    b.step(2)
    r_img = b.add_request(gold.MM_PROMPT, pixels=px)
    res = {r: list(t) for r, t, _ in b.run_until_drained(2)}
    got.append((res[r_text], res[r_img]))
  assert got[1] == got[0]
  timg = got[1][1]
  solo = ts([gold.MM_PROMPT], total_generation_steps=6,
            pixels=torch.tensor(pixels))
  _check(timg, solo.tokens[0].tolist(), 6, ts.vocab.eos_id())


# -- against the port's own solo Sampler ------------------------------------


class TestContinuousBatching:

  def test_single_request_matches_solo(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    b = _batcher(s)
    rid = b.add_request("alpha beta", max_steps=8)
    results = b.run_until_drained(step_size=3)
    assert [r[0] for r in results] == [rid]
    _check(results[0][1], _solo(s, "alpha beta", 8), 8, eos)

  @pytest.mark.parametrize("slots,step_size", [(4, 2), (3, 5)])
  def test_concurrent_requests_match_solo(self, pair, slots, step_size):
    s, eos = pair.sampler, pair.vocab.eos_id()
    b = _batcher(s, num_slots=slots)
    prompts = ["alpha beta", "gamma delta eps", "zeta"][:slots]
    ids = {b.add_request(p): p for p in prompts}
    results = {r: t for r, t, _ in b.run_until_drained(step_size)}
    assert set(results) == set(ids)
    for rid, prompt in ids.items():
      _check(results[rid], _solo(s, prompt, 8), 8, eos)

  def test_midflight_join_does_not_perturb(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    b = _batcher(s, steps=10)
    r1 = b.add_request("alpha beta gamma")
    b.step(3)
    r2 = b.add_request("delta eps")
    results = {r: t for r, t, _ in b.run_until_drained(4)}
    for rid, prompt in ((r1, "alpha beta gamma"), (r2, "delta eps")):
      _check(results[rid], _solo(s, prompt, 10), 10, eos)

  def test_slot_reuse_after_finish(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    b = _batcher(s, num_slots=1, steps=4)
    r1 = b.add_request("alpha theta eta zeta eps delta gamma beta", max_steps=6)
    assert b.run_until_drained(2)[0][0] == r1
    # The freed slot (its longer occupant's ring and carry overwritten)
    # serves a new request exactly.
    r2 = b.add_request("beta gamma")
    second = b.run_until_drained(2)
    assert second[0][0] == r2
    _check(second[0][1], _solo(s, "beta gamma", 4), 4, eos)

  def test_step_size_is_irrelevant(self, pair):
    outs = []
    for n in (1, 5):
      b = _batcher(pair.sampler, steps=6)
      b.add_request("zeta eta")
      outs.append(b.run_until_drained(n)[0][1])
    assert outs[0] == outs[1]

  def test_capacity_enforced(self, pair):
    b = _batcher(pair.sampler, num_slots=1, steps=4)
    b.add_request("alpha")
    with pytest.raises(RuntimeError, match="slots busy"):
      b.add_request("beta")

  def test_categorical_requires_generator(self, pair):
    b = _batcher(pair.port_sampler(deterministic_sampling=False),
                 num_slots=1)
    with pytest.raises(ValueError, match="rng"):
      b.add_request("alpha")

  def test_categorical_reproducible_across_topologies(self, pair):
    """A request's draws depend on its own generator alone: not on its
    neighbors, their seeds, when it joined or the slot count."""
    s2 = pair.port_sampler(deterministic_sampling=False, temperature=0.9,
                           top_k=6)
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    solo = _batcher(s2, num_slots=1)
    rid = solo.add_request("beta gamma", generator=gen(42))
    want = {r: t for r, t, _ in solo.run_until_drained(4)}[rid]
    for slots, neighbors in ((3, (7, 9)), (4, (1, 2))):
      crowded = _batcher(s2, num_slots=slots)
      crowded.add_request("alpha", generator=gen(neighbors[0]))
      crowded.step(3)  # the target request joins a running batch
      rid2 = crowded.add_request("beta gamma", generator=gen(42))
      crowded.add_request("delta eps zeta", generator=gen(neighbors[1]))
      got = {r: t for r, t, _ in crowded.run_until_drained(2)}[rid2]
      assert got == want, (got, want)

  def test_budget_growth(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    b = _batcher(s, steps=4)
    b.add_request("alpha", max_steps=4)
    r_long = b.add_request("beta gamma delta", max_steps=40)
    results = {r: t for r, t, _ in b.run_until_drained(8)}
    assert b._buffer_len == 64
    _check(results[r_long], _solo(s, "beta gamma delta", 40), 40, eos)


@pytest.mark.parametrize("prompt,seed", [("beta gamma", 123),
                                         ("alpha delta eps", 5)])
def test_categorical_matches_batch1_solo(pair, prompt, seed):
  """A slot reproduces a batch-1 solo call from a generator seeded alike,
  and leaves the request's generator where that call leaves it."""
  s2 = pair.port_sampler(deterministic_sampling=False, temperature=0.9)
  solo_gen = torch.Generator().manual_seed(seed)
  want = s2([prompt], total_generation_steps=8, generator=solo_gen)
  b = _batcher(s2, num_slots=2)
  b.add_request("gamma zeta", generator=torch.Generator().manual_seed(1))
  b.step(2)
  gen = torch.Generator().manual_seed(seed)
  rid = b.add_request(prompt, generator=gen)
  got = {r: t for r, t, _ in b.run_until_drained(3)}[rid]
  _check(got, want.tokens[0].tolist(), 8, pair.vocab.eos_id())
  assert torch.equal(gen.get_state(), solo_gen.get_state())


class TestSamplerControlsInBatcher:

  def test_stop_token_matches_solo(self, pair):
    s = pair.sampler
    ref = _solo(s, "alpha beta", 8)
    stop_id = int(ref[2])
    s2 = pair.port_sampler(stop_token_ids=[stop_id])
    solo = _solo(s2, "alpha beta", 8)
    b = _batcher(s2)
    rid = b.add_request("alpha beta")
    got = {r: t for r, t, _ in b.run_until_drained(4)}[rid]
    assert got[-1] == stop_id
    assert got == solo[:len(got)]

  def test_repetition_penalty_matches_solo(self, pair):
    s2 = pair.port_sampler(repetition_penalty=5.0)
    b = _batcher(s2)
    rid = b.add_request("alpha beta")
    got = {r: t for r, t, _ in b.run_until_drained(4)}[rid]
    _check(got, _solo(s2, "alpha beta", 8), 8, pair.vocab.eos_id())

  def test_validates_steps(self, pair):
    b = _batcher(pair.sampler, num_slots=1)
    with pytest.raises(ValueError, match="max_steps"):
      b.add_request("alpha", max_steps=0)


class TestLogitBias:

  def test_negative_bias_bans_a_token(self, pair):
    ref = _solo(pair.sampler, "alpha beta", 8)
    banned = int(ref[0])
    b = _batcher(pair.sampler, per_request_sampling=True)
    rid = b.add_request("alpha beta", logit_bias={banned: -100.0})
    got = {r: t for r, t, _ in b.run_until_drained(4)}[rid]
    assert got and banned not in got

  def test_positive_bias_forces_a_token(self, pair):
    tok = pair.vocab.EncodeAsIds("zeta")[0]
    b = _batcher(pair.sampler, per_request_sampling=True)
    rid = b.add_request("alpha beta", max_steps=6, logit_bias={tok: 100.0})
    got = {r: t for r, t, _ in b.run_until_drained(3)}[rid]
    assert got == [tok] * 6

  def test_unbiased_neighbor_stays_identical(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    tok = pair.vocab.EncodeAsIds("zeta")[0]
    b = _batcher(s, per_request_sampling=True)
    r_free = b.add_request("gamma delta eps")
    b.step(2)
    r_bias = b.add_request("alpha beta", logit_bias={tok: 100.0})
    results = {r: t for r, t, _ in b.run_until_drained(3)}
    assert results[r_bias] == [tok] * 8
    _check(results[r_free], _solo(s, "gamma delta eps", 8), 8, eos)

  @pytest.mark.parametrize("kwargs,match", [
      (dict(logit_bias={i: 1.0 for i in range(33)}), "logit_bias entries"),
      (dict(logit_bias={1: 101.0}), r"\[-100, 100\]"),
      (dict(logit_bias={len(WORDS) + 4: 1.0}), "outside the vocabulary"),
      (dict(stop_token_ids=[1, 2, 3, 4, 5]), "per-request stop tokens"),
      (dict(min_tokens=-1), "min_tokens"),
      (dict(repetition_penalty=0.0), "repetition_penalty"),
      (dict(temperature=0.5), "categorical-sampling knobs"),
  ])
  def test_validation(self, pair, kwargs, match):
    b = _batcher(pair.sampler, per_request_sampling=True)
    with pytest.raises(ValueError, match=match):
      b.add_request("alpha", **kwargs)
    plain = _batcher(pair.sampler, num_slots=1, steps=4)
    with pytest.raises(ValueError, match="per_request_sampling"):
      plain.add_request("alpha", logit_bias={1: 1.0})


class TestProductionAdmission:

  def test_prefix_admission_matches_solo_prefix(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    pstate = s.prefill_prefix("alpha beta gamma")
    solo = _solo(s, "delta eps", 6, prefix_state=pstate)
    b = _batcher(s, steps=6)
    b.add_request("zeta")  # a neighbor without the prefix
    rid = b.add_request("delta eps", prefix_state=pstate)
    _check({r: t for r, t, _ in b.run_until_drained(2)}[rid], solo, 6, eos)

  def test_prefix_admission_shared_across_slots(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    pstate = s.prefill_prefix("alpha beta")
    before = [t.clone() for t in sampler_lib._cache_leaves(pstate.cache)]
    b = _batcher(s, num_slots=3, steps=5)
    rids = {b.add_request(p, prefix_state=pstate): p
            for p in ("gamma", "delta eps", "zeta")}
    results = {r: t for r, t, _ in b.run_until_drained(2)}
    for rid, p in rids.items():
      _check(results[rid], _solo(s, p, 5, prefix_state=pstate), 5, eos)
    for a, c in zip(before, sampler_lib._cache_leaves(pstate.cache)):
      assert torch.equal(a, c)  # the shared prefix is never written

  @pytest.mark.parametrize("per_tick", [None, 1])
  def test_chunked_admission_matches_single_shot(self, pair, per_tick):
    chunked = pair.port_sampler(prefill_chunk_size=4)
    solo = _solo(pair.sampler, LONG, 6)
    b = _batcher(chunked, steps=6, admission_chunks_per_tick=per_tick)
    rid = b.add_request(LONG)
    results = {r: t for r, t, _ in b.run_until_drained(2)}
    _check(results[rid], solo, 6, pair.vocab.eos_id())

  def test_bounded_admission_interleaves_with_decode(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    chunked = pair.port_sampler(prefill_chunk_size=4)
    b = _batcher(chunked, admission_chunks_per_tick=1)
    r1 = b.add_request("alpha")
    b.step(2)
    r2 = b.add_request(LONG, max_steps=4)
    # 11 tokens with BOS -> padded to 12, three chunks: two ticks of chunk
    # work before the newcomer starts; r1 decodes throughout.
    assert len(b._pending) == 1
    b.step(1)
    assert not b._pending[0].request.started
    b.step(1)
    b.step(1)
    assert not b._pending
    results = {r: t for r, t, _ in b.run_until_drained(2)}
    _check(results[r1], _solo(s, "alpha", 8), 8, eos)
    _check(results[r2], _solo(s, LONG, 4), 4, eos)

  def test_stream_callback_delivers_all_tokens_in_order(self, pair):
    streamed, closed = {}, []

    def cb(rid, new_tokens, done):
      streamed.setdefault(rid, []).extend(new_tokens)
      if done:
        closed.append(rid)

    b = _batcher(pair.sampler, steps=6, stream_callback=cb)
    r1 = b.add_request("alpha beta")
    r2 = b.add_request("gamma")
    results = {r: t for r, t, _ in b.run_until_drained(2)}
    assert streamed[r1] == results[r1] and streamed[r2] == results[r2]
    assert sorted(closed) == [r1, r2]

  def test_stream_callback_incremental(self, pair):
    deliveries = []
    b = _batcher(pair.sampler, num_slots=1,
                 stream_callback=lambda r, t, d: t and deliveries.append(d))
    b.add_request("alpha beta")
    b.run_until_drained(2)
    assert len(deliveries) >= 2 and not deliveries[0]


class TestChatThroughBatcher:

  def test_two_turn_chat_matches_solo(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    solo1 = s(["alpha beta"], total_generation_steps=6, return_state=True)
    solo2 = s(["gamma"], total_generation_steps=6, prefix_state=solo1.state)
    b = _batcher(s, steps=6, preserve_states=True)
    r1 = b.add_request("alpha beta", return_state=True)
    noise = b.add_request("zeta eta theta")
    res1 = {r: t for r, t, _ in b.run_until_drained(2)}
    _check(res1[r1], solo1.tokens[0].tolist(), 6, eos)
    _check(res1[noise], _solo(s, "zeta eta theta", 6), 6, eos)
    r2 = b.add_request("gamma", prefix_state=b.take_state(r1))
    b.add_request("delta eps")
    res2 = {r: t for r, t, _ in b.run_until_drained(2)}
    _check(res2[r2], solo2.tokens[0].tolist(), 6, eos)

  def test_three_turn_chain(self, pair):
    s, eos = pair.sampler, pair.vocab.eos_id()
    b = _batcher(s, steps=5, preserve_states=True)
    state, solo_state = None, None
    for prompt in ("alpha beta", "gamma", "delta"):
      solo = s([prompt], total_generation_steps=5, prefix_state=solo_state,
               return_state=True)
      solo_state = solo.state
      rid = b.add_request(prompt, prefix_state=state, return_state=True)
      res = {r: t for r, t, _ in b.run_until_drained(2)}
      _check(res[rid], solo.tokens[0].tolist(), 5, eos)
      state = b.take_state(rid)
      assert torch.equal(state.length, solo_state.length)

  def test_requires_flag_and_single_take(self, pair):
    plain = _batcher(pair.sampler, num_slots=1, steps=4)
    with pytest.raises(ValueError, match="preserve_states"):
      plain.add_request("alpha", return_state=True)
    b = _batcher(pair.sampler, num_slots=1, steps=4, preserve_states=True)
    rid = b.add_request("alpha beta", return_state=True)
    b.run_until_drained(2)
    b.take_state(rid)
    with pytest.raises(KeyError, match="No state"):
      b.take_state(rid)
    with pytest.raises(KeyError, match="No state"):
      b.take_state(999)


class TestMultimodalBatching:

  def test_image_slots_mix_with_text_and_match_solo(self, golden_pair):
    _, ts, _ = golden_pair
    eos = ts.vocab.eos_id()
    cfg = ts.model.config
    rng = np.random.default_rng(4)
    imgs = [torch.tensor(2.0 * rng.standard_normal(
        (1, cfg.vision_tokens, cfg.vision_width), dtype=np.float32))
            for _ in range(2)]
    b = _batcher(ts, num_slots=3, steps=6)
    r0 = b.add_request("the red car", img_embed=imgs[0])
    r1 = b.add_request("a photo of dog")
    b.step(2)
    r2 = b.add_request("cart the red", img_embed=imgs[1])
    res = {r: t for r, t, _ in b.run_until_drained(2)}
    for rid, prompt, img in ((r0, "the red car", imgs[0]),
                             (r1, "a photo of dog", None),
                             (r2, "cart the red", imgs[1])):
      _check(res[rid], _solo(ts, prompt, 6, img_embed=img), 6, eos)
    # The slot that served an image serves plain text next.
    rid = b.add_request("dog car")
    got = {r: t for r, t, _ in b.run_until_drained(2)}[rid]
    _check(got, _solo(ts, "dog car", 6), 6, eos)

  def test_rejects_misuse(self, golden_pair, pair):
    _, ts, pixels = golden_pair
    cfg = ts.model.config
    b = _batcher(ts, steps=4)
    img = torch.zeros(1, cfg.vision_tokens, cfg.vision_width)
    with pytest.raises(ValueError, match="at most one"):
      b.add_request("the", img_embed=img, pixels=torch.tensor(pixels))
    with pytest.raises(ValueError, match="vision_width"):
      b.add_request("the", img_embed=img.expand(2, -1, -1))
    with pytest.raises(ValueError, match="BOS"):
      b.add_request("red", prefix_state=ts.prefill_prefix("the"),
                    img_embed=img)
    text_only = _batcher(pair.sampler, steps=4)
    with pytest.raises(ValueError, match="vision_encoder"):
      text_only.add_request("alpha", pixels=torch.tensor(pixels))


class TestProgramReuse:
  """Batchers of one configuration over one sampler share their tick
  programs (on the card, the captured graphs); never across samplers or
  configurations."""

  def test_same_config_shares_and_matches_solo(self, pair):
    s = pair.port_sampler()
    b1, b2 = _batcher(s), _batcher(s)
    assert b2._programs is b1._programs
    rid = b2.add_request("alpha beta gamma")
    ((got_id, got, _),) = b2.run_until_drained(step_size=4)
    assert got_id == rid
    _check(got, _solo(s, "alpha beta gamma", 8), 8, pair.vocab.eos_id())

  @pytest.mark.parametrize("other", [dict(num_slots=3),
                                     dict(preserve_states=True),
                                     dict(record_logprobs=2),
                                     dict(reuse_programs=False)])
  def test_different_config_does_not_share(self, pair, other):
    s = pair.port_sampler()
    assert _batcher(s, **other)._programs is not _batcher(s)._programs

  def test_different_sampler_does_not_share(self, pair):
    assert (_batcher(pair.port_sampler())._programs
            is not _batcher(pair.port_sampler())._programs)


# -- what is not ported, and the grammars that are ------------------------


def _grammar(pair, pattern="(alpha|beta)+"):
  vocab = pair.vocab
  return port.TokenDFA(
      pattern, port.token_strings_from_vocab(vocab, vocab.GetPieceSize()),
      eos_id=vocab.eos_id())


def _budget(dfa):
  return (*dfa.char_dfa.trans.shape, dfa._token_atoms.shape[1])


# The features this test once held to a NotImplementedError: each runs now
# (the grammar ones, ROADMAP item 11, with the batcher keywords given here;
# serving over a mesh, item 14c, on a tensor-parallel sampler).
REFUSED = {
    "draft_len": dict(draft_len=2),
    "constraints": dict(),
    "dynamic_grammar_slots": dict(dynamic_grammar_slots=2),
    "mesh": None,
    "constraint=": dict(),
    "register_grammar": dict(),
}


@pytest.mark.parametrize("feature", list(REFUSED))
def test_left_out_features_raise_naming_their_item(pair, feature):
  """Serving over a mesh runs: a tensor-parallel sampler's batcher matches
  the solo ``Sampler`` (test_torch_port_tensor_parallel.py holds it to
  JAX's), and so does ``multi_lora`` over a tensor-parallel LoRA sampler,
  each request the solo unsharded ``Sampler``'s on its merged weights
  (test_torch_port_tp_extras.py holds it to JAX's); a grammar feature
  runs: a constrained request stays in its grammar and matches a solo
  constrained ``Sampler`` (a free neighbor the solo
  unconstrained one), and its misuse raises JAX's ``ValueError``
  (test_torch_port_constrain.py holds them to JAX's tokens)."""
  s = pair.port_sampler()
  if feature == "mesh":
    tp = pair.port_sampler(mesh=port.make_mesh(
        (1, 2), ("data", "model"), devices=["cpu"] * 2))
    batcher = _batcher(tp)
    rids = {batcher.add_request(p): p for p in ("alpha beta", LONG)}
    for rid, tokens, _ in batcher.run_until_drained(2):
      _check(tokens, _solo(s, rids[rid], 8), 8, pair.vocab.eos_id())
    lmodel = griffin.Griffin(pair.model.config, device="meta",
                             dtype=torch.float32, lora_rank=2)
    lmodel.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(5)
    drawn = lambda: {n: 0.3 * torch.randn(p.shape, generator=gen)  # noqa: E731
                     for n, p in lmodel.adapter_leaves().items()}
    base = pair.model.state_dict()
    lmodel.load_state_dict({**base, **drawn()})
    ltp = sampler_lib.Sampler(lmodel, pair.vocab, device="cpu",
                              mesh=tp.mesh)
    batcher = _batcher(ltp, multi_lora=True)
    adapters = drawn()
    rids = {batcher.add_request("alpha beta", adapters=adapters): (
        "alpha beta", adapters), batcher.add_request(LONG): (LONG, None)}
    for rid, tokens, _ in batcher.run_until_drained(2):
      prompt, own = rids[rid]
      solo = lmodel
      if own is not None:
        solo = griffin.Griffin(pair.model.config, device="meta",
                               dtype=torch.float32, lora_rank=2)
        solo.to_empty(device="cpu")
        solo.load_state_dict({**base, **own})
      _check(tokens, _solo(sampler_lib.Sampler(solo, pair.vocab,
                                               device="cpu"), prompt, 8),
             8, pair.vocab.eos_id())
    return
  dfa = _grammar(pair)
  kw = dict(REFUSED[feature])
  constraint = 0
  if feature in ("constraints", "draft_len"):
    kw["constraints"] = [dfa]
  elif feature == "dynamic_grammar_slots":
    with pytest.raises(ValueError, match="dynamic_grammar_budget"):
      _batcher(s, **kw)
    kw["dynamic_grammar_budget"] = _budget(dfa)
    constraint = dfa
  elif feature == "register_grammar":
    with pytest.raises(ValueError, match="dynamic_grammar_slots"):
      _batcher(s).register_grammar(dfa)
    kw.update(dynamic_grammar_slots=1, dynamic_grammar_budget=_budget(dfa))
    constraint = dfa
  else:  # constraint=
    with pytest.raises(ValueError, match="constraints"):
      _batcher(s).add_request("alpha", constraint=0)
    kw["constraints"] = [dfa]
    with pytest.raises(ValueError, match="registered grammars"):
      _batcher(s, **kw).add_request("alpha", constraint=1)
  b = _batcher(s, steps=6, **kw)
  if feature == "register_grammar":
    assert b.register_grammar(dfa) == b.register_grammar(_grammar(pair)) == 1
  rid = b.add_request("gamma delta", constraint=constraint)
  free = b.add_request("gamma delta")
  res = {r: t for r, t, _ in b.run_until_drained(3)}
  text = "".join(pair.vocab.DecodeIds([t]) for t in res[rid]
                 if t != pair.vocab.eos_id())
  assert dfa.is_live_prefix(text), res[rid]
  for r, c in ((rid, dfa), (free, None)):
    solo = _solo(s, "gamma delta", 6, constraint=c)
    assert res[r] == solo[:len(res[r])], (feature, res[r], solo)


def test_batcher_needs_a_card_unless_asked(pair, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    port.ContinuousBatcher(pair.sampler, num_slots=1)
  with pytest.raises(ValueError, match="sampler on cpu"):
    serving.ContinuousBatcher(pair.sampler, num_slots=1, device="meta")
