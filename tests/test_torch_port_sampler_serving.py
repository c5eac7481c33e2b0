"""The port's serving features of the Sampler vs the JAX Sampler.

Chunked prefill, the repetition penalty, per-row sampling filters and
overrides, prefix caching, conversational state and the ``ModalSampler``'s
image turn followed by text turns, on the golden fixture's tiny Griffin
(float32, window 8) in both packages on the CPU. The JAX side pads prompts
to the longest one (``bucket_prompt_lengths=False``), as the port does.
Tokens must match exactly and logits within the fixture's 2e-4 (float32 on
both sides, summed in other orders).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.inference import modal_sampler as jmodal
from cadence_gemma_tpu.inference import sampler as jsampler
import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.inference import modal_sampler
from cadence_gemma_tpu_torch.inference import sampler
from tests import make_golden_fixture as gold

ATOL = 2e-4  # the golden fixture's
DOG = os.path.join(os.path.dirname(gold.FIXTURE), "dog.jpg")
# 17 and 9 tokens with BOS: the second row is left-padded by 8.
RAGGED = ["the red car a photo of dog cart the red car a photo of dog car",
          "a photo of dog car cart the red"]
PREFIX = "the red car a photo of dog cart the"
STEPS = 6


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types
  )
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


@pytest.fixture(scope="module")
def golden():
  """(JAX vocab, JAX model, JAX params, port vocab, port model)."""
  jvocab, _, _, jconfig, jmodel = gold.build()
  params = convert.read_npz_params(gold.FIXTURE, "p")
  tmodel = convert.griffin_from_flax_params(
      params, _port_config(jconfig), device="cpu", dtype=torch.float32
  )
  jparams = jax.tree_util.tree_map(jnp.asarray, params)
  return jvocab, jmodel, jparams, port.SimpleVocab(gold.WORDS), tmodel


def _samplers(golden, **kwargs):
  jvocab, jmodel, jparams, vocab, tmodel = golden
  return (jsampler.Sampler(jmodel, jvocab, jparams,
                           bucket_prompt_lengths=False, **kwargs),
          sampler.Sampler(tmodel, vocab, device="cpu", **kwargs))


def _assert_outputs_match(got, want, logits=True):
  assert got.text == want.text
  for t, jt in zip(got.tokens, want.tokens):
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
  if logits:
    assert len(got.logits) == len(want.logits)
    for l, jl in zip(got.logits, want.logits):
      np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("chunk,echo", [
    (3, True), (4, True), (8, True), (16, True), (4, False),
])
def test_chunked_prefill_matches_jax_and_single_shot(golden, chunk, echo):
  js, ts = _samplers(golden, prefill_chunk_size=chunk)
  kw = dict(total_generation_steps=STEPS, echo=echo, return_logits=True,
            end_sampling_at_eos_token=False)
  got = ts(RAGGED, **kw)
  _assert_outputs_match(got, js(RAGGED, **kw))
  single = sampler.Sampler(ts.model, ts.vocab, device="cpu")(RAGGED, **kw)
  _assert_outputs_match(got, single)


def test_chunked_prefill_leaves_an_image_prompt_single_shot(golden):
  """The image splices in after BOS, which a chunk cannot hold: such a
  prompt prefills in one shot, with JAX's warning."""
  _, ts = _samplers(golden)
  chunked = sampler.Sampler(ts.model, ts.vocab, device="cpu",
                            prefill_chunk_size=2)
  cfg = ts.model.config
  image = torch.tensor(np.random.default_rng(5).standard_normal(
      (2, cfg.vision_tokens, cfg.vision_width), dtype=np.float32))
  kw = dict(total_generation_steps=3, return_logits=True,
            end_sampling_at_eos_token=False, img_embed=image)
  with pytest.warns(UserWarning, match="chunking was skipped"):
    got = chunked(gold.PROMPTS, **kw)
  _assert_outputs_match(got, ts(gold.PROMPTS, **kw))


def test_chunked_prefill_only_echo_matches_jax(golden):
  js, ts = _samplers(golden, prefill_chunk_size=4)
  kw = dict(total_generation_steps=0, echo=True, return_logits=True)
  _assert_outputs_match(ts(RAGGED, **kw), js(RAGGED, **kw))


@pytest.mark.parametrize("penalty", [1.3, 5.0, 1.0])
def test_repetition_penalty_matches_jax(golden, penalty):
  js, ts = _samplers(golden, repetition_penalty=penalty)
  kw = dict(total_generation_steps=8, return_logits=True,
            end_sampling_at_eos_token=False)
  got = ts(RAGGED, **kw)
  # Returned logits are the model's, before the penalty.
  _assert_outputs_match(got, js(RAGGED, **kw))
  # The penalty covers generated tokens only: echo does not change them.
  echoed = ts(RAGGED, echo=True, **kw)
  for t, e, n in zip(got.tokens, echoed.tokens, (17, 9)):
    torch.testing.assert_close(e[n:], t)
  plain = sampler.Sampler(ts.model, ts.vocab, device="cpu")(RAGGED, **kw)
  same = all(torch.equal(a, b) for a, b in zip(got.tokens, plain.tokens))
  if penalty == 1.0:
    assert same  # the identity
  elif penalty == 5.0:
    assert not same  # strong enough to break the tiny model's repeats
  with pytest.raises(ValueError, match="repetition_penalty"):
    sampler.Sampler(ts.model, ts.vocab, device="cpu", repetition_penalty=0.0)


def test_filter_logits_rows_matches_jax_bit_for_bit():
  rng = np.random.default_rng(4)
  logits = rng.standard_normal((6, 40)).astype(np.float32)
  logits[2, 9] = logits[2, 17] = logits[2].max() - 0.5  # a tie at k's edge
  temp = np.array([1.0, 0.7, 1.0, 1.0, 1.3, 0.9], np.float32)
  top_k = np.array([0, 0, 3, 0, 5, 40], np.int32)
  top_p = np.array([1.0, 1.0, 1.0, 0.6, 0.8, 0.3], np.float32)
  got = sampler.filter_logits_rows(
      torch.tensor(logits), torch.tensor(temp), torch.tensor(top_k),
      torch.tensor(top_p)).numpy()
  want = np.asarray(jsampler.filter_logits_rows(
      jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
      jnp.asarray(top_p)))
  np.testing.assert_array_equal(got, want)
  # A row at the defaults passes through; each row matches the shared
  # filter at its own settings.
  np.testing.assert_array_equal(got[0], logits[0])
  for row in range(6):
    shared = sampler.filter_logits(
        torch.tensor(logits[row:row + 1]), float(temp[row]),
        int(top_k[row]) or None, float(top_p[row]))
    np.testing.assert_array_equal(got[row:row + 1], shared.numpy())
  assert [sampler._next_bucket(n) for n in (1, 16, 17, 200)] == [
      jsampler._next_bucket(n) for n in (1, 16, 17, 200)]


def test_sampling_overrides_seed_token_matches_jax(golden):
  """The first token under per-row overrides: a logit bias, stop tokens
  masked for one row (the bias would make EOS its argmax), and filters
  that reduce to greedy (top-k 1)."""
  js, ts = _samplers(golden)
  eos = ts.vocab.eos_id()
  ids = [ts.tokenize(s) for s in gold.PROMPTS]
  tokens = np.array(ids, np.int32)
  lengths = np.array([len(i) for i in ids], np.int32)
  overrides = (
      np.array([1.0, 0.5], np.float32),       # temp
      np.array([0, 1], np.int32),             # top_k
      np.array([1.0, 0.9], np.float32),       # top_p
      np.array([False, True]),                # suppress stop tokens
      np.array([[-1], [7]], np.int32),        # extra stop columns
      np.array([[5, -1], [eos, 7]], np.int32),  # logit bias ids
      np.array([[40.0, 0.0], [60.0, 50.0]], np.float32),  # bias values
  )
  # Jitted: eager JAX would dispatch this prefill op by op, several times
  # slower.
  want = jax.jit(js._prompt_processing_fn, static_argnums=(4, 5, 6))(
      js.params, jnp.asarray(tokens), None, jnp.asarray(lengths), 4, True,
      False, None, None, None, None,
      tuple(jnp.asarray(z) for z in overrides),
  )
  with torch.inference_mode():
    got = ts._prefill(
        torch.tensor(tokens).long(), torch.tensor(lengths).long(), 4, True,
        False, None, sampling_overrides=tuple(torch.tensor(z)
                                              for z in overrides),
    )
  np.testing.assert_array_equal(got.tokens_buffer.numpy(),
                                np.asarray(want.tokens_buffer))
  first = got.tokens_buffer[:, 0].tolist()
  assert first[0] == 5 and first[1] not in (eos, 7)
  np.testing.assert_allclose(got.logits_buffer.numpy(),
                             np.asarray(want.logits_buffer), atol=ATOL)
  # Row overrides in categorical mode: top-k 1 is the biased argmax.
  cat = sampler.Sampler(ts.model, ts.vocab, device="cpu",
                        deterministic_sampling=False)
  greedy_rows = tuple(torch.tensor(z) for z in overrides)
  greedy_rows = (greedy_rows[0], torch.tensor([1, 1]), *greedy_rows[2:])
  with torch.inference_mode():
    drawn = cat._prefill(
        torch.tensor(tokens).long(), torch.tensor(lengths).long(), 4, False,
        False, torch.Generator().manual_seed(0),
        sampling_overrides=greedy_rows,
    )
  assert drawn.tokens_buffer[:, 0].tolist() == first


def test_prefix_continuation_matches_full_prompt_and_jax(golden):
  """A chunked prefix broadcast to a batch of two continuations; the
  prefix's cache is unchanged afterwards and serves a second call alike."""
  js, ts = _samplers(golden, prefill_chunk_size=4)
  kw = dict(total_generation_steps=STEPS, return_logits=True,
            end_sampling_at_eos_token=False)
  state, jstate = ts.prefill_prefix(PREFIX), js.prefill_prefix(PREFIX)
  assert state.length == jstate.length == 10
  before = [t.clone() for t in sampler._cache_leaves(state.cache)]
  suffixes = ["red car a photo of dog cart the", "a dog car cart the red car a"]
  got = ts(suffixes, prefix_state=state, **kw)
  _assert_outputs_match(got, js(suffixes, prefix_state=jstate, **kw))
  full = ts([f"{PREFIX} {s}" for s in suffixes], **kw)
  _assert_outputs_match(got, full)
  for a, b in zip(before, sampler._cache_leaves(state.cache)):
    assert torch.equal(a, b)
  again = ts(suffixes, prefix_state=state, echo=True, **kw)
  for t, e in zip(got.tokens, again.tokens):
    torch.testing.assert_close(e[8:], t)  # echo covers the continuation
  assert again.text[0].startswith("red car a photo")


def test_plan_continuation_chunks_matches_jax_and_single_shot(golden):
  """A continuation longer than the chunk, through its plan: middle chunks
  on a copy of the prefix's cache, then the sampling prefill."""
  js, ts = _samplers(golden, prefill_chunk_size=4)
  state, jstate = ts.prefill_prefix(PREFIX), js.prefill_prefix(PREFIX)
  before = [t.clone() for t in sampler._cache_leaves(state.cache)]
  suffix = ["red car a photo of dog cart the car"]
  mid, cache, final, start, tokens = ts.plan_continuation_chunks(suffix,
                                                                 state)
  jmid, _, jfinal, jstart, jtokens = js.plan_continuation_chunks(suffix,
                                                                 jstate)
  for got, want in ((tokens, jtokens), (final, jfinal), (start, jstart)):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert [m[1].tolist() for m in mid] == [np.asarray(m[1]).tolist()
                                          for m in jmid]
  assert final.shape == (1, 1) and start.tolist() == [18]
  assert all(a is not b for a, b in zip(sampler._cache_leaves(cache),
                                        sampler._cache_leaves(state.cache)))
  with torch.inference_mode():
    for tok_c, pos_c in mid:
      _, cache = ts._prefill_chunk_step(tok_c, pos_c, cache)
    planned = ts._prefill(final, None, 1, True, False, None,
                          initial_cache=cache, start_positions=start)
  single = ts(suffix, total_generation_steps=1, return_logits=True,
              prefix_state=state)
  np.testing.assert_allclose(planned.logits_buffer[0].numpy(),
                             single.logits[0].numpy(), atol=ATOL)
  for a, b in zip(before, sampler._cache_leaves(state.cache)):
    assert torch.equal(a, b)


def test_three_turn_conversation_matches_jax_and_teacher_forcing(golden):
  js, ts = _samplers(golden)
  kw = dict(total_generation_steps=4, return_logits=True,
            end_sampling_at_eos_token=False, return_state=True)
  state = jstate = None
  history = [ts.vocab.bos_id()]
  for i, prompt in enumerate(["the red car", "a photo of", "dog cart"]):
    got = ts([prompt], prefix_state=state, **kw)
    want = js([prompt], prefix_state=jstate, **kw)
    _assert_outputs_match(got, want)
    history += ts.vocab.EncodeAsIds(prompt)
    # The whole history in one call gives this turn's first logits.
    whole = ts.model(torch.tensor([history]),
                     torch.arange(len(history))[None],
                     return_cache=False, last_logits_only=True)[0].detach()
    np.testing.assert_allclose(got.logits[0][0].numpy(),
                               whole[0, 0].numpy(), atol=ATOL)
    history += got.tokens[0].tolist()
    state, jstate = got.state, want.state
    assert state.pending_token.shape == (1, 1)
    np.testing.assert_array_equal(state.length.numpy(),
                                  np.asarray(jstate.length))
    assert int(state.length[0]) == len(history) - 1


def test_it_template_pending_token_cases_match_jax(golden):
  js, ts = _samplers(golden, is_it_model=True)
  out = ts(["the red"], total_generation_steps=3, return_state=True,
           end_sampling_at_eos_token=False)
  jout = js(["the red"], total_generation_steps=3, return_state=True,
            end_sampling_at_eos_token=False)
  np.testing.assert_array_equal(out.tokens[0].numpy(),
                                np.asarray(jout.tokens[0]))
  eos = ts.vocab.eos_id()
  for pending, close in ((eos, "\n"), (7, jcommon.IT_TURN_CLOSE)):
    state = sampler.PrefixState(out.state.cache, out.state.length,
                                torch.tensor([[pending]]))
    jstate = jsampler.PrefixState(jout.state.cache, jout.state.length,
                                  jnp.asarray([[pending]], jnp.int32))
    tokens, _, start = ts.encode_continuation(["dog"], state)
    jtokens, _, jstart = js.encode_continuation(["dog"], jstate)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    # A stop token already closed the model turn: it is not doubled.
    want = [pending] + ts.vocab.EncodeAsIds(
        close + common.apply_it_formatter("dog"))
    assert tokens[0].tolist() == want
  mixed = sampler.PrefixState(
      ts._continue_from_prefix(out.state, 2), out.state.length.expand(2),
      torch.tensor([[eos], [7]]))
  with pytest.raises(ValueError, match="Mixed"):
    ts.encode_continuation(["dog", "car"], mixed)
  # A text prefix leaves the user turn open; the continuation closes it.
  tokens, _, _ = ts.encode_continuation(["dog"], ts.prefill_prefix("a"))
  assert tokens[0].tolist() == ts.vocab.EncodeAsIds(
      f"dog{common.IT_TURN_CLOSE}{common.IT_MODEL_OPEN}")


def test_prefix_and_state_errors_match_jax(golden):
  js, ts = _samplers(golden)
  state, jstate = ts.prefill_prefix(PREFIX), js.prefill_prefix(PREFIX)
  image = np.zeros((1, ts.model.config.vision_tokens,
                    ts.model.config.vision_width), np.float32)
  cases = [
      ("equal-length", dict(input_strings=["red", "red car"])),
      ("non-empty", dict(input_strings=[""])),
      ("img_embed", dict(input_strings=["red"], img_embed=image)),
  ]
  for match, kw in cases:
    for s, p, wrap in ((ts, state, torch.tensor), (js, jstate, jnp.asarray)):
      if "img_embed" in kw:
        kw = dict(kw, img_embed=wrap(kw["img_embed"]))
      with pytest.raises(ValueError, match=match):
        s(total_generation_steps=3, prefix_state=p, **kw)
  state2, jstate2 = (ts.prefill_prefix(PREFIX, batch_size=2),
                     js.prefill_prefix(PREFIX, batch_size=2))
  for s, p in ((ts, state2), (js, jstate2)):
    with pytest.raises(ValueError, match="batch"):
      s(["red", "car", "dog"], total_generation_steps=3, prefix_state=p)
    with pytest.raises(ValueError, match="return_state"):
      s(["red"], total_generation_steps=0, return_state=True)


def test_modal_sampler_image_turn_then_text_turn_matches_jax(golden):
  """Pixels encoded and prefilled once with ``return_state``, then a text
  follow-up from the returned state, in both packages."""
  jvocab, jmodel, jparams, vocab, tmodel = golden
  _, tower, enc, _, _ = gold.build()
  vparams = convert.read_npz_params(gold.FIXTURE, "v")
  ptower = port.ViTConfig(**{f: getattr(tower, f)
                             for f in port.ViTConfig.__dataclass_fields__})
  tenc = convert.encoder_from_flax_params(vparams, ptower, ptower,
                                          device="cpu", dtype=torch.float32)
  ts = modal_sampler.ModalSampler(tmodel, vocab, tenc, device="cpu")
  js = jmodal.ModalSampler(
      jmodel, jvocab, jparams, vision_encoder=enc,
      vision_params=jax.tree_util.tree_map(jnp.asarray, vparams),
      bucket_prompt_lengths=False,
  )
  pixels = np.asarray(tenc.preprocess_path(DOG))
  kw = dict(total_generation_steps=4, return_logits=True,
            end_sampling_at_eos_token=False)
  got = ts([gold.MM_PROMPT], pixels=torch.tensor(pixels), return_state=True,
           **kw)
  want = js([gold.MM_PROMPT], pixels=jnp.asarray(pixels), return_state=True,
            **kw)
  _assert_outputs_match(got, want)
  # Positions continue after the spliced visual tokens.
  assert int(got.state.length[0]) == int(want.state.length[0]) == (
      4 + tmodel.config.vision_tokens + 3)
  follow = ts(["the red car"], prefix_state=got.state, **kw)
  _assert_outputs_match(follow, js(["the red car"],
                                   prefix_state=want.state, **kw))
  with pytest.raises(ValueError, match="prefix_state"):
    ts(["the red car"], prefix_state=got.state, pixels=torch.tensor(pixels),
       **kw)
