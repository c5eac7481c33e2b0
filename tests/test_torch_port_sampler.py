"""The PyTorch port's Sampler vs the golden fixture and the JAX Sampler.

The golden fixture (``tests/fixtures/golden_tiny.npz``) pins a tiny Griffin's
weights, its greedy tokens and its per-step logits; the port reads the
weights through ``convert.read_npz_params`` and must reproduce the tokens
exactly and the logits within the fixture's own 2e-4. Everything runs in
float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu.inference import sampler as jsampler
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch import tokenizers
from cadence_gemma_tpu_torch.inference import sampler
from tests import make_golden_fixture as gold

# Prompts of 3 and 6 tokens (with BOS): the first row is left-padded by 3.
RAGGED = ["the red", "a photo of dog car"]


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types
  )
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


@pytest.fixture(scope="module")
def golden():
  """(npz, JAX vocab, JAX model, JAX params, port vocab, port model)."""
  npz = np.load(gold.FIXTURE)
  jvocab, _, _, jconfig, jmodel = gold.build()
  params = convert.read_npz_params(gold.FIXTURE, "p")
  tmodel = convert.griffin_from_flax_params(
      params, _port_config(jconfig), device="cpu", dtype=torch.float32
  )
  jparams = jax.tree_util.tree_map(jnp.asarray, params)
  return npz, jvocab, jmodel, jparams, tokenizers.SimpleVocab(gold.WORDS), tmodel


def test_read_npz_params_builds_the_fixture_config(golden):
  _, _, jmodel, jparams, _, tmodel = golden
  params = convert.read_npz_params(gold.FIXTURE, "p")
  assert set(params) == set(jparams)
  inferred = common.GriffinConfig.from_flax_params_or_variables(
      params, embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
      logits_soft_cap=30.0, scan_type=common.ScanType.LINEAR_NATIVE,
  )
  # Shapes recover everything but the vision fields, which the text-only
  # model does not read.
  want = _port_config(jmodel.config)
  assert inferred == want._replace(
      vision_tokens=inferred.vision_tokens,
      vision_width=inferred.vision_width,
      vl_expanded_width=inferred.vl_expanded_width,
  )
  assert tmodel.config == want


def test_text_decode_matches_golden(golden):
  npz, _, _, _, vocab, tmodel = golden
  s = sampler.Sampler(tmodel, vocab, device="cpu")
  out = s(gold.PROMPTS, total_generation_steps=gold.STEPS,
          end_sampling_at_eos_token=False, return_logits=True)
  np.testing.assert_array_equal(
      torch.stack(out.tokens).numpy(), npz["expected_text_tokens"]
  )
  np.testing.assert_allclose(
      torch.stack(out.logits).numpy(), npz["expected_text_logits"],
      atol=2e-4,
  )


@pytest.mark.parametrize("echo", [False, True])
def test_left_padded_batch_matches_jax_sampler(golden, echo):
  _, jvocab, jmodel, jparams, vocab, tmodel = golden
  js = jsampler.Sampler(jmodel, jvocab, jparams, bucket_prompt_lengths=False)
  want = js(RAGGED, total_generation_steps=6, echo=echo, return_logits=True,
            end_sampling_at_eos_token=False)
  got = sampler.Sampler(tmodel, vocab, device="cpu")(
      RAGGED, total_generation_steps=6, echo=echo, return_logits=True,
      end_sampling_at_eos_token=False,
  )
  assert got.text == want.text
  for t, jt in zip(got.tokens, want.tokens):
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
  # float32 on both sides; summation order differs.
  for l, jl in zip(got.logits, want.logits):
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=2e-4)


def test_prefill_only_echo_logits_match_jax(golden):
  _, jvocab, jmodel, jparams, vocab, tmodel = golden
  js = jsampler.Sampler(jmodel, jvocab, jparams, bucket_prompt_lengths=False)
  want = js(RAGGED, total_generation_steps=0, echo=True, return_logits=True)
  got = sampler.Sampler(tmodel, vocab, device="cpu")(
      RAGGED, total_generation_steps=0, echo=True, return_logits=True
  )
  for t, jt in zip(got.tokens, want.tokens):
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
  for l, jl in zip(got.logits, want.logits):
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=2e-4)


def test_stop_token_ends_decoding(golden):
  _, _, _, _, vocab, tmodel = golden
  s = sampler.Sampler(tmodel, vocab, device="cpu")
  free = s(gold.PROMPTS, total_generation_steps=gold.STEPS,
           end_sampling_at_eos_token=False)
  first = [int(t[0]) for t in free.tokens]
  stopped = sampler.Sampler(
      tmodel, vocab, device="cpu", stop_token_ids=first
  )(gold.PROMPTS, total_generation_steps=gold.STEPS)
  # Every row's first token is a stop token: no decode step runs and the
  # rest of each buffer keeps the pad id.
  for t, f in zip(stopped.tokens, first):
    assert int(t[0]) == f
    assert (t[1:] == vocab.pad_id()).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 3, None), (1.3, None, 0.8), (0.9, 4, 0.6),
])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
  rng = np.random.default_rng(0)
  logits = rng.standard_normal((3, 12)).astype(np.float32)
  logits[1, 5] = logits[1, 7]  # a tie at the top-k threshold is kept
  got = sampler.filter_logits(torch.tensor(logits), temperature, top_k, top_p)
  want = jsampler.filter_logits_rows(
      jnp.asarray(logits), jnp.full((3,), temperature),
      jnp.full((3,), top_k or 0), jnp.full((3,), top_p or 1.0),
  )
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_categorical_sampling_is_seeded_and_filtered(golden):
  _, _, _, _, vocab, tmodel = golden
  s = sampler.Sampler(tmodel, vocab, device="cpu",
                      deterministic_sampling=False, top_k=2)
  with pytest.raises(ValueError, match="Generator"):
    s(gold.PROMPTS, total_generation_steps=4)

  def run(seed):
    return s(gold.PROMPTS, total_generation_steps=8,
             generator=torch.Generator().manual_seed(seed),
             end_sampling_at_eos_token=False, return_logits=True)

  a, b = run(3), run(3)
  for ta, tb, la in zip(a.tokens, b.tokens, a.logits):
    torch.testing.assert_close(ta, tb)
    # Each sampled token is one of the two most likely at its step.
    top2 = torch.topk(la, 2, dim=-1).indices
    assert (top2 == ta[:, None]).any(dim=-1).all()
