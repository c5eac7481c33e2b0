"""The PyTorch port's image-conditioned generation vs the JAX package.

The golden fixture's tiny Griffin (``p[...]`` weights, its connector
included) and tiny encoder (``v[...]``) run in both packages on the CPU in
float32: the connector and the image splice, the fused residual add +
RMSNorm epilogue (JAX's Pallas kernel in interpret mode), the Sampler with
image features, and the ``ModalSampler`` golden, which must reproduce the
fixture's multimodal tokens exactly and its logits within the text golden's
2e-4. Float32 on both sides differs only in summation order.
"""

import os

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from cadence_gemma_tpu.inference import sampler as jsampler
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.ops import fused_epilogue as jfused
import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.inference import modal_sampler
from cadence_gemma_tpu_torch.inference import sampler
from cadence_gemma_tpu_torch.ops import fused_epilogue
from tests import make_golden_fixture as gold

DOG = os.path.join(os.path.dirname(gold.FIXTURE), "dog.jpg")
TOL = dict(atol=1e-4, rtol=1e-4)
GOLDEN_ATOL = 2e-4  # the text golden's (test_torch_port_sampler.py)
TOKENS = np.array([[1, 5, 9, 3, 7, 2], [1, 4, 8, 10, 6, 11]], np.int32)


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types
  )
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


def _port_tower(config):
  return port.ViTConfig(**{f: getattr(config, f)
                           for f in port.ViTConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def golden():
  """(npz, JAX vocab, tower config, JAX config, numpy params, vparams)."""
  jvocab, tower, _, jconfig, _ = gold.build()
  return (np.load(gold.FIXTURE), jvocab, tower, jconfig,
          convert.read_npz_params(gold.FIXTURE, "p"),
          convert.read_npz_params(gold.FIXTURE, "v"))


def _models(golden, fused_epilogue=False):
  _, _, _, jconfig, params, _ = golden
  jmodel = jgriffin.Griffin(jconfig, dtype=jnp.float32,
                            param_dtype=jnp.float32,
                            gradient_checkpointing=False,
                            fused_epilogue=fused_epilogue)
  tmodel = convert.griffin_from_flax_params(
      params, _port_config(jconfig), device="cpu", dtype=torch.float32,
      fused_epilogue=fused_epilogue,
  )
  return jmodel, tmodel


def _image(config, batch=2, seed=0):
  rng = np.random.default_rng(seed)
  return rng.standard_normal(
      (batch, config.vision_tokens, config.vision_width), dtype=np.float32)


def test_converter_carries_the_connector_and_conv_kernels(golden):
  npz, _, tower, _, params, vparams = golden
  _, tmodel = _models(golden)
  state = tmodel.state_dict()
  np.testing.assert_array_equal(
      state["vl_connector.ffw_down.kernel"].numpy(),
      npz["p['vl_connector']['ffw_down']['kernel']"].T)
  np.testing.assert_array_equal(
      state["vl_connector.ffw_up.w"].numpy(),
      npz["p['vl_connector']['ffw_up']['w']"])
  enc = convert.encoder_from_flax_params(
      vparams, _port_tower(tower), _port_tower(tower), device="cpu",
      dtype=torch.float32)
  hwio = npz["v['dino']['patch_embed']['kernel']"]
  np.testing.assert_array_equal(
      enc.state_dict()["dino.patch_embed.kernel"].numpy(),
      hwio.transpose(3, 2, 0, 1))
  with pytest.raises(ValueError, match="2-D or 4-D"):
    convert.state_dict_from_flax({"x": {"kernel": np.zeros((2, 2, 2))}})


@pytest.mark.parametrize("fused", [False, True])
@torch.no_grad()
def test_splice_prefill_and_decode_match_jax(golden, fused):
  """Connector, splice and positions through the prefill, then decode steps
  from the cache; with fused=True every block's epilogue goes through JAX's
  Pallas kernel (interpret mode) and the port's fused path."""
  _, _, _, jconfig, params, _ = golden
  jmodel, tmodel = _models(golden, fused)
  image = _image(jconfig)
  pos = np.tile(np.arange(TOKENS.shape[1], dtype=np.int32), (2, 1))
  v = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
  apply = jax.jit(jmodel.apply)  # one compile serves every decode step
  with pltpu.force_tpu_interpret_mode():
    logits_j, cache_j = apply(v, jnp.asarray(TOKENS), jnp.asarray(pos),
                              image=jnp.asarray(image))
  before = fused_epilogue.launches
  logits_t, cache_t = tmodel(torch.tensor(TOKENS).long(), torch.tensor(pos),
                             image=torch.tensor(image))
  assert fused_epilogue.launches == before  # CPU: the plain version
  n = jconfig.vision_tokens
  assert logits_t.shape == (2, TOKENS.shape[1] + n, jconfig.vocab_size)
  np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)

  next_pos = pos[:, -1:] + 1 + n
  token = TOKENS[:, -1:]
  for _ in range(3):
    with pltpu.force_tpu_interpret_mode():
      logits_j, cache_j = apply(v, jnp.asarray(token), jnp.asarray(next_pos),
                                cache_j)
    logits_t, cache_t = tmodel(torch.tensor(token).long(),
                               torch.tensor(next_pos), cache_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    token = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)
    next_pos = next_pos + 1


def test_splice_rejects_a_mismatched_feature_width(golden):
  _, tmodel = _models(golden)
  image = torch.zeros(1, 4, tmodel.config.vision_width + 1)
  with pytest.raises(ValueError, match="vision_width"):
    tmodel(torch.tensor(TOKENS[:1]).long(),
           torch.arange(TOKENS.shape[1])[None], image=image)


@pytest.mark.parametrize("shape", [(2, 3, 256), (1, 1, 2560), (5, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_rmsnorm_matches_jax(shape, dtype):
  """Forward against JAX's kernel (interpret mode) and its reference; the
  backward against jax.vjp of the custom_vjp."""
  rng = np.random.default_rng(1)
  x, r = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
  s = 0.1 * rng.standard_normal(shape[-1], dtype=np.float32)
  jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
  jx, jr = jnp.asarray(x, jdt), jnp.asarray(r, jdt)
  with pltpu.force_tpu_interpret_mode():
    y_j, normed_j = jfused.fused_add_rmsnorm(jx, jr, jnp.asarray(s))
  y_ref, normed_ref = jfused.reference_add_rmsnorm(jx, jr, jnp.asarray(s))
  tx, tr = torch.tensor(x).to(tdt), torch.tensor(r).to(tdt)
  y, normed = fused_epilogue.fused_add_rmsnorm(tx, tr, torch.tensor(s))
  assert y.dtype == normed.dtype == tdt
  f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
  # The add is one rounding of the same sum on every side.
  np.testing.assert_array_equal(y.float().numpy(), f32(y_j))
  np.testing.assert_array_equal(y.float().numpy(), f32(y_ref))
  # float32 statistics summed in other orders; in bf16 the output rounding
  # may then land one bf16 ulp (2^-8 relative) apart.
  tol = TOL if dtype == "float32" else dict(atol=1e-6, rtol=2**-7)
  for want in (normed_j, normed_ref):
    np.testing.assert_allclose(normed.float().numpy(), f32(want), **tol)

  if dtype == "float32":
    g_y, g_n = (rng.standard_normal(shape, dtype=np.float32)
                for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
      _, vjp = jax.vjp(jfused.fused_add_rmsnorm, jx, jr, jnp.asarray(s))
      want = vjp((jnp.asarray(g_y), jnp.asarray(g_n)))
    inputs = [torch.tensor(z).requires_grad_() for z in (x, r, s)]
    outs = fused_epilogue.fused_add_rmsnorm(*inputs)
    got = torch.autograd.grad(outs, inputs,
                              (torch.tensor(g_y), torch.tensor(g_n)))
    for a, b in zip(got, want):
      np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("echo", [False, True])
def test_sampler_with_image_features_matches_jax(golden, quirk, echo):
  _, jvocab, _, jconfig, params, _ = golden
  jmodel, tmodel = _models(golden)
  image = _image(jconfig, seed=2)
  prompts = ["a photo of", "the red car"]  # equal lengths
  js = jsampler.Sampler(jmodel, jvocab, jax.tree_util.tree_map(
      jnp.asarray, params), bucket_prompt_lengths=False,
                        reference_position_quirk=quirk)
  want = js(prompts, total_generation_steps=5, echo=echo, return_logits=True,
            end_sampling_at_eos_token=False, img_embed=jnp.asarray(image))
  s = sampler.Sampler(tmodel, port.SimpleVocab(gold.WORDS), device="cpu",
                      reference_position_quirk=quirk)
  got = s(prompts, total_generation_steps=5, echo=echo, return_logits=True,
          end_sampling_at_eos_token=False, img_embed=torch.tensor(image))
  assert got.text == want.text
  for t, jt, l, jl in zip(got.tokens, want.tokens, got.logits, want.logits):
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    # Echoed logits cover the text tokens only: the visual ones are dropped.
    assert l.shape[0] == (4 + 5 if echo else 5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=GOLDEN_ATOL)


def test_one_token_prompt_with_image_matches_jax(golden):
  """A BOS-only prompt: the last of the spliced positions seeds decoding,
  and (as in JAX) decode positions do not skip the visual tokens."""
  _, jvocab, _, jconfig, params, _ = golden
  jmodel, tmodel = _models(golden)
  image = _image(jconfig, batch=1, seed=3)
  js = jsampler.Sampler(jmodel, jvocab, jax.tree_util.tree_map(
      jnp.asarray, params), bucket_prompt_lengths=False)
  want = js([""], total_generation_steps=4, return_logits=True,
            end_sampling_at_eos_token=False, img_embed=jnp.asarray(image))
  got = sampler.Sampler(tmodel, port.SimpleVocab(gold.WORDS), device="cpu")(
      [""], total_generation_steps=4, return_logits=True,
      end_sampling_at_eos_token=False, img_embed=torch.tensor(image))
  np.testing.assert_array_equal(got.tokens[0].numpy(),
                                np.asarray(want.tokens[0]))
  np.testing.assert_allclose(got.logits[0].numpy(),
                             np.asarray(want.logits[0]), atol=GOLDEN_ATOL)


def _modal(golden):
  _, _, tower, _, _, vparams = golden
  _, tmodel = _models(golden)
  enc = convert.encoder_from_flax_params(
      vparams, _port_tower(tower), _port_tower(tower), device="cpu",
      dtype=torch.float32)
  return modal_sampler.ModalSampler(
      tmodel, port.SimpleVocab(gold.WORDS), enc, device="cpu")


def test_modal_sampler_reproduces_the_golden(golden):
  npz = golden[0]
  out = _modal(golden)([gold.MM_PROMPT], total_generation_steps=gold.STEPS,
                       end_sampling_at_eos_token=False, img_path=DOG,
                       return_logits=True)
  np.testing.assert_array_equal(out.tokens[0].numpy(),
                                npz["expected_mm_tokens"])
  np.testing.assert_allclose(out.logits[0].numpy(), npz["expected_mm_logits"],
                             atol=GOLDEN_ATOL)


def test_modal_sampler_image_arguments(golden):
  s = _modal(golden)
  pixels = torch.tensor(s.vision_encoder.preprocess_path(DOG))
  features = s.encode(pixels)
  # Features reach the connector in bfloat16, whatever the model's dtype.
  assert features.dtype == torch.bfloat16
  torch.testing.assert_close(s.encode_image(DOG), features)
  kw = dict(total_generation_steps=3, end_sampling_at_eos_token=False,
            return_logits=True)
  by_pixels = s([gold.MM_PROMPT], pixels=pixels, **kw)
  by_embed = s([gold.MM_PROMPT], img_embed=features, **kw)
  torch.testing.assert_close(by_pixels.logits[0], by_embed.logits[0])
  with pytest.raises(ValueError, match="at most one"):
    s([gold.MM_PROMPT], img_path=DOG, pixels=pixels, **kw)
  with pytest.raises(ValueError, match="equal-length"):
    s(["a photo", "the red car"], img_embed=features.expand(2, -1, -1), **kw)
  # Grammar constraints stay refused; the prefix and state arguments are
  # checked as JAX checks them, before the encoder runs.
  with pytest.raises(NotImplementedError):
    s([gold.MM_PROMPT], constraint=object(), **kw)
  with pytest.raises(ValueError, match="prefix_state"):
    s([gold.MM_PROMPT], prefix_state=object(), pixels=pixels, **kw)
  with pytest.raises(ValueError, match="return_state"):
    s([gold.MM_PROMPT], pixels=pixels, total_generation_steps=0,
      return_state=True)
  text_only = modal_sampler.ModalSampler(s.model, s.vocab, device="cpu")
  with pytest.raises(ValueError, match="vision_encoder"):
    text_only([gold.MM_PROMPT], img_path=DOG, **kw)
