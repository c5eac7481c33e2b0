"""The PyTorch port's vision towers and MHA kernel module vs the JAX package.

The same numpy inputs and weights go through the JAX function and its
counterpart in the port, on the CPU: the MHA plain version against JAX's
``flash_mha_attention`` in Pallas interpret mode (its one-pass kernel, and
its tiled kernel forced at small ``t``), the resize, and the ViT block, the
tower and the fused encoder at tiny configurations. Float32 comparisons
differ only in summation order; bfloat16 ones also in where rounding lands.
"""

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from cadence_gemma_tpu.models import vit as jvit
from cadence_gemma_tpu.ops import pallas_attention as fa
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.models import vit
from cadence_gemma_tpu_torch.ops import mha_attention

# float32 on both sides: the same operations summed in other orders.
F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(b, t, n, h, seed=0):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal((b, t, n, h), dtype=np.float32)
          for _ in range(3)]


def _jax_mha(q, k, v, dtype):
  with pltpu.force_tpu_interpret_mode():
    out = fa.flash_mha_attention(*(jnp.asarray(z, dtype) for z in (q, k, v)))
  return np.asarray(out.astype(jnp.float32))


def _port_mha(q, k, v, dtype):
  out = mha_attention.flash_mha_attention(
      *(torch.tensor(z).to(dtype) for z in (q, k, v)))
  assert out.dtype == dtype
  return out.float().numpy()


# t = 128 fills one JAX tile; t = 77 does not.
@pytest.mark.parametrize("head_dim", [64, 72])
@pytest.mark.parametrize("t", [128, 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_plain_matches_jax_onepass_kernel(head_dim, t, dtype):
  q, k, v = _qkv(2, t, 2, head_dim)
  got = _port_mha(q, k, v, getattr(torch, dtype))
  want = _jax_mha(q, k, v, getattr(jnp, dtype))
  if dtype == "float32":
    np.testing.assert_allclose(got, want, **F32_TOL)
  else:
    # Both round exp(s - max) to bf16 against the same row max and the
    # output to bf16: they differ by at most one bf16 ulp of |out| < 2.
    np.testing.assert_allclose(got, want, atol=2**-7, rtol=0)


@pytest.mark.parametrize("head_dim", [64, 72])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_plain_matches_jax_tiled_kernel(monkeypatch, head_dim, dtype):
  """The tiled online-softmax kernel (the TPU's path for t_pad > 1024),
  forced at a small t as the JAX package's own tests force it."""
  monkeypatch.setattr(fa, "_ONEPASS_MAX_T", 0)
  monkeypatch.setattr(fa, "_ONEPASS_MAX_T_F32", 0)
  q, k, v = _qkv(1, 200, 2, head_dim, seed=1)
  got = _port_mha(q, k, v, getattr(torch, dtype))
  want = _jax_mha(q, k, v, getattr(jnp, dtype))
  if dtype == "float32":
    np.testing.assert_allclose(got, want, **F32_TOL)
  else:
    # The tiled kernel rounds exp(s - running max) to bf16, the plain
    # version against the final max: about 2^-9 apart per weight, plus the
    # output's bf16 rounding.
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_mha_backward_matches_jax():
  """The port's backward recomputes through reference_mha as _mha_bwd
  recomputes through _reference_mha."""
  q, k, v = _qkv(1, 70, 2, 72, seed=2)
  g = np.random.default_rng(3).standard_normal(q.shape, dtype=np.float32)

  def jax_loss(*qkv):
    return jnp.sum(fa.flash_mha_attention(*qkv) * g)

  with pltpu.force_tpu_interpret_mode():
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(z) for z in (q, k, v)))
  inputs = [torch.tensor(z).requires_grad_() for z in (q, k, v)]
  out = mha_attention.flash_mha_attention(*inputs)
  got = torch.autograd.grad((out * torch.tensor(g)).sum(), inputs)
  for a, b in zip(got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                               rtol=1e-4)
  ref = mha_attention.reference_mha(*(torch.tensor(z) for z in (q, k, v)))
  np.testing.assert_allclose(ref.numpy(), np.asarray(fa._reference_mha(
      *(jnp.asarray(z) for z in (q, k, v)))), **F32_TOL)


@pytest.mark.parametrize("shape,size", [((2, 3, 96, 128), 48),
                                        ((1, 3, 20, 30), 48),
                                        ((1, 3, 48, 48), 48)])
def test_preprocess_matches_jax_resize(shape, size):
  """A downsample, an upsample and the identity against jax.image.resize's
  bicubic; float32 on both sides."""
  pixels = np.random.default_rng(4).random(shape, dtype=np.float32)
  want = jvit.preprocess(jnp.asarray(pixels), jvit.DINO_MEAN, jvit.DINO_STD,
                         size)
  got = vit.preprocess(torch.tensor(pixels), vit.DINO_MEAN, vit.DINO_STD, size)
  # Normalizing by std ~0.22 scales the resize's ~1e-6 differences by ~4.
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                             rtol=0)


def _jax_config(**overrides):
  kwargs = dict(embed_dim=144, depth=3, num_heads=2, mlp_hidden_dim=64,
                patch_size=7, image_size=28, output_layer=1)
  kwargs.update(overrides)
  return jvit.ViTConfig(**kwargs)


def _port_config(config: jvit.ViTConfig) -> vit.ViTConfig:
  return vit.ViTConfig(**{f: getattr(config, f)
                          for f in vit.ViTConfig.__dataclass_fields__})


def _seeded(params, seed):
  """Every leaf redrawn from numpy, so zero and unit initializers (biases,
  LayerNorm scales, prefix tokens, LayerScale) carry signal too: kernels
  N(0, 1 / fan_in), LayerNorm scales 1 + N(0, 0.01), the rest N(0, 0.01)."""
  rng = np.random.default_rng(seed)

  def draw(path, p):
    leaf = path[-1].key
    z = rng.standard_normal(p.shape).astype(np.float32)
    if leaf == "kernel":
      return z / np.sqrt(np.prod(p.shape[:-1]))
    return (1.0 if leaf == "scale" else 0.0) + 0.1 * z

  return jax.tree_util.tree_map_with_path(draw, params)


def _load(module, params):
  convert.load_flax_params(module, params)
  return module


@pytest.mark.parametrize("layer_scale,gelu_tanh,head_dim",
                         [(True, False, 64), (False, True, 72)])
def test_vit_block_matches_jax(layer_scale, gelu_tanh, head_dim):
  config = _jax_config(embed_dim=2 * head_dim, use_layer_scale=layer_scale,
                       gelu_approximate=gelu_tanh)
  x = np.random.default_rng(5).standard_normal((2, 21, config.embed_dim),
                                               dtype=np.float32)
  jblock = jvit.ViTBlock(config, dtype=jnp.float32, param_dtype=jnp.float32)
  params = _seeded(jax.jit(jblock.init)(jax.random.PRNGKey(0),
                                       jnp.asarray(x))["params"], 6)
  want = jax.jit(jblock.apply)({"params": params}, jnp.asarray(x))
  block = _load(vit.ViTBlock(_port_config(config), device="cpu"), params)
  with torch.no_grad():
    got = block(torch.tensor(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                             rtol=1e-4)


_TOWER_CASES = [
    # (prefix tokens + LayerScale, pad_tokens_to, use_flash_attention)
    (True, 128, False),
    (True, 0, False),
    (False, 128, True),
    (True, 128, True),
]


@pytest.mark.parametrize("dino_like,pad,flash", _TOWER_CASES)
def test_vision_transformer_matches_jax(dino_like, pad, flash):
  config = _jax_config(
      embed_dim=128 if dino_like else 144,
      num_prefix_tokens=5 if dino_like else 0, use_layer_scale=dino_like,
      gelu_approximate=not dino_like,
  )
  pixels = np.random.default_rng(7).standard_normal((2, 3, 28, 28),
                                                    dtype=np.float32)
  jtower = jvit.VisionTransformer(config, dtype=jnp.float32,
                                  param_dtype=jnp.float32,
                                  use_flash_attention=flash,
                                  pad_tokens_to=pad)
  with pltpu.force_tpu_interpret_mode():
    params = _seeded(jax.eval_shape(jtower.init, jax.random.PRNGKey(1),
                                    jnp.asarray(pixels))["params"], 8)
    want = jax.jit(jtower.apply)({"params": params}, jnp.asarray(pixels))
  tower = _load(vit.VisionTransformer(
      _port_config(config), device="cpu", dtype=torch.float32,
      use_flash_attention=flash, pad_tokens_to=pad), params)
  before = mha_attention.launches
  with torch.no_grad():
    got = tower(torch.tensor(pixels))
  assert mha_attention.launches == before  # CPU: the plain version
  assert got.shape == (2, config.num_patches, config.embed_dim)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                             rtol=1e-4)


def _encoder_pair(dtype):
  dino = _jax_config(embed_dim=128, num_prefix_tokens=5, use_layer_scale=True)
  siglip = _jax_config(embed_dim=144, gelu_approximate=True)
  jenc = jvit.DinoSigLIPEncoder(dino, siglip, dtype=dtype,
                                param_dtype=jnp.float32)
  pixels = np.random.default_rng(9).random((2, 3, 40, 50), dtype=np.float32)
  params = _seeded(jax.eval_shape(jenc.init, jax.random.PRNGKey(2),
                                  jnp.asarray(pixels))["params"], 10)
  return jenc, params, pixels, _port_config(dino), _port_config(siglip)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dino_siglip_encoder_matches_jax(dtype):
  jenc, params, pixels, dino, siglip = _encoder_pair(getattr(jnp, dtype))
  want = np.asarray(jax.jit(jenc.apply)({"params": params},
                                        jnp.asarray(pixels))
                    .astype(jnp.float32))
  enc = convert.encoder_from_flax_params(params, dino, siglip, device="cpu",
                                         dtype=getattr(torch, dtype))
  with torch.no_grad():
    got = enc(torch.tensor(pixels))
  assert got.shape == (2, 16, 128 + 144) and enc.feature_width == 272
  assert got.dtype == getattr(torch, dtype)
  if dtype == "float32":
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
  else:
    # bf16 rounding at other places (bias adds, LayerNorm outputs) over two
    # blocks: relative RMS of the difference below 1%.
    diff = got.float().numpy() - want
    assert np.sqrt(np.mean(diff**2) / np.mean(want**2)) < 1e-2


def test_encoder_init_and_refusals():
  enc = vit.DinoSigLIPEncoder(
      _port_config(_jax_config(embed_dim=128, num_prefix_tokens=5,
                               use_layer_scale=True)),
      _port_config(_jax_config(embed_dim=144)), device="cpu",
      generator=torch.Generator().manual_seed(0))
  state = enc.state_dict()
  assert (state["dino.block0.ls1"] == 1e-5).all()
  assert not state["dino.prefix_tokens"].any()
  assert (state["siglip.block1.norm2.scale"] == 1).all()
  assert abs(float(state["dino.pos_embed"].std()) - 0.02) < 5e-3
  kernel = state["siglip.patch_embed.kernel"]
  assert kernel.shape == (144, 3, 7, 7)
  assert abs(float(kernel.std()) - (3 * 49) ** -0.5) < 0.02
  with torch.no_grad():
    assert torch.isfinite(enc(torch.rand(1, 3, 28, 28))).all()
  for flag in ("quantized", "act_quant", "softmax_bf16"):
    with pytest.raises(NotImplementedError, match=flag):
      vit.DinoSigLIPEncoder(device="meta", **{flag: True})


def test_presets_equal_jax():
  for name in ("SIGLIP_SO400M_384", "DINOV2_LARGE_REG4_384"):
    assert getattr(vit, name) == _port_config(getattr(jvit, name))
  assert vit.DINOV2_LARGE_REG4_384.num_patches == 729
