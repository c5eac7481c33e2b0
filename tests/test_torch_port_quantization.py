"""The port's int8 serving vs the JAX package, on the CPU.

The same numpy weights go through JAX's ``quantize_params`` and the port's:
the int8 values and float32 scales must be identical, bit for bit, and so
must ``quantize_activations``. Each int8 layer (``Dense``, ``Einsum``,
``BlockDiagonalLinear``, ``Embedder`` encode and decode, one ``ViTBlock``),
weight-only and with ``act_quant``, runs in bfloat16 on the same quantized
tree as its JAX module: int32 products are exact, outputs agree within one
bfloat16 ulp of the larger value (the two frameworks sum the weight-only
products in other orders). The whole ``Griffin(quantized=True)``, with and
without ``act_quant``, runs the golden fixture's tiny config in float32
against JAX within ``test_torch_port_model.py``'s 1e-4; the port's
``Sampler(prefill_act_quant=True)`` must give JAX's greedy tokens over 8
steps, and so must the int8 ``ModalSampler`` with int8 towers. A
``ContinuousBatcher`` over an int8 sampler gives each request its solo
tokens. JAX's own ``tests/test_quantization.py`` cases close the file.
Card tests of the CUDA kernel against its plain version are in
``test_torch_port_int8_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.inference import modal_sampler as jmodal
from cadence_gemma_tpu.inference import sampler as jsampler
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.models import layers as jlayers
from cadence_gemma_tpu.models import modules as jmodules
from cadence_gemma_tpu.models import vit as jvit
from cadence_gemma_tpu.ops import quantization as jquant
import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.checkpoint import synthetic
from cadence_gemma_tpu_torch.inference import modal_sampler
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.models import layers
from cadence_gemma_tpu_torch.models import modules
from cadence_gemma_tpu_torch.models import vit
from cadence_gemma_tpu_torch.ops import int8_matmul
from cadence_gemma_tpu_torch.ops import quantization
from tests import make_golden_fixture as gold

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)  # test_torch_port_model.py's


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


def _bf16(x: np.ndarray) -> torch.Tensor:
  return torch.tensor(x).bfloat16()


def _jax_bf16(x: np.ndarray):
  return jnp.asarray(x).astype(jnp.bfloat16)


def _within_one_ulp(got: torch.Tensor, want) -> None:
  """|got - want| <= one bfloat16 ulp of max(|got|, |want|), elementwise."""
  got = got.float().numpy()
  want = np.asarray(jnp.asarray(want).astype(jnp.float32))
  assert got.shape == want.shape
  big = np.maximum(np.abs(got), np.abs(want))
  ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
  bad = np.abs(got - want) > ulp
  assert not bad.any(), (got[bad][:5], want[bad][:5], bad.sum())


def _to_state(params) -> dict:
  return convert.state_dict_from_flax(params)


# -- quantize_tensor, quantize_params, quantize_activations -----------------


@pytest.mark.parametrize("shape,axes", [((64, 48), (0,)), ((48, 64), (1,)),
                                        ((2, 40, 24), (1,)),
                                        ((3, 16, 16), (1,))])
def test_quantize_tensor_bits_match_jax(shape, axes):
  w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
  w[0] = 0.0  # an all-zero channel takes the 1e-12 floor
  jq, js = jquant.quantize_tensor(jnp.asarray(w), axes)
  q, s = quantization.quantize_tensor(torch.tensor(w), axes)
  np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
  np.testing.assert_array_equal(s.numpy(), np.asarray(js))
  assert q.dtype == torch.int8 and s.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_bits_match_jax(dtype):
  x = 3 * np.random.default_rng(2).standard_normal((2, 7, 96)).astype(
      np.float32)
  x[1, 3] = 0.0
  jx = jnp.asarray(x).astype(getattr(jnp, dtype))
  tx = torch.tensor(x).to(getattr(torch, dtype))
  jq, js = jquant.quantize_activations(jx)
  q, s = quantization.quantize_activations(tx)
  np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
  np.testing.assert_array_equal(s.numpy(), np.asarray(js))
  assert s.shape == (2, 7, 1)


def _tiny_jax_griffin(quantized=False, act_quant=False):
  config = jcommon.GriffinConfig(
      vocab_size=64, width=32, mlp_expanded_width=96, num_heads=2,
      block_types=(jcommon.TemporalBlockType.RECURRENT,
                   jcommon.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
      logits_soft_cap=30.0, lru_width=32,
      scan_type=jcommon.ScanType.LINEAR_NATIVE,
      vision_tokens=4, vision_width=12, vl_expanded_width=20,
  )
  model = jgriffin.Griffin(config, dtype=jnp.float32,
                           param_dtype=jnp.float32,
                           gradient_checkpointing=False, quantized=quantized,
                           act_quant=act_quant)
  return config, model


@pytest.fixture(scope="module")
def tiny():
  """(JAX config, JAX model, seeded float32 flax params)."""
  config, model = _tiny_jax_griffin()
  shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 4), jnp.int32),
                          jnp.arange(4)[None])["params"]
  rng = np.random.default_rng(4)
  params = jax.tree_util.tree_map(
      lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
      shapes)
  return config, model, params


def test_quantize_params_matches_jax_leaf_for_leaf(tiny):
  """The port's quantize_params on its state dict, and on the flax tree,
  against JAX's on the same tree after conversion: same names, same bits."""
  _, _, params = tiny
  # Eager, as JAX's own tests call it: under jit XLA turns the division by
  # 127 into a product with its reciprocal, one float32 ulp off in places.
  want = _to_state(jax.tree_util.tree_map(np.asarray,
                                          jquant.quantize_params(params)))
  got = quantization.quantize_params(_to_state(params))
  from_tree = _to_state(quantization.quantize_params(params))
  assert set(got) == set(want) == set(from_tree)
  assert any(n.endswith("ffw_up.w_q") for n in got)
  assert any(n.endswith("a_gate.w_q") for n in got)
  assert "embedder.input_embedding_q" in got
  for name, value in want.items():
    for other in (got[name], from_tree[name]):
      assert other.dtype == value.dtype, name
      np.testing.assert_array_equal(other.numpy(), value.numpy(), name)


def test_quantized_tree_loads_and_names_match_quantized_model(tiny):
  """A quantized JAX tree converts into the port's quantized model: every
  name and (contraction-last) shape checked by load_flax_params."""
  config, _, params = tiny
  qparams = jquant.quantize_params(params)
  model = convert.griffin_from_flax_params(
      qparams, _port_config(config), device="cpu", dtype=torch.float32)
  assert model.quantized
  state = model.state_dict()
  assert set(state) == set(_to_state(qparams))
  w = np.asarray(qparams["blocks.0"]["mlp_block"]["ffw_up"]["w_q"])
  np.testing.assert_array_equal(
      state["blocks.0.mlp_block.ffw_up.w_q"].numpy(), w.transpose(0, 2, 1))
  with pytest.raises(ValueError, match="config"):
    convert.griffin_from_flax_params(qparams, device="cpu")


def test_quantized_bytes_half_of_bf16_at_2b():
  """The 2B's int8 state is within 1% of half its bfloat16 bytes (meta
  tensors: shapes only)."""
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1)
  bf16 = griffin.Griffin(config, device="meta").state_dict()
  int8 = quantization.quantize_params(bf16)
  ratio = quantization.quantized_bytes(int8) / (
      quantization.quantized_bytes(bf16) / 2)
  assert abs(ratio - 1) < 0.01, ratio
  model_state = griffin.Griffin(config, device="meta",
                                quantized=True).state_dict()
  assert {n: tuple(t.shape) for n, t in int8.items()} == {
      n: tuple(t.shape) for n, t in model_state.items()}


def test_int8_act_matmul_is_exact():
  rng = np.random.default_rng(3)
  xq = rng.integers(-127, 128, (5, 64)).astype(np.int8)
  q = rng.integers(-127, 128, (24, 64)).astype(np.int8)
  want = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(q).T,
                             (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
  got = quantization.int8_act_matmul(torch.tensor(xq), torch.tensor(q))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_weight_matmul_cpu_is_the_plain_version():
  rng = np.random.default_rng(5)
  a = _bf16(rng.standard_normal((3, 4, 32)).astype(np.float32))
  q = torch.tensor(rng.integers(-127, 128, (3, 16, 32)).astype(np.int8))
  scale = torch.tensor(rng.random((3, 16)).astype(np.float32))
  before = int8_matmul.launches
  got = int8_matmul.int8_weight_matmul(a, q, scale)
  assert int8_matmul.launches == before
  want = (a @ q.bfloat16().transpose(1, 2)) * scale.bfloat16()[:, None]
  torch.testing.assert_close(got, want, atol=0, rtol=0)
  # A shared activation (batch stride 0) reads one [M, K] for every batch.
  shared = a[:1].expand(3, -1, -1)
  torch.testing.assert_close(
      int8_matmul.int8_weight_matmul(shared, q, scale),
      (a[:1] @ q.bfloat16().transpose(1, 2)) * scale.bfloat16()[:, None],
      atol=0, rtol=0)


# Rows and the 2B's int8 weights [batches, n, k] (the vision-language
# connector's two included): decode (2 rows), the eight-slot tick (8) and a
# 16-row batch keep the mma.sync kernel and today's split-K; the crossover
# and above -- the text prefill (2 x 3000 rows), a QLoRA step (2 x 2777
# spliced tokens, the logits' loss chunks of 4096 rows, the connector's
# 2 x 729 visual tokens) -- go to the wgmma forward. The input gradient
# takes the wgmma kernel at every shape. Ids name the shape and the split.
SPLIT_CASES = [
    (2, 2560, 2560, 1, 7, False), (2, 256, 2560, 1, 40, False),
    (8, 256, 256, 10, 4, False), (2, 7680, 2560, 2, 1, False),
    (2, 256000, 2560, 1, 1, False), (3000, 2560, 2560, 1, 1, True),
    (2, 2560, 7680, 1, 7, False), (2, 4000, 2176, 1, 5, False),
    (2, 2560, 4000, 1, 7, False), (8, 2560, 2560, 1, 7, False),
    (16, 256000, 2560, 1, 1, False), (16, 256, 256, 10, 4, False),
    (255, 2560, 2560, 1, 1, False), (256, 2560, 2560, 1, 1, True),
    (6000, 2560, 2560, 1, 1, True), (5554, 7680, 2560, 2, 1, True),
    (5554, 256, 256, 10, 1, True), (4096, 256000, 2560, 1, 1, True),
    (1458, 4000, 2176, 1, 1, True)]


@pytest.mark.parametrize("m,n,k,batches,splits,wgmma", SPLIT_CASES,
                         ids=["-".join(map(str, c[:5])) for c in SPLIT_CASES])
def test_split_k_rule(m, n, k, batches, splits, wgmma):
  assert int8_matmul.split_k(batches, m, n, k) == splits
  assert int8_matmul.uses_wgmma(m) == wgmma


def _meta(*shape):
  return torch.empty(*shape, device="meta", dtype=torch.bfloat16)


@pytest.mark.parametrize("layout", ("dense", "ffw_up", "ffw_up_expanded",
                                    "block_diagonal", "embed", "batched"))
def test_int8_wgmma_a_layout(layout):
  """The tensor map through which the wgmma forward reads the activation,
  as the layers hand it over (``layers.py``): one [M, K] for a batch-1 or
  shared activation, the gates' heads in place as [M, H, I], a batched
  [B, M, K] otherwise; strides in bytes, multiples of 16 as TMA needs."""
  m = 6000
  x = _meta(m, 2560)
  batches, a, want = {
      "dense": (1, x.reshape(1, -1, 2560),
                (False, True, (2560, m, 1), (5120, 5120 * m))),
      "ffw_up": (2, x.reshape(1, -1, 2560),
                 (False, True, (2560, m, 1), (5120, 5120 * m))),
      "ffw_up_expanded": (2, x[None].expand(2, -1, -1),
                          (False, True, (2560, m, 1), (5120, 5120 * m))),
      "block_diagonal": (10, x.reshape(-1, 10, 256).transpose(0, 1),
                         (True, False, (256, 10, m), (512, 5120))),
      "embed": (1, _meta(1, 4096, 2560),
                (False, True, (2560, 4096, 1), (5120, 5120 * 4096))),
      "batched": (3, _meta(3, m, 2560),
                  (False, False, (2560, m, 3), (5120, 5120 * m))),
  }[layout]
  got = int8_matmul.a_layout(a, batches)
  assert (got.heads, got.shared, got.dims, got.strides) == want
  assert all(stride % 16 == 0 for stride in got.strides)


# -- the int8 layers against JAX's modules, bfloat16 -----------------------


def _quantized_dense_params(rng, d_in, d_out):
  w = rng.standard_normal((d_in, d_out)).astype(np.float32) / np.sqrt(d_in)
  q, s = jquant.quantize_tensor(jnp.asarray(w), (0,))
  return {"kernel_q": np.asarray(q), "kernel_scale": np.asarray(s),
          "bias": 0.1 * rng.standard_normal(d_out).astype(np.float32)}


@pytest.mark.parametrize("act_quant", [False, True])
def test_dense_matches_jax(act_quant):
  rng = np.random.default_rng(6)
  params = _quantized_dense_params(rng, 64, 48)
  x = rng.standard_normal((2, 5, 64)).astype(np.float32)
  jdense = jlayers.QuantizableDense(features=48, quantized=True,
                                    act_quant=act_quant, dtype=jnp.bfloat16,
                                    param_dtype=jnp.float32)
  want = jdense.apply({"params": params}, _jax_bf16(x))
  dense = layers.Dense(64, 48, device="cpu", dtype=torch.float32,
                       quantized=True, act_quant=act_quant)
  convert.load_flax_params(dense, params)
  with torch.no_grad():
    got = dense(_bf16(x))
  assert got.dtype == torch.bfloat16
  _within_one_ulp(got, want)


@pytest.mark.parametrize("act_quant", [False, True])
def test_einsum_matches_jax(act_quant):
  rng = np.random.default_rng(7)
  w = rng.standard_normal((2, 64, 96)).astype(np.float32) / 8
  q, s = jquant.quantize_tensor(jnp.asarray(w), (1,))
  params = {"w_q": np.asarray(q), "w_scale": np.asarray(s),
            "b": 0.1 * rng.standard_normal((2, 1, 1, 96)).astype(np.float32)}
  x = rng.standard_normal((2, 5, 64)).astype(np.float32)
  jein = jlayers.Einsum(w_shape=(2, 64, 96), b_shape=(2, 1, 1, 96),
                        eqn="...td,cdD->c...tD", quantized=True,
                        act_quant=act_quant, dtype=jnp.bfloat16,
                        param_dtype=jnp.float32)
  want = jein.apply({"params": params}, _jax_bf16(x))
  ein = layers.Einsum((2, 64, 96), (2, 1, 1, 96), "...td,cdD->c...tD",
                      device="cpu", dtype=torch.float32, quantized=True,
                      act_quant=act_quant)
  convert.load_flax_params(ein, params)
  with torch.no_grad():
    got = ein(_bf16(x))
  assert got.shape == (2, 2, 5, 96)
  _within_one_ulp(got, want)


def test_block_diagonal_linear_matches_jax():
  rng = np.random.default_rng(8)
  w = rng.standard_normal((4, 16, 16)).astype(np.float32) / 4
  q, s = jquant.quantize_tensor(jnp.asarray(w), (1,))
  params = {"w_q": np.asarray(q), "w_scale": np.asarray(s),
            "b": 0.1 * rng.standard_normal((4, 16)).astype(np.float32)}
  x = rng.standard_normal((2, 5, 64)).astype(np.float32)
  jbd = jlayers.BlockDiagonalLinear(width=64, num_blocks=4, quantized=True,
                                    dtype=jnp.bfloat16,
                                    param_dtype=jnp.float32)
  want = jbd.apply({"params": params}, _jax_bf16(x))
  bd = layers.BlockDiagonalLinear(64, 4, device="cpu", dtype=torch.float32,
                                  quantized=True)
  convert.load_flax_params(bd, params)
  with torch.no_grad():
    got = bd(_bf16(x))
  _within_one_ulp(got, want)


def test_embedder_encode_and_decode_match_jax():
  rng = np.random.default_rng(9)
  table = rng.standard_normal((40, 32)).astype(np.float32)
  q, s = jquant.quantize_tensor(jnp.asarray(table), (1,))
  params = {"input_embedding_q": np.asarray(q),
            "input_embedding_scale": np.asarray(s)}
  jemb = jmodules.Embedder(vocab_size=40, embed_dim=32,
                           scale_by_sqrt_dim=True, quantized=True,
                           dtype=jnp.bfloat16)
  emb = modules.Embedder(40, 32, True, device="cpu", dtype=torch.bfloat16,
                         quantized=True)
  convert.load_flax_params(emb, params)
  tokens = rng.integers(0, 40, (2, 6))
  x = rng.standard_normal((2, 3, 32)).astype(np.float32)
  want_enc = jemb.apply({"params": params}, jnp.asarray(tokens),
                        method=jemb.encode)
  want_dec = jemb.apply({"params": params}, _jax_bf16(x), method=jemb.decode)
  with torch.no_grad():
    got_enc = emb.encode(torch.tensor(tokens))
    got_dec = emb.decode(_bf16(x))
  _within_one_ulp(got_enc, want_enc)
  _within_one_ulp(got_dec, want_dec)


@pytest.mark.parametrize("act_quant,softmax_bf16", [(False, False),
                                                    (True, True)])
def test_vit_block_matches_jax(act_quant, softmax_bf16):
  config = jvit.ViTConfig(embed_dim=32, depth=1, num_heads=2,
                          mlp_hidden_dim=64, use_layer_scale=True)
  rng = np.random.default_rng(10)
  x = rng.standard_normal((2, 10, 32)).astype(np.float32)
  jblock = jvit.ViTBlock(config, dtype=jnp.bfloat16, param_dtype=jnp.float32)
  shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0),
                          _jax_bf16(x))["params"]
  def draw(path, s):
    z = rng.standard_normal(s.shape).astype(np.float32)
    leaf = path[-1].key
    if leaf == "kernel":
      return z / np.sqrt(s.shape[0])
    return (1.0 if leaf == "scale" else 0.0) + 0.1 * z

  params = jax.tree_util.tree_map_with_path(draw, shapes)
  qparams = jquant.quantize_params(params)
  jq = jvit.ViTBlock(config, dtype=jnp.bfloat16, param_dtype=jnp.float32,
                     quantized=True, act_quant=act_quant,
                     softmax_bf16=softmax_bf16)
  want = jax.jit(jq.apply)({"params": qparams}, _jax_bf16(x))
  block = vit.ViTBlock(_port_tower(config), device="cpu",
                       use_flash_attention=False, quantized=True,
                       act_quant=act_quant, softmax_bf16=softmax_bf16)
  convert.load_flax_params(block, qparams)
  with torch.no_grad():
    got = block(_bf16(x))
  # Two residual adds of bf16 outputs: compare in relative RMS beside the
  # ulp check of the first projection (the whole block rounds in bf16 at
  # other places than XLA's fusions).
  diff = got.float().numpy() - np.asarray(want.astype(jnp.float32))
  ref = np.asarray(want.astype(jnp.float32))
  assert np.sqrt(np.mean(diff**2) / np.mean(ref**2)) < 1e-2
  with torch.no_grad():
    h = block.norm1(_bf16(x))
    got_qkv = block.attn_qkv(h)
  want_qkv = jlayers.QuantizableDense(
      features=96, quantized=True, act_quant=act_quant, dtype=jnp.bfloat16,
      param_dtype=jnp.float32).apply({"params": qparams["attn_qkv"]},
                                     jnp.asarray(h.float().numpy())
                                     .astype(jnp.bfloat16))
  _within_one_ulp(got_qkv, want_qkv)


# -- the whole model and the samplers, on the golden fixture ---------------


@pytest.fixture(scope="module")
def golden_int8():
  """The golden fixture's model, int8, in both packages (float32)."""
  jvocab, tower, enc, jconfig, _ = gold.build()
  params = convert.read_npz_params(gold.FIXTURE, "p")
  vparams = convert.read_npz_params(gold.FIXTURE, "v")
  jqparams = jax.tree_util.tree_map(jnp.asarray,
                                    jquant.quantize_params(params))
  qmodel_j = jgriffin.Griffin(jconfig, dtype=jnp.float32,
                              param_dtype=jnp.float32,
                              gradient_checkpointing=False, quantized=True)
  tmodel = convert.griffin_from_flax_params(
      quantization.quantize_params(params), _port_config(jconfig),
      device="cpu", dtype=torch.float32)
  return dict(jvocab=jvocab, tower=tower, jconfig=jconfig, params=params,
              vparams=vparams, jqparams=jqparams, jmodel=qmodel_j,
              tmodel=tmodel, vocab=port.SimpleVocab(gold.WORDS))


TOKENS = np.array([[1, 5, 9, 3, 7, 2, 4, 6], [0, 0, 1, 4, 8, 10, 6, 11]],
                  np.int32)
SEG = np.maximum(np.arange(8)[None] - np.array([[0], [2]]), -1).astype(
    np.int32)


@pytest.mark.parametrize("act_quant", [False, True])
def test_griffin_logits_match_jax(golden_int8, act_quant):
  g = golden_int8
  jmodel = jgriffin.Griffin(g["jconfig"], dtype=jnp.float32,
                            param_dtype=jnp.float32,
                            gradient_checkpointing=False, quantized=True,
                            act_quant=act_quant)
  want, _ = jax.jit(jmodel.apply, static_argnames="return_cache")(
      {"params": g["jqparams"]}, jnp.asarray(TOKENS), jnp.asarray(SEG),
      return_cache=False)
  model = g["tmodel"].act_quant_view() if act_quant else g["tmodel"]
  with torch.no_grad():
    got, _ = model(torch.tensor(TOKENS).long(), torch.tensor(SEG),
                   return_cache=False)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_act_quant_view_shares_every_weight(golden_int8):
  model = golden_int8["tmodel"]
  view = model.act_quant_view()
  ptrs = [p.data_ptr() for p in model.parameters()]
  assert [p.data_ptr() for p in view.parameters()] == ptrs
  assert len(set(ptrs)) == len(ptrs)
  assert view.blocks[0].mlp_block.ffw_up.act_quant
  assert not model.blocks[0].mlp_block.ffw_up.act_quant
  s = sampler_lib.Sampler(model, golden_int8["vocab"], device="cpu",
                          prefill_act_quant=True)
  assert [p.data_ptr() for p in s._prefill_model.parameters()] == ptrs


@pytest.mark.parametrize("chunk", [None, 4])
def test_prefill_act_quant_sampler_matches_jax(golden_int8, chunk):
  g = golden_int8
  prompts = ["a photo of dog car", "the red"]
  js = jsampler.Sampler(g["jmodel"], g["jvocab"], g["jqparams"],
                        bucket_prompt_lengths=False, prefill_act_quant=True,
                        prefill_chunk_size=chunk)
  want = js(prompts, total_generation_steps=8, return_logits=True,
            end_sampling_at_eos_token=False)
  ts = sampler_lib.Sampler(g["tmodel"], g["vocab"], device="cpu",
                           prefill_act_quant=True, prefill_chunk_size=chunk)
  got = ts(prompts, total_generation_steps=8, return_logits=True,
           end_sampling_at_eos_token=False)
  for t, jt in zip(got.tokens, want.tokens):
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
  for l, jl in zip(got.logits, want.logits):
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=2e-4)


def test_prefill_runs_act_quant_and_decode_weight_only(golden_int8,
                                                       monkeypatch):
  """Every prefill forward of the act_quant sampler (each chunk too)
  quantizes activations; no decode step does."""
  g = golden_int8
  s = sampler_lib.Sampler(g["tmodel"], g["vocab"], device="cpu",
                          prefill_act_quant=True, prefill_chunk_size=4)
  calls = []
  real = quantization.quantize_activations
  monkeypatch.setattr(quantization, "quantize_activations",
                      lambda x: calls.append(x.shape) or real(x))
  counts = []
  for steps in (1, 6):
    calls.clear()
    s(["a photo of dog car cart the red"], total_generation_steps=steps,
      end_sampling_at_eos_token=False)
    counts.append(len(calls))
  # 3 chunks x (2 blocks x 4 or 5 products + the connector-free path).
  assert counts[0] > 0 and counts[1] == counts[0]
  assert all(shape[-2] == 4 for shape in calls)  # chunk-sized prefills only


@pytest.fixture(scope="module")
def golden_int8_modal(golden_int8):
  """The int8 ModalSampler in both packages: int8 towers with act_quant,
  int8 Griffin with prefill_act_quant."""
  g = golden_int8
  tower = g["tower"]
  jenc = jvit.DinoSigLIPEncoder(dino_config=tower, siglip_config=tower,
                                dtype=jnp.float32, param_dtype=jnp.float32,
                                quantized=True, act_quant=True)
  js = jmodal.ModalSampler(
      g["jmodel"], g["jvocab"], g["jqparams"], vision_encoder=jenc,
      vision_params=jax.tree_util.tree_map(
          jnp.asarray, jquant.quantize_params(g["vparams"])),
      bucket_prompt_lengths=False, prefill_act_quant=True)
  tenc = convert.encoder_from_flax_params(
      quantization.quantize_params(g["vparams"]), _port_tower(tower),
      _port_tower(tower), device="cpu", dtype=torch.float32, quantized=True,
      act_quant=True)
  ts = modal_sampler.ModalSampler(g["tmodel"], g["vocab"], tenc,
                                  device="cpu", prefill_act_quant=True)
  pixels = np.random.default_rng(3).uniform(
      size=(1, 3, tower.image_size, tower.image_size)).astype(np.float32)
  return js, ts, pixels


def test_int8_modal_sampler_matches_jax(golden_int8_modal):
  js, ts, pixels = golden_int8_modal
  want = js([gold.MM_PROMPT], total_generation_steps=8, return_logits=True,
            pixels=jnp.asarray(pixels), end_sampling_at_eos_token=False)
  got = ts([gold.MM_PROMPT], total_generation_steps=8, return_logits=True,
           pixels=torch.tensor(pixels), end_sampling_at_eos_token=False)
  assert ts.vision_encoder.dino.block0.attn_qkv.act_quant
  np.testing.assert_array_equal(got.tokens[0].numpy(),
                                np.asarray(want.tokens[0]))
  np.testing.assert_allclose(got.logits[0].numpy(),
                             np.asarray(want.logits[0]), atol=2e-4)


def test_int8_batcher_matches_solo(golden_int8, golden_int8_modal):
  g = golden_int8
  s = sampler_lib.Sampler(g["tmodel"], g["vocab"], device="cpu",
                          prefill_act_quant=True, prefill_chunk_size=4)
  batcher = serving.ContinuousBatcher(s, num_slots=2, max_steps_default=6,
                                      device="cpu",
                                      admission_chunks_per_tick=1)
  prompts = {"a": "a photo of", "b": "the red car dog cart photo",
             "c": "red"}
  ids = {batcher.add_request(prompts["a"]): "a"}
  batcher.step(2)
  ids[batcher.add_request(prompts["b"])] = "b"
  results = {ids[r]: list(t) for r, t, _ in batcher.run_until_drained(2)}
  ids = {batcher.add_request(prompts["c"]): "c"}
  results.update({ids[r]: list(t)
                  for r, t, _ in batcher.run_until_drained(2)})
  for name, prompt in prompts.items():
    solo = s([prompt], total_generation_steps=6).tokens[0].tolist()
    got = results[name]
    assert got == solo[:len(got)]
    assert len(got) == 6 or got[-1] == g["vocab"].eos_id()
  # An image request through the int8 towers, beside a text one.
  _, ts, pixels = golden_int8_modal
  b = serving.ContinuousBatcher(ts, num_slots=2, max_steps_default=6,
                                device="cpu")
  r_text = b.add_request("the red car")
  b.step(2)
  r_img = b.add_request(gold.MM_PROMPT, pixels=torch.tensor(pixels))
  res = {r: list(t) for r, t, _ in b.run_until_drained(2)}
  solo = ts([gold.MM_PROMPT], total_generation_steps=6,
            pixels=torch.tensor(pixels)).tokens[0].tolist()
  assert res[r_img] == solo[:len(res[r_img])]
  solo_text = ts(["the red car"], total_generation_steps=6).tokens[0].tolist()
  assert res[r_text] == solo_text[:len(res[r_text])]


# -- JAX's own cases (tests/test_quantization.py), ported -------------------


def test_round_trip_error_bounded():
  w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
  q, scale = quantization.quantize_tensor(w, (0,))
  assert q.dtype == torch.int8 and scale.shape == (32,)
  back = quantization.dequantize_tensor(q, scale, (0,), torch.float32)
  assert (w - back).abs().max() <= float(scale.max()) * 0.51


def test_scale_commutes_with_matmul():
  gen = torch.Generator().manual_seed(0)
  w = torch.randn(16, 8, generator=gen)
  x = torch.randn(4, 16, generator=gen)
  q, scale = quantization.quantize_tensor(w, (0,))
  pre = x @ quantization.dequantize_tensor(q, scale, (0,), torch.float32)
  post = (x @ q.float()) * scale
  torch.testing.assert_close(pre, post, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_port(tiny):
  """The tiny config's float32 model, its int8 twin, and the config."""
  config, _, params = tiny
  pconfig = _port_config(config)
  model = convert.griffin_from_flax_params(params, pconfig, device="cpu",
                                           dtype=torch.float32)
  qmodel = convert.griffin_from_flax_params(
      quantization.quantize_params(params), pconfig, device="cpu",
      dtype=torch.float32)
  return model, qmodel


def test_logits_close_to_full_precision(tiny_port):
  model, qmodel = tiny_port
  tokens = torch.tensor(np.random.default_rng(2).integers(0, 64, (2, 6)))
  pos = torch.arange(6)[None].expand(2, -1)
  with torch.no_grad():
    logits, _ = model(tokens, pos)
    qlogits, _ = qmodel(tokens, pos)
  rel = (logits - qlogits).abs().max() / (logits.abs().max() + 1e-9)
  assert rel < 0.05, rel


def test_act_quant_logits_close_to_weight_only(tiny_port):
  model, qmodel = tiny_port
  tokens = torch.arange(12).reshape(2, 6) % 64
  pos = torch.arange(6)[None].expand(2, -1)
  with torch.no_grad():
    ref, _ = model(tokens, pos, return_cache=False)
    aq, _ = qmodel.act_quant_view()(tokens, pos, return_cache=False)
  assert aq.shape == ref.shape
  assert (aq - ref).abs().max() < 1.5


def test_act_quant_adds_no_params(tiny_port):
  _, qmodel = tiny_port
  built = griffin.Griffin(qmodel.config, device="meta", quantized=True,
                          act_quant=True).state_dict()
  assert {n: t.shape for n, t in built.items()} == {
      n: t.shape for n, t in qmodel.state_dict().items()}
  with pytest.raises(ValueError, match="act_quant"):
    griffin.Griffin(qmodel.config, device="meta", act_quant=True)


def test_prefill_act_quant_requires_quantized(tiny_port):
  model, _ = tiny_port
  with pytest.raises(ValueError, match="prefill_act_quant"):
    sampler_lib.Sampler(model, port.SimpleVocab(["a"]), device="cpu",
                        prefill_act_quant=True)
  with pytest.raises(ValueError, match="act_quant_view"):
    model.act_quant_view()


def test_quantized_init_draws_zeros_and_ones(tiny):
  config, _, _ = tiny
  model = griffin.Griffin(_port_config(config), device="cpu",
                          dtype=torch.float32, quantized=True)
  state = model.state_dict()
  assert not state["blocks.0.recurrent_block.linear_x.kernel_q"].any()
  assert (state["embedder.input_embedding_scale"] == 1).all()
  assert (state["blocks.0.recurrent_block.rg_lru.a_gate.w_scale"] == 1).all()
  assert state["blocks.0.recurrent_block.rg_lru.a_param"].std() > 0


def test_lora_is_refused():
  """Per-row adapters (multi-LoRA serving) build over an int8 base, stacked
  one pair a batch row; a rank-r pair over an int8 base builds, and int8
  activations refuse a gradient (``torch._int_mm`` has none)."""
  dense = layers.Dense(8, 8, device="meta", quantized=True, lora_rank=4,
                       lora_rows=2)
  assert (dense.lora_a.shape, dense.lora_b.shape) == ((2, 8, 4), (2, 4, 8))
  einsum = layers.Einsum((2, 8, 8), (2, 1, 1, 8), "...td,cdD->c...tD",
                         device="meta", quantized=True, lora_rank=4,
                         lora_rows=2)
  assert einsum.lora_a.shape == (2, 2, 8, 4)
  assert einsum.lora_b.shape == (2, 2, 4, 8)
  layer = layers.Dense(16, 16, device="cpu", dtype=torch.float32,
                       quantized=True, act_quant=True, lora_rank=4)
  with torch.no_grad():
    layer.kernel_q.fill_(1)
    layer.kernel_scale.fill_(0.1)
    layer.bias.zero_()
    layer.lora_a.fill_(0.5)
    layer.lora_b.fill_(0.5)
  x = torch.randn(3, 16)
  with torch.no_grad():
    assert layer(x).shape == (3, 16)
  with pytest.raises(ValueError, match="act_quant has no gradient"):
    layer(x)


def test_realistic_params_shapes_and_stats(tiny):
  config, _, _ = tiny
  pconfig = _port_config(config)
  model = griffin.Griffin(pconfig, device="cpu", dtype=torch.float32)
  init = {n: t.clone() for n, t in model.state_dict().items()}
  state = synthetic.realistic_params(model, torch.Generator().manual_seed(0))
  assert {n: (t.shape, t.dtype) for n, t in state.items()} == {
      n: (t.shape, t.dtype) for n, t in init.items()}
  norm = [t for n, t in state.items() if n.endswith(".scale")]
  assert norm and all(t.abs().max() > 0 for t in norm)
  pooled = torch.cat([t.reshape(-1) for t in norm])
  assert 0.2 < float(pooled.std()) < 0.5
  # The table: its initializer's variance 1 / width plus 0.3^2.
  table = state["embedder.input_embedding"]
  assert abs(float(table.std()) - (1 / 32 + 0.09) ** 0.5) < 0.05
  again = synthetic.realistic_params(
      griffin.Griffin(pconfig, device="cpu", dtype=torch.float32),
      torch.Generator().manual_seed(0))
  for name, value in state.items():
    torch.testing.assert_close(again[name], value, atol=0, rtol=0)
  qmodel = griffin.Griffin(pconfig, device="meta", dtype=torch.float32,
                           quantized=True)
  qmodel.to_empty(device="cpu")
  qmodel.load_state_dict(quantization.quantize_params(state))
  toks = torch.zeros(1, 6, dtype=torch.long)
  pos = torch.arange(6)[None]
  with torch.no_grad():
    assert torch.isfinite(model(toks, pos, return_cache=False)[0]).all()
    assert torch.isfinite(qmodel(toks, pos, return_cache=False)[0]).all()


def test_greedy_token_agreement_metrics():
  r = synthetic.greedy_token_agreement([1, 2, 3, 4], [1, 2, 9, 4])
  assert r["match_fraction"] == 0.75
  assert r["prefix_match"] == 0.5
  assert r["first_divergence"] == 2
  r2 = synthetic.greedy_token_agreement(torch.tensor([5, 6]), [5, 6])
  assert r2["match_fraction"] == 1.0 and r2["first_divergence"] == -1
