"""The port's LoRA adapters and adapter training vs the JAX package, on the CPU.

A tiny Griffin (blocks R, A; width 16; window 8; the test config of JAX's
``tests/test_lora.py``) in float32. JAX draws the base with its
initializers; the adapters are seeded numpy normals (``lora_b`` too, so the
adapter term is not zero), carried to the port by ``convert.py``. Both
packages run the sequential scan and the einsum attention, so they differ
only in summation order:

  * each ``Dense`` / ``Einsum`` adapter term (bf16 and int8 base) within
    1e-5 of the largest output;
  * whole models' logits within 1e-4 (``test_torch_port_model.py``'s);
  * ``lora_train_step`` over 3 steps: the loss within 1e-5 relative, the
    adapters within 1e-4 of each leaf's largest value, the base bit for
    bit (it never requires a gradient);
  * ``merge_lora`` within 1e-6 (one float32 matmul and add on each side).

The int8 product's input gradient (the CUDA kernel's plain version on the
CPU) is held against autograd of JAX's expression here; the kernel itself
against that plain version in ``test_torch_port_int8_cuda.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu import tokenizers as jtokenizers
from cadence_gemma_tpu.inference import sampler as jsampler
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.models import layers as jlayers
from cadence_gemma_tpu.ops import quantization as jquant
from cadence_gemma_tpu.training import data as jdata
from cadence_gemma_tpu.training import lora as jlora
from cadence_gemma_tpu.training import train_loop as jtrain_loop
import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.models import layers
from cadence_gemma_tpu_torch.ops import int8_matmul
from cadence_gemma_tpu_torch.ops import quantization
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab
from cadence_gemma_tpu_torch.training import data
from cadence_gemma_tpu_torch.training import lora
from cadence_gemma_tpu_torch.training import train_loop as tl

RANK = 4
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)  # test_torch_port_model.py's
PAD = 0


def _jax_config():
  return jcommon.GriffinConfig(
      vocab_size=48, width=16, mlp_expanded_width=32, num_heads=2,
      block_types=(jcommon.TemporalBlockType.RECURRENT,
                   jcommon.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
      logits_soft_cap=30.0, lru_width=16,
      scan_type=jcommon.ScanType.LINEAR_NATIVE, vision_tokens=4,
      vision_width=12, vl_expanded_width=20,
  )


def _port_config():
  config = _jax_config()
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types)
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


def _jax_model(rank=RANK, **kwargs):
  return jgriffin.Griffin(_jax_config(), gradient_checkpointing=False,
                          lora_rank=rank, dtype=jnp.float32,
                          param_dtype=jnp.float32, **kwargs)


def _randomize_adapters(params, seed, std=0.3):
  """``params`` with every adapter leaf a seeded normal (numpy)."""
  rng = np.random.default_rng(seed)
  adapters, base = jlora.split_lora(params)
  adapters = jax.tree_util.tree_map(
      lambda p: (std * rng.standard_normal(p.shape)).astype(np.float32),
      adapters)
  return jlora.merge_params(base, adapters)


@pytest.fixture(scope="module")
def jax_params():
  """A LoRA model's float32 tree: JAX's base init, random adapters."""
  params = _jax_model().init(jax.random.PRNGKey(0), jnp.ones((1, 6), jnp.int32),
                             jnp.arange(6)[None], return_cache=False)["params"]
  params = jax.tree_util.tree_map(np.asarray, params)
  return _randomize_adapters(params, seed=1)


def _port_model(params, **kwargs):
  return convert.griffin_from_flax_params(
      params, _port_config(), device="cpu", dtype=torch.float32,
      lora_rank=kwargs.pop("lora_rank", RANK), **kwargs)


TOKENS = np.array([[1, 5, 9, 2, 4, 7, 11, 3, 8, 6],
                   [1, 7, 3, 2, 9, 5, 12, 30, 0, 0]], np.int32)


def _logits_jax(model, params, tokens=TOKENS):
  pos = np.asarray(jnp.cumsum(tokens != PAD, axis=-1) - 1)
  logits, _ = model.apply({"params": params}, jnp.asarray(tokens),
                          jnp.asarray(pos), return_cache=False)
  return np.asarray(logits)


def _logits_port(model, tokens=TOKENS):
  t = torch.tensor(tokens).long()
  pos = torch.cumsum(t != PAD, dim=-1) - 1
  with torch.no_grad():
    logits, _ = model(t, pos, return_cache=False)
  return logits.numpy()


# --- The adapter layers ---------------------------------------------------

_LAYER_CASES = [(kind, quantized) for kind in ("dense", "einsum")
                for quantized in (False, True)]


@pytest.mark.parametrize("kind,quantized", _LAYER_CASES)
@pytest.mark.parametrize("alpha", [None, 2.0, 0.0])
def test_adapter_term_matches_jax(kind, quantized, alpha):
  """One layer with seeded weights and adapters in both packages: the whole
  output (base + adapter term + bias) agrees within 1e-5 of its largest
  value, and so does the adapter term alone (the output minus the same
  layer's with zero adapters); ``lora_alpha=0.0`` nulls it exactly (JAX's
  regression: not the rank's scale)."""
  rng = np.random.default_rng(3)
  x = rng.standard_normal((2, 5, 24)).astype(np.float32)
  if kind == "dense":
    jmod = jlayers.QuantizableDense(features=12, lora_rank=RANK,
                                    lora_alpha=alpha, quantized=quantized)
  else:
    jmod = jlayers.Einsum(w_shape=(2, 24, 12), b_shape=(2, 1, 1, 12),
                          eqn="...td,cdD->c...tD", lora_rank=RANK,
                          lora_alpha=alpha, quantized=quantized)
  shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"]
  params = {}
  for name, s in shapes.items():
    if s.dtype == jnp.int8:
      params[name] = rng.integers(-127, 128, s.shape).astype(np.int8)
    elif name.endswith("scale"):
      params[name] = rng.uniform(0.01, 0.02, s.shape).astype(np.float32)
    else:
      params[name] = (0.3 * rng.standard_normal(s.shape)).astype(np.float32)

  def port_layer(p):
    if kind == "dense":
      layer = layers.Dense(24, 12, device="cpu", dtype=torch.float32,
                           quantized=quantized, lora_rank=RANK,
                           lora_alpha=alpha)
    else:
      layer = layers.Einsum((2, 24, 12), (2, 1, 1, 12), "...td,cdD->c...tD",
                            device="cpu", dtype=torch.float32,
                            quantized=quantized, lora_rank=RANK,
                            lora_alpha=alpha)
    convert.load_flax_params(layer, p)
    return layer

  zero = dict(params, lora_b=np.zeros_like(params["lora_b"]))
  want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
  want_term = want - np.asarray(jmod.apply({"params": zero}, jnp.asarray(x)))
  with torch.no_grad():
    got = port_layer(params)(torch.tensor(x)).numpy()
    got_term = got - port_layer(zero)(torch.tensor(x)).numpy()
  if alpha == 0.0:
    assert not want_term.any() and not got_term.any()
  else:
    assert np.abs(want_term).max() > 0.1
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=1e-5 * np.abs(want).max())
  np.testing.assert_allclose(got_term, want_term, rtol=0,
                             atol=1e-5 * np.abs(want_term).max())


def test_adapter_leaf_set_matches_jax(jax_params):
  """The port's adapters are JAX's leaves, by name, shape and layout (flax's
  ``[in, r]`` / ``[r, out]`` and ``[c, d, r]`` / ``[c, r, D]``), and no
  non-target (gates, conv, norms, embedder) carries one."""
  adapters_j, _ = jlora.split_lora(jax_params)
  want = {name: tuple(v.shape) for name, v in
          convert.state_dict_from_flax(adapters_j).items()}
  model = _port_model(jax_params)
  got = {name: tuple(p.shape) for name, p in model.named_parameters()
         if lora.is_lora_path(name)}
  assert got == want
  assert got["blocks.0.recurrent_block.linear_x.lora_a"] == (16, RANK)
  assert got["blocks.0.mlp_block.ffw_up.lora_b"] == (2, RANK, 32)
  assert not any(part in name for name in got for part in (
      "input_gate", "a_gate", "conv_1d", "embedder", "norm"))
  assert lora.lora_parameter_count(lora.split_lora(model.state_dict())[0]) \
      == jlora.lora_parameter_count(adapters_j)


def test_lora_model_logits_match_jax(jax_params):
  np.testing.assert_allclose(_logits_port(_port_model(jax_params)),
                             _logits_jax(_jax_model(), jax_params),
                             **MODEL_TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_adapters_cross_back_to_flax(jax_params, quantized):
  """``convert.py`` both ways, adapters included, over a float32 and an
  int8 base: the port's state dict goes back to a flax tree that JAX's
  LoRA model runs to the port's logits, and converting that tree again
  gives the state dict bit for bit."""
  params = jax_params
  if quantized:
    adapters, base = jlora.split_lora(jax_params)
    params = jlora.merge_params(jquant.quantize_params(base), adapters)
  model = _port_model(params)
  with torch.no_grad():
    for p in lora.lora_parameters(model):  # adapters the port trained
      p.mul_(1.5)
  state = model.state_dict()
  tree = convert.flax_params_from_state_dict(state)
  assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
      jax.tree_util.tree_map(np.asarray, params))
  back = convert.state_dict_from_flax(tree)
  assert set(back) == set(state)
  for name, value in state.items():
    assert back[name].dtype == value.dtype and torch.equal(back[name],
                                                           value), name
  np.testing.assert_allclose(
      _logits_jax(_jax_model(quantized=quantized), tree),
      _logits_port(model), **MODEL_TOL)


def test_zero_b_lora_model_equals_base():
  """``lora_b`` is drawn zero: a LoRA model from the same generator equals
  the base model exactly, and its base weights are the base's."""
  config = _port_config()
  base = griffin.Griffin(config, device="cpu", dtype=torch.float32)
  model = griffin.Griffin(config, device="cpu", dtype=torch.float32,
                          lora_rank=RANK)
  adapters, rest = lora.split_lora(model.state_dict())
  assert all(not v.any() for k, v in adapters.items() if k.endswith("lora_b"))
  assert all(v.std() > 0 for k, v in adapters.items() if k.endswith("lora_a"))
  for name, value in base.state_dict().items():
    assert torch.equal(rest[name], value), name
  np.testing.assert_array_equal(_logits_port(model), _logits_port(base))


def test_split_merge_round_trip_and_mask(jax_params):
  state = _port_model(jax_params).state_dict()
  adapters, base = lora.split_lora(state)
  assert adapters and base and not set(adapters) & set(base)
  assert lora.merge_params(base, adapters) == state
  mask = lora.lora_mask(state)
  assert {n for n, m in mask.items() if m} == set(adapters)
  assert all(lora.is_lora_path(tuple(n.split("."))) for n in adapters)


def test_merge_lora_matches_jax(jax_params):
  """The folded tree matches JAX's ``merge_lora`` (float32 a @ b * s added
  to each weight); a plain model of it gives the LoRA model's logits."""
  for alpha in (None, 2.0):
    want = convert.state_dict_from_flax(jlora.merge_lora(jax_params, alpha))
    got = lora.merge_lora(_port_model(jax_params).state_dict(), alpha)
    assert set(got) == set(want)
    for name, value in want.items():
      torch.testing.assert_close(got[name], value, atol=1e-6, rtol=1e-6,
                                 msg=name)
  merged = griffin.Griffin(_port_config(), device="cpu", dtype=torch.float32)
  merged.load_state_dict(lora.merge_lora(_port_model(jax_params).state_dict()))
  np.testing.assert_allclose(_logits_port(merged),
                             _logits_port(_port_model(jax_params)),
                             atol=2e-5, rtol=0)


def test_merge_lora_refuses_a_quantized_tree(jax_params):
  adapters, base = jlora.split_lora(jax_params)
  qtree = jlora.merge_params(jquant.quantize_params(base), adapters)
  with pytest.raises(ValueError, match="kernel_q") as raised:
    jlora.merge_lora(qtree)
  state = quantization.quantize_params(_port_model(jax_params).state_dict())
  with pytest.raises(ValueError, match="kernel_q") as got:
    lora.merge_lora(state)
  # JAX's message, naming the same leaves.
  assert str(got.value).split(" — ")[0] == str(raised.value).split(" — ")[0]


def test_init_adapters_draws_only_adapters():
  """From an explicit generator, on a model on ``meta`` (no weight built):
  the model's adapter names, shapes and dtype; ``lora_b`` zero; ``lora_a``
  at fan_in^-0.5; the same draw from the same seed."""
  model = griffin.Griffin(_port_config(), device="meta", dtype=torch.float32,
                          lora_rank=8)
  first = lora.init_adapters(model, torch.Generator().manual_seed(5))
  again = lora.init_adapters(model, torch.Generator().manual_seed(5))
  want = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()
          if lora.is_lora_path(n)}
  assert {n: (tuple(v.shape), v.dtype) for n, v in first.items()} == want
  for name, value in first.items():
    assert value.device.type == "cpu" and torch.equal(value, again[name])
    if name.endswith("lora_b"):
      assert not value.any()
  big = lora.init_adapters(
      griffin.Griffin(common.GriffinConfig.from_preset(
          common.Preset.RECURRENT_GEMMA_2B_V1), device="meta", lora_rank=8),
      torch.Generator().manual_seed(0))
  a = big["blocks.0.recurrent_block.linear_x.lora_a"].float()
  assert abs(float(a.std()) - 2560 ** -0.5) < 0.02 * 2560 ** -0.5
  with pytest.raises(ValueError, match="lora_rank"):
    lora.init_adapters(griffin.Griffin(_port_config(), device="meta"),
                       torch.Generator())


# --- The int8 input gradient ---------------------------------------------


@pytest.mark.parametrize("shared", [False, True])
def test_int8_input_gradient_matches_jax(shared):
  """The product's gradient for its input (the CUDA kernel's plain version
  on the CPU), per batch and for an activation shared by two products (the
  fused up-projection), against ``jax.grad`` of JAX's expression; the
  weight and scale get none."""
  rng = np.random.default_rng(7)
  a = rng.standard_normal((1 if shared else 3, 5, 32)).astype(np.float32)
  q = rng.integers(-127, 128, (3, 24, 32)).astype(np.int8)
  scale = rng.uniform(0.01, 0.02, (3, 24)).astype(np.float32)
  g = rng.standard_normal((3, 5, 24)).astype(np.float32)

  def f(x):
    y = (x @ jnp.swapaxes(jnp.asarray(q).astype(jnp.float32), 1, 2)
         ) * jnp.asarray(scale)[:, None, :]
    return jnp.sum(y * g)

  want = np.asarray(jax.grad(f)(jnp.asarray(a)))
  x = torch.tensor(a, requires_grad=True)
  qt, st = torch.tensor(q), torch.tensor(scale)
  y = int8_matmul.int8_weight_matmul(x, qt, st)
  np.testing.assert_allclose(
      y.detach().numpy(),
      np.asarray(jnp.asarray(a) @ jnp.swapaxes(
          jnp.asarray(q).astype(jnp.float32), 1, 2)) * scale[:, None],
      rtol=1e-5, atol=1e-5)
  y.backward(torch.tensor(g))
  np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-5)
  assert qt.grad is None and st.grad is None
  plain = int8_matmul.int8_weight_matmul_dgrad_plain(
      torch.tensor(g), qt, st, reduce_batches=shared)
  np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


# --- Adapter training ------------------------------------------------------

_LR = 5e-2


def _jax_lora_steps(model, params, quantized, steps=3):
  adapters, base = jlora.split_lora(params)
  if quantized:
    base = jquant.quantize_params(base)
  tx = jlora.make_optimizer(learning_rate=_LR)
  opt_state = tx.init(adapters)
  mask = jnp.asarray(TOKENS != PAD)
  losses = []
  for _ in range(steps):
    loss, adapters, opt_state = jlora.lora_train_step(
        model, adapters, base, tx, opt_state, PAD, jnp.asarray(TOKENS), mask)
    losses.append(float(loss))
  return losses, jax.tree_util.tree_map(np.asarray, adapters)


@pytest.mark.parametrize("quantized", [False, True])
def test_lora_train_step_matches_jax(jax_params, quantized):
  """Three adapter-only Adam steps (clip 1.0, b2 0.999) on a float32 base
  and on its ``quantize_params`` copy (QLoRA): losses within 1e-5, adapters
  within 1e-4 of each leaf's largest value, the base bit for bit."""
  losses_j, adapters_j = _jax_lora_steps(
      _jax_model(quantized=quantized), jax_params, quantized)

  model = _port_model(jax_params)
  if quantized:
    qmodel = griffin.Griffin(_port_config(), device="meta",
                             dtype=torch.float32, quantized=True,
                             lora_rank=RANK)
    qmodel.to_empty(device="cpu")
    qmodel.load_state_dict(quantization.quantize_params(model.state_dict()))
    model = qmodel
  base_before = {n: v.clone() for n, v in
                 lora.split_lora(model.state_dict())[1].items()}
  optimizer = lora.make_optimizer(lora.lora_parameters(model), _LR)
  tokens = torch.tensor(TOKENS).long()
  mask = tokens != PAD
  losses = [float(lora.lora_train_step(model, optimizer, PAD, tokens, mask))
            for _ in range(3)]

  np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
  assert losses[-1] < losses[0]
  adapters, base = lora.split_lora(model.state_dict())
  for name, want in convert.state_dict_from_flax(adapters_j).items():
    tol = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(adapters[name], want, atol=tol, rtol=0,
                               msg=name)
  for name, value in base_before.items():
    assert torch.equal(base[name], value), name
  assert all(p.grad is None for p in model.parameters())
  # Adam's moments exist at adapter size only.
  state_sizes = [t.numel() for s in optimizer.state.values()
                 for t in s.values() if t.ndim]
  assert max(state_sizes) <= max(
      p.numel() for p in lora.lora_parameters(model))


def test_lora_train_step_refuses_another_optimizer(jax_params):
  model = _port_model(jax_params)
  tokens = torch.tensor(TOKENS).long()
  with pytest.raises(ValueError, match="adapters alone"):
    lora.lora_train_step(model, lora.make_optimizer(model.parameters()),
                         PAD, tokens, tokens != PAD)


def test_train_loop_lora_matches_jax(jax_params):
  """``train_loop(lora=True)``: 2 epochs cut at 6 steps, both packages:
  the adapters agree (1e-4 of each leaf's largest value) and the LM's
  moved, the base is untouched."""
  batch = jdata.TrainingInput(input_tokens=TOKENS,
                              target_mask=TOKENS != PAD)
  cfg = dict(learning_rate=_LR, num_epochs=2, max_steps=6, lora=True,
             eval_every_n=1000)
  out_j = jtrain_loop.train_loop(
      _jax_model(), jax.tree_util.tree_map(jnp.asarray, jax_params),
      [batch] * 4, jtrain_loop.TrainingConfig(checkpoint_every_n=None, **cfg))
  want = convert.state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             out_j))
  model = _port_model(jax_params)
  before = {n: v.clone() for n, v in model.state_dict().items()}
  tl.train_loop(model, [data.TrainingInput(TOKENS, TOKENS != PAD)] * 4,
                tl.TrainingConfig(**cfg), device="cpu")
  for name, value in model.state_dict().items():
    if lora.is_lora_path(name):
      tol = 1e-4 * float(want[name].abs().max())
      torch.testing.assert_close(value, want[name], atol=tol, rtol=0,
                                 msg=name)
      # A text batch does not reach the connector: Adam's zero gradient
      # leaves its adapters where they were.
      moved = not torch.equal(value, before[name])
      assert moved != name.startswith("vl_connector."), name
    else:
      assert torch.equal(value, before[name]), name


def test_train_loop_lora_refusals_match_jax(jax_params):
  """JAX's ``ValueError``s and warning: ``lora`` with ``freeze_llm``, and a
  model without adapters (after the ``weight_decay`` warning)."""
  both = dict(lora=True, freeze_llm=True)
  with pytest.raises(ValueError, match="mutually exclusive"):
    jtrain_loop.train_loop(_jax_model(), jax_params, [],
                           jtrain_loop.TrainingConfig(**both))
  with pytest.raises(ValueError, match="mutually exclusive"):
    tl.train_loop(_port_model(jax_params), [], tl.TrainingConfig(**both),
                  device="cpu")
  base = griffin.Griffin(_port_config(), device="cpu", dtype=torch.float32)
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    with pytest.raises(ValueError, match="no lora_a/lora_b"):
      tl.train_loop(base, [], tl.TrainingConfig(lora=True, weight_decay=0.3),
                    device="cpu")
  assert any("weight_decay is ignored" in str(w.message) for w in caught)


def test_lora_model_serves_like_jax(jax_params):
  """A trained-like LoRA model (random adapters), on a float32 base and on
  its int8 copy, gives JAX's greedy tokens through the ``Sampler``."""
  words = [f"w{i}" for i in range(44)]
  prompts = ["w1 w2 w3", "w7 w9"]
  for quantized in (False, True):
    jmodel, params = _jax_model(quantized=quantized), jax_params
    model = _port_model(jax_params)
    if quantized:
      adapters, base = jlora.split_lora(jax_params)
      params = jlora.merge_params(jquant.quantize_params(base), adapters)
      model = _port_model(params)
    want = jsampler.Sampler(jmodel, jtokenizers.SimpleVocab(words), params)(
        prompts, total_generation_steps=6, end_sampling_at_eos_token=False)
    got = sampler_lib.Sampler(model, SimpleVocab(words), device="cpu")(
        prompts, total_generation_steps=6, end_sampling_at_eos_token=False)
    assert [list(map(int, t)) for t in got.tokens] == [
        list(map(int, t)) for t in want.tokens], quantized


def test_package_exports_the_lora_surface():
  assert port.lora is lora
  assert port.train_loop is tl.train_loop
  assert port.two_stage_sft is tl.two_stage_sft
  assert port.TrainingConfig is tl.TrainingConfig
