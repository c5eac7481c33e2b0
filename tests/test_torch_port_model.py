"""The PyTorch port's Griffin backbone vs the JAX model, and port hygiene.

A tiny Griffin (blocks R, A, R; width 32) with seeded numpy weights runs in
both packages on the same tokens. Everything is float32 on the CPU, so the
two differ only in summation order: logits agree to 1e-4.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.models import griffin

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)

# Row 0: 14 real tokens; row 1: left-padded by 5.
TOKENS = np.array([[1, 5, 9, 13, 17, 21, 25, 29, 33, 37, 4, 8, 12, 16],
                   [0, 0, 0, 0, 0, 1, 6, 11, 16, 21, 26, 31, 36, 3]],
                  np.int32)
SEG = np.maximum(np.arange(14)[None] - np.array([[0], [5]]), -1).astype(
    np.int32
)


def port_config(config: jcommon.GriffinConfig) -> common.GriffinConfig:
  """The port's config with the same fields as a JAX config."""
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types
  )
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


def tiny_pair(scan_type=jcommon.ScanType.LINEAR_NATIVE, window=8,
              use_flash_attention=None, seed=0):
  """(JAX model, its params, the port's model holding the same weights)."""
  config = jcommon.GriffinConfig(
      vocab_size=40, width=32, mlp_expanded_width=64, num_heads=2,
      block_types=(jcommon.TemporalBlockType.RECURRENT,
                   jcommon.TemporalBlockType.ATTENTION,
                   jcommon.TemporalBlockType.RECURRENT),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=window,
      logits_soft_cap=30.0, lru_width=32, scan_type=scan_type,
  )
  jmodel = jgriffin.Griffin(
      config, dtype=jnp.float32, param_dtype=jnp.float32,
      gradient_checkpointing=False, use_flash_attention=use_flash_attention,
  )
  # Interpret mode lets init trace through the Pallas kernels on the CPU.
  with pltpu.force_tpu_interpret_mode():
    params = jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32),
        jnp.arange(4)[None],
    )["params"]
  rng = np.random.default_rng(seed)
  # Seeded weights everywhere, so zero-initialized scales count too.
  params = jax.tree_util.tree_map(
      lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32),
      params,
  )
  tmodel = convert.griffin_from_flax_params(
      params, port_config(config), device="cpu", dtype=torch.float32,
      use_flash_attention=use_flash_attention,
  )
  return jmodel, params, tmodel


def _close(torch_value, jax_value):
  np.testing.assert_allclose(
      torch_value.numpy(), np.asarray(jax_value, np.float32), **TOL
  )


@torch.no_grad()
def test_forward_and_prefill_then_decode_match_jax():
  jmodel, params, tmodel = tiny_pair()
  v = {"params": params}
  apply = jax.jit(jmodel.apply)  # one compile serves every decode step
  logits_j, cache_j = apply(v, jnp.asarray(TOKENS), jnp.asarray(SEG))
  logits_t, cache_t = tmodel(torch.tensor(TOKENS).long(), torch.tensor(SEG))
  _close(logits_t, logits_j)

  pos = SEG[:, -1:] + 1
  token = TOKENS[:, -1:]
  for _ in range(4):
    logits_j, cache_j = apply(
        v, jnp.asarray(token), jnp.asarray(pos), cache_j
    )
    logits_t, cache_t = tmodel(
        torch.tensor(token).long(), torch.tensor(pos), cache_t
    )
    _close(logits_t, logits_j)
    token = np.asarray(jnp.argmax(logits_j[:, -1:], -1)).astype(np.int32)
    pos = pos + 1
  for name in cache_j:
    for got, want in zip(cache_t[name], cache_j[name]):
      _close(got, want)


@torch.no_grad()
def test_forced_kernel_paths_match_jax_pallas_interpret():
  """JAX through both Pallas kernels (interpret mode), t > window, vs the
  port's kernel paths, which take the plain versions on CPU tensors."""
  jmodel, params, tmodel = tiny_pair(
      scan_type=jcommon.ScanType.LINEAR_PALLAS, window=6,
      use_flash_attention=True,
  )
  with pltpu.force_tpu_interpret_mode():
    logits_j, _ = jmodel.apply(
        {"params": params}, jnp.asarray(TOKENS), jnp.asarray(SEG)
    )
  logits_t, _ = tmodel(torch.tensor(TOKENS).long(), torch.tensor(SEG))
  _close(logits_t, logits_j)


def test_last_logits_only_equals_last_row_of_full_logits():
  _, _, tmodel = tiny_pair()
  with torch.no_grad():
    full, _ = tmodel(torch.tensor(TOKENS).long(), torch.tensor(SEG))
    last, _ = tmodel(torch.tensor(TOKENS).long(), torch.tensor(SEG),
                     last_logits_only=True)
  torch.testing.assert_close(last, full[:, -1:], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("preset", list(common.Preset))
def test_presets_equal_jax(preset):
  want = jcommon.GriffinConfig.from_preset(jcommon.Preset[preset.name])
  got = common.GriffinConfig.from_preset(preset)
  assert got == port_config(want)


def test_config_from_numpy_params_equals_jax():
  jmodel, params, _ = tiny_pair()
  numpy_params = jax.tree_util.tree_map(np.asarray, params)
  got = common.GriffinConfig.from_flax_params_or_variables(
      numpy_params, embeddings_scale_by_sqrt_dim=True,
      attention_window_size=8, logits_soft_cap=30.0,
  )
  want = jcommon.GriffinConfig.from_flax_params_or_variables(
      params, embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
      logits_soft_cap=30.0,
  )
  assert got == port_config(want)
  assert got._replace(scan_type=common.ScanType.LINEAR_NATIVE) == (
      port_config(jmodel.config)
  )


def test_port_hygiene(monkeypatch):
  """The port, its training, vision, parallel, complex and kernel-lab
  modules included, imports no JAX and nothing of the JAX package, and its entry points refuse to fall
  back to the CPU without being asked."""
  probe = (
      "import sys; before = set(sys.modules); "
      "import cadence_gemma_tpu_torch; "
      "import cadence_gemma_tpu_torch.training.train_loop; "
      "import cadence_gemma_tpu_torch.training.trainer; "
      "import cadence_gemma_tpu_torch.training.data; "
      "import cadence_gemma_tpu_torch.models.vit; "
      "import cadence_gemma_tpu_torch.inference.modal_sampler; "
      "import cadence_gemma_tpu_torch.parallel.sharding; "
      "import cadence_gemma_tpu_torch.parallel.sp_attention; "
      "import cadence_gemma_tpu_torch.complex_lib; "
      "import cadence_gemma_tpu_torch.benchmarks.kernel_lab; "
      "new = set(sys.modules) - before; "
      "print(sorted(m for m in new if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'cadence_gemma_tpu')))"
  )
  env = dict(os.environ, PYTHONPATH=str(REPO))
  result = subprocess.run(
      [sys.executable, "-c", probe], capture_output=True, text=True,
      cwd=REPO, env=env, check=True, timeout=120,
  )
  assert result.stdout.strip() == "[]", result.stdout + result.stderr

  sources = sorted((REPO / "cadence_gemma_tpu_torch").rglob("*.py"))
  assert REPO / "cadence_gemma_tpu_torch/training/train_loop.py" in sources
  sources.append(REPO / "chip_smoke.py")
  bad = re.compile(
      r"^\s*(import\s+(jax|flax|cadence_gemma_tpu)\b|"
      r"from\s+(jax|flax|cadence_gemma_tpu)[\s.])", re.M
  )
  for path in sources:
    assert not bad.search(path.read_text()), path

  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  config = common.GriffinConfig.from_preset(common.Preset.RECURRENT_GEMMA_2B_V1)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    port.Griffin(config)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    griffin.resolve_device(None)
  _, params, tmodel = tiny_pair()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    convert.griffin_from_flax_params(params, tmodel.config)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    port.Sampler(tmodel, port.SimpleVocab(["a"]))
  with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
    port.make_mesh((1, 4), ("data", "sequence"))


def test_vision_entry_points_need_a_card_unless_asked(monkeypatch):
  """The encoder, its converter and the ModalSampler run on the card by
  default and raise without one; device='cpu' is the only way to the CPU."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    port.DinoSigLIPEncoder()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    convert.encoder_from_flax_params({})
  _, _, tmodel = tiny_pair()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    port.ModalSampler(tmodel, port.SimpleVocab(["a"]))
  tiny = port.ViTConfig(embed_dim=128, depth=1, num_heads=2,
                        mlp_hidden_dim=32, patch_size=7, image_size=14)
  encoder = port.DinoSigLIPEncoder(tiny, tiny, device="cpu")
  sampler = port.ModalSampler(tmodel, port.SimpleVocab(["a"]), encoder,
                              device="cpu")
  assert sampler.device.type == encoder.device.type == "cpu"
