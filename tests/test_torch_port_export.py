"""The port's serving export (``checkpoint/export.py``) against JAX's.

JAX's ``_tiny_model`` configuration of ``tests/test_export.py`` (vocab 32,
width 16, blocks (R, A), window 8, soft cap 30) in float32 on the CPU, with
seeded numpy weights carried to the port by ``convert.py``. The port's model
takes the kernel paths (``ScanType.AUTO``, ``use_flash_attention=True``), so
its programs hold the ``torch.library`` operators, whose CPU implementations
are the plain versions; the JAX model runs its native scan and einsum
attention. A batch of 2 prompts of 12 tokens is longer than the window.

The two packages' loaded artifacts agree to the model tests' 1e-4 (summation
order); the port's loaded artifact reproduces its live serving functions bit
for bit, and so does one exported from fake (shapes-only) parameters.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses import fake_tensor

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.checkpoint import export as jexport
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.checkpoint import export as export_lib
from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.ops import quantization

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)
BATCH, PROMPT, STEPS = 2, 12, 3


def _jax_config():
  return jcommon.GriffinConfig(
      vocab_size=32, width=16, mlp_expanded_width=32, num_heads=2,
      lru_width=16,
      block_types=(jcommon.TemporalBlockType.RECURRENT,
                   jcommon.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
      logits_soft_cap=30.0, scan_type=jcommon.ScanType.LINEAR_NATIVE,
  )


def _port_config() -> common.GriffinConfig:
  fields = _jax_config()._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in fields["block_types"])
  fields["scan_type"] = common.ScanType.AUTO
  return common.GriffinConfig(**fields)


def _inputs(seed: int):
  rng = np.random.default_rng(seed)
  tokens = rng.integers(0, 32, (BATCH, PROMPT)).astype(np.int32)
  positions = np.tile(np.arange(PROMPT, dtype=np.int32)[None], (BATCH, 1))
  return tokens, positions


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
  """(JAX model, its variables, the port's model, its params, both loaded
  artifacts and the port's artifact directory)."""
  jmodel = jgriffin.Griffin(_jax_config(), dtype=jnp.float32,
                            param_dtype=jnp.float32,
                            gradient_checkpointing=False)
  variables = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                          jnp.arange(4)[None])
  rng = np.random.default_rng(0)
  variables = jax.tree_util.tree_map(
      lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32),
      variables)
  model = convert.griffin_from_flax_params(
      variables["params"], _port_config(), device="cpu", dtype=torch.float32,
      use_flash_attention=True)
  params = dict(model.named_parameters())
  root = tmp_path_factory.mktemp("export")
  jexp = jexport.export_serving(jmodel, variables, batch_size=BATCH,
                                prompt_len=PROMPT, cache_dtype=jnp.float32)
  jexport.save_serving_export(jexp, str(root / "jax"))
  exp = export_lib.export_serving(model, params, batch_size=BATCH,
                                  prompt_len=PROMPT, cache_dtype=torch.float32)
  export_lib.save_serving_export(exp, str(root / "port"))
  return dict(jmodel=jmodel, variables=variables, model=model, params=params,
              jloaded=jexport.load_serving_export(str(root / "jax")),
              loaded=export_lib.load_serving_export(str(root / "port")),
              path=root / "port", jax_path=root / "jax", exp=exp)


def _greedy(logits):
  return np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)


def _assert_caches(got, want, **tol):
  """A port cache against a JAX cache: the same blocks, cache types and
  leaves."""
  assert sorted(got) == sorted(want)
  for name in got:
    assert type(got[name]).__name__ == type(want[name]).__name__
    for g, w in zip(got[name], want[name]):
      np.testing.assert_allclose(g.double().numpy(),
                                 np.asarray(w, np.float64), err_msg=name,
                                 **tol)


def _assert_equal_caches(got, want):
  assert sorted(got) == sorted(want)
  for name in got:
    assert type(got[name]) is type(want[name])
    for g, w in zip(got[name], want[name]):
      assert torch.equal(g, w), name


def test_loaded_artifact_matches_jax_artifact(setup):
  """Prefill logits and cache at 1e-4; greedy tokens identical over 3
  decode steps, each step's logits at 1e-4."""
  tokens, positions = _inputs(1)
  jlogits, jcache = setup["jloaded"].prefill(
      setup["variables"], jnp.asarray(tokens), jnp.asarray(positions))
  logits, cache = setup["loaded"].prefill(
      setup["params"], torch.from_numpy(tokens), torch.from_numpy(positions))
  np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
  _assert_caches(cache, jcache, **TOL)
  tok, jtok = _greedy(logits), _greedy(jlogits)
  np.testing.assert_array_equal(tok, jtok)
  for step in range(STEPS):
    pos = np.full((BATCH, 1), PROMPT + step, np.int32)
    jlogits, jcache = setup["jloaded"].decode_step(
        setup["variables"], jcache, jnp.asarray(jtok), jnp.asarray(pos))
    logits, cache = setup["loaded"].decode_step(
        setup["params"], cache, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    tok, jtok = _greedy(logits), _greedy(jlogits)
    np.testing.assert_array_equal(tok, jtok)


def test_loaded_artifact_matches_live_functions(setup):
  """The loaded programs against the port's live serving functions, bit
  for bit: the prefill and a greedy decode chain."""
  prefill, decode_step = export_lib.make_serving_functions(setup["model"])
  params, loaded = setup["params"], setup["loaded"]
  tokens, positions = (torch.from_numpy(z) for z in _inputs(2))
  logits, cache = loaded.prefill(params, tokens, positions)
  with torch.no_grad():
    want_logits, want_cache = prefill(params, tokens, positions)
  assert torch.equal(logits, want_logits)
  _assert_equal_caches(cache, want_cache)
  for step in range(STEPS):
    tok = torch.from_numpy(_greedy(logits))
    pos = torch.full((BATCH, 1), PROMPT + step, dtype=torch.int32)
    logits, cache = loaded.decode_step(params, cache, tok, pos)
    with torch.no_grad():
      want_logits, want_cache = decode_step(params, want_cache, tok, pos)
    assert torch.equal(logits, want_logits)
    _assert_equal_caches(cache, want_cache)


def test_loaded_artifact_matches_live_model(setup):
  """The loaded prefill against ``Griffin.forward`` itself."""
  tokens, positions = (torch.from_numpy(z) for z in _inputs(3))
  logits, cache = setup["loaded"].prefill(setup["params"], tokens, positions)
  with torch.no_grad():
    want_logits, want_cache = setup["model"](tokens, positions,
                                             last_logits_only=True)
  assert torch.equal(logits, want_logits)
  _assert_equal_caches(cache, want_cache)


def test_params_in_any_order(setup):
  tokens, positions = (torch.from_numpy(z) for z in _inputs(4))
  params = dict(reversed(list(setup["params"].items())))
  got, _ = setup["loaded"].prefill(params, tokens, positions)
  want, _ = setup["loaded"].prefill(setup["params"], tokens, positions)
  assert torch.equal(got, want)


def test_export_from_shapes_only(setup, tmp_path):
  """Fake parameters (no weight memory) on a model built on the meta
  device give an artifact whose results are bit for bit those of the one
  exported from real weights."""
  mode = fake_tensor.FakeTensorMode()
  with mode:
    fakes = {name: torch.empty(p.shape, dtype=p.dtype)
             for name, p in setup["params"].items()}
  meta_model = griffin.Griffin(_port_config(), device="meta",
                               dtype=torch.float32, use_flash_attention=True)
  exp = export_lib.export_serving(meta_model, fakes, batch_size=BATCH,
                                  prompt_len=PROMPT,
                                  cache_dtype=torch.float32)
  export_lib.save_serving_export(exp, str(tmp_path))
  loaded = export_lib.load_serving_export(str(tmp_path))
  tokens, positions = (torch.from_numpy(z) for z in _inputs(5))
  got_logits, got_cache = loaded.prefill(setup["params"], tokens, positions)
  want_logits, want_cache = setup["loaded"].prefill(setup["params"], tokens,
                                                    positions)
  assert torch.equal(got_logits, want_logits)
  _assert_equal_caches(got_cache, want_cache)
  tok = torch.from_numpy(_greedy(got_logits))
  pos = torch.full((BATCH, 1), PROMPT, dtype=torch.int32)
  got, _ = loaded.decode_step(setup["params"], got_cache, tok, pos)
  want, _ = setup["loaded"].decode_step(setup["params"], want_cache, tok, pos)
  assert torch.equal(got, want)


def test_meta(setup):
  """JAX's ``test_meta`` fields, the port's own, and the artifact's size."""
  meta = setup["loaded"].meta
  assert meta["format"] == "cadence_gemma_tpu_torch.serving_export.v1"
  assert meta["batch_size"] == BATCH
  assert meta["prompt_len"] == PROMPT
  assert meta["cache_dtype"] == "float32"
  assert meta["num_devices"] == 1 and meta["mesh_axes"] is None
  assert meta["config"] == {
      "vocab_size": 32, "width": 16, "num_layers": 2,
      "attention_window_size": 8, "block_types": ["RECURRENT", "ATTENTION"],
  }
  assert meta["torch_version"] == torch.__version__
  assert meta["device_type"] == "cpu"
  assert json.loads((setup["path"] / "meta.json").read_text()) == meta
  # The artifact is programs + metadata, not weights: it stays small.
  files = sorted(f.name for f in setup["path"].iterdir())
  assert files == ["decode_step.pt2", "meta.json", "prefill.pt2"]
  total = sum(f.stat().st_size for f in setup["path"].iterdir())
  assert total < 5_000_000


def test_rejects_non_artifact(tmp_path):
  (tmp_path / "meta.json").write_text('{"format": "something-else"}')
  with pytest.raises(ValueError, match="not a serving export"):
    export_lib.load_serving_export(str(tmp_path))


def test_rejects_jax_artifact(setup):
  with pytest.raises(ValueError, match="not a serving export"):
    export_lib.load_serving_export(str(setup["jax_path"]))


def test_rejects_other_device_type(setup):
  """Inputs of another device type than the artifact's are refused (a
  meta tensor stands in for one here)."""
  tokens = torch.zeros(BATCH, PROMPT, dtype=torch.int32, device="meta")
  with pytest.raises(ValueError, match="'cpu'"):
    setup["loaded"].prefill(setup["params"], tokens, tokens)


def _op_counts(exp: export_lib.ServingExport) -> list[dict[str, int]]:
  """The nodes of each program (prefill, decode step) that call one of the
  port's operators, by operator name."""
  counts = []
  for blob in (exp.prefill, exp.decode_step):
    import io  # pylint: disable=import-outside-toplevel
    program = torch.export.load(io.BytesIO(blob))
    found = {}
    for node in program.graph.nodes:
      name = getattr(node.target, "name", lambda: "")()
      if name.startswith("cadence_gemma_tpu_torch::"):
        key = name.split("::")[1]
        found[key] = found.get(key, 0) + 1
    counts.append(found)
  return counts


def test_op_nodes_in_exported_graphs(setup):
  """One LRU op a recurrent block and one window op an attention block in
  the prefill; the decode step's one-token walk holds neither."""
  prefill, decode = _op_counts(setup["exp"])
  assert prefill == {"lru_scan_forward": 1, "window_attention_forward": 1}
  assert decode == {}


def test_op_nodes_with_fused_epilogue(setup):
  model = convert.griffin_from_flax_params(
      setup["variables"]["params"], _port_config(), device="cpu",
      dtype=torch.float32, use_flash_attention=True, fused_epilogue=True)
  exp = export_lib.export_serving(model, setup["params"], batch_size=BATCH,
                                  prompt_len=PROMPT,
                                  cache_dtype=torch.float32)
  prefill, decode = _op_counts(exp)
  assert prefill == {"lru_scan_forward": 1, "window_attention_forward": 1,
                     "add_rmsnorm": 2}
  assert decode == {"add_rmsnorm": 2}


def test_op_nodes_int8(setup, tmp_path):
  """A ``quantize_params`` copy: every weight-only product is the int8
  operator (7 projections and the gates' 2 in R, 6 in A, the logits'), and
  the loaded artifact reproduces the live quantized model bit for bit."""
  qparams = quantization.quantize_params(setup["model"].state_dict())
  qmodel = griffin.Griffin(_port_config(), device="meta", dtype=torch.float32,
                           use_flash_attention=True, quantized=True)
  exp = export_lib.export_serving(qmodel, qparams, batch_size=BATCH,
                                  prompt_len=PROMPT,
                                  cache_dtype=torch.float32)
  prefill, decode = _op_counts(exp)
  assert prefill == {"lru_scan_forward": 1, "window_attention_forward": 1,
                     "int8_weight_matmul": 14}
  assert decode == {"int8_weight_matmul": 14}
  export_lib.save_serving_export(exp, str(tmp_path))
  loaded = export_lib.load_serving_export(str(tmp_path))
  live = griffin.Griffin(_port_config(), device="cpu", dtype=torch.float32,
                         use_flash_attention=True, quantized=True)
  live.load_state_dict(qparams)
  tokens, positions = (torch.from_numpy(z) for z in _inputs(6))
  got, _ = loaded.prefill(qparams, tokens, positions)
  with torch.no_grad():
    want, _ = live(tokens, positions, last_logits_only=True)
  assert torch.equal(got, want)


_FRESH = """
import sys
import numpy as np
import torch
from cadence_gemma_tpu_torch.checkpoint import export as export_lib
from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.models import griffin
built = []
griffin.Griffin.__init__ = lambda *a, **k: built.append(1)
artifact, weights, inputs, out = sys.argv[1:]
loaded = export_lib.load_serving_export(artifact)
params = checkpoint_io.load_parameters(weights, device="cpu")
data = np.load(inputs)
logits, cache = loaded.prefill(params, torch.from_numpy(data["tokens"]),
                               torch.from_numpy(data["positions"]))
np.save(out, logits.numpy())
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax")),
      len(built))
"""


def test_fresh_process_reproduces_prefill(setup, tmp_path):
  """A new process that builds no ``Griffin`` loads the artifact and a
  checkpoint of the weights and gives the prefill's logits bit for bit."""
  weights = tmp_path / "weights.pt"
  checkpoint_io.save_parameters(str(weights), setup["params"])
  tokens, positions = _inputs(7)
  np.savez(tmp_path / "inputs.npz", tokens=tokens, positions=positions)
  env = dict(os.environ, PYTHONPATH=str(REPO))
  result = subprocess.run(
      [sys.executable, "-c", _FRESH, str(setup["path"]), str(weights),
       str(tmp_path / "inputs.npz"), str(tmp_path / "logits.npy")],
      capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300,
      check=False)
  assert result.returncode == 0, result.stderr
  assert result.stdout.split("\n")[-2] == "[] 0", result.stdout
  got = np.load(tmp_path / "logits.npy")
  want, _ = setup["loaded"].prefill(setup["params"],
                                    torch.from_numpy(tokens),
                                    torch.from_numpy(positions))
  np.testing.assert_array_equal(got, want.numpy())
