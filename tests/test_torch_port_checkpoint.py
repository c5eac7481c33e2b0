"""The port's checkpoints, resume, preemption and prefetch, on the CPU.

``test_torch_port_lora.py``'s tiny Griffin (blocks R, A; width 16; float32;
seeded numpy adapters) trains under the port's ``train_loop``:

  * the checkpoint format keeps every leaf's dtype (bf16, float32, int8) and
    a failed save leaves the previous checkpoint; an asynchronous save
    holds the values it was given, not later in-place updates;
  * a run resumed from ``step_2`` equals the uninterrupted 3-step run bit
    for bit: full fine-tuning, ``freeze_llm``, LoRA, gradient accumulation
    saved mid-window, and a skipped non-finite step; a preemption writes
    ``preempted_step_k``; ``prefetch_batches=2`` gives the bits of 0;
  * a resumed LoRA run against JAX's uninterrupted ``train_loop`` (adapters
    within 1e-4 of each leaf's largest value, ``test_torch_port_lora.py``'s
    tolerance), and JAX's multi-epoch resume, which trains no epoch after
    the first, beside the port's, which equals the uninterrupted run;
  * ``with_retries`` and ``PreemptionHandler`` against JAX's, and the timm
    import against JAX's ``timm_vit_to_flax`` -> ``encoder_from_flax_params``
    on a synthesized timm state dict.
"""

import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu.checkpoint import timm_import as jtimm
from cadence_gemma_tpu.models import vit as jvit
from cadence_gemma_tpu.training import data as jdata
from cadence_gemma_tpu.training import lora as jlora
from cadence_gemma_tpu.training import train_loop as jtrain_loop
from cadence_gemma_tpu.utils import resilience as jresilience
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.checkpoint import timm_import
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.models import vit
from cadence_gemma_tpu_torch.ops import quantization
from cadence_gemma_tpu_torch.training import data
from cadence_gemma_tpu_torch.training import lora
from cadence_gemma_tpu_torch.training import train_loop as tl
from cadence_gemma_tpu_torch.utils import resilience
from tests import test_torch_port_lora as lora_case
from tests import test_vit as jvit_case

PAD = lora_case.PAD
LR = 1e-2
NAN_MARK = 47  # a batch whose first row holds this token has a NaN loss


@pytest.fixture(scope="module")
def jax_params():
  """The LoRA model's float32 tree: JAX's base init, random adapters."""
  params = lora_case._jax_model().init(
      jax.random.PRNGKey(0), jnp.ones((1, 6), jnp.int32),
      jnp.arange(6)[None], return_cache=False)["params"]
  params = jax.tree_util.tree_map(np.asarray, params)
  return lora_case._randomize_adapters(params, seed=1)


def _batches(n=3, image=False):
  """``n`` distinct batches (the test batch, rolled); with ``image`` each
  carries [2, 4, 12] features as its pixels (``_encode`` passes them on)."""
  out = []
  for i in range(n):
    tokens = np.roll(lora_case.TOKENS, i, axis=1).copy()
    tokens[:, 0] = 1
    pixels = None
    if image:
      rng = np.random.default_rng(10 + i)
      pixels = rng.standard_normal((2, 4, 12)).astype(np.float32)
    out.append(data.TrainingInput(tokens, tokens != PAD, pixels=pixels))
  return out


def _encode(pixels):
  return pixels


def _models(jax_params, case, seed):
  """A fresh model of ``case``; a LoRA model's adapters drawn from
  ``seed`` (a resumed run must not depend on them)."""
  if case == "lora":
    return lora_case._port_model(
        lora_case._randomize_adapters(jax_params, seed=seed))
  return lora_case._port_model(jlora.split_lora(jax_params)[1], lora_rank=0)


def _nan_on_mark(module, args, output):
  if bool((args[0][0] == NAN_MARK).any()):
    return output[0] * float("nan"), output[1]
  return None


_RESUME_CASES = {
    "full": (dict(), {}),
    "freeze_llm": (dict(freeze_llm=True), dict(image=True)),
    "lora": (dict(lora=True), {}),
    # Saved two microbatches into a window of three: the update comes at 3.
    "accumulation": (dict(gradient_accumulation_steps=3), {}),
    # Steps 2 and 3 are non-finite and skipped; step 3 reports a count of 2
    # only if step 2's count was restored.
    "nonfinite": (dict(skip_nonfinite_updates=True), dict(nan_from=1)),
}


def _case_data(case):
  fields, extra = _RESUME_CASES[case]
  batches = _batches(image=extra.get("image", False))
  for batch in batches[extra.get("nan_from", 3):]:
    batch.input_tokens[0, 1] = NAN_MARK
  return fields, batches


def _train(model, batches, config, **kwargs):
  logged = []
  model.register_forward_hook(_nan_on_mark)
  tl.train_loop(model, batches, config, device="cpu",
                encode_image=_encode if batches[0].pixels is not None
                else None,
                log_metrics=lambda m, s: logged.append((s, m)), **kwargs)
  return logged


def _assert_same_state(a, b):
  got, want = a.state_dict(), b.state_dict()
  assert list(got) == list(want)
  for name in want:
    assert torch.equal(got[name], want[name]), name


# -- the format -------------------------------------------------------------


def test_parameters_round_trip_keeps_dtypes(tmp_path, jax_params):
  model = lora_case._port_model(jax_params)
  state = model.state_dict()
  trees = {
      "bf16": {n: v.to(torch.bfloat16) for n, v in state.items()},
      "int8": quantization.quantize_params(lora.split_lora(state)[1]),
      "lora": lora.split_lora(state)[0],
  }
  assert any(v.dtype == torch.int8 for v in trees["int8"].values())
  for name, tree in trees.items():
    path = str(tmp_path / name)
    checkpoint_io.save_parameters(path, tree)
    back = checkpoint_io.load_parameters(path, device="cpu")
    assert list(back) == list(tree)
    for leaf, value in tree.items():
      assert back[leaf].dtype == value.dtype, (name, leaf)
      assert torch.equal(back[leaf], value), (name, leaf)
  # A LoRA checkpoint's adapters merge back into the base.
  merged = lora.merge_params(lora.split_lora(state)[1],
                             checkpoint_io.load_parameters(
                                 str(tmp_path / "lora"), device="cpu"))
  assert all(torch.equal(merged[n], state[n]) for n in state)


def test_train_state_round_trip(tmp_path):
  w = torch.nn.Parameter(torch.randn(4, 3))
  optimizer = torch.optim.AdamW([w], lr=0.1)
  w.grad = torch.randn(4, 3)
  optimizer.step()
  path = str(tmp_path / "state")
  opt_state = {"optimizer": optimizer.state_dict(), "micro_step": 2,
               "grads": {"w": torch.ones(4, 3)}}
  checkpoint_io.save_train_state(path, {"w": w}, opt_state, 7)
  params, back, step = checkpoint_io.load_train_state(path, device="cpu")
  assert step == 7 and back["micro_step"] == 2
  assert torch.equal(params["w"], w.detach())
  assert torch.equal(back["grads"]["w"], torch.ones(4, 3))
  fresh = torch.optim.AdamW([torch.nn.Parameter(w.detach().clone())], lr=0.1)
  fresh.load_state_dict(back["optimizer"])
  for key in ("exp_avg", "exp_avg_sq", "step"):
    assert torch.equal(fresh.state_dict()["state"][0][key],
                       optimizer.state_dict()["state"][0][key]), key


def test_checkpoint_loads_need_the_format_a_card_and_one_device(tmp_path,
                                                                monkeypatch):
  path = str(tmp_path / "other")
  torch.save({"params": {}}, path)
  with pytest.raises(ValueError, match="not a checkpoint"):
    checkpoint_io.load_parameters(path, device="cpu")
  with pytest.raises(NotImplementedError, match="item 14c"):
    checkpoint_io.load_parameters(path, device="cpu", sharding="replicated")
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    checkpoint_io.load_parameters(path)


def test_failed_save_leaves_the_previous_checkpoint(tmp_path):
  path = str(tmp_path / "ckpt")
  good = {"w": torch.arange(6.0)}
  checkpoint_io.save_parameters(path, good)
  with pytest.raises(Exception):  # a leaf pickle refuses
    checkpoint_io.save_parameters(path, {"w": lambda: None})
  assert torch.equal(checkpoint_io.load_parameters(path, device="cpu")["w"],
                     good["w"])
  assert os.listdir(tmp_path) == ["ckpt"]  # no temporary file left


def test_async_save_holds_the_values_it_was_given(tmp_path):
  w = torch.arange(1000.0)
  moments = {"m": torch.ones(10)}
  path = str(tmp_path / "async")
  with checkpoint_io.AsyncTrainStateSaver() as saver:
    saver.save(path, {"w": w}, moments, 3)
    w.add_(1.0)  # the next step's in-place update
    moments["m"].mul_(5.0)
    saver.save(path + "b", {"w": w}, moments, 4)  # waits for the first
  params, state, step = checkpoint_io.load_train_state(path, device="cpu")
  assert step == 3 and torch.equal(params["w"], torch.arange(1000.0))
  assert torch.equal(state["m"], torch.ones(10))
  params, _, step = checkpoint_io.load_train_state(path + "b", device="cpu")
  assert step == 4 and torch.equal(params["w"], torch.arange(1000.0) + 1)


def test_async_save_reraises_its_error(tmp_path):
  saver = checkpoint_io.AsyncTrainStateSaver()
  saver.save(str(tmp_path / "x"), {"w": torch.ones(2)}, {"f": lambda: 0}, 1)
  with pytest.raises(Exception):
    saver.wait()
  saver.wait()  # the error is reported once


# -- resume, preemption, prefetch ------------------------------------------


@pytest.mark.parametrize("case", list(_RESUME_CASES))
def test_resume_equals_the_uninterrupted_run(tmp_path, jax_params, case):
  fields, batches = _case_data(case)
  config = tl.TrainingConfig(learning_rate=LR, eval_every_n=1, max_steps=3,
                             checkpoint_every_n=2,
                             checkpoint_dir=str(tmp_path), **fields)
  whole = _models(jax_params, case, seed=1)
  logged = _train(whole, batches, config)
  assert sorted(os.listdir(tmp_path)) == ["step_2"]

  resumed = _models(jax_params, case, seed=2)
  logged_resumed = _train(resumed, batches, tl.TrainingConfig(
      learning_rate=LR, eval_every_n=1, max_steps=3,
      resume_from=str(tmp_path / "step_2"), **fields))
  _assert_same_state(resumed, whole)
  assert [s for s, _ in logged_resumed] == [3]
  assert logged_resumed[0][1].get("consecutive_nonfinite_steps") == (
      logged[-1][1].get("consecutive_nonfinite_steps"))
  if case == "nonfinite":
    assert logged[-1][1]["consecutive_nonfinite_steps"] == 2.0
  # The checkpoint holds the combined tree; LoRA's optimizer state is
  # adapter-sized, freeze_llm's the connector's.
  params, state, step = checkpoint_io.load_train_state(
      str(tmp_path / "step_2"), device="cpu")
  assert step == 2 and list(params) == list(whole.state_dict())
  sizes = {t.numel() for s in state["optimizer"]["state"].values()
           for t in s.values() if t.ndim}
  if case == "lora":
    assert max(sizes) <= max(p.numel() for p in lora.lora_parameters(whole))
  elif case == "freeze_llm":
    assert max(sizes) <= max(p.numel() for p in
                             whole.vl_connector.parameters())
  assert bool(state["grads"]) == (case == "accumulation")
  assert state["micro_step"] == (2 if case == "accumulation" else 0)


def test_resume_refuses_another_accumulation_window(tmp_path, jax_params):
  fields, batches = _case_data("accumulation")
  _train(_models(jax_params, "full", 1), batches, tl.TrainingConfig(
      learning_rate=LR, max_steps=2, checkpoint_every_n=2,
      checkpoint_dir=str(tmp_path), **fields))
  with pytest.raises(ValueError, match="gradient_accumulation_steps"):
    _train(_models(jax_params, "full", 1), batches, tl.TrainingConfig(
        resume_from=str(tmp_path / "step_2"), gradient_accumulation_steps=2))


def test_preemption_writes_preempted_step_and_resumes(tmp_path, jax_params):
  _, batches = _case_data("lora")
  handler = resilience.PreemptionHandler()
  model = _models(jax_params, "lora", seed=1)
  steps = []

  def log(metrics, step):
    steps.append((step, sorted(metrics)))
    if step == 1:
      handler.trigger()  # the notice arrives during step 2

  model.register_forward_hook(lambda *_: steps.append("forward"))
  tl.train_loop(model, batches, tl.TrainingConfig(
      learning_rate=LR, eval_every_n=1, lora=True,
      checkpoint_dir=str(tmp_path), checkpoint_every_n=None),
                device="cpu", log_metrics=log, preemption=handler)
  assert steps.count("forward") == 2
  assert steps[-1] == (2, ["preempted_at"])
  assert os.listdir(tmp_path) == ["preempted_step_2"]

  whole = _models(jax_params, "lora", seed=1)
  _train(whole, batches, tl.TrainingConfig(learning_rate=LR, lora=True,
                                           checkpoint_every_n=None))
  resumed = _models(jax_params, "lora", seed=3)
  _train(resumed, batches, tl.TrainingConfig(
      learning_rate=LR, lora=True,
      resume_from=str(tmp_path / "preempted_step_2")))
  _assert_same_state(resumed, whole)


def test_prefetch_gives_the_bits_of_no_prefetch(jax_params):
  _, batches = _case_data("freeze_llm")
  runs = []
  for prefetch in (0, 2):
    model = _models(jax_params, "full", seed=1)
    _train(model, batches, tl.TrainingConfig(
        learning_rate=LR, num_epochs=2, max_steps=5, freeze_llm=True,
        prefetch_batches=prefetch))
    runs.append(model)
  _assert_same_state(runs[1], runs[0])


def test_prefetch_keeps_order_reraises_and_stops():
  def source(fail_at=None):
    for i in range(6):
      if i == fail_at:
        raise OSError(f"batch {i} unreadable")
      yield data.TrainingInput(np.full((1, 2), i, np.int32),
                               np.ones((1, 2), bool))

  got = [int(b.input_tokens[0, 0])
         for b in data.prefetch_to_device(source(), 2, device="cpu")]
  assert got == list(range(6))
  with pytest.raises(OSError, match="batch 3"):
    list(data.prefetch_to_device(source(fail_at=3), 2, device="cpu"))
  gen = data.prefetch_to_device(source(), 1, device="cpu")
  next(gen)
  gen.close()
  deadline = time.monotonic() + 5
  while any(t.name == "cadence-data-prefetch" for t in threading.enumerate()):
    assert time.monotonic() < deadline, "the producer outlived its consumer"
    time.sleep(0.01)


# -- against the JAX loop ---------------------------------------------------


def _jax_lora_run(params, batches, tmp, **fields):
  config = jtrain_loop.TrainingConfig(learning_rate=LR, lora=True,
                                      eval_every_n=1000, **fields)
  jbatches = [jdata.TrainingInput(input_tokens=b.input_tokens,
                                  target_mask=b.target_mask)
              for b in batches]
  out = jtrain_loop.train_loop(
      lora_case._jax_model(), jax.tree_util.tree_map(jnp.asarray, params),
      jbatches, config, log_metrics=lambda *_: None)
  return convert.state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             out))


def test_resumed_run_matches_jax_uninterrupted(tmp_path, jax_params):
  _, batches = _case_data("lora")
  want = _jax_lora_run(jax_params, batches, tmp_path, max_steps=3,
                       checkpoint_every_n=None)
  _train(_models(jax_params, "lora", seed=1), batches, tl.TrainingConfig(
      learning_rate=LR, lora=True, max_steps=2, checkpoint_every_n=2,
      checkpoint_dir=str(tmp_path)))
  resumed = _models(jax_params, "lora", seed=2)
  _train(resumed, batches, tl.TrainingConfig(
      learning_rate=LR, lora=True, max_steps=3,
      resume_from=str(tmp_path / "step_2")))
  for name, value in resumed.state_dict().items():
    if lora.is_lora_path(name):
      tol = 1e-4 * float(want[name].abs().max())
      torch.testing.assert_close(value, want[name], atol=tol, rtol=0,
                                 msg=name)
    else:
      assert torch.equal(value, want[name]), name


def test_multi_epoch_resume_jax_quirk_and_the_port(tmp_path, jax_params):
  """JAX fast-forwards ``skip < step`` in every epoch (``train_loop.py:
  296-298``): a run resumed from ``step_2`` over 2 epochs of 3 batches
  trains step 3 and then skips all of epoch 2, ending where the 1-epoch run
  ends. The port skips the first 2 batches of the stream once and equals
  the uninterrupted 2-epoch run."""
  _, batches = _case_data("lora")
  jdir = tmp_path / "jax"
  one_epoch = _jax_lora_run(jax_params, batches, jdir, checkpoint_every_n=2,
                            checkpoint_dir=str(jdir))
  resumed_j = _jax_lora_run(jax_params, batches, jdir, num_epochs=2,
                            checkpoint_every_n=None,
                            resume_from=str(jdir / "step_2"))
  two_epochs = _jax_lora_run(jax_params, batches, jdir, num_epochs=2,
                             checkpoint_every_n=None)
  adapters = [n for n in one_epoch if lora.is_lora_path(n)]
  for name in adapters:
    np.testing.assert_allclose(resumed_j[name].numpy(),
                               one_epoch[name].numpy(), rtol=1e-6,
                               atol=1e-7, err_msg=name)
  assert any(not torch.allclose(resumed_j[n], two_epochs[n], atol=1e-4)
             for n in adapters)

  pdir = tmp_path / "port"
  whole = _models(jax_params, "lora", seed=1)
  _train(whole, batches, tl.TrainingConfig(
      learning_rate=LR, lora=True, num_epochs=2, checkpoint_every_n=2,
      checkpoint_dir=str(pdir)))
  resumed = _models(jax_params, "lora", seed=2)
  logged = _train(resumed, batches, tl.TrainingConfig(
      learning_rate=LR, lora=True, num_epochs=2, eval_every_n=1,
      resume_from=str(pdir / "step_2")))
  assert [s for s, _ in logged] == [3, 4, 5, 6]
  _assert_same_state(resumed, whole)


# -- resilience -------------------------------------------------------------


@pytest.mark.parametrize("failures,retries", [(0, 3), (2, 3), (4, 3)])
def test_with_retries_matches_jax(monkeypatch, failures, retries):
  monkeypatch.setattr(time, "sleep", lambda s: None)
  traces = []
  for lib in (jresilience, resilience):
    calls, retried = [], []

    def flaky(x):
      calls.append(x)
      if len(calls) <= failures:
        raise OSError(f"attempt {len(calls)}")
      return x * 2

    wrapped = lib.with_retries(flaky, retries=retries,
                               on_retry=lambda a, e: retried.append(a))
    try:
      result = wrapped(21)
    except OSError as e:
      result = str(e)
    traces.append((result, len(calls), retried))
  assert traces[0] == traces[1]
  assert resilience.with_retries(retries=1)(lambda: 5)() == 5


def test_preemption_handler_matches_jax():
  for lib in (jresilience, resilience):
    seen = []
    previous = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
      handler = lib.PreemptionHandler(signals=(signal.SIGUSR1,))
      assert not handler.triggered
      with handler:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5
        while not handler.triggered:
          assert time.monotonic() < deadline
          time.sleep(0.01)
      assert seen == [signal.SIGUSR1]  # the previous handler ran too
      os.kill(os.getpid(), signal.SIGUSR1)  # restored on exit
      time.sleep(0.05)
      assert seen == [signal.SIGUSR1] * 2
      manual = lib.PreemptionHandler()
      manual.trigger()
      assert manual.triggered
    finally:
      signal.signal(signal.SIGUSR1, previous)


# -- timm import ------------------------------------------------------------


def _tiny_towers():
  dino = jvit_case.tiny_cfg(num_prefix_tokens=5, use_layer_scale=True,
                            output_layer=1)
  siglip = jvit_case.tiny_cfg(output_layer=1, gelu_approximate=True)
  return dino, siglip


def _port_vit_config(config):
  return vit.ViTConfig(**{f: getattr(config, f)
                          for f in vit.ViTConfig.__dataclass_fields__})


@pytest.mark.parametrize("pos_grid", [None, 8, 3])
def test_timm_import_matches_jax(pos_grid):
  fake = jvit_case.TestTimmConversion._fake_state_dict
  dino_j, siglip_j = _tiny_towers()
  dino_sd = fake(None, dino_j, with_prefix=True, with_ls=True,
                 pos_grid=pos_grid)
  siglip_sd = fake(None, siglip_j, with_prefix=False, with_ls=False,
                   pos_grid=pos_grid)
  dino_sd["blocks.2.norm1.weight"] = np.ones(16, np.float32)  # past layer 1
  torch_sd = {k: torch.from_numpy(v) for k, v in siglip_sd.items()}
  dino_p, siglip_p = _port_vit_config(dino_j), _port_vit_config(siglip_j)

  got = timm_import.load_dino_siglip_encoder_params(
      dino_sd, torch_sd, dino_p, siglip_p)
  want_tree = jtimm.load_dino_siglip_encoder_params(
      dino_sd, siglip_sd, dino_j, siglip_j)
  want = convert.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, want_tree))
  assert sorted(got) == sorted(want)
  for name, value in want.items():
    # The position embedding's resize sums in another order; the rest is
    # the same numbers renamed.
    tol = 1e-5 if name.endswith(("pos_embed", "prefix_tokens")) else 0.0
    torch.testing.assert_close(got[name], value, atol=tol, rtol=0,
                               msg=name)

  encoder = vit.DinoSigLIPEncoder(dino_p, siglip_p, device="meta",
                                  dtype=torch.float32)
  encoder.to_empty(device="cpu")
  encoder.load_state_dict(got)
  reference = convert.encoder_from_flax_params(
      want_tree, dino_p, siglip_p, device="cpu", dtype=torch.float32)
  pixels = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(0))
  with torch.no_grad():
    torch.testing.assert_close(encoder(pixels), reference(pixels),
                               atol=1e-4, rtol=1e-4)


def test_timm_import_checks_prefix_tokens():
  dino_j, _ = _tiny_towers()
  sd = jvit_case.TestTimmConversion._fake_state_dict(
      None, dino_j, with_prefix=True, with_ls=True)
  with pytest.raises(ValueError, match="prefix tokens"):
    timm_import.timm_vit_to_state_dict(
        sd, _port_vit_config(jvit_case.tiny_cfg(num_prefix_tokens=2,
                                                use_layer_scale=True)))
