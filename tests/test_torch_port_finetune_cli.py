"""The port's ``finetune`` program against the JAX package's, on the CPU.

On ``test_torch_port_examples.py``'s world and patches, with its towers at
56 px (16 visual tokens: JAX's training steps compile for minutes at the
729-token length) and 4 LLaVA-style records over ``tests/fixtures``' images
(batch 2, 24 text tokens, 2 + 2 steps, learning rate 1e-2, validation on 2
records): the two-stage path, the LoRA path (the port starting from the
adapters JAX's ``init_adapters`` drew) and the QLoRA path must log JAX's
losses within 1e-4 relative and save JAX's final weights within the
tolerance ``test_torch_port_image_sft.py`` holds ``two_stage_sft`` to. JAX's
three runs start together in subprocesses. The usage error is pinned, and
``--mesh data:2,model:2`` runs to its end with JAX's two-stage losses and
weights.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.examples import finetune
from cadence_gemma_tpu_torch.training import lora as lora_lib
from tests import test_torch_port_examples as cli_tests

ADAPTER_RANK = cli_tests.ADAPTER_RANK


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  return cli_tests.make_world(tmp_path_factory.mktemp("finetune_world"))


@pytest.fixture
def train_patches(monkeypatch):
  cli_tests.patch_port(monkeypatch, cli_tests.TRAIN_TOWERS)
  return monkeypatch


def _finetune_argv(world, out_dir, *extra) -> list[str]:
  return [f"--tokenizer_path={world['tokenizer']}",
          f"--train_json={world['train_json']}",
          f"--val_json={world['val_json']}",
          f"--image_root={world['image_root']}", f"--output_dir={out_dir}",
          "--batch_size=2", "--max_seq_len=24", "--stage1_steps=2",
          "--stage2_steps=2", "--stage1_lr=1e-2", "--stage2_lr=1e-2",
          "--metrics=jsonl", *extra]


def _losses(out_dir) -> list[float]:
  with open(os.path.join(out_dir, "metrics.jsonl")) as f:
    return [json.loads(line)["train_loss"] for line in f]


def _assert_final_close(got: dict, want: dict, lr: float, updates: int):
  """``test_torch_port_image_sft.py``'s rule for two_stage_sft. The int8
  leaves of the QLoRA base: bit for bit, but for the connector's, which
  stage 1 trained before the quantization: there a weight that the two
  frameworks' summation orders leave on either side of a rounding boundary
  may take the next int8 step (at most 0.1 % of them)."""
  assert got.keys() == want.keys()
  outside = total = 0
  for name, value in want.items():
    assert got[name].dtype == value.dtype, name
    if value.dtype == torch.int8:
      steps = (got[name].int() - value.int()).abs()
      if name.startswith("vl_connector."):
        assert int(steps.max()) <= 1, name
        assert int((steps > 0).sum()) <= 1e-3 * value.numel(), name
      else:
        assert torch.equal(got[name], value), name
      continue
    err = (got[name].float() - value.float()).abs()
    assert float(err.max()) <= 2 * lr * updates, name
    outside += int((err > 1e-4 * float(value.abs().max())).sum())
    total += value.numel()
  assert outside <= 1e-3 * total, (outside, total)


FINETUNE_CASES = {
    "two_stage": [],
    "lora": [f"--lora_rank={ADAPTER_RANK}"],
    "qlora": [f"--lora_rank={ADAPTER_RANK}", "--lora_int8_base"],
}


@pytest.fixture(scope="module")
def jax_finetune(world, tmp_path_factory):
  """JAX's three fine-tuning runs, started together: {case: (process, its
  output directory, where its initial adapters go)}."""
  runs = {}
  for case, extra in FINETUNE_CASES.items():
    root = tmp_path_factory.mktemp(f"jax_{case}")
    (root / "out").mkdir()
    adapters = root / "adapters.orbax"
    proc = cli_tests.start_jax("finetune", [[
        f"--checkpoint_path={world['lm_jax']}",
        f"--vision_checkpoint={world['train_towers_jax']}",
        *_finetune_argv(world, root / "out", *extra)]],
        towers=cli_tests.TRAIN_TOWERS, adapters_out=str(adapters) if extra else None)
    runs[case] = (proc, root / "out", adapters)
  yield runs
  for proc, _, _ in runs.values():
    if proc.poll() is None:
      proc.kill()
      proc.communicate()


@pytest.mark.parametrize("case", list(FINETUNE_CASES))
def test_finetune_matches_jax(world, jax_finetune, train_patches, tmp_path,
                              case):
  """Stage 1 (the connector) then stage 2 (everything, or the adapters);
  the logged losses and the saved final weights against JAX's."""
  extra = FINETUNE_CASES[case]
  proc, jax_dir, adapters = jax_finetune[case]
  cli_tests.jax_outputs(proc)
  if extra:
    drawn = convert.state_dict_from_flax(
        cli_tests.jax_checkpoint_to_port.restore_tree(str(adapters)))
    train_patches.setattr(lora_lib, "init_adapters",
                          lambda model, generator: dict(drawn))
  port_dir = tmp_path / "port"
  port_dir.mkdir()
  cli_tests.run_port(finetune.main, [f"--checkpoint_path={world['lm']}",
                           f"--vision_checkpoint={world['train_towers']}",
                           *_finetune_argv(world, port_dir, *extra)])
  losses, want_losses = _losses(port_dir), _losses(jax_dir)
  assert len(losses) == len(want_losses) == 4
  np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
  want = convert.state_dict_from_flax(
      cli_tests.jax_checkpoint_to_port.restore_tree(str(jax_dir / "final")))
  got = checkpoint_io.load_parameters(str(port_dir / "final"), "cpu")
  _assert_final_close(got, want, 1e-2, 2)
  if case == "qlora":
    assert any(k.endswith("kernel_q") for k in got)
    assert any(lora_lib.is_lora_path(k) for k in got)
  else:
    assert not any(lora_lib.is_lora_path(k) for k in got)


def test_finetune_refusals(world, tmp_path, train_patches):
  del train_patches
  argv = [f"--checkpoint_path={world['lm']}",
          f"--vision_checkpoint={world['train_towers']}",
          *_finetune_argv(world, tmp_path)]
  with pytest.raises(SystemExit) as exit_info:
    finetune.main([*argv, "--lora_int8_base", "--device", "cpu"])
  assert exit_info.value.code != 0


def test_finetune_mesh_runs_to_its_end(world, jax_finetune, train_patches,
                                      tmp_path):
  """``--mesh data:2,model:2`` (the CPU repeated): stage 1 on one device,
  stage 2 DP x TP; JAX's single-device losses and final weights, by the
  two-stage rule (JAX's own mesh run equals its single-device one,
  ``test_train_loop.py:303-336``)."""
  del train_patches
  proc, jax_dir, _ = jax_finetune["two_stage"]
  if proc.returncode is None:  # the JAX run's output not read yet
    cli_tests.jax_outputs(proc)
  assert proc.returncode == 0
  cli_tests.run_port(finetune.main, [
      f"--checkpoint_path={world['lm']}",
      f"--vision_checkpoint={world['train_towers']}",
      *_finetune_argv(world, tmp_path, "--mesh", "data:2,model:2")])
  losses, want_losses = _losses(tmp_path), _losses(jax_dir)
  assert len(losses) == len(want_losses) == 4
  np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
  want = convert.state_dict_from_flax(
      cli_tests.jax_checkpoint_to_port.restore_tree(str(jax_dir / "final")))
  got = checkpoint_io.load_parameters(str(tmp_path / "final"), "cpu")
  _assert_final_close(got, want, 1e-2, 2)
