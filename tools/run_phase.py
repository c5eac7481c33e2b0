"""One phase of ``chip_smoke.py`` alone, on the card.

  python3 tools/run_phase.py NAME [--profile]

Runs the smoke's phases 1 and 2 (the card; the kernels' build), builds what
the phase takes (phase 18's models with the smoke's own ``realistic_2b``:
the ``realistic_params`` 2B in bf16 and its weight-only int8 copy) and runs
the phase, in minutes instead of the whole smoke's. NAME is one of:

  tp                phase 25, tensor-parallel serving (and phase 21's carry
                    walk, whose row it reports);
  tp_training       phase 26, DP x TP training;
  tp_extras         phase 27, the sharded towers, TP multi-LoRA, the TP
                    export;
  pipeline          phase 28, pipeline parallelism;
  process_per_card  phase 29, one process a card (two gloo ranks on the
                    card, NCCL in a group of one);
  export            phase 23, the serving export (``--profile`` adds its
                    profile);
  cli               phase 24, the command-line programs.

Where the phase adds to the kernels line, the last line is its rows (the
phase's launches, errors and shard-shape figures) as that line's JSON.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # pylint: disable=wrong-import-position

import chip_smoke as cs  # pylint: disable=wrong-import-position


def _rows(rows: dict) -> list[dict]:
  kernels = [dict(name=name, launches=0, max_abs_err=0.0) for name in rows]
  cs.add_phase_rows(kernels, rows)
  return kernels


def _tp(dev, profile):
  del profile
  kernels = [dict(name=name, launches=0, max_abs_err=0.0) for name in (
      "lru_scan", "window_attention", "add_rmsnorm", "int8_weight_matmul",
      "int8_weight_matmul_wgmma")]
  kernels.append(cs.phase_carry_walk(dev))
  cs.add_row_launches(kernels, cs.phase_tensor_parallel(
      dev, kernels, cs.realistic_2b(dev)))
  return kernels


def _with_dir(prefix: str, run):
  root = tempfile.mkdtemp(prefix=prefix)
  try:
    run(root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _export(dev, profile):
  kernels = [dict(name=name, launches=0) for name in (
      "lru_scan", "window_attention", "int8_weight_matmul",
      "int8_weight_matmul_wgmma", "add_rmsnorm")]
  handoff = cs.realistic_2b(dev)
  _with_dir("export-phase-", lambda root: cs.phase_export(
      dev, kernels, handoff, profile, root))


def _cli(dev, profile):
  del profile
  handoff = cs.realistic_2b(dev)
  _with_dir("cli-phase-", lambda root: cs.phase_cli(dev, handoff, root))


PHASES = {
    "tp": _tp,
    "tp_training": lambda dev, _: _rows(cs.phase_tp_training(
        dev, cs.realistic_2b(dev))),
    "tp_extras": lambda dev, _: _rows(cs.phase_tp_extras(
        dev, cs.realistic_2b(dev))),
    "pipeline": lambda dev, _: _rows(cs.phase_pipeline(
        dev, cs.realistic_2b(dev))),
    "process_per_card": lambda dev, _: _rows(cs.phase_process_per_card(dev)),
    "export": _export,
    "cli": _cli,
}


def main() -> int:
  names = [a for a in sys.argv[1:] if not a.startswith("--")]
  if len(names) != 1 or names[0] not in PHASES:
    print(f"usage: run_phase.py {{{','.join(PHASES)}}} [--profile]",
          file=sys.stderr)
    return 2
  if not torch.cuda.is_available():
    print("run_phase.py needs a CUDA device.", file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  start = time.perf_counter()
  cs.phase_card()
  cs.phase_build()
  kernels = PHASES[names[0]](dev, "--profile" in sys.argv[1:])
  cs.log(f"== total {time.perf_counter() - start:.1f} s")
  if kernels is not None:
    print(json.dumps({"kernels": kernels}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
