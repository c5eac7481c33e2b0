"""Phase 28 of ``chip_smoke.py`` (pipeline parallelism) alone, on the card.

Runs the smoke's phases 1 and 2 (the card; the kernels' build), builds
phase 18's models with the smoke's own ``realistic_2b`` (the
``realistic_params`` 2B in bf16 and its weight-only int8 copy) and runs
``phase_pipeline`` on them, in a few minutes instead of the whole smoke's.
The last line is the phase's launches, errors and microbatch-shape figures
as rows of the kernels line.

  python3 tools/pp_phase.py
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # pylint: disable=wrong-import-position

import chip_smoke as cs  # pylint: disable=wrong-import-position


def main() -> int:
  if not torch.cuda.is_available():
    print("pp_phase.py needs a CUDA device.", file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  start = time.perf_counter()
  cs.phase_card()
  cs.phase_build()
  handoff = cs.realistic_2b(dev)
  rows = cs.phase_pipeline(dev, handoff)
  kernels = [dict(name=name, launches=0, max_abs_err=0.0) for name in rows]
  cs.add_phase_rows(kernels, rows)
  cs.log(f"== total {time.perf_counter() - start:.1f} s")
  print(json.dumps({"kernels": kernels}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
