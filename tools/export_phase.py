"""Phase 23 of ``chip_smoke.py`` (the serving export) alone, on the card.

Runs the smoke's phases 1 and 2 (the card; the kernels' build), builds
phase 18's models with the smoke's own ``realistic_2b`` (the
``realistic_params`` 2B in bf16 and its weight-only int8 copy, with phase
18's vocabulary and prompts) and runs ``phase_export`` on them (the first
``EXPORT_BLOCKS`` blocks of each), in a few minutes instead of the whole
smoke's.

  python3 tools/export_phase.py [--profile]

``--profile`` adds the kernel time of a loaded and a live prefill against
their times, as ``chip_smoke.py --profile`` does.
"""

from __future__ import annotations

import pathlib
import shutil
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # pylint: disable=wrong-import-position

import chip_smoke as cs  # pylint: disable=wrong-import-position


def main() -> int:
  if not torch.cuda.is_available():
    print("export_phase.py needs a CUDA device.", file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  start = time.perf_counter()
  cs.phase_card()
  cs.phase_build()
  handoff = cs.realistic_2b(dev)
  kernels = [dict(name=name, launches=0) for name in (
      "lru_scan", "window_attention", "int8_weight_matmul",
      "int8_weight_matmul_wgmma", "add_rmsnorm")]
  root = tempfile.mkdtemp(prefix="export-phase-")
  try:
    cs.phase_export(dev, kernels, handoff, "--profile" in sys.argv[1:], root)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  cs.log(f"== total {time.perf_counter() - start:.1f} s")
  return 0


if __name__ == "__main__":
  sys.exit(main())
