"""Phase 23 of ``chip_smoke.py`` (the serving export) alone, on the card.

Runs the smoke's phases 1 and 2 (the card; the kernels' build), builds
phase 18's models (the ``realistic_params`` 2B in bf16 and its weight-only
int8 copy, with phase 18's seeds, vocabulary and prompts) and runs
``phase_export`` on them, in about four minutes instead of the whole
smoke's fourteen.

  python3 tools/export_phase.py [--profile]

``--profile`` adds the kernel time of a loaded and a live prefill against
their times, as ``chip_smoke.py --profile`` does.
"""

from __future__ import annotations

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # pylint: disable=wrong-import-position
import torch  # pylint: disable=wrong-import-position

import chip_smoke as cs  # pylint: disable=wrong-import-position
from cadence_gemma_tpu_torch import common  # pylint: disable=wrong-import-position
from cadence_gemma_tpu_torch.checkpoint import synthetic  # pylint: disable=wrong-import-position
from cadence_gemma_tpu_torch.models import griffin  # pylint: disable=wrong-import-position
from cadence_gemma_tpu_torch.ops import quantization  # pylint: disable=wrong-import-position
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab  # pylint: disable=wrong-import-position


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
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1)
  model = griffin.Griffin(config, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator(dev).manual_seed(cs.SEED))
  state = synthetic.realistic_params(
      model, torch.Generator(dev).manual_seed(cs.SEED + 80))
  qmodel = griffin.Griffin(config, device="meta", quantized=True)
  qmodel.to_empty(device=dev)
  qmodel.load_state_dict(quantization.quantize_params(state))
  del state
  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(cs.SEED + 82)
  prompts = [" ".join(f"w{i}" for i in rng.integers(
      0, config.vocab_size - 4, n - 1)) for n in cs.PROMPT_TOKENS]
  kernels = [dict(name=name, launches=0) for name in (
      "lru_scan", "window_attention", "int8_weight_matmul",
      "int8_weight_matmul_wgmma", "add_rmsnorm")]
  cs.phase_export(dev, kernels, dict(model=model, qmodel=qmodel, vocab=vocab,
                                     prompts=prompts),
                  "--profile" in sys.argv[1:])
  cs.log(f"== total {time.perf_counter() - start:.1f} s")
  return 0


if __name__ == "__main__":
  sys.exit(main())
