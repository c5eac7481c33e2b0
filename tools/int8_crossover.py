"""Times both routes of the int8 weight-only product at the 2B's layouts
over a range of rows, on the card: the mma.sync kernel
(``csrc/int8_matmul.cu``) against the wgmma kernel (``csrc/int8_wgmma.cu``),
in turns (mma.sync, wgmma, wgmma, mma.sync; the faster of each pair), CUDA
events around a run of calls. ``int8_matmul.uses_wgmma`` is forced to one
route at a time; the last column is what the rule picks. The crossover
``int8_matmul.WGMMA_MIN_ROWS`` comes from this table. The input gradient
has one kernel (wgmma) at every shape; it is timed at the same rows, twice.

  python3 tools/int8_crossover.py [--json chiprun_out/int8_crossover.jsonl]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from cadence_gemma_tpu_torch.ops import int8_matmul  # pylint: disable=wrong-import-position

# layout -> (batches, n, k, shared activation), the 2B's.
LAYOUTS = {"dense": (1, 2560, 2560, False), "ffw_up": (2, 7680, 2560, True),
           "ffw_down": (1, 2560, 7680, False),
           "block_diagonal": (10, 256, 256, False),
           "logits": (1, 256000, 2560, False)}
ROWS = (64, 128, 192, 256, 384, 512, 1024, 3000, 6000)
LOGITS_ROWS = (16, 64, 128, 256, 512, 4096)


def operands(layout: str, m: int, gen: torch.Generator):
  batches, n, k, shared = LAYOUTS[layout]
  q = torch.randint(-127, 128, (batches, n, k), generator=gen, device="cuda",
                    dtype=torch.int8)
  scale = torch.rand(batches, n, generator=gen, device="cuda") * 1e-2
  if layout == "block_diagonal":  # the heads read in place from [m, 2560]
    x = torch.randn(m, batches * k, generator=gen,
                    device="cuda").bfloat16()
    a = x.view(m, batches, k).transpose(0, 1)
  else:
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    a = x[None].expand(batches, -1, -1) if shared else x[None]
  g = torch.randn(batches, m, n, generator=gen, device="cuda").bfloat16()
  return a, q, scale, g, shared


def ms(fn, reps: int) -> float:
  fn()
  torch.cuda.synchronize()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--json", help="also write one JSON line a shape")
  args = parser.parse_args()
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, check=True).stdout.strip()
  print(card, flush=True)
  rule = int8_matmul.uses_wgmma
  gen = torch.Generator("cuda").manual_seed(0)
  out = open(args.json, "w") if args.json else None
  try:
    for kind in ("forward", "dgrad"):
      for layout in LAYOUTS:
        for m in LOGITS_ROWS if layout == "logits" else ROWS:
          a, q, scale, g, shared = operands(layout, m, gen)
          if kind == "forward":
            fn = lambda: int8_matmul.int8_weight_matmul(a, q, scale)  # pylint: disable=cell-var-from-loop
          else:
            fn = lambda: int8_matmul.int8_weight_matmul_dgrad(  # pylint: disable=cell-var-from-loop
                g, q, scale, shared)
          reps = 3 if layout == "logits" and m >= 512 else 20
          times = {"mma.sync": [], "wgmma": []}
          turns = (("mma.sync", "wgmma", "wgmma", "mma.sync")
                   if kind == "forward" else ("wgmma", "wgmma"))
          for route in turns:
            int8_matmul.uses_wgmma = lambda _, r=route: r == "wgmma"
            times[route].append(ms(fn, reps))
          int8_matmul.uses_wgmma = rule
          best = {r: min(t) if t else None for r, t in times.items()}
          flops = 2.0 * q.numel() * m
          route = ("wgmma" if kind == "dgrad" or rule(m) else "mma.sync")
          row = dict(kind=kind, layout=layout, rows=m, card=card,
                     mma_sync_ms=best["mma.sync"], wgmma_ms=best["wgmma"],
                     wgmma_tflops=flops / best["wgmma"] / 1e9, rule=route)
          mma = ("-" if best["mma.sync"] is None
                 else f"{best['mma.sync']:.4f} ms")
          print(f"{kind:8s} {layout:15s} rows {m:5d}: mma.sync {mma}, wgmma "
                f"{best['wgmma']:.4f} ms ({row['wgmma_tflops']:.0f} "
                f"TFLOP/s); the rule takes {route}", flush=True)
          if out:
            out.write(json.dumps(row) + "\n")
          del a, q, scale, g
  finally:
    int8_matmul.uses_wgmma = rule
    if out:
      out.close()


if __name__ == "__main__":
  main()
