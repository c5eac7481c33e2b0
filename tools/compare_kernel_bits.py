#!/usr/bin/env python3
"""Holds this checkout's port kernels against another checkout's, on one GPU.

  python3 tools/compare_kernel_bits.py --other DIR

``DIR`` is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive``). The script runs itself twice
in child processes, once with each checkout's ``cadence_gemma_tpu_torch`` on
``PYTHONPATH``, in the order other, this, this, other. Each child builds its
checkout's kernels, runs the API the two share (the RG-LRU forward and
cotangent scans, the window attention forward, dq and dk/dv, each without a
key halo: ``kv_prefix`` is 0 where the wrappers take it) on the same seeded
inputs at the shapes of the RecurrentGemma-2B prefill and training step,
saves the outputs and times each call (CUDA events, mean of 20 after a
warm-up). The parent process checks that every output is bit-identical
across the four runs and prints the times side by side with the card's name
and power limit. Exits 1 without a CUDA device, and on any difference.

Against a checkout from before the Hopper redesign of the window attention
forward, that forward (and the dq, dk/dv calls fed its out and lse) reports
different bits; against one from before the redesign of the backward pair,
dq and dk/dv do: the wgmma kernels sum in another order. Those are expected
differences: the card tests and ``chip_smoke.py`` hold each kernel to its
plain version instead, at unchanged tolerances.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent


def _child(out_path: str) -> None:
  import numpy as np  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.ops import lru_scan  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.ops import window_attention as wa  # pylint: disable=import-outside-toplevel

  dev = torch.device("cuda", 0)
  rng = np.random.default_rng(0)

  def tensor(shape, bf16=True):
    z = torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
    return z.bfloat16() if bf16 else z

  b, t, d = 2, 3000, 2560
  x, g = tensor((b, t, d)), tensor((b, t, d))
  a = torch.sigmoid(tensor((b, t, d), bf16=False)).bfloat16()
  h0 = tensor((b, d), bf16=False)
  n, h, window = 10, 256, 2048
  q, k, v, d_out = (tensor(s) for s in ((b, t, n, h), (b, t, 1, h),
                                        (b, t, 1, h), (b, t, n, h)))
  seg = np.tile(np.arange(t, dtype=np.int32), (b, 1))
  seg[0, 1500:] = np.arange(t - 1500)
  seg[1] = np.maximum(np.arange(t) - 700, -1)
  seg = torch.tensor(seg, device=dev)
  out, lse = wa.window_attention_forward(q, k, v, seg, window)
  delta = wa.attention_delta(out, d_out)
  bwd_args = (q, k, v, seg, lse, delta, d_out, window)
  # The training step's attention: 4096 tokens, row 1 right-padded after
  # 3000 (its pad positions repeat the last real one).
  t_train = 4096
  qt, kt, vt, dt = (tensor(s) for s in ((b, t_train, n, h),
                                        (b, t_train, 1, h),
                                        (b, t_train, 1, h),
                                        (b, t_train, n, h)))
  seg_t = np.tile(np.arange(t_train, dtype=np.int32), (b, 1))
  seg_t[1, 3000:] = 2999
  seg_t = torch.tensor(seg_t, device=dev)
  out_t, lse_t = wa.window_attention_forward(qt, kt, vt, seg_t, window)
  train_args = (qt, kt, vt, seg_t, lse_t, wa.attention_delta(out_t, dt), dt,
                window)

  calls = {
      "lru_scan_forward": lambda: lru_scan.lru_scan_forward(x, a, h0),
      "lru_scan_forward_reverse_f32": lambda: lru_scan.lru_scan_forward(
          x.float(), a.float(), None, True),
      "lru_scan_backward": lambda: lru_scan.lru_scan_backward(g, a, h0),
      "window_attention_forward": lambda: wa.window_attention_forward(
          q, k, v, seg, window),
      "window_attention_dq": lambda: wa.window_attention_dq(*bwd_args),
      "window_attention_dkv": lambda: wa.window_attention_dkv(*bwd_args),
      "window_attention_dq_train": lambda: wa.window_attention_dq(
          *train_args),
      "window_attention_dkv_train": lambda: wa.window_attention_dkv(
          *train_args),
  }
  outputs, times = {}, {}
  for name, fn in calls.items():
    result = fn()
    result = result if isinstance(result, tuple) else (result,)
    outputs[name] = [z.cpu() for z in result]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
      fn()
    end.record()
    end.synchronize()
    times[name] = start.elapsed_time(end) / 20
  torch.save({"outputs": outputs, "times": times}, out_path)


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--other", required=True,
                      help="root of the other checkout")
  parser.add_argument("--child", help=argparse.SUPPRESS)
  args = parser.parse_args()
  if args.child:
    _child(args.child)
    return 0

  import torch  # pylint: disable=import-outside-toplevel

  if not torch.cuda.is_available():
    print("compare_kernel_bits.py needs a CUDA device.", file=sys.stderr)
    return 1
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  print(smi, flush=True)
  other = pathlib.Path(args.other).resolve()
  runs = []
  with tempfile.TemporaryDirectory() as tmp:
    for i, (label, root) in enumerate((("other", other), ("this", REPO),
                                       ("this", REPO), ("other", other))):
      path = os.path.join(tmp, f"{i}.pt")
      env = dict(os.environ, PYTHONPATH=str(root))
      subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                      "--other", str(other), "--child", path],
                     env=env, cwd=str(root), check=True, timeout=900)
      runs.append((label, torch.load(path)))
  reference = runs[0][1]["outputs"]
  same = True
  for name, tensors in reference.items():
    for label, run in runs[1:]:
      for got, want in zip(run["outputs"][name], tensors):
        if not torch.equal(got, want):
          same = False
          print(f"DIFFERENT: {name} ({label})", flush=True)
  for name in reference:
    print(f"{name}: ms in turns (other, this, this, other) "
          f"{[round(run['times'][name], 4) for _, run in runs]}")
  print(json.dumps({"bit_identical": same}))
  return 0 if same else 1


if __name__ == "__main__":
  sys.exit(main())
