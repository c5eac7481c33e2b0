"""Int8 figures of this tree against another checkout, in turns, on the card.

Runs one process a turn, other, this, this, other (each imports the package
and ``chip_smoke`` of its own tree and builds its own kernels), and prints
one JSON line a figure and turn:

- the weight-only product and its input gradient at the named shapes:
  device time with the launch queue full on copies of the inputs larger
  than the L2 (CUDA events over a few calls where one call's inputs exceed
  the L2 many times over), as ``chip_smoke.py`` times them;
- the text prefill of 2 x 3000 tokens through a ``realistic_params`` 2B in
  bf16 and its weight-only int8 copy: CUDA events around the model's
  forward (the first of four calls a warm-up);
- QLoRA steps (rank 8) on ``chip_smoke.py``'s phase-19 batch and towers:
  host clock around ``lora_train_step`` with a synchronize (the first of
  five a warm-up), and each step's int8 launches by route.

  python3 tools/int8_turns.py --other _checkout/parent
      [--json chiprun_out/int8_turns.jsonl]

The other checkout is the parent commit unpacked with ``git archive`` into
a directory ``.gitignore`` lists. The port has no benchmark yet: PERF.md's
parent-against-change figures for the int8 kernels, the weight-only prefill
and the QLoRA step come from this script, and a change to the int8 kernels
reruns it against its parent until a benchmark takes its place.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]


def turn(label: str) -> None:
  """One turn in this process: the tree is the first entry of sys.path."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel

  import chip_smoke as cs  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch import _build  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch import common  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.benchmarks.kernel_lab import cuda_ms  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.benchmarks.kernel_lab import device_ms  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.checkpoint import synthetic  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.models import griffin  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.models import vit  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.ops import int8_matmul  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.ops import quantization  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.training import lora as sft_lora  # pylint: disable=import-outside-toplevel

  _build.build()  # every library of this tree, in parallel, before timing
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, check=True).stdout.strip()

  def emit(**kw):
    print(json.dumps({"tree": label, "card": card, **kw}), flush=True)

  gen = torch.Generator(dev).manual_seed(7)

  def weights(b, n, k):
    q = torch.randint(-127, 128, (b, n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    return q, torch.rand(b, n, generator=gen, device=dev) * 1e-2

  def timed(fn, *inputs) -> float:
    if sum(t.numel() * t.element_size() for t in inputs) > 4 * cs.L2_BYTES:
      return cuda_ms(lambda: fn(*inputs), reps=5)
    return device_ms(fn, 12, inputs=cs.cold_copies(*inputs))

  forward = {  # label: batches, rows, n, k, shared activation
      "forward [6000,2560] x [2560,2560]": (1, 6000, 2560, 2560, False),
      "forward [5554,2560] x [2560,2560]": (1, 5554, 2560, 2560, False),
      "forward shared [5554,2560] x [2,7680,2560]": (2, 5554, 7680, 2560,
                                                     True),
      "forward [4096,2560] x [256000,2560]": (1, 4096, 256000, 2560, False),
      "forward [2,2560] x [256000,2560] (decode)": (1, 2, 256000, 2560,
                                                    False),
  }
  for name, (b, m, n, k, shared) in forward.items():
    q, s = weights(b, n, k)
    a = torch.randn(1 if shared else b, m, k, generator=gen,
                    device=dev).bfloat16()
    emit(figure=name, ms=timed(int8_matmul.int8_weight_matmul, a, q, s))
    del a, q, s
  dgrad = {
      "dgrad [4096,256000] x [256000,2560]": (1, 4096, 256000, 2560, False),
      "dgrad [5554,2560] x [2560,2560]": (1, 5554, 2560, 2560, False),
      "dgrad pair [2,5554,7680] x [7680,2560]": (2, 5554, 7680, 2560, True),
  }
  for name, (b, m, n, k, reduce) in dgrad.items():
    q, s = weights(b, n, k)
    g = torch.randn(b, m, n, generator=gen, device=dev).bfloat16()
    fn = lambda g_, q_, s_, r=reduce: int8_matmul.int8_weight_matmul_dgrad(  # pylint: disable=g-long-lambda
        g_, q_, s_, r)
    emit(figure=name, ms=timed(fn, g, q, s))
    del g, q, s
  torch.cuda.empty_cache()

  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1)
  model = griffin.Griffin(config, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator(dev).manual_seed(11))
  state = synthetic.realistic_params(model,
                                     torch.Generator(dev).manual_seed(12))
  qmodel = griffin.Griffin(config, device="meta", quantized=True)
  qmodel.to_empty(device=dev)
  qmodel.load_state_dict(quantization.quantize_params(state))
  del state
  rng = np.random.default_rng(13)
  ids = torch.tensor(rng.integers(4, config.vocab_size, (2, 3000)),
                     device=dev)
  pos = torch.arange(3000, device=dev)[None].expand(2, -1)
  prefill = {"bf16": [], "int8 weight-only": []}
  with torch.inference_mode():
    for side in ("bf16", "int8 weight-only") * 4:
      forward_model = model if side == "bf16" else qmodel
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      torch.cuda.synchronize()
      start.record()
      forward_model(ids, pos, return_cache=True, last_logits_only=True)
      end.record()
      end.synchronize()
      prefill[side].append(start.elapsed_time(end))
  for side, times in prefill.items():
    emit(figure=f"text prefill 2 x 3000, {side}", ms=times[1:])
  del model, qmodel
  torch.cuda.empty_cache()

  lmodel = griffin.Griffin(config, device="meta", quantized=True,
                           lora_rank=cs.SFT_LORA_RANK)
  lmodel.to_empty(device=dev)
  base = griffin.Griffin(config, device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator(dev).manual_seed(14))
  qstate = quantization.quantize_params(base.state_dict())
  del base
  adapters = sft_lora.init_adapters(lmodel,
                                    torch.Generator(dev).manual_seed(15))
  lmodel.load_state_dict(sft_lora.merge_params(qstate, adapters))
  del qstate, adapters
  encoder = vit.DinoSigLIPEncoder(
      device=dev, generator=torch.Generator(dev).manual_seed(16))
  batch = cs.sft_batch(config.vocab_size)
  tokens = torch.as_tensor(batch.input_tokens, device=dev).long()
  mask = torch.as_tensor(batch.target_mask, device=dev)
  with torch.no_grad():
    img = encoder(torch.as_tensor(batch.pixels, device=dev))
  del encoder
  torch.cuda.empty_cache()
  optimizer = sft_lora.make_optimizer(sft_lora.lora_parameters(lmodel),
                                      cs.SFT_LEARNING_RATE)
  counters = [name for name in ("launches", "dgrad_launches",
                                "wgmma_launches", "dgrad_wgmma_launches")
              if hasattr(int8_matmul, name)]
  step_ms = []
  for _ in range(5):
    for name in counters:
      setattr(int8_matmul, name, 0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    loss = sft_lora.lora_train_step(lmodel, optimizer, 0, tokens, mask, img)
    float(loss)
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - start) * 1e3)
  emit(figure="QLoRA step, 2 x 2777 spliced tokens", ms=step_ms[1:],
       launches={name: getattr(int8_matmul, name) for name in counters})


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--other", help="the other checkout's root")
  parser.add_argument("--json", help="also write the JSON lines here")
  parser.add_argument("--turn", help=argparse.SUPPRESS)
  args = parser.parse_args()
  if args.turn:
    turn(args.turn)
    return
  other = pathlib.Path(args.other).resolve()
  lines = []
  for label, root in (("other", other), ("this", HERE), ("this", HERE),
                      ("other", other)):
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, str(HERE / "tools" / "int8_turns.py"), "--turn",
         label], cwd=root, env=env, capture_output=True, text=True,
        check=False)
    if proc.returncode:
      sys.exit(f"the {label} turn failed:\n{proc.stdout[-3000:]}\n"
               f"{proc.stderr[-6000:]}")
    for line in proc.stdout.splitlines():
      if line.startswith("{"):
        print(line, flush=True)
        lines.append(line)
  if args.json:
    pathlib.Path(args.json).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
  main()
