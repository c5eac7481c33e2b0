"""Host-bound paths of this tree against another checkout, in turns, on the
card: what launching the kernels through ``torch.library`` operators costs
where the host sets the pace.

Runs one process a turn, (other, this, this, other) twice (each imports the
package and ``chip_smoke`` of its own tree and builds its own kernels), and
prints one JSON line a figure and turn:

- host us a call of the kernel wrappers at decode-sized shapes (the fused
  add + RMSNorm, the weight-only int8 product, the LRU scan, the window
  attention): five times ``HOST_CALLS`` calls enqueued back to back, host
  clock, the card finishing after the clock stops;
- the chunked prefill of ``chip_smoke.py``'s text prompts (2 x 3000 tokens,
  chunks of 1024): host clock around a one-step ``Sampler`` call, which
  reads its first token back (the first of eleven a warm-up);
- the admission stall of a continuous batcher (8 slots, 7 rows live): host
  clock around ``step`` with and without admitting a 1000-token prompt,
  eight of each in turns;
- QLoRA steps (rank 8) on ``chip_smoke.py``'s phase-19 batch and towers:
  host clock around ``lora_train_step`` with a synchronize (the first of
  five a warm-up), and each step's int8 launches by route.

  python3 tools/op_turns.py --other _checkout/parent
      [--json chiprun_out/op_turns.jsonl]

The other checkout is the parent commit unpacked with ``git archive`` into
a directory ``.gitignore`` lists. PERF.md's in-turns figures of the
operators' host cost come from this script.
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
HOST_CALLS = 500
CHUNK_TOKENS = 1024
STALL_TOKENS = 1000
SLOTS, TICK, LIVE_TOKENS = 8, 8, 300
TURNS = ("other", "this", "this", "other") * 2


def turn(label: str) -> None:
  """One turn in this process: the tree is the first entry of sys.path."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel

  import chip_smoke as cs  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch import _build  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch import common  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.inference import sampler as sampler_lib  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.inference import serving  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.models import griffin  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.models import vit  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.ops import fused_epilogue  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.ops import int8_matmul  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.ops import lru_scan  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.ops import quantization  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.ops import window_attention as wa  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.tokenizers import SimpleVocab  # pylint: disable=import-outside-toplevel
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

  gen = torch.Generator(dev).manual_seed(21)
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1)

  # Host us a call of each wrapper.
  x = torch.randn(2, 1, config.width, generator=gen, device=dev).bfloat16()
  scale = torch.zeros(config.width, device=dev, dtype=torch.bfloat16)
  a = torch.randn(1, 2, 7680, generator=gen, device=dev).bfloat16()
  q = torch.randint(-127, 128, (1, 2560, 7680), generator=gen, device=dev,
                    dtype=torch.int8)
  s = torch.rand(1, 2560, generator=gen, device=dev) * 1e-2
  lx = torch.randn(2, 16, config.width, generator=gen, device=dev).bfloat16()
  la = torch.rand(2, 16, config.width, generator=gen, device=dev).bfloat16()
  aq = torch.randn(1, 512, 10, 256, generator=gen, device=dev).bfloat16()
  ak = torch.randn(1, 512, 1, 256, generator=gen, device=dev).bfloat16()
  seg = torch.arange(512, device=dev)[None]
  calls = {
      "add_rmsnorm [2,1,2560]":
          lambda: fused_epilogue.add_rmsnorm_forward(x, x, scale),
      "int8_weight_matmul [2,7680] x [2560,7680]":
          lambda: int8_matmul.int8_weight_matmul(a, q, s),
      "lru_scan_forward [2,16,2560]":
          lambda: lru_scan.lru_scan_forward(lx, la),
      "window_attention_forward [1,512,10,256]":
          lambda: wa.window_attention_forward(aq, ak, ak, seg, 256),
  }
  for name, fn in calls.items():
    for _ in range(20):
      fn()
    torch.cuda.synchronize()
    host_us = []
    for _ in range(5):
      start = time.perf_counter()
      for _ in range(HOST_CALLS):
        fn()
      host_us.append((time.perf_counter() - start) / HOST_CALLS * 1e6)
      torch.cuda.synchronize()
    emit(figure=f"host us a call, {name}", us=host_us,
         median_us=float(np.median(host_us)))
  del x, a, q, s, lx, la, aq, ak

  model = griffin.Griffin(config, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator(dev).manual_seed(22))
  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(23)
  prompts = [" ".join(f"w{i}" for i in rng.integers(
      0, config.vocab_size - 4, n - 1)) for n in cs.PROMPT_TOKENS]

  # The chunked prefill: time to the first token.
  chunked = sampler_lib.Sampler(model, vocab, device=dev,
                                prefill_chunk_size=CHUNK_TOKENS)
  ms = []
  for _ in range(11):
    torch.cuda.synchronize()
    start = time.perf_counter()
    chunked(prompts, total_generation_steps=1)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - start) * 1e3)
  emit(figure=f"chunked prefill 2 x {max(cs.PROMPT_TOKENS)}, chunks of "
       f"{CHUNK_TOKENS}, ms to the first token", ms=ms[1:])
  del chunked

  # The admission stall: a tick with and without an admission.
  batcher = serving.ContinuousBatcher(
      sampler_lib.Sampler(model, vocab, device=dev), num_slots=SLOTS,
      max_steps_default=4096)
  for _ in range(SLOTS - 1):
    batcher.add_request(" ".join(f"w{j}" for j in rng.integers(
        0, config.vocab_size - 4, LIVE_TOKENS)))
  batcher.step(TICK)  # admits the rows and captures the tick
  prompt = " ".join(f"w{j}" for j in rng.integers(0, config.vocab_size - 4,
                                                  STALL_TOKENS - 1))
  stall = {"no admission": [], "an admission": []}
  for _ in range(8):
    for key in stall:
      new = batcher.add_request(prompt) if key == "an admission" else None
      start = time.perf_counter()
      batcher.step(TICK)
      stall[key].append((time.perf_counter() - start) * 1e3)
      if new is not None:
        batcher.cancel(new)
  emit(figure=f"tick ms ({TICK} steps, {SLOTS - 1} rows live)", ms=stall,
       stall_ms=float(np.median(stall["an admission"])
                      - np.median(stall["no admission"])))
  del batcher, model
  torch.cuda.empty_cache()

  # QLoRA steps on the phase-19 batch and towers.
  lmodel = griffin.Griffin(config, device="meta", quantized=True,
                           lora_rank=cs.SFT_LORA_RANK)
  lmodel.to_empty(device=dev)
  base = griffin.Griffin(config, device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator(dev).manual_seed(24))
  qstate = quantization.quantize_params(base.state_dict())
  del base
  adapters = sft_lora.init_adapters(lmodel,
                                    torch.Generator(dev).manual_seed(25))
  lmodel.load_state_dict(sft_lora.merge_params(qstate, adapters))
  del qstate, adapters
  encoder = vit.DinoSigLIPEncoder(
      device=dev, generator=torch.Generator(dev).manual_seed(26))
  batch = cs.sft_batch(config.vocab_size)
  tokens = torch.as_tensor(batch.input_tokens, device=dev).long()
  mask = torch.as_tensor(batch.target_mask, device=dev)
  with torch.no_grad():
    img = encoder(torch.as_tensor(batch.pixels, device=dev))
  del encoder
  torch.cuda.empty_cache()
  optimizer = sft_lora.make_optimizer(sft_lora.lora_parameters(lmodel),
                                      cs.SFT_LEARNING_RATE)
  counters = ("launches", "wgmma_launches", "dgrad_wgmma_launches")
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
  for label in TURNS:
    root = HERE if label == "this" else other
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, str(HERE / "tools" / "op_turns.py"), "--turn",
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
