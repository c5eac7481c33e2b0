"""How far a TP-2 LoRA model's logits lie from the unsharded one's (CPU).

A small Griffin (width 80, six blocks) with rank-8 adapters whose ``lora_b``
is drawn at several standard deviations, unsharded and over a ``(1, 2)``
mesh of CPU devices: the relative RMS of the two models' logits over a
61-token prompt (all positions, and the last one), in float32 and in
bfloat16. Then, in float32 at std 2.0, the same comparison with one shard's
adapter piece zeroed: what a misplaced adapter slice does to the logits.
Phase 27 of ``chip_smoke.py`` bounds the float32 comparison on the 2B and
logs the bfloat16 one; this script shows why.

  python3 tools/tp_lora_noise.py
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

# pylint: disable=wrong-import-position
import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel
from cadence_gemma_tpu_torch.training import lora
# pylint: enable=wrong-import-position

STDS = (0.0, 0.02, 0.5, 2.0)
RANK = 8
CONFIG = common.GriffinConfig(
    vocab_size=512, width=80, mlp_expanded_width=160, num_heads=10,
    block_types=(common.TemporalBlockType.RECURRENT,
                 common.TemporalBlockType.RECURRENT,
                 common.TemporalBlockType.ATTENTION) * 2,
    embeddings_scale_by_sqrt_dim=True, attention_window_size=16,
    logits_soft_cap=30.0, lru_width=80)


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
  diff = got.float() - want.float()
  return (diff.square().mean().sqrt()
          / want.float().square().mean().sqrt()).item()


def logits(model, tokens: torch.Tensor) -> torch.Tensor:
  positions = torch.arange(tokens.shape[1])[None]
  with torch.no_grad():
    out, _ = model(tokens, positions, return_cache=False)
  return out[0]


def lora_model(dtype: torch.dtype, std: float, seed: int = 5):
  base = griffin.Griffin(CONFIG, device="cpu", dtype=dtype,
                         generator=torch.Generator().manual_seed(1))
  model = griffin.Griffin(CONFIG, device="cpu", dtype=dtype, lora_rank=RANK)
  gen = torch.Generator().manual_seed(seed)
  adapters = lora.init_adapters(model, gen)
  for name, leaf in adapters.items():
    if name.endswith("lora_b"):
      leaf.normal_(0.0, std, generator=gen)
  model.load_state_dict(lora.merge_params(base.state_dict(), adapters))
  return model


def main() -> int:
  mesh = sharding.make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
  tokens = torch.tensor([[1] + list(range(10, 70))])
  for dtype in (torch.float32, torch.bfloat16):
    for std in STDS:
      model = lora_model(dtype, std)
      want = logits(model, tokens)
      got = logits(tensor_parallel.tensor_parallel(model, mesh), tokens)
      print(f"{str(dtype):15s} lora_b std {std:<5}: rel. RMS all positions "
            f"{rel_rms(got, want):.3e}, last {rel_rms(got[-1], want[-1]):.3e}")
  model = lora_model(torch.float32, STDS[-1])
  want = logits(model, tokens)
  for leaf in ("linear_x.lora_b", "linear_y.lora_b", "linear_out.lora_a"):
    tp = tensor_parallel.tensor_parallel(model, mesh)
    name = f"blocks.0.temporal.s.shards.0.{leaf}"
    piece = dict(tp.named_parameters())[name]
    piece.data = torch.zeros_like(piece.data)  # this shard's own copy
    print(f"float32 lora_b std {STDS[-1]}, {name} zeroed: rel. RMS "
          f"{rel_rms(logits(tp, tokens), want):.3e}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
