"""Multimodal SFT (the JAX package's ``examples/finetune.py``).

Stage 1 trains the vision-language connector with the LM frozen; stage 2
fine-tunes everything (``two_stage_sft``) or, with ``--lora_rank``, LoRA
adapters over a bf16 or (``--lora_int8_base``) an int8 base. The final
weights go to ``{output_dir}/final``.

Example:
  python3 -m cadence_gemma_tpu_torch.examples.finetune \\
      --checkpoint_path=/ckpts/2b-it.pt --tokenizer_path=/ckpts/tok.model \\
      --vision_checkpoint=/ckpts/dino_siglip.pt \\
      --train_json=llava_instruct_150k.json --image_root=/data/coco \\
      --output_dir=/ckpts/cadence-2b
"""

from __future__ import annotations

import dataclasses
import math
import sys

import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch import tokenizers
from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.examples import _cli
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.ops import quantization
from cadence_gemma_tpu_torch.parallel import sharding as sharding_lib
from cadence_gemma_tpu_torch.training import data as data_lib
from cadence_gemma_tpu_torch.training import lora as lora_lib
from cadence_gemma_tpu_torch.training import train_loop
from cadence_gemma_tpu_torch.utils import logging as logging_lib

FLAGS = _cli.Flags(__doc__, "python3 -m cadence_gemma_tpu_torch.examples."
                   "finetune")
FLAGS.string("checkpoint_path", None, "LM checkpoint.", required=True)
FLAGS.string("vision_checkpoint", None, "DinoSigLIPEncoder checkpoint.",
             required=True)
FLAGS.string("tokenizer_path", None, "SentencePiece.", required=True)
FLAGS.string("train_json", None, "LLaVA-style JSON.", required=True)
FLAGS.string("val_json", None, "Validation JSON.")
FLAGS.string("image_root", "", "Image directory.")
FLAGS.string("output_dir", None, "Where to save params.", required=True)
FLAGS.integer("batch_size", 1, "Batch size.")
FLAGS.integer("max_seq_len", 1024, "Sequence length.")
FLAGS.float("stage1_lr", 1e-4, "Frozen-stage learning rate.")
FLAGS.float("stage2_lr", 1e-5, "Full-stage learning rate.")
FLAGS.integer("stage1_steps", 1000, "Frozen-stage steps.")
FLAGS.integer("stage2_steps", 4000, "Full-stage steps.")
FLAGS.enum_class("preset", common.Preset.RECURRENT_GEMMA_2B_V1,
                 common.Preset, "Preset.")
FLAGS.enum("metrics", "stdout", ["stdout", "jsonl", "mlflow", "wandb"],
           "Metric-logging backend (utils/logging.py adapters).")
FLAGS.string(
    "metrics_target", "",
    "Backend target: mlflow tracking URI, wandb project, or jsonl path.")
FLAGS.integer(
    "lora_rank", 0,
    "When > 0, stage 2 trains LoRA adapters of this rank instead of the "
    "full tree (training/lora.py): the base stays frozen (optionally int8 "
    "via --lora_int8_base), gradients and Adam moments exist only at "
    "adapter size, and the final save folds the adapters into plain "
    "weights.")
FLAGS.boolean(
    "lora_int8_base", False,
    "QLoRA-style: quantize the frozen base to int8 before adapter "
    "training. The final save keeps base + adapters unmerged (int8 cannot "
    "be folded losslessly).")
FLAGS.integer(
    "gradient_accumulation_steps", 1,
    "Average gradients over this many microbatches before each optimizer "
    "update. Steps count microbatches.")
FLAGS.string(
    "mesh", "",
    "Device mesh for the full/LoRA stage as 'axis:size,...' (e.g. "
    "'data:2,model:4'), every position on --device: DP over 'data', the "
    "Megatron TP layouts over 'model' (train_loop(mesh=)). Empty = single "
    "device.")


def _parse_mesh(spec: str, device):
  if not spec:
    return None
  names, sizes = [], []
  for part in spec.split(","):
    name, _, size = part.partition(":")
    names.append(name.strip())
    sizes.append(int(size))
  return sharding_lib.make_mesh(sizes, names,
                                devices=[device] * math.prod(sizes))


def main(argv: list[str] | None = None) -> int:
  args = FLAGS.parse(argv)
  device = griffin.resolve_device(args.device)
  state = checkpoint_io.load_parameters(args.checkpoint_path, device)
  config = convert.config_from_state_dict(state, preset=args.preset)
  model = _cli.build_griffin(config, state, device)
  del state
  vocab = tokenizers.load_sentencepiece(args.tokenizer_path)
  lora_rank = args.lora_rank
  if args.lora_int8_base and not lora_rank:
    FLAGS.usage_error(
        "--lora_int8_base requires --lora_rank > 0: without adapters the "
        "run is plain full-tree SFT and the int8 flag would be silently "
        "ignored.")

  encoder = _cli.load_encoder(args.vision_checkpoint, device)

  def make_data():
    return data_lib.DatasetBuilder(
        vocab=vocab,
        json_path=args.train_json,
        image_root=args.image_root,
        max_seq_len=args.max_seq_len,
        batch_size=args.batch_size,
        load_pixels=True,
    )

  val = None
  if args.val_json:
    val = data_lib.DatasetBuilder(
        vocab=vocab,
        json_path=args.val_json,
        image_root=args.image_root,
        max_seq_len=args.max_seq_len,
        batch_size=args.batch_size,
        load_pixels=True,
    )

  stage1 = train_loop.TrainingConfig(
      learning_rate=args.stage1_lr, max_steps=args.stage1_steps,
      batch_size=args.batch_size, checkpoint_dir=args.output_dir,
      gradient_accumulation_steps=args.gradient_accumulation_steps,
  )
  stage2 = train_loop.TrainingConfig(
      learning_rate=args.stage2_lr, max_steps=args.stage2_steps,
      batch_size=args.batch_size, checkpoint_dir=args.output_dir,
      gradient_accumulation_steps=args.gradient_accumulation_steps,
  )
  backend = args.metrics
  target = args.metrics_target
  log_kwargs = {
      "jsonl": {"path": target or f"{args.output_dir}/metrics.jsonl"},
      "mlflow": {"tracking_uri": target or None, "run_name": "sft"},
      "wandb": {"project": target or "cadence-gemma-tpu"},
      "stdout": {},
  }[backend]
  log_metrics = logging_lib.make_logger(backend, **log_kwargs)
  mesh = _parse_mesh(args.mesh, device)
  common_kw = dict(validation_data=val, encode_image=encoder,
                   pad_id=vocab.pad_id(), log_metrics=log_metrics,
                   device=device)

  if lora_rank:
    # Stage 1 (connector) as usual, then LoRA-adapt everything else.
    train_loop.train_loop(model, make_data(),
                          dataclasses.replace(stage1, freeze_llm=True),
                          **common_kw)
    base = model.state_dict()
    if args.lora_int8_base:
      base = quantization.quantize_params(base)
    lora_model = griffin.Griffin(config, device="meta",
                                 dtype=_cli.COMPUTE_DTYPE,
                                 lora_rank=lora_rank,
                                 quantized=args.lora_int8_base)
    adapters = lora_lib.init_adapters(
        lora_model, torch.Generator(device).manual_seed(0))
    # bfloat16 adapters whatever the base's dtype, as JAX casts them;
    # ``assign`` keeps each tensor's dtype.
    adapters = {name: leaf.to(torch.bfloat16)
                for name, leaf in adapters.items()}
    lora_model.load_state_dict(lora_lib.merge_params(base, adapters),
                               assign=True)
    del model, base
    train_loop.train_loop(lora_model, make_data(),
                          dataclasses.replace(stage2, lora=True),
                          mesh=mesh, **common_kw)
    params = lora_model.state_dict()
    if not args.lora_int8_base:
      params = lora_lib.merge_lora(params)  # adapter-free serving tree
  else:
    train_loop.two_stage_sft(model, make_data, stage1, stage2, mesh=mesh,
                             **common_kw)
    params = model.state_dict()
  checkpoint_io.save_parameters(f"{args.output_dir}/final", params)
  return 0


if __name__ == "__main__":
  sys.exit(main())
