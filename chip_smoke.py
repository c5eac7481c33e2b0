#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cadence_gemma_tpu_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

  1. card: the device's name, and its name and power limit from nvidia-smi;
  2. build: ``nvcc`` compiles every kernel under
     ``cadence_gemma_tpu_torch/csrc`` (one process per source, in parallel)
     and prints ptxas' registers and spills of each kernel, and the Hopper
     kernels' (the real and complex scans' TMA ring, the window forward,
     dq, dk/dv and the MHA) registers, local bytes and shared memory as
     launched;
  3. each forward kernel against its plain PyTorch version at the shapes of
     the serving path's prefill (batch 2 of 3000 tokens, the shorter prompt
     left-padded), with its time, the plain version's time, the least time
     the card could take (bound) and, where one PyTorch call computes the
     same function, that call's; for the attention kernels also the achieved
     TFLOP/s, the share of the bound and the ratio to SDPA, and the window
     forward again at the training step's [2, 4096, 10, 256]. The RG-LRU
     scans (here and in 5, 9 and 11) are timed by their device time with
     the launch queue full on copies of their inputs that exceed the L2,
     with GB/s, the share of the bound and the host's microseconds a call;
  4. the serving path: a full-width, full-depth RecurrentGemma-2B (random
     bf16 weights from a seeded ``torch.Generator``) behind a ``Sampler``
     generates 32 greedy tokens for two prompts longer than the attention
     window, its decode one step captured as a CUDA graph and replayed (a
     warm-up call of the same shapes captures it; here and in 8, 10 and 16
     a captured step's launches are counted by the wrappers' counters at
     its capture and multiplied by the replays, and decode ms a step comes
     from CUDA events around the decode loop). The kernels' launch
     counters, reset just before, must show that the prefill ran the RG-LRU
     kernel once per recurrent block and the attention kernel once per
     attention block, and that decode ran none;
     here and in 6, 8, 10 and 12 every real scan launch must have taken the
     TMA ring of ``csrc/lru_scan.cu``, none the per-thread walk.
     The inputs the prefill gave each kernel's first call are captured and
     the kernel's output on them held against its plain version; the same
     model's logits through the kernels are held against its plain path
     (sequential scan, einsum attention);
  5. each backward kernel (the RG-LRU cotangent scan, the attention's dq
     and dk/dv) against its plain version at the shapes of the training
     step (batch 2 of 4096 tokens, row 1 right-padded after 3000), timed
     as in 3; dq and dk/dv also print their TFLOP/s, share of the bound and
     resources, and their summed time against SDPA's backward (one
     boolean-masked call that computes dq, dk and dv together);
  6. the training path: ``train_loop`` takes 3 AdamW steps of full
     fine-tuning of a full-width, full-depth RecurrentGemma-2B (seeded
     random bf16 weights) on one repeated batch of 2 x 4096 tokens, the loss
     over the second half. The loss must be finite and fall, and the
     counters, reset just before, must show per step 36 forward and 18
     backward LRU launches and 16 forward, 8 dq and 8 dk/dv attention
     launches (each block's forward runs again in the backward under
     per-block rematerialization). The inputs the first step gave each
     backward kernel are captured and held against its plain version. On
     one 2100-token sequence the trained model's loss and gradient tree
     through the kernels are held, leaf by leaf, against its plain path;
  7. the towers' bidirectional MHA kernel against its plain version at the
     DINOv2-L and SigLIP-so400m shapes at 384 px ([2, 734, 16, 64] and
     [2, 729, 16, 72]) and at a longer sequence ([2, 1600, 16, 72], where
     the TPU needed its tiled kernel), and the fused residual add + RMSNorm
     kernel at the multimodal prefill's and a decode step's shapes, each
     timed by its device time with the launch queue full (CUDA events around
     calls enqueued behind a sleep on the card; add_rmsnorm's on copies of
     its inputs that exceed the L2 together), with the host's time a call
     beside it; the MHA's yardstick is one unmasked SDPA call,
     and each shape prints its TFLOP/s, share of the bound and ratio to it;
  8. the multimodal serving path: the DINOv2-L || SigLIP-so400m encoder at
     its published widths (blocks 0-22 of each) and a full-width, full-depth
     RecurrentGemma-2B with the fused epilogue, seeded random weights, behind
     a ``ModalSampler`` that takes raw [2, 3, 480, 640] pixels (resized on
     the card) and two 1400-token prompts, so the spliced prefill holds 2129
     tokens, and generates 32 greedy tokens. The counters, reset just
     before, must show 46 MHA launches (23 blocks of each tower), 18 LRU and
     8 window-attention launches in the prefill and none in decode, and 26
     add_rmsnorm launches in each of the 32 forwards (the prefill's and 31
     replays of the captured step's). Each kernel is held
     against its plain version on the inputs of its first call; the resize
     on the card against the CPU's; the fused features and the last
     position's logits against the plain path of the same weights (towers
     on the einsum, Griffin unfused, sequential scan, einsum attention).
     Then decode ms a step fused and unfused in turns, and an image turn
     with ``return_state`` followed by a text turn from its state (18 LRU
     launches with a carry, add_rmsnorm replayed in the captured step), the
     follow-up's first logits held against one teacher-forced call of the
     whole history with the image;

  9. the sequence-parallel variants of two kernels at the shapes of the SP
     prefill's shards: the RG-LRU kernel with the running product of ``a``
     (forward and backward walks, ``reverse`` false and true, [2, 4096,
     2560] bf16, bit for bit against the plain loops) and the window
     attention with a 2048-key halo (q [2, 4096, 10, 256], k and v
     [2, 6144, 1, 256]; a later shard's continuous positions, and shard 0's
     zero halo with a row left-padded by 1384), timed as in 3 with one
     boolean-masked SDPA call over the same band as the yardstick, and the
     same figures as in 3;
 10. the sequence-parallel serving path: a full-width, full-depth
     RecurrentGemma-2B (seeded random bf16 weights) with
     ``scan_sharding_spec`` on a (1, 4) data x sequence mesh (four shards on
     one card, or one on each of four) behind a ``Sampler``: prompts of 16384
     and 15000 tokens (the second left-padded by 1384, 4096 tokens a shard)
     and 32 greedy tokens. The counters, reset just before, must show 72 LRU
     launches with the running product (18 recurrent blocks x 4 shards) and
     32 attention launches with the halo (8 x 4) in the prefill, no
     unsharded scan or attention launch, and none in decode. Each kernel is
     held against its plain version on the inputs of its first call; the
     last position's logits against the same weights unsharded (a second
     ``Griffin`` from the same seed, through the unsharded kernels), whose
     generation's token agreement is printed; SP and unsharded prefill are
     timed in balanced turns;
 11. the sequence-parallel backward variants at the shapes of the SP
     training step's shards: the RG-LRU cotangent scan with the running
     product of ``a`` ([1, 4096, 2560] bf16, bit for bit against the plain
     loop) and the window attention's dq and dk/dv with a 2048-key halo
     (q [1, 4096, 10, 256], k and v [1, 6144, 1, 256]; shard 0's zero halo
     and a later shard), timed as in 5 with SDPA's backward over the same
     band as the yardstick;
 12. the sequence-parallel training path: ``train_loop`` takes 3 AdamW
     steps of a full-width, full-depth RecurrentGemma-2B (seeded random
     bf16 weights) with ``scan_sharding_spec`` on the (1, 4) mesh, on one
     repeated row of 16384 tokens right-padded after 15000, the loss over
     the second half of the real tokens. The loss must be finite and fall;
     the counters, reset just before, must show per step 144 LRU launches
     with the product (18 recurrent blocks x 4 shards, twice under remat),
     72 LRU backward launches with it, 64 halo attention forwards, 32 halo
     dq and 32 halo dk/dv, and none of the unsharded kernels. The first
     step's inputs to each backward kernel are held against its plain
     version; the SP gradients against the unsharded gradients of the same
     model on the same batch, leaf by leaf; SP and unsharded steps are
     timed in balanced turns;
 13. the complex-valued RG-LRU scan's four entry points (forward and
     backward walks, each with and without the running product of ``a``)
     at the 2B's ``lru_width``, [2, 4096, 2560] bf16 components with
     ``reverse`` and ``h0`` both ways and one float32 case, bit for bit
     against their plain loops, timed as the real scans in 3 (device time
     with the launch queue full on cold copies, GB/s, share of the bound,
     host us a call), on the TMA ring and, on copies TMA cannot describe,
     on the per-thread walk that ran them before the ring;
 14. the complex path: ``ops.scan.linear_scan`` of ``complex_lib.Complex``
     operands, forward and ``torch.autograd.grad`` of x, a and h0.
     Unsharded at [2, 4096, 2560] the counters, reset just before, must
     show one complex forward and one complex backward launch, and the
     kernel path is held against ``LINEAR_NATIVE`` on the same card;
     sequence-sharded over the (1, 4) mesh at [1, 16384, 2560] they must
     show 4 forwards and 4 backwards with the product and no unsharded
     complex launch; every complex launch of both runs must have taken the
     TMA ring of ``csrc/lru_scan_complex.cu``. The first shard's inputs to
     each kernel are held against its plain loop and timed as in 13 (batch
     1), and the results against the same call with no spec;
 15. the kernel lab: ``cadence_gemma_tpu_torch.benchmarks.kernel_lab.main()``
     at [1, 2048, 2560] bf16 (the scan kernel, variant A's sweep and
     variant B's, the JAX lab's own tiles), then variant A at every st and
     variant B at every tile of their sweeps against their plain versions,
     bit for bit, B's worst tile within one bf16 step of the sequential
     scan, A at st = 128 within 10 % of the scan kernel's line, and the
     spread of B's three st = 256 lines; then the probe: B at st = 256 and
     the library's forward scan on one SP shard's [1, 4096, 2560] bf16,
     timed as the scans in 3, B bit for bit there too;
 16. the serving features, run right after 4 on its 2B: the same prompts
     with ``prefill_chunk_size=1024`` (padded to 3072, three chunks: 54 LRU
     launches, all on the ring, no window-attention launch; the second
     chunk's first scan, whose carry comes from the cache, bit for bit
     against its plain loop; last logits against the single-shot prefill,
     time to the first token and peak memory of both in turns); a
     2048-token prefix at batch 1 continued by two calls of 2 x 512 tokens
     (18 LRU launches each with a carry; last logits against the full
     prompts in one call; the prefix's cache unchanged; time to the first
     token against the full prompts' in turns); three conversation turns
     with ``return_state``, each turn's first logits against a
     teacher-forced call of the whole history; captured against eager
     decode in turns (decode ms a step, greedy tokens identical, logits'
     largest difference), and categorical sampling (temperature 0.8, top-k
     50, top-p 0.95) and greedy with ``repetition_penalty=1.3``, each
     captured and eager from generators seeded alike: identical tokens and
     generator offsets.

  python3 chip_smoke.py --profile

adds kernel time by name (torch.profiler) for the prefill and decode of the
serving path (and the idle share of captured and eager decode), for one
training step, for the encode and the
image-conditioned prefill, for the sequence-parallel prefill and for one
sequence-parallel training step, with the device's idle share.

Needs a CUDA card and the CUDA toolkit (``nvcc``); without a card it exits
with status 1 and prints no result. The line before the last is a JSON
object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import inspect
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from cadence_gemma_tpu_torch import _build
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import complex_lib
from cadence_gemma_tpu_torch.benchmarks import kernel_lab
from cadence_gemma_tpu_torch.benchmarks.kernel_lab import cuda_ms
from cadence_gemma_tpu_torch.benchmarks.kernel_lab import device_ms
from cadence_gemma_tpu_torch.inference import modal_sampler
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.models import vit
from cadence_gemma_tpu_torch.ops import fused_epilogue
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import mha_attention
from cadence_gemma_tpu_torch.ops import scan as scan_lib
from cadence_gemma_tpu_torch.ops import window_attention as wa
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab
from cadence_gemma_tpu_torch.training import data as data_lib
from cadence_gemma_tpu_torch.training import train_loop as train_loop_lib
from cadence_gemma_tpu_torch.training import trainer

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

SEED = 0
PROMPT_TOKENS = (3000, 2300)
DECODE_STEPS = 32
# The main path's RecurrentGemma-2B prefill: batch 2, padded to the longer
# prompt; lru_width 2560; 10 query heads of 256 over one KV head, window 2048.
PREFILL_TOKENS = max(PROMPT_TOKENS)
LRU_SHAPE = (2, PREFILL_TOKENS, 2560)
ATTN_SHAPE = (2, PREFILL_TOKENS, 10, 256)
ATTN_WINDOW = 2048
# Row 1 is left-padded as the Sampler pads the shorter prompt
# (segment_pos = -1 on its first ATTN_PAD positions); row 0 starts a second
# document at ATTN_BOUNDARY.
ATTN_PAD = PREFILL_TOKENS - min(PROMPT_TOKENS)
ATTN_BOUNDARY = 1500
REFERENCE_PROMPT_TOKENS = 2100

# The kernel and the plain loop do the same two separately rounded float32
# operations per step in the same order: the results are bit-identical.
LRU_MAX_ABS_ERR = 0.0
# Same bf16 inputs; the kernel rounds its unnormalized probabilities to bf16
# before PV (the plain version keeps float32), and both round the output to
# bf16: 2e-2 covers those roundings at |out| < 2.
ATTN_OUT_MAX_ABS_ERR = 2e-2
# Softmax statistics are float32 on both sides, summed in another order.
ATTN_LSE_MAX_ABS_ERR = 1e-3
# Kernel path vs plain path of the whole bf16 model: bf16 rounding at other
# places (probabilities before PV) compounds over 26 blocks. Relative RMS of
# the difference of the last position's logits.
MODEL_LOGITS_REL_RMS = 5e-2

# The training path: RecurrentGemma-2B, batch 2 x 4096 tokens, row 1 holds
# 3000 real tokens and is right-padded (its positions repeat the last one);
# the loss covers the second half of each row's real tokens.
TRAIN_TOKENS = 4096
TRAIN_REAL_TOKENS = (4096, 3000)
TRAIN_STEPS = 3
# AdamW's learning rate for the smoke: large enough that 3 steps on one
# repeated batch lower the loss of bf16 weights.
TRAIN_LEARNING_RATE = 1e-3
LRU_TRAIN_SHAPE = (2, TRAIN_TOKENS, 2560)
ATTN_TRAIN_SHAPE = (2, TRAIN_TOKENS, 10, 256)
GRAD_REFERENCE_TOKENS = 2100

# The cotangent scan repeats its plain loop's float32 add and multiply in the
# same order: bit-identical.
LRU_BWD_MAX_ABS_ERR = 0.0
# dq, dk, dv: the kernels round p and ds to bf16 before their products and
# the results to bf16; the plain versions keep float32 to the end. Error
# bound as a fraction of the largest gradient (about 2^-8 expected).
ATTN_BWD_REL_ERR = 2e-2
# Kernel path vs plain path of the bf16 2B's loss and gradients (the plain
# path's einsum attention and autograd of the sequential scan round at other
# places), per parameter leaf.
MODEL_LOSS_REL_ERR = 1e-2
GRAD_LEAF_REL_RMS = 0.1
GRAD_LEAF_MIN_COSINE = 0.99
# Against the plain path of a float32 copy of the model both bf16 paths are
# off by bf16's own rounding (~6e-2 per leaf at the median); the kernels may
# add at most a tenth to the plain path's median distance.
GRAD_F32_MEDIAN_RATIO = 1.1

LRU_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:265"
ATTN_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:207"
LRU_BWD_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:265"
DQ_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:295"
DKV_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:360"
# One CUDA kernel replaces both TPU MHA kernels: the one-pass
# _flash_mha_onepass (:749, the towers' regime) and the tiled
# _flash_mha_forward (:776, t_pad > 1024).
MHA_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:749"
RMSNORM_REPLACES = "cadence_gemma_tpu/ops/fused_epilogue.py:70"
# The sequence-parallel variants: _lru_pallas_call with compute_a_prod=True
# (called from _sharded_scan, pallas_lru.py:471) and _flash_window_forward
# with kv_prefix.
LRU_A_PROD_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:265"
ATTN_PREFIX_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:207"
# The backward walk with the product: the same pallas_call, launched from
# _lru_bwd (:516) through _sharded_scan(backprop=True).
LRU_BWD_A_PROD_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:265"

# The towers' attention: DINOv2-L (729 patches + 5 prefix tokens, head_dim
# 64) and SigLIP-so400m (729, head_dim 72) at 384 px, batch 2; then a longer
# sequence, where the TPU needed its tiled kernel. The first is the row of
# the kernels line.
MHA_SHAPES = ((2, 734, 16, 64), (2, 729, 16, 72), (2, 1600, 16, 72))
# Same bf16 inputs; both round unnormalized probabilities to bf16 before PV
# (the kernel against the running max of its tiles) and the output to bf16:
# 2e-2 covers those roundings at |out| < 2.
MHA_MAX_ABS_ERR = 2e-2
# The fused epilogue at the multimodal prefill (2 x 2129 rows) and at a
# decode step (2 rows); the first is the row of the kernels line.
RMSNORM_SHAPES = ((2, 2129, 2560), (2, 1, 2560))
# y: one rounding of the same float32 sum on both sides (exact). normed:
# float32 statistics summed in another order, then one bf16 rounding: at
# most one bf16 ulp, 2^-8 relative; 2^-7 of |normed| allows for both.
RMSNORM_NORMED_REL_ERR = 2**-7

# The multimodal serving path: raw pixels resized on the card, two prompts
# of 1400 tokens (BOS + 1399 words), 729 visual tokens spliced after BOS.
MM_PIXELS = (2, 3, 480, 640)
MM_PROMPT_TOKENS = 1400
MM_DECODE_STEPS = 32
# The resize on the card vs on the CPU: the same float32 weights summed in
# another order.
RESIZE_MAX_ABS_ERR = 1e-4
# Kernel path vs plain path of the bf16 encoder: the kernel rounds
# unnormalized probabilities to bf16 where the einsum rounds normalized
# ones, and each path rounds its own activations to bf16, over 23 blocks of
# each tower. Relative RMS of the difference of the fused features.
MM_FEATURES_REL_RMS = 5e-2
# Kernel path vs plain path from pixels to the last position's logits: the
# towers' difference above carried through the connector and 26 blocks in
# which the fused epilogue also reduces in float32 where the plain RMSNorm
# reduces in bf16 (as MODEL_LOGITS_REL_RMS for the text path).
MM_LOGITS_REL_RMS = 5e-2

# The sequence-parallel serving path: a (1, 4) data x sequence mesh, prompts
# of 16384 and 15000 tokens (the second left-padded by 1384, inside shard 0),
# 4096 tokens a shard, each shard's attention against a 2048-key halo.
SP_SHARDS = 4
SP_PROMPT_TOKENS = (16384, 15000)
SP_DECODE_STEPS = 32
SP_LOCAL_TOKENS = max(SP_PROMPT_TOKENS) // SP_SHARDS
SP_PAD = max(SP_PROMPT_TOKENS) - min(SP_PROMPT_TOKENS)
LRU_SP_SHAPE = (2, SP_LOCAL_TOKENS, 2560)
ATTN_SP_SHAPE = (2, SP_LOCAL_TOKENS, 10, 256)
# The running product is one more separately rounded float32 multiply a step
# on both sides: bit-identical, as the scan itself.
LRU_A_PROD_MAX_ABS_ERR = 0.0
# SP vs unsharded logits of the same bf16 weights: the correction
# y + h0 * a_prod is a bf16 multiply and add (as the JAX package computes
# it), which the unsharded scan does not round; the kernels' own differences
# as MODEL_LOGITS_REL_RMS.
SP_LOGITS_REL_RMS = 5e-2
# Turns of SP (True) and unsharded (False) prefills, balanced against linear
# and quadratic drift as EPILOGUE_TURNS below.
SP_TURNS = (True, False, False, True, False, True, True, False)

# The sequence-parallel training path: the same (1, 4) mesh, one row of
# 16384 tokens right-padded after 15000 (inside shard 3), 4096 tokens a
# shard, the loss over the second half of the real tokens.
SP_TRAIN_TOKENS = 16384
SP_TRAIN_REAL_TOKENS = 15000
SP_TRAIN_STEPS = 3
SP_TRAIN_LOCAL_TOKENS = SP_TRAIN_TOKENS // SP_SHARDS
LRU_SP_TRAIN_SHAPE = (1, SP_TRAIN_LOCAL_TOKENS, 2560)
ATTN_SP_TRAIN_SHAPE = (1, SP_TRAIN_LOCAL_TOKENS, 10, 256)
# Turns of SP (True) and unsharded (False) training steps.
SP_TRAIN_TURNS = (True, False, False, True)

# The complex scan at the 2B's lru_width: batch 2 x 4096 steps, bf16
# components (and one float32 case); its path through ops.scan.linear_scan
# unsharded at that shape and sequence-sharded over the (1, 4) mesh at
# 1 x 16384.
LRU_COMPLEX_SHAPE = (2, 4096, 2560)
LRU_COMPLEX_SP_SHAPE = (1, 16384, 2560)
# Every product and sum rounded alone in the same order on both sides.
LRU_COMPLEX_MAX_ABS_ERR = 0.0
# The replaced TPU kernel: the complex body of _lru_pallas_call, in all four
# of its uses (forward, backward; each with compute_a_prod).
LRU_COMPLEX_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:171"
# Kernel path vs LINEAR_NATIVE on one card: y and h_last bit for bit (the
# kernels' bits are the plain loop's); the gradients of x and h0 (the
# cotangent walk against autograd of the loop) by relative RMS. The decay's
# gradient differs by bf16 rounding: the kernel path, as JAX's _lru_bwd,
# multiplies dx by the bf16 outputs y in bf16, autograd of the loop by the
# float32 carry in float32; one bf16 step is 2^-8 relative.
COMPLEX_PATH_GRAD_REL_RMS = 1e-6
COMPLEX_PATH_DA_REL_RMS = 1e-2
# SP vs unsharded: the correction y + h0 * a_prod in bf16 (as the JAX
# package computes it), which the unsharded scan does not round; h_last in
# float32 relative to its largest value; gradients per operand. Each limit
# is about ten times the reading on an H100 (y 1.3e-4, h_last 0, gradients
# 2.2e-4 and cosine 1.000000): the product of `a` decays within a few steps
# of a shard's start, so few outputs take a correction at all.
COMPLEX_SP_Y_REL_RMS = 2e-3
COMPLEX_SP_H_REL_ERR = 1e-5
COMPLEX_SP_GRAD_REL_RMS = 5e-3
COMPLEX_SP_GRAD_MIN_COSINE = 0.9999

# The kernel lab: one configuration of each variant, held bit for bit
# against its plain version (A's is the sequential scan); B's association
# differs from the sequential scan's, so against that it is held within one
# bf16 step of y (2^-7 of |y|) and 1e-4 of h_last. Near y = 0 the two
# float32 carries' difference (~5e-7 on an H100) exceeds a bf16 step of y,
# so y also has 1e-6 absolute, as the lab's card test. Variant A is held at
# every st of its sweep; at st = 128 it runs the code of the library's
# forward scan, which the lab times on its first line, so the two lines
# agree within 10 %. Variant B is held at every tile of its sweep, and
# timed at st = 256 beside the library's scan on one SP shard's shape (the
# probe). The lab's replaced TPU kernels.
LAB_UNROLLED_ST = 128
LAB_SAME_AS_SCAN_REL = 0.10
LAB_LOGSCAN_TILE = (256, 512)  # the st = 256 lines tie on the H100
LAB_PROBE_SHAPE = (1, 4096, 2560)
LAB_PROBE_TILE = (256, 2560)
LAB_Y_REL_ERR = 2.0**-7
LAB_Y_ABS_ERR = 1e-6
LAB_H_MAX_ABS_ERR = 1e-4
LAB_UNROLLED_REPLACES = "benchmarks/kernel_lab.py:74"
LAB_LOGSCAN_REPLACES = "benchmarks/kernel_lab.py:128"

# The serving features on the main path's 2B (phase 16): the main path's
# prompts prefilled in chunks of CHUNK_TOKENS (padded to 3072, three
# chunks); a PREFIX_TOKENS prefix at batch 1, continued by two calls of 2 x
# CONTINUATION_TOKENS; conversation turns of TURN_TOKENS prompt tokens and
# TURN_STEPS generated ones; captured and eager decode in GRAPH_TURNS
# (True: captured), balanced against drift as EPILOGUE_TURNS below.
CHUNK_TOKENS = 1024
PREFIX_TOKENS = 2048
CONTINUATION_TOKENS = 512
TURN_TOKENS = (300, 200, 120)
TURN_STEPS = 8
GRAPH_TURNS = (False, True, True, False)
CATEGORICAL = dict(temperature=0.8, top_k=50, top_p=0.95)
SERVING_PENALTY = 1.3
# The ModalSampler's image turn and its text follow-up (phase 8).
MODAL_TURN_STEPS = 8
MODAL_FOLLOWUP_TOKENS = 64


def log(*args) -> None:
  print(*args, flush=True)


# The H100's L2 cache.
L2_BYTES = 50e6


def cold_copies(*tensors: torch.Tensor, copy=None) -> list[tuple]:
  """Copies of ``tensors`` that together hold more than twice the L2, for
  :func:`device_ms` to rotate through; the tensors themselves if they hold
  less than 1 MB (a decode step's inputs, which its caller leaves warm).
  With ``copy``, every set (the first too) is made by it."""
  n_bytes = sum(t.numel() * t.element_size() for t in tensors)
  if n_bytes < 1e6 and copy is None:
    return [tensors]
  count = int(np.ceil(2 * L2_BYTES / n_bytes)) + 1
  if copy is not None:
    return [tuple(copy(t) for t in tensors) for _ in range(count)]
  return [tensors] + [tuple(t.clone() for t in tensors)
                      for _ in range(count - 1)]


def bound(n_bytes: float, flops: float, flops_per_s: float):
  """(least ms the card could take, what bounds it)."""
  t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / flops_per_s * 1e3
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Calls a scan's device time averages over.
SCAN_REPS = 48


def time_scan(call, inputs: tuple, n_bytes: float, flops: float,
              copy=None) -> dict:
  """A scan's figures as the paths call it: the device time of a call
  with the launch queue full, on copies of its inputs that exceed the L2
  (:func:`device_ms`: at ~0.05 ms a call, CUDA events around calls launched
  one after another would time the host's launch; ``copy`` makes them, see
  :func:`cold_copies`), the host's time to launch one call, the bound of
  these inputs, GB/s and the share of the bound."""
  copies = cold_copies(*inputs, copy=copy)
  ms = device_ms(call, SCAN_REPS, inputs=copies)
  torch.cuda.synchronize()
  start = time.perf_counter()
  for _ in range(SCAN_REPS):
    call(*copies[0])
  host_us = (time.perf_counter() - start) / SCAN_REPS * 1e6
  torch.cuda.synchronize()
  bound_ms, bound_by = bound(n_bytes, flops, FP32_FLOPS)
  return dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
              gbps=n_bytes / ms / 1e6, bound_share=bound_ms / ms,
              host_us=host_us)


def log_scan(f: dict, plain_ms: float, n_bytes: float) -> None:
  log(f"  ms {f['ms']:.4f} (a call with the launch queue full, cold inputs)"
      f"  plain_ms {plain_ms:.3f}  bound_ms {f['bound_ms']:.4f} "
      f"({f['bound_by']}, {n_bytes / 1e6:.1f} MB): {f['gbps']:.0f} GB/s, "
      f"{100 * f['bound_share']:.1f}% of the bound; host "
      f"{f['host_us']:.1f} us a call")


def reset_scan_routes() -> None:
  lru_scan.ring_launches = lru_scan.thread_walk_launches = 0


def check_scan_routes(scans: int) -> None:
  """Every real scan launch since :func:`reset_scan_routes` (``scans`` of
  them) took the TMA ring of ``csrc/lru_scan.cu``."""
  routes = (lru_scan.ring_launches, lru_scan.thread_walk_launches)
  log(f"  scan routes: {routes[0]} launches on the TMA ring, {routes[1]} on "
      f"the per-thread walk (want {scans}, 0)")
  if routes != (scans, 0):
    raise AssertionError(f"Scan routes (ring, per-thread walk) {routes}, "
                         f"want ({scans}, 0).")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
  return (got.float() - want.float()).abs().max().item()


def phase_card() -> dict:
  kind = torch.cuda.get_device_name(0)
  count = torch.cuda.device_count()
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60,
  ).stdout.strip()
  log(f"== card: {kind} (count {count}); torch {torch.__version__}, "
      f"CUDA {torch.version.cuda}")
  log(smi)
  return {"platform": "gpu", "kind": kind, "count": count}


def template_args(mangled: str) -> str:
  """A kernel's mangled template arguments as ptxas names them, readable:
  ``13__nv_bfloat16Li32ELb0E`` -> ``bf16, 32, 0``; a ring kernel's walk
  leads (``NS0_8RealWalkIfLi16E...`` -> ``RealWalk: f32, 16, ...``)."""
  walk = re.search(r"\d+([A-Z][A-Za-z]*Walk)I", mangled)
  args = ", ".join(
      "bf16" if m.group(0) == "13__nv_bfloat16" else
      "f32" if m.group(1) is None else m.group(1)
      for m in re.finditer(r"13__nv_bfloat16|(?:^|I)f(?=L)|L[ib](\d+)E",
                           mangled))
  return f"{walk.group(1)}: {args}" if walk else args


def phase_build() -> None:
  start = time.perf_counter()
  reports = _build.build()
  log(f"== build: {time.perf_counter() - start:.2f} s "
      f"(built {sorted(reports) or 'nothing: up to date'})")
  for name, report in reports.items():
    for line in report.splitlines():
      entry = "Compiling entry function" in line and re.search(
          r"([a-z][a-z_]*_kernel)(?:I(.*?E)Ev)?", line)
      if entry:
        kernel = entry.group(1) + (f"<{template_args(entry.group(2))}>"
                                   if entry.group(2) else "")
        log(f"  {name}: {kernel}")
      elif "registers" in line or "spill" in line:
        log(f"  {name}: {line.strip()}")
  # The scans' TMA-ring kernels as launched, bf16, for each entry point at
  # both channel counts (32 a block at batch 2 of the 2B, 16 at batch 1).
  for library in ("lru_scan", "lru_scan_complex"):
    for backprop, a_prod in ((0, 0), (1, 0), (0, 1), (1, 1)):
      for channels in (32, 16):
        info = _build.kernel_attributes(library, f"cg_{library}_attributes",
                                        backprop, a_prod, 1, channels)
        log(f"  {library} ring_kernel "
            f"{'cotangent' if backprop else 'forward'}"
            f"{' + product' if a_prod else ''}, C = {channels}: "
            f"{info['registers']} registers a thread at launch, "
            f"{info['local_bytes']} local (spilled) bytes, "
            f"{info['shared_bytes']} bytes of shared memory, "
            f"{info['threads']} threads")
  # The kernel lab's log-scan (variant B) at every st it is built for.
  for dtype, label in ((1, "bf16"), (0, "f32")):
    for st in kernel_lab.LOGSCAN_STEPS:
      info = _build.kernel_attributes("kernel_lab",
                                      "cg_lab_logscan_attributes", dtype, st)
      log(f"  kernel_lab lab_logscan_kernel {label} st {st}: "
          f"{info['registers']} registers a thread at launch, "
          f"{info['local_bytes']} local (spilled) bytes, "
          f"{info['shared_bytes']} bytes of shared memory, "
          f"{info['threads']} threads")
  # The Hopper attention kernels' resources as launched (setmaxnreg moves
  # the window kernels' producer registers to their consumers).
  for library, kernel, dims in (
      ("window_attention", "window_attention", wa.KERNEL_HEAD_DIMS),
      ("window_attention_backward", "window_attention_dq",
       wa.KERNEL_HEAD_DIMS),
      ("window_attention_backward", "window_attention_dkv",
       wa.KERNEL_HEAD_DIMS),
      ("mha_attention", "mha_attention", mha_attention.KERNEL_HEAD_DIMS)):
    for head_dim in dims:
      info = resources(library, head_dim, kernel)
      log(f"  {kernel} head_dim {head_dim}: {info['registers']} registers a "
          f"thread at launch, {info['local_bytes']} local (spilled) bytes, "
          f"{info['shared_bytes']} bytes of shared memory")


def phase_lru(dev) -> dict:
  b, t, d = LRU_SHAPE
  rng = np.random.default_rng(SEED)
  x = torch.tensor(rng.standard_normal(LRU_SHAPE, dtype=np.float32),
                   device=dev).bfloat16()
  a = torch.sigmoid(torch.tensor(
      rng.standard_normal(LRU_SHAPE, dtype=np.float32), device=dev
  )).bfloat16()
  h0 = torch.tensor(rng.standard_normal((b, d), dtype=np.float32), device=dev)
  log(f"== lru_scan vs plain at [{b},{t},{d}] bf16 "
      f"(tolerance {LRU_MAX_ABS_ERR})")
  worst = 0.0
  for reverse in (False, True):
    for init in (None, h0):
      err = check_lru(x, a, init, reverse)
      log(f"  reverse={reverse} h0={init is not None}: max_abs_err {err}")
      worst = max(worst, err)

  # Timed as the prefill calls it: forward, no initial state. Read x and a,
  # write y (bf16) and h_last (fp32); two fp32 flops a step.
  n_bytes = 3 * b * t * d * 2 + b * d * 4
  figures = time_scan(lru_scan.lru_scan_forward, (x, a), n_bytes,
                      2 * b * t * d)
  plain_ms = cuda_ms(lambda: lru_scan.lru_scan_plain(x, a), reps=2)
  log_scan(figures, plain_ms, n_bytes)
  return dict(name="lru_scan", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/lru_scan.cu",
              replaces=LRU_REPLACES, max_abs_err=worst, plain_ms=plain_ms,
              library_ms=None, **figures)


def window_forward_figures(q, k, v, seg, kv_prefix=0, plain=True) -> dict:
  """Times the window forward on these inputs beside one SDPA call with the
  same visibility as a boolean mask (the yardstick) and, if ``plain``, the
  plain version; the bound of this run's band, the achieved rate, the share
  of the bound and the ratio to SDPA."""
  b, t, n, h = q.shape
  visible = wa.band_mask(seg, t, ATTN_WINDOW, kv_prefix)  # [b, t, P + t]
  qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))

  def library():
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt.expand(-1, n, -1, -1), vt.expand(-1, n, -1, -1),
        attn_mask=visible[:, None],
    )

  ms = cuda_ms(lambda: wa.window_attention_forward(q, k, v, seg, ATTN_WINDOW,
                                                   kv_prefix), 20)
  library_ms = cuda_ms(library, 5)
  plain_ms = cuda_ms(lambda: wa.window_attention_plain(
      q, k, v, seg, ATTN_WINDOW, kv_prefix), 2) if plain else None
  # Work of this run's band: QK^T and PV, 2 * h flops each per visible
  # (query, key) pair and head; bytes: q, k, v, segment_pos in, out, lse out.
  pairs = int(visible.sum().item())
  flops = 4 * n * h * pairs
  n_bytes = (2 * (2 * b * t * n * h + 2 * b * (kv_prefix + t) * h)
             + 4 * b * t + 4 * b * n * t)
  bound_ms, bound_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
  return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
              bound_ms=bound_ms, bound_by=bound_by, pairs=pairs, flops=flops,
              **speed(ms, flops, bound_ms, library_ms))


def speed(ms: float, flops: float, bound_ms: float, library_ms) -> dict:
  """What a redesign is judged on: achieved TFLOP/s, the share of the bound
  reached and the time as a multiple of the library call's."""
  return dict(tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
              sdpa_ratio=None if library_ms is None else ms / library_ms)


def log_figures(label: str, f: dict) -> None:
  plain = "" if f["plain_ms"] is None else f"  plain_ms {f['plain_ms']:.3f}"
  log(f"  {label}: ms {f['ms']:.4f}{plain}  library_ms (SDPA) "
      f"{f['library_ms']:.4f}  bound_ms {f['bound_ms']:.4f} "
      f"({f['bound_by']}, {f['flops'] / 1e9:.1f} GFLOP over {f['pairs']} "
      f"visible pairs): {f['tflops']:.1f} TFLOP/s, "
      f"{100 * f['bound_share']:.1f}% of the bound, "
      f"{f['sdpa_ratio']:.3f} x SDPA")


def phase_attention(dev) -> dict:
  b, t, n, h = ATTN_SHAPE
  rng = np.random.default_rng(SEED + 1)
  q, k, v = (
      torch.tensor(rng.standard_normal(s, dtype=np.float32),
                   device=dev).bfloat16()
      for s in ((b, t, n, h), (b, t, 1, h), (b, t, 1, h))
  )
  seg = np.tile(np.arange(t, dtype=np.int32), (b, 1))
  seg[0, ATTN_BOUNDARY:] = np.arange(t - ATTN_BOUNDARY, dtype=np.int32)
  seg[1] = np.maximum(np.arange(t, dtype=np.int32) - ATTN_PAD, -1)
  seg = torch.tensor(seg, device=dev)
  log(f"== window_attention vs plain at [{b},{t},{n},{h}] bf16, window "
      f"{ATTN_WINDOW} (tolerance out {ATTN_OUT_MAX_ABS_ERR}, "
      f"lse {ATTN_LSE_MAX_ABS_ERR})")

  out_err, lse_err = check_attention(q, k, v, seg, ATTN_WINDOW)
  figures = window_forward_figures(q, k, v, seg)
  log_figures(f"[{b},{t},{n},{h}], the prefill's", figures)
  del q, k, v

  # The training step's shape: batch 2 x 4096, row 1 right-padded after
  # 3000 (its forward runs twice a block under remat).
  b, t, n, h = ATTN_TRAIN_SHAPE
  q, k, v = (
      torch.tensor(rng.standard_normal(s, dtype=np.float32),
                   device=dev).bfloat16()
      for s in ((b, t, n, h), (b, t, 1, h), (b, t, 1, h))
  )
  train = window_forward_figures(q, k, v, training_segment_pos(dev),
                                 plain=False)
  log_figures(f"[{b},{t},{n},{h}], the training step's", train)
  keys = ("ms", "library_ms", "bound_ms", "tflops", "bound_share",
          "sdpa_ratio")
  return dict(name="window_attention", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/window_attention.cu",
              replaces=ATTN_REPLACES, max_abs_err=max(out_err, lse_err),
              **{key: figures[key] for key in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "tflops", "bound_share", "sdpa_ratio")},
              train_shape={"shape": list(ATTN_TRAIN_SHAPE),
                           **{key: train[key] for key in keys}},
              **resources("window_attention", h))


def resources(library: str, head_dim: int, kernel: str | None = None) -> dict:
  """The registers, spilled bytes and shared memory at head_dim of
  ``kernel`` (default: the library's name) of library ``library``."""
  info = _build.kernel_attributes(
      library, f"cg_{kernel or library}_attributes", head_dim)
  return dict(registers=info["registers"], local_bytes=info["local_bytes"],
              shared_bytes=info["shared_bytes"])


def check_lru(x, a, h0=None, reverse=False) -> float:
  """Max abs error of the kernel against its plain version; raises above
  the tolerance."""
  y, h_last = lru_scan.lru_scan(x, a, h0, reverse)
  y_ref, h_ref = lru_scan.lru_scan_plain(x, a, h0, reverse)
  err = max(max_err(y, y_ref), max_err(h_last, h_ref))
  if not err <= LRU_MAX_ABS_ERR:
    raise AssertionError(f"lru_scan disagrees with its plain version: {err}")
  return err


def check_attention(q, k, v, seg, window, kv_prefix=0) -> tuple[float, float]:
  """Max abs errors (out, lse) of the kernel against its plain version;
  raises above the tolerances or if a padded row is not zero."""
  out, lse = wa.window_attention(q, k, v, seg, window, kv_prefix=kv_prefix)
  out_ref, lse_ref = wa.window_attention_plain(q, k, v, seg, window,
                                               kv_prefix)
  out_err, lse_err = max_err(out, out_ref), max_err(lse, lse_ref)
  log(f"  out max_abs_err {out_err}  lse max_abs_err {lse_err}")
  if not (out_err <= ATTN_OUT_MAX_ABS_ERR and lse_err <= ATTN_LSE_MAX_ABS_ERR):
    raise AssertionError("window_attention disagrees with its plain version.")
  padded = seg < 0
  if out[padded].any() or not (lse.transpose(1, 2)[padded] == wa.MASKED_LSE).all():
    raise AssertionError("Padded rows must give zeros and the masked lse.")
  return out_err, lse_err


class CaptureFirstCall:
  """Stands in for a kernel wrapper in a module and keeps a copy of the
  arguments of its first call (its ``index``-th with ``index``)."""

  def __init__(self, module, name: str, index: int = 0):
    self.module, self.name = module, name
    self.wrapper = getattr(module, name)
    self.args = self.kwargs = None
    self.calls, self.index = 0, index
    setattr(module, name, self)

  def __call__(self, *args, **kwargs):
    if self.args is None and self.calls == self.index:
      copy = lambda z: z.clone() if isinstance(z, torch.Tensor) else z
      self.args = tuple(copy(z) for z in args)
      self.kwargs = {key: copy(z) for key, z in kwargs.items()}
    self.calls += 1
    return self.wrapper(*args, **kwargs)

  def restore(self):
    setattr(self.module, self.name, self.wrapper)


class DecodeProbe:
  """Sees the samplers' decode loops, captured as CUDA graphs or eager.

  CUDA events around each ``Sampler._decode`` call and the steps it ran give
  decode ms a step. A replay of a captured step runs no Python, so the
  kernel wrappers' counters miss its launches: ``counts()`` (the counters)
  read around a decode step's Python, which runs at a graph's warm-up and
  capture, give one step's launches, and a run's launches are the
  counters' plus those times the replays (:meth:`run_launches`).
  """

  def __init__(self, counts):
    self.counts = counts
    self.step_launches = None
    self.decodes = []  # [start event, end event, steps]
    self.replays = 0
    self._saved = (sampler_lib.Sampler._decode, sampler_lib._DecodeGraph._step,
                   sampler_lib._DecodeGraph.replay)
    decode, step, replay = self._saved
    probe = self

    def timed_decode(sampler, state, *args, **kwargs):
      first = int(state.step)
      start = torch.cuda.Event(enable_timing=True)
      start.record()
      state = decode(sampler, state, *args, **kwargs)
      end = torch.cuda.Event(enable_timing=True)
      end.record()
      probe.decodes.append([start, end, int(state.step) - first])
      return state

    def counted_step(graph, sampler):
      before = probe.counts()
      logits = step(graph, sampler)
      after = probe.counts()
      probe.step_launches = {k: after[k] - before[k] for k in after}
      return logits

    def counted_replay(graph):
      probe.replays += 1
      return replay(graph)

    sampler_lib.Sampler._decode = timed_decode
    sampler_lib._DecodeGraph._step = counted_step
    sampler_lib._DecodeGraph.replay = counted_replay

  def reset(self) -> None:
    self.decodes.clear()
    self.replays = 0

  def decode_ms(self) -> float:
    """Decode ms a step of the last decode loop."""
    start, end, steps = self.decodes[-1]
    end.synchronize()
    return start.elapsed_time(end) / steps

  def run_launches(self, counted: dict[str, int]) -> dict[str, int]:
    """The launches of a run: the counters' and the replays'."""
    if not self.replays:
      return dict(counted)
    return {k: counted[k] + self.step_launches[k] * self.replays
            for k in counted}

  def close(self) -> None:
    (sampler_lib.Sampler._decode, sampler_lib._DecodeGraph._step,
     sampler_lib._DecodeGraph.replay) = self._saved


def _use_plain_path(model: griffin.Griffin, plain: bool) -> None:
  """Routes the model through the plain scan and einsum attention, or back."""
  for block in model.blocks:
    if block.temporal_block_type is common.TemporalBlockType.RECURRENT:
      block.recurrent_block.rg_lru.scan_type = (
          common.ScanType.LINEAR_NATIVE if plain else model.config.scan_type
      )
    else:
      block.attention_block.use_flash_attention = False if plain else None


def phase_main_path(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16,
      generator=torch.Generator(dev).manual_seed(SEED),
  )
  torch.cuda.synchronize()
  n_params = sum(p.numel() for p in model.parameters())
  log(f"== main path: RecurrentGemma-2B, {config.num_layers} blocks, width "
      f"{config.width}, {n_params / 1e9:.3f} B parameters in bf16 "
      f"(built in {time.perf_counter() - start:.1f} s)")
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  n_attention = config.num_layers - n_recurrent
  if (n_recurrent, n_attention) != (18, 8):
    raise AssertionError(f"2B has 18 R and 8 A blocks, got {n_recurrent}, "
                         f"{n_attention}.")

  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(SEED + 2)
  # BOS plus n - 1 words; the shorter prompt is left-padded.
  prompts = [
      " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4, n - 1))
      for n in PROMPT_TOKENS
  ]
  sampler = sampler_lib.Sampler(model, vocab, device=dev)

  # Per model forward: [start event, end event, the two launch counters at
  # its end]. The first forward of a call is the prefill; the decode steps
  # replay a captured graph, which the probe sees.
  calls = []

  def before_forward(*_):
    calls.append([torch.cuda.Event(enable_timing=True)])
    calls[-1][0].record()

  def after_forward(*_):
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    calls[-1] += [end, lru_scan.launches, wa.launches]

  hooks = [model.register_forward_pre_hook(before_forward),
           model.register_forward_hook(after_forward)]
  counts = lambda: {"lru_scan": lru_scan.launches,
                    "window_attention": wa.launches}
  probe = DecodeProbe(counts)
  run_kw = dict(total_generation_steps=DECODE_STEPS, return_logits=True,
                end_sampling_at_eos_token=False)
  try:
    # Warm-up with the measured run's shapes (its decode graph is captured
    # here), which also keeps the inputs that this prefill (the same as the
    # measured run's) gives each kernel's first call.
    captures = [CaptureFirstCall(lru_scan, "lru_scan"),
                CaptureFirstCall(wa, "window_attention")]
    try:
      sampler(prompts, **run_kw)
    finally:
      for capture in captures:
        capture.restore()
    torch.cuda.synchronize()
    calls.clear()
    probe.reset()
    torch.cuda.reset_peak_memory_stats()
    lru_scan.launches = 0
    wa.launches = 0
    reset_scan_routes()
    start = time.perf_counter()
    out = sampler(prompts, **run_kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = probe.run_launches(counts())
    replays, step_launches = probe.replays, probe.step_launches
    decode_ms = probe.decode_ms()
  finally:
    probe.close()
    for hook in hooks:
      hook.remove()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  check_scan_routes(lru_scan.launches)

  if len(calls) + replays != DECODE_STEPS or replays != DECODE_STEPS - 1:
    raise AssertionError(f"{len(calls)} forwards and {replays} replays of "
                         f"the captured step for {DECODE_STEPS} tokens.")
  prefill = tuple(calls[0][2:])
  if prefill != (n_recurrent, n_attention):
    raise AssertionError(f"Prefill launched (lru, attention) = {prefill}, "
                         f"want {(n_recurrent, n_attention)}.")
  if tuple(launches.values()) != prefill or any(step_launches.values()):
    raise AssertionError(f"Decode launched kernels: {launches} after "
                         f"prefill {prefill}; a captured step "
                         f"{step_launches}.")
  tokens = torch.stack(out.tokens)
  logits = torch.stack(out.logits)
  if tokens.shape != (2, DECODE_STEPS) or logits.shape != (
      2, DECODE_STEPS, config.vocab_size):
    raise AssertionError(f"Shapes {tokens.shape}, {logits.shape}.")
  if not torch.isfinite(logits).all():
    raise AssertionError("Non-finite logits.")
  if not ((tokens >= 0) & (tokens < config.vocab_size)).all():
    raise AssertionError("Token out of range.")

  prefill_ms = calls[0][0].elapsed_time(calls[0][1])
  padded = max(PROMPT_TOKENS)
  log(f"  prompts {PROMPT_TOKENS} tokens (padded to {padded}), "
      f"{DECODE_STEPS} greedy steps, decode captured ({replays} replays of "
      f"one step, whose capture launched {step_launches})")
  log(f"  launches in the run {launches}; prefill {prefill}")
  prompt_rate = sum(PROMPT_TOKENS) / prefill_ms * 1e3  # real tokens only
  log(f"  prefill_ms {prefill_ms:.2f} ({prompt_rate:.0f} prompt tokens/s)  "
      f"decode_ms_per_step {decode_ms:.3f}  "
      f"wall {wall_s:.3f} s ({2 * DECODE_STEPS / wall_s:.1f} generated "
      f"tokens/s)  peak {peak_gb:.2f} GB")
  log(f"  first tokens {tokens[:, :8].tolist()}")

  # Each kernel against its plain version on the inputs the prefill gave it.
  for kernel, capture in zip(kernels, captures):
    args, kwargs = capture.args, capture.kwargs
    if args is None:
      raise AssertionError(f"The prefill never called {kernel['name']}.")
    tensors = [z for z in (*args, *kwargs.values())
               if isinstance(z, torch.Tensor)]
    log(f"  {kernel['name']} on the prefill's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]}:")
    if kernel["name"] == "lru_scan":
      err = check_lru(*args, **kwargs)
      log(f"  max_abs_err {err} (tolerance {LRU_MAX_ABS_ERR})")
    else:
      err = max(check_attention(*args, **kwargs))
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
    kernel["launches"] = launches[kernel["name"]]

  # The same weights through the plain path, one prompt longer than the
  # window, compared at the last position's logits.
  ids = torch.tensor(
      [[1, *rng.integers(4, config.vocab_size, REFERENCE_PROMPT_TOKENS - 1)]],
      device=dev,
  )
  pos = torch.arange(REFERENCE_PROMPT_TOKENS, device=dev)[None]
  with torch.inference_mode():
    got, _ = model(ids, pos, return_cache=False, last_logits_only=True)
    _use_plain_path(model, True)
    want, _ = model(ids, pos, return_cache=False, last_logits_only=True)
    _use_plain_path(model, False)
  diff = (got.float() - want.float())
  rel = (diff.square().mean().sqrt() / want.float().square().mean().sqrt())
  rel = rel.item()
  log(f"  kernel path vs plain path, {REFERENCE_PROMPT_TOKENS} tokens: "
      f"logits rel_rms {rel:.3e} (tolerance {MODEL_LOGITS_REL_RMS}), "
      f"max_abs {diff.abs().max().item():.3e}, same argmax "
      f"{bool(got.argmax() == want.argmax())}")
  if not (torch.isfinite(got).all() and rel <= MODEL_LOGITS_REL_RMS):
    raise AssertionError("Kernel path and plain path disagree.")
  if profile:
    profile_main_path(sampler, prompts, prefill_ms, decode_ms)
  return model, vocab, prompts, sampler, out


def decode_kernel_times(sampler, prompts):
  """(prefill's, DECODE_STEPS decode steps') kernel times by name: a
  prefill-only call's trace and the difference of a call with DECODE_STEPS
  more tokens. That call's decode graph is captured before its trace."""
  longer = lambda: sampler(prompts, total_generation_steps=1 + DECODE_STEPS,
                           end_sampling_at_eos_token=False)
  longer()
  prefill_k = kernel_times(lambda: sampler(prompts, total_generation_steps=1))
  both_k = kernel_times(longer)
  return prefill_k, {
      name: (ms - prefill_k.get(name, (0.0, 0))[0],
             count - prefill_k.get(name, (0.0, 0))[1])
      for name, (ms, count) in both_k.items()
  }


def profile_main_path(sampler, prompts, prefill_ms, decode_ms) -> None:
  """Logs kernel time by name, per step, for prefill and for decode."""
  prefill_k, decode_k = decode_kernel_times(sampler, prompts)
  for label, times, steps, wall_ms in (
      ("prefill", prefill_k, 1, prefill_ms),
      ("decode", decode_k, DECODE_STEPS, decode_ms),
  ):
    busy = sum(ms for ms, _ in times.values()) / steps
    log(f"  {label}: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms a step "
        f"(device idle share {1 - busy / wall_ms:.3f}); top kernels:")
    for name, (ms, count) in sorted(
        times.items(), key=lambda kv: -kv[1][0])[:8]:
      log(f"    {ms / steps:9.4f} ms  x{count / steps:6.1f}  {name[:90]}")


# Traces of one call to take before giving up when the profiler hands back no
# device event: a short trace (50 launches of a 2 µs kernel) has come back
# empty once in a run whose kernels all launched and agreed.
PROFILE_ATTEMPTS = 3


def kernel_times(fn) -> dict[str, tuple[float, int]]:
  """{kernel name: (device ms, launches)} of one call, from torch.profiler.

  Raises if the profiler records no device event in PROFILE_ATTEMPTS traces
  of the call."""
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  for attempt in range(PROFILE_ATTEMPTS):
    with torch.profiler.profile(activities=activities) as prof:
      fn()
      torch.cuda.synchronize()
    times = {
        e.key: (e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    }
    if times:
      return times
    log(f"  torch.profiler recorded no device event (trace {attempt + 1} of "
        f"{PROFILE_ATTEMPTS})")
  raise RuntimeError("torch.profiler recorded no kernel on the card.")


def _timed_call(fn) -> tuple[float, float]:
  """(ms, peak GB) of one call: CUDA events around it, the peak of the
  memory it allocated."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end), torch.cuda.max_memory_allocated() / 1e9


def _turns(turns, calls: dict) -> dict:
  """{side: [ms, ...]} of ``calls[side]()`` timed in ``turns``."""
  times = {side: [] for side in calls}
  for side in turns:
    times[side].append(_timed_call(calls[side])[0])
  return times


def _check_carry(capture: CaptureFirstCall, what: str) -> float:
  """The captured LRU call had a carry from the cache; its kernel output
  bit for bit against the plain loop."""
  if capture.args is None:
    raise AssertionError(f"{what} never called lru_scan.")
  h0 = capture.args[2] if len(capture.args) > 2 else capture.kwargs.get("h0")
  if h0 is None or not bool(h0.any()):
    raise AssertionError(f"{what}: the scan took no carry from the cache.")
  err = check_lru(*capture.args, **capture.kwargs)
  log(f"  {what}: lru_scan on {tuple(capture.args[0].shape)} with a carry "
      f"from the cache, max_abs_err {err} vs lru_scan_plain (tolerance "
      f"{LRU_MAX_ABS_ERR})")
  return err


def phase_serving(dev, model, vocab, prompts, sampler, single,
                  kernels: list[dict], profile: bool) -> None:
  """The Sampler's serving features on the main path's 2B."""
  config = model.config
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  log(f"== serving features on the main path's 2B: chunked prefill "
      f"({CHUNK_TOKENS}-token chunks), prefix caching, conversational "
      f"state, captured vs eager decode")
  by_name = {kernel["name"]: kernel for kernel in kernels}
  counts = lambda: {"lru_scan": lru_scan.launches,
                    "window_attention": wa.launches}
  rng = np.random.default_rng(SEED + 50)

  def words(n):
    return " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4, n))

  def launched(fn, want, what):
    """Runs ``fn`` with the counters reset; checks its launches."""
    lru_scan.launches = wa.launches = 0
    reset_scan_routes()
    result = fn()
    torch.cuda.synchronize()
    got = counts()
    log(f"  {what}: launches {got}")
    check_scan_routes(got["lru_scan"])
    if got != want:
      raise AssertionError(f"{what} launched {got}, want {want}.")
    return result

  run_kw = dict(total_generation_steps=DECODE_STEPS, return_logits=True,
                end_sampling_at_eos_token=False)
  served = 0  # LRU launches of the serving runs below

  # Chunked prefill of the main path's prompts.
  chunked = sampler_lib.Sampler(model, vocab, device=dev,
                                prefill_chunk_size=CHUNK_TOKENS)
  chunked(prompts, **run_kw)  # warm-up; captures its decode graph
  n_chunks = -(-max(PROMPT_TOKENS) // CHUNK_TOKENS)
  # The first scan of the second chunk: its carry comes from the cache.
  capture = CaptureFirstCall(lru_scan, "lru_scan", index=n_recurrent)
  try:
    out = launched(lambda: chunked(prompts, **run_kw),
                   {"lru_scan": n_chunks * n_recurrent,
                    "window_attention": 0},
                   f"chunked prefill ({n_chunks} chunks) + decode")
  finally:
    capture.restore()
  served += n_chunks * n_recurrent
  err = _check_carry(capture, "chunk 2")
  by_name["lru_scan"]["max_abs_err"] = max(by_name["lru_scan"]["max_abs_err"],
                                           err)
  chunk_logits = torch.stack(out.logits)
  single_logits = torch.stack(single.logits)
  rel = _rel_rms(chunk_logits[:, 0], single_logits[:, 0])
  agree = (torch.stack(out.tokens) == torch.stack(single.tokens)).float()
  log(f"  chunked vs single-shot prefill, last prompt position: logits "
      f"rel_rms {rel:.3e} (tolerance {MODEL_LOGITS_REL_RMS}); token "
      f"agreement of the {DECODE_STEPS}-token generations "
      f"{agree.mean().item():.4f}")
  if not (torch.isfinite(chunk_logits).all() and rel <= MODEL_LOGITS_REL_RMS):
    raise AssertionError("Chunked and single-shot prefill disagree.")
  ttft = {True: lambda: chunked(prompts, total_generation_steps=1),
          False: lambda: sampler(prompts, total_generation_steps=1)}
  peaks = {side: _timed_call(fn)[1] for side, fn in ttft.items()}
  times = _turns(GRAPH_TURNS, ttft)
  log(f"  prefill (time to the first token) ms in turns {GRAPH_TURNS} "
      f"(True: chunked): chunked {[round(t, 2) for t in times[True]]}, "
      f"single-shot {[round(t, 2) for t in times[False]]}; peak memory "
      f"chunked {peaks[True]:.2f} GB, single-shot {peaks[False]:.2f} GB")
  if profile:
    for side, label in ((True, "chunked"), (False, "single-shot")):
      profile_call(ttft[side], float(np.median(times[side])),
                   f"{label} prefill")

  # Prefix caching: a batch-1 prefix (two chunks) continued by two calls.
  prefix = words(PREFIX_TOKENS - 1)
  state = chunked.prefill_prefix(prefix)
  before = [t.clone() for t in sampler_lib._cache_leaves(state.cache)]
  for call in range(2):
    rows = [words(CONTINUATION_TOKENS) for _ in range(2)]
    capture = CaptureFirstCall(lru_scan, "lru_scan")
    try:
      got = launched(
          lambda: chunked(rows, total_generation_steps=1, return_logits=True,
                          prefix_state=state),
          {"lru_scan": n_recurrent, "window_attention": 0},
          f"continuation {call + 1} (2 x {CONTINUATION_TOKENS} tokens after "
          f"{PREFIX_TOKENS})")
    finally:
      capture.restore()
    served += n_recurrent
    err = _check_carry(capture, f"continuation {call + 1}")
    by_name["lru_scan"]["max_abs_err"] = max(
        by_name["lru_scan"]["max_abs_err"], err)
    full_rows = [f"{prefix} {r}" for r in rows]
    full = sampler(full_rows, total_generation_steps=1, return_logits=True)
    rel = _rel_rms(got.logits[0][0][None], full.logits[0][0][None])
    rel = max(rel, _rel_rms(got.logits[1][0][None], full.logits[1][0][None]))
    log(f"  continuation {call + 1} vs the full "
        f"{PREFIX_TOKENS + CONTINUATION_TOKENS}-token prompts in one call: "
        f"last logits "
        f"rel_rms {rel:.3e} (tolerance {MODEL_LOGITS_REL_RMS})")
    if not rel <= MODEL_LOGITS_REL_RMS:
      raise AssertionError("A prefix continuation disagrees with its full "
                           "prompt.")
  for a, b in zip(before, sampler_lib._cache_leaves(state.cache)):
    if not torch.equal(a, b):
      raise AssertionError("A continuation changed the prefix's cache.")
  times = _turns(GRAPH_TURNS, {
      True: lambda: chunked(rows, total_generation_steps=1,
                            prefix_state=state),
      False: lambda: sampler(full_rows, total_generation_steps=1)})
  log(f"  time to the first token, ms in turns {GRAPH_TURNS} (True: the "
      f"continuation from the prefix): continuation "
      f"{[round(t, 2) for t in times[True]]}, full prompt "
      f"{[round(t, 2) for t in times[False]]}; ratio of medians "
      f"{np.median(times[True]) / np.median(times[False]):.4f}")
  if profile:
    profile_call(lambda: chunked(rows, total_generation_steps=1,
                                 prefix_state=state),
                 float(np.median(times[True])), "continuation prefill")
  del state, before

  # Conversational state: each turn continues the last one's state.
  state, history = None, [vocab.bos_id()]
  for turn, n in enumerate(TURN_TOKENS):
    text = words(n)
    got = launched(
        lambda: sampler([text], total_generation_steps=TURN_STEPS,
                        return_logits=True, end_sampling_at_eos_token=False,
                        return_state=True, prefix_state=state),
        {"lru_scan": n_recurrent, "window_attention": 0},
        f"turn {turn + 1} ({n} prompt tokens)")
    served += n_recurrent
    history += vocab.EncodeAsIds(text)
    ids = torch.tensor([history], device=dev)
    with torch.inference_mode():
      whole, _ = model(ids, torch.arange(len(history), device=dev)[None],
                       return_cache=False, last_logits_only=True)
    rel = _rel_rms(got.logits[0][0], whole[0, 0])
    log(f"  turn {turn + 1} vs the {len(history)}-token history in one "
        f"call (teacher-forced): first logits rel_rms {rel:.3e} (tolerance "
        f"{MODEL_LOGITS_REL_RMS})")
    if not rel <= MODEL_LOGITS_REL_RMS:
      raise AssertionError(f"Turn {turn + 1} disagrees with its history.")
    history += got.tokens[0].tolist()
    state = got.state
  del state

  # Captured decode against eager decode, in turns.
  eager = sampler_lib.Sampler(model, vocab, device=dev, jit_compile=False)
  sides = {True: sampler, False: eager}
  per_step, outs = {True: [], False: []}, {True: [], False: []}
  probe = DecodeProbe(counts)
  try:
    for graph in GRAPH_TURNS:
      outs[graph].append(sides[graph](prompts, **run_kw))
      per_step[graph].append(probe.decode_ms())
  finally:
    probe.close()
  ref_tokens = torch.stack(outs[True][0].tokens)
  same = all(torch.equal(torch.stack(o.tokens), ref_tokens)
             for side in outs.values() for o in side)
  diff = max_err(torch.stack(outs[True][0].logits),
                 torch.stack(outs[False][0].logits))
  log(f"  decode ms a step in turns {GRAPH_TURNS} (True: captured): captured "
      f"{[round(ms, 3) for ms in per_step[True]]} (median "
      f"{np.median(per_step[True]):.3f}), eager "
      f"{[round(ms, 3) for ms in per_step[False]]} (median "
      f"{np.median(per_step[False]):.3f}); greedy tokens identical {same}; "
      f"logits max_abs_diff {diff:.3e}")
  if not same:
    raise AssertionError("Captured and eager greedy decode disagree.")
  for label, kw in (("categorical " + str(CATEGORICAL),
                     dict(deterministic_sampling=False, **CATEGORICAL)),
                    (f"greedy, repetition_penalty {SERVING_PENALTY}",
                     dict(repetition_penalty=SERVING_PENALTY))):
    got = {}
    for graph in (True, False):
      gen = torch.Generator(dev).manual_seed(SEED + 51)
      s = sampler_lib.Sampler(model, vocab, device=dev, jit_compile=graph,
                              **kw)
      got[graph] = (torch.stack(s(prompts, generator=gen, **run_kw).tokens),
                    gen.get_state())
    same = torch.equal(got[True][0], got[False][0])
    same_gen = torch.equal(got[True][1], got[False][1])
    log(f"  {label}: captured and eager tokens identical {same}, "
        f"generators at the same offset {same_gen}; first tokens "
        f"{got[True][0][:, :6].tolist()}")
    if not (same and same_gen):
      raise AssertionError(f"Captured and eager decode disagree ({label}).")
  if profile:
    for graph in (True, False):
      profile_decode(sides[graph], prompts, float(np.median(per_step[graph])),
                     "captured" if graph else "eager")

  by_name["lru_scan"]["launches"] += served
  log(f"  LRU launches of the serving runs: {served} (added to the "
      f"lru_scan row)")


def profile_call(fn, wall_ms: float, label: str) -> None:
  """Kernel time of one call against its time: the device's idle share."""
  times = kernel_times(fn)
  busy = sum(ms for ms, _ in times.values())
  log(f"  {label}: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms (device "
      f"idle share {1 - busy / wall_ms:.3f}), "
      f"{sum(n for _, n in times.values())} kernels")


def profile_decode(sampler, prompts, decode_ms: float, label: str) -> None:
  """Kernel time of a decode step against its time: the idle share."""
  _, decode_k = decode_kernel_times(sampler, prompts)
  busy = sum(ms for ms, _ in decode_k.values()) / DECODE_STEPS
  kernels = sum(n for _, n in decode_k.values()) / DECODE_STEPS
  log(f"  {label} decode: kernels busy {busy:.3f} ms of {decode_ms:.3f} ms "
      f"a step (device idle share {1 - busy / decode_ms:.3f}), {kernels:.1f} "
      f"kernels a step")


def training_segment_pos(dev) -> torch.Tensor:
  """The training batch's positions: row 1 right-padded after 3000 tokens,
  its pad positions repeating the last real one (``get_positions``)."""
  tokens = torch.ones(2, TRAIN_TOKENS, dtype=torch.long, device=dev)
  tokens[1, TRAIN_REAL_TOKENS[1]:] = 0
  return trainer.get_positions(tokens, 0)


def phase_lru_backward(dev) -> dict:
  b, t, d = LRU_TRAIN_SHAPE
  rng = np.random.default_rng(SEED + 3)
  g = torch.tensor(rng.standard_normal(LRU_TRAIN_SHAPE, dtype=np.float32),
                   device=dev).bfloat16()
  a = torch.sigmoid(torch.tensor(
      rng.standard_normal(LRU_TRAIN_SHAPE, dtype=np.float32), device=dev
  )).bfloat16()
  dh_last = torch.tensor(rng.standard_normal((b, d), dtype=np.float32),
                         device=dev)
  log(f"== lru_scan_backward vs plain at [{b},{t},{d}] bf16 "
      f"(tolerance {LRU_BWD_MAX_ABS_ERR})")
  worst = 0.0
  for reverse in (False, True):
    for carry in (None, dh_last):
      err = check_lru_backward(g, a, carry, reverse)
      log(f"  reverse={reverse} dh_last={carry is not None}: max_abs_err {err}")
      worst = max(worst, err)
  # Timed as training calls it: the forward scan's cotangents, dh_last
  # given. Read g and a, write dx (bf16); read dh_last, write dh0 (fp32);
  # two fp32 flops a step.
  n_bytes = 3 * b * t * d * 2 + 2 * b * d * 4
  figures = time_scan(
      lambda g, a: lru_scan.lru_scan_backward(g, a, dh_last), (g, a),
      n_bytes, 2 * b * t * d)
  plain_ms = cuda_ms(
      lambda: lru_scan.lru_scan_backward_plain(g, a, dh_last), reps=2
  )
  log_scan(figures, plain_ms, n_bytes)
  return dict(name="lru_scan_backward", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/lru_scan.cu",
              replaces=LRU_BWD_REPLACES, max_abs_err=worst,
              plain_ms=plain_ms, library_ms=None, **figures)


def phase_attention_backward(dev) -> list[dict]:
  b, t, n, h = ATTN_TRAIN_SHAPE
  rng = np.random.default_rng(SEED + 4)
  q, k, v, g = (
      torch.tensor(rng.standard_normal(s, dtype=np.float32),
                   device=dev).bfloat16()
      for s in ((b, t, n, h), (b, t, 1, h), (b, t, 1, h), (b, t, n, h))
  )
  seg = training_segment_pos(dev)
  log(f"== window_attention dq and dk/dv vs plain at [{b},{t},{n},{h}] bf16, "
      f"window {ATTN_WINDOW}, row 1 right-padded after "
      f"{TRAIN_REAL_TOKENS[1]} (tolerance {ATTN_BWD_REL_ERR} of the largest "
      f"gradient)")
  out, lse = wa.window_attention(q, k, v, seg, ATTN_WINDOW)
  delta = wa.attention_delta(out, g)
  args = (q, k, v, seg, lse, delta, g, ATTN_WINDOW)
  dq_err = check_dq(*args)
  dkv_err = check_dkv(*args)
  return backward_rows(args, dq_err, dkv_err)


def backward_rows(args, dq_err: float, dkv_err: float,
                  suffix: str = "") -> list[dict]:
  """Times dq and dk/dv on ``args`` (the wrappers' arguments) and their
  plain versions; their bounds over this run's visible (query, key) pairs,
  TFLOP/s, shares of the bound and resources, and the pair's summed time
  against SDPA's backward, which computes dq, dk and dv in one call."""
  q, k, v, seg, _, _, g, window, *rest = args
  kv_prefix = rest[0] if rest else 0
  b, t, n, h = q.shape
  kv_len = k.shape[1]
  # The yardstick: SDPA's backward with the same visibility as a boolean
  # mask (forward + backward, minus the forward), k and v expanded to the
  # n query heads.
  visible = wa.band_mask(seg, t, window, kv_prefix)  # [b, t, P + t]
  pairs = int(visible.sum().item())
  qt, kt, vt = (z.transpose(1, 2).detach().requires_grad_()
                for z in (q, k, v))
  gt = g.transpose(1, 2)

  def sdpa():
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt.expand(-1, n, -1, -1), vt.expand(-1, n, -1, -1),
        attn_mask=visible[:, None],
    )

  def sdpa_forward_backward():
    torch.autograd.grad(sdpa(), (qt, kt, vt), gt)

  with torch.no_grad():
    sdpa_fwd_ms = cuda_ms(sdpa, 5)
  library_ms = cuda_ms(sdpa_forward_backward, 5) - sdpa_fwd_ms
  del qt, kt, vt, gt, visible
  dq_ms = cuda_ms(lambda: wa.window_attention_dq(*args), 10)
  dkv_ms = cuda_ms(lambda: wa.window_attention_dkv(*args), 10)
  dq_plain_ms = cuda_ms(lambda: wa.window_attention_dq_plain(*args), 2)
  dkv_plain_ms = cuda_ms(lambda: wa.window_attention_dkv_plain(*args), 2)
  pair_ms = dq_ms + dkv_ms
  # Bytes: q and dO, k and v over all kv_len keys in bf16, segment_pos, lse
  # and delta in 32 bits, and the outputs (dq; dk and dv over kv_len keys).
  # Operations: 2 h flops per product per visible pair and head; dq does 3
  # products (s, dO.v, ds k), dk/dv 4 (s, dO.v, p dO, ds q).
  inputs = 2 * (2 * b * t * n * h + 2 * b * kv_len * h) + 4 * b * t + (
      2 * 4 * b * n * t)
  rows = []
  for name, ms, plain_ms, err, products, n_out, replaces in (
      ("window_attention_dq", dq_ms, dq_plain_ms, dq_err, 3, b * t * n * h,
       DQ_REPLACES),
      ("window_attention_dkv", dkv_ms, dkv_plain_ms, dkv_err, 4,
       2 * b * kv_len * h, DKV_REPLACES),
  ):
    flops = 2 * products * n * h * pairs
    bound_ms, bound_by = bound(inputs + 2 * n_out, flops, BF16_TENSOR_FLOPS)
    figures = speed(ms, flops, bound_ms, None)
    log(f"  {name + suffix}: ms {ms:.4f}  plain_ms {plain_ms:.3f}  bound_ms "
        f"{bound_ms:.4f} ({bound_by}, {flops / 1e9:.1f} GFLOP over {pairs} "
        f"visible pairs): {figures['tflops']:.1f} TFLOP/s, "
        f"{100 * figures['bound_share']:.1f}% of the bound")
    rows.append(dict(
        name=name + suffix, route="cuda",
        source="cadence_gemma_tpu_torch/csrc/window_attention_backward.cu",
        replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        tflops=figures["tflops"], bound_share=figures["bound_share"],
        pair_ms=pair_ms, pair_sdpa_ratio=pair_ms / library_ms,
        **resources("window_attention_backward", h, name),
    ))
  log(f"  the pair dq + dk/dv {pair_ms:.4f} ms against SDPA's backward "
      f"{library_ms:.4f} ms (dq, dk and dv together; k and v expanded to {n} "
      f"heads): {pair_ms / library_ms:.3f} x SDPA")
  return rows


def check_lru_backward(g, a, dh_last=None, reverse=False) -> float:
  """Max abs error of the cotangent-scan kernel against its plain version;
  raises above the tolerance."""
  dx, dh0 = lru_scan.lru_scan_backward(g, a, dh_last, reverse)
  dx_ref, dh0_ref = lru_scan.lru_scan_backward_plain(g, a, dh_last, reverse)
  err = max(max_err(dx, dx_ref), max_err(dh0, dh0_ref))
  if not err <= LRU_BWD_MAX_ABS_ERR:
    raise AssertionError(
        f"lru_scan_backward disagrees with its plain version: {err}"
    )
  return err


def _check_relative(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
  scale = want.float().abs().max().item()
  err = max_err(got, want)
  log(f"  {name}: max_abs_err {err:.4e} (largest |gradient| {scale:.4e}, "
      f"ratio {err / scale:.3e})")
  if not (torch.isfinite(got).all() and err <= ATTN_BWD_REL_ERR * scale):
    raise AssertionError(f"{name} disagrees with its plain version.")
  return err


def check_dq(*args) -> float:
  """Max abs error of the dq kernel against its plain version; raises above
  the tolerance or if a row that sees no key gets a gradient."""
  return _check_relative("dq", wa.window_attention_dq(*args),
                         wa.window_attention_dq_plain(*args))


def check_dkv(*args) -> float:
  dk, dv = wa.window_attention_dkv(*args)
  dk_ref, dv_ref = wa.window_attention_dkv_plain(*args)
  return max(_check_relative("dk", dk, dk_ref),
             _check_relative("dv", dv, dv_ref))


def training_batch(vocab_size: int) -> data_lib.TrainingInput:
  """Two rows of random tokens after BOS: row 0 fills 4096, row 1 holds
  3000 and is right-padded; the loss covers the second half of each."""
  rng = np.random.default_rng(SEED + 5)
  tokens = rng.integers(4, vocab_size, (2, TRAIN_TOKENS)).astype(np.int32)
  tokens[:, 0] = 1
  mask = np.zeros(tokens.shape, bool)
  for row, real in enumerate(TRAIN_REAL_TOKENS):
    tokens[row, real:] = 0
    mask[row, real // 2:real] = True
  return data_lib.TrainingInput(input_tokens=tokens, target_mask=mask)


def _launch_counts() -> dict[str, int]:
  return {"lru_scan": lru_scan.launches,
          "lru_scan_backward": lru_scan.backward_launches,
          "window_attention": wa.launches,
          "window_attention_dq": wa.dq_launches,
          "window_attention_dkv": wa.dkv_launches}


def _reset_launch_counts() -> None:
  lru_scan.launches = lru_scan.backward_launches = 0
  wa.launches = wa.dq_launches = wa.dkv_launches = 0
  reset_scan_routes()


def phase_training(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16,
      generator=torch.Generator(dev).manual_seed(SEED + 6),
  )
  torch.cuda.synchronize()
  log(f"== training path: RecurrentGemma-2B, {config.num_layers} blocks, "
      f"width {config.width}, bf16 weights (built in "
      f"{time.perf_counter() - start:.1f} s); train_loop, {TRAIN_STEPS} "
      f"AdamW steps at learning rate {TRAIN_LEARNING_RATE}, batch 2 x "
      f"{TRAIN_TOKENS} ({sum(TRAIN_REAL_TOKENS)} real tokens)")
  batch = training_batch(config.vocab_size)
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  n_attention = config.num_layers - n_recurrent

  steps = []  # (step, loss, host time after the loss reached the host)

  def log_metrics(metrics, step):
    steps.append((step, metrics["train_loss"], time.perf_counter()))

  # The first step's inputs to each backward kernel, for the checks below.
  captures = [CaptureFirstCall(lru_scan, "lru_scan_backward"),
              CaptureFirstCall(wa, "window_attention_dq"),
              CaptureFirstCall(wa, "window_attention_dkv")]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _reset_launch_counts()
  start = time.perf_counter()
  try:
    train_loop_lib.train_loop(
        model, [batch] * TRAIN_STEPS,
        train_loop_lib.TrainingConfig(learning_rate=TRAIN_LEARNING_RATE,
                                      eval_every_n=1, max_steps=TRAIN_STEPS),
        log_metrics=log_metrics, device=dev,
    )
  finally:
    for capture in captures:
      capture.restore()
  torch.cuda.synchronize()
  launches = _launch_counts()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  per_step = {"lru_scan": 2 * n_recurrent, "lru_scan_backward": n_recurrent,
              "window_attention": 2 * n_attention,
              "window_attention_dq": n_attention,
              "window_attention_dkv": n_attention}
  want = {name: TRAIN_STEPS * count for name, count in per_step.items()}
  log(f"  launches in the {TRAIN_STEPS} steps {launches}")
  if launches != want:
    raise AssertionError(f"Training launched {launches}, want {want} "
                         f"({per_step} a step).")
  check_scan_routes(launches["lru_scan"] + launches["lru_scan_backward"])
  losses = [loss for _, loss, _ in steps]
  times = [start] + [t for _, _, t in steps]
  step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
  log(f"  losses {losses}")
  if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
    raise AssertionError(f"Non-finite or missing losses: {losses}.")
  if not losses[-1] < losses[0]:
    raise AssertionError(f"The loss did not fall: {losses}.")
  steady_ms = float(np.mean(step_ms[1:]))
  real_tokens = sum(TRAIN_REAL_TOKENS)
  log(f"  ms per step {[round(ms, 1) for ms in step_ms]} (the first "
      f"includes warm-up); steady {steady_ms:.1f} ms "
      f"({real_tokens / steady_ms * 1e3:.0f} real tokens/s); peak "
      f"{peak_gb:.2f} GB")

  # Each backward kernel against its plain version on the inputs the first
  # training step gave it.
  checks = {"lru_scan_backward": check_lru_backward,
            "window_attention_dq": check_dq,
            "window_attention_dkv": check_dkv}
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for capture in captures:
    name = capture.name
    if capture.args is None:
      raise AssertionError(f"Training never called {name}.")
    tensors = [z for z in (*capture.args, *capture.kwargs.values())
               if isinstance(z, torch.Tensor)]
    log(f"  {name} on the training step's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]}:")
    err = checks[name](*capture.args, **capture.kwargs)
    log(f"  {name} max_abs_err {err}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    by_name[name]["launches"] = launches[name]
    capture.args = capture.kwargs = None
  del captures
  compare_gradient_paths(model, config, dev)
  if profile:
    profile_training(model, batch, dev, steady_ms)


def _leaf_stats(grads, grads_ref) -> list[tuple[float, float, str]]:
  """(relative RMS of the difference, cosine, name) per parameter leaf."""
  stats = []
  for name, g in grads.items():
    g, r = g.float(), grads_ref[name].float()
    rel_rms = ((g - r).square().mean().sqrt()
               / r.square().mean().sqrt().clamp_min(1e-30)).item()
    cosine = torch.nn.functional.cosine_similarity(
        g.flatten(), r.flatten(), dim=0).item()
    stats.append((rel_rms, cosine, name))
  return sorted(stats, reverse=True)


def _log_leaf_stats(label: str, stats) -> None:
  worst_cos = min(stats, key=lambda s: s[1])
  log(f"  {label}: median rel_rms {stats[len(stats) // 2][0]:.3e}, worst "
      f"{stats[0][2]} {stats[0][0]:.3e}; lowest cosine {worst_cos[2]} "
      f"{worst_cos[1]:.6f}")


def compare_gradient_paths(model, config, dev) -> None:
  """Loss and gradients of one sequence through the kernels vs the plain
  path (autograd of the sequential scan and of the einsum attention), both
  in bf16 and held against the plain path of a float32 copy of the model."""
  model.zero_grad(set_to_none=True)
  torch.cuda.empty_cache()
  rng = np.random.default_rng(SEED + 7)
  tokens = torch.tensor(
      [[1, *rng.integers(4, config.vocab_size, GRAD_REFERENCE_TOKENS - 1)]],
      device=dev,
  )
  mask = torch.zeros_like(tokens, dtype=torch.bool)
  mask[:, GRAD_REFERENCE_TOKENS // 2:] = True

  def loss_and_grads(net):
    loss = trainer.accumulate_gradients(net, 0, tokens, mask)
    # The text loss does not reach the vision-language connector.
    grads = {n: p.grad for n, p in net.named_parameters()
             if p.grad is not None}
    net.zero_grad(set_to_none=True)
    return loss.item(), grads

  before = _launch_counts()
  loss, grads = loss_and_grads(model)
  after = _launch_counts()
  if not all(after[name] > before[name] for name in after):
    raise AssertionError(f"The kernel path missed a kernel: {before} -> "
                         f"{after}.")
  _use_plain_path(model, True)
  try:
    loss_plain, grads_plain = loss_and_grads(model)
  finally:
    _use_plain_path(model, False)
  # The float32 reference: the same weights, the plain path, no TF32.
  model32 = griffin.Griffin(config, device="meta", dtype=torch.float32)
  model32.to_empty(device=dev)
  model32.load_state_dict(model.state_dict())
  _use_plain_path(model32, True)
  loss_f32, grads_f32 = loss_and_grads(model32)
  del model32
  if _launch_counts() != after:
    raise AssertionError("A plain path launched a kernel.")

  rel_loss = abs(loss - loss_plain) / abs(loss_plain)
  log(f"  kernel path vs plain path, {GRAD_REFERENCE_TOKENS} tokens: loss "
      f"{loss:.6f} vs {loss_plain:.6f} (rel {rel_loss:.2e}, tolerance "
      f"{MODEL_LOSS_REL_ERR}); float32 plain path {loss_f32:.6f}")
  stats = _leaf_stats(grads, grads_plain)
  stats_f32 = _leaf_stats(grads, grads_f32)
  stats_plain_f32 = _leaf_stats(grads_plain, grads_f32)
  log(f"  gradients of {len(stats)} leaves; limits per leaf, kernel vs "
      f"plain: rel_rms <= {GRAD_LEAF_REL_RMS}, cosine >= "
      f"{GRAD_LEAF_MIN_COSINE}")
  _log_leaf_stats("bf16 kernel path vs bf16 plain path", stats)
  _log_leaf_stats("bf16 kernel path vs float32 plain path", stats_f32)
  _log_leaf_stats("bf16 plain path vs float32 plain path", stats_plain_f32)
  bad = [s for s in stats
         if not (s[0] <= GRAD_LEAF_REL_RMS and s[1] >= GRAD_LEAF_MIN_COSINE)]
  if not (np.isfinite(loss) and rel_loss <= MODEL_LOSS_REL_ERR) or bad:
    raise AssertionError(f"Kernel and plain gradients disagree: {bad[:5]}.")
  median, median_plain = (x[len(x) // 2][0]
                          for x in (stats_f32, stats_plain_f32))
  log(f"  median distance to float32, kernel path / plain path "
      f"{median / median_plain:.4f} (limit {GRAD_F32_MEDIAN_RATIO})")
  if not median <= GRAD_F32_MEDIAN_RATIO * median_plain:
    raise AssertionError("The kernel path is farther from float32 than the "
                         "plain path.")


def profile_training(model, batch, dev, step_ms: float) -> None:
  """Logs kernel time by name for one more training step (after one more
  unprofiled step that allocates a fresh optimizer's state), against the
  step time measured without the profiler."""
  optimizer = trainer.make_optimizer(model, TRAIN_LEARNING_RATE)
  tokens = torch.as_tensor(batch.input_tokens, device=dev).long()
  mask = torch.as_tensor(batch.target_mask, device=dev)

  def step():
    trainer.train_step(model, optimizer, 0, tokens, mask)

  step()
  times = kernel_times(step)
  busy = sum(ms for ms, _ in times.values())
  log(f"  training step under the profiler: kernels busy {busy:.1f} ms of "
      f"{step_ms:.1f} ms a step (device idle share {1 - busy / step_ms:.3f}); "
      f"top kernels:")
  for name, (ms, count) in sorted(times.items(), key=lambda kv: -kv[1][0])[:14]:
    log(f"    {ms:9.3f} ms  x{count:5d}  {name[:90]}")
  del optimizer
  model.zero_grad(set_to_none=True)
  torch.cuda.empty_cache()


def check_mha(q, k, v) -> float:
  """Max abs error of the MHA kernel against its plain version; raises
  above the tolerance."""
  out = mha_attention.flash_mha_attention(q, k, v)
  err = max_err(out, mha_attention.mha_attention_plain(q, k, v))
  if not (torch.isfinite(out).all() and err <= MHA_MAX_ABS_ERR):
    raise AssertionError(f"mha_attention disagrees with its plain version: "
                         f"{err}")
  return err


def check_add_rmsnorm(x, residual, scale, eps=1e-6) -> float:
  """Max abs error of normed against the plain version; raises unless y is
  exact and normed within its relative tolerance."""
  y, normed = fused_epilogue.fused_add_rmsnorm(x, residual, scale, eps)
  y_ref, normed_ref = fused_epilogue.reference_add_rmsnorm(x, residual,
                                                            scale, eps)
  if not torch.equal(y, y_ref):
    raise AssertionError(f"add_rmsnorm's y differs: {max_err(y, y_ref)}")
  diff = (normed.float() - normed_ref.float()).abs()
  rel = (diff / normed_ref.float().abs().clamp_min(1e-6)).max().item()
  if not rel <= RMSNORM_NORMED_REL_ERR:
    raise AssertionError(f"add_rmsnorm's normed differs: relative {rel}")
  return diff.max().item()


def phase_mha(dev) -> dict:
  log(f"== mha_attention vs plain, bf16 (tolerance {MHA_MAX_ABS_ERR}); "
      f"library: one unmasked SDPA call on the same [b, n, t, h] tensors; "
      f"ms: device time a call with the launch queue full (CUDA events)")
  rows = []
  worst = 0.0
  for i, (b, t, n, h) in enumerate(MHA_SHAPES):
    rng = np.random.default_rng(SEED + 20 + i)
    q, k, v = (torch.tensor(rng.standard_normal((b, t, n, h),
                                                dtype=np.float32),
                            device=dev).bfloat16() for _ in range(3))
    err = check_mha(q, k, v)
    worst = max(worst, err)
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    kernel = lambda: mha_attention.mha_attention_forward(q, k, v)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt)
    ms, call_ms = device_ms(kernel, 20), cuda_ms(kernel, 20)
    plain_ms = device_ms(
        lambda: mha_attention.mha_attention_plain(q, k, v), 3)
    library_ms, library_call_ms = device_ms(library, 20), cuda_ms(library, 20)
    # QK^T and PV: 2 h flops each per (query, key) pair and head; q, k, v
    # read and out written once in bf16.
    flops = 4 * b * n * t * t * h
    n_bytes = 4 * b * t * n * h * 2
    bound_ms, bound_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
    figures = speed(ms, flops, bound_ms, library_ms)
    log(f"  [{b},{t},{n},{h}]: max_abs_err {err:.3e}  ms {ms:.4f}  plain_ms "
        f"{plain_ms:.3f}  library_ms (SDPA) {library_ms:.4f}  bound_ms "
        f"{bound_ms:.5f} ({bound_by}, {flops / 1e9:.2f} GFLOP): "
        f"{figures['tflops']:.1f} TFLOP/s, "
        f"{100 * figures['bound_share']:.1f}% of the bound, "
        f"{figures['sdpa_ratio']:.3f} x SDPA; a call with the host's launch "
        f"(CUDA events): kernel {call_ms:.4f}, SDPA {library_call_ms:.4f}")
    rows.append(dict(shape=[b, t, n, h], ms=ms, call_ms=call_ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms, **figures))
  # The first shape (DINOv2-L's) is the row of the kernels line.
  first = rows[0]
  return dict(name="mha_attention", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/mha_attention.cu",
              replaces=MHA_REPLACES, max_abs_err=worst,
              **{key: first[key] for key in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "tflops", "bound_share", "sdpa_ratio")},
              shapes=rows[1:], **resources("mha_attention", first["shape"][3]))


def phase_add_rmsnorm(dev) -> dict:
  log(f"== add_rmsnorm vs plain, bf16 (y exact, normed within "
      f"{RMSNORM_NORMED_REL_ERR} relative); library: none (no one PyTorch "
      f"call adds the residual and applies the (scale + 1) gain); ms: device "
      f"time a call with the launch queue full (CUDA events), on copies of "
      f"the inputs that exceed the L2")
  row = None
  worst = 0.0
  for i, shape in enumerate(RMSNORM_SHAPES):
    gen = torch.Generator(dev).manual_seed(SEED + 30 + i)
    x, r = (torch.randn(shape, device=dev, generator=gen).bfloat16()
            for _ in range(2))
    scale = (0.1 * torch.randn(shape[-1], device=dev,
                               generator=gen)).bfloat16()
    err = check_add_rmsnorm(x, r, scale)
    worst = max(worst, err)
    kernel = lambda: fused_epilogue.add_rmsnorm_forward(x, r, scale)
    plain = lambda: fused_epilogue.reference_add_rmsnorm(x, r, scale)
    # Byte-bound: timed on copies of x and r that exceed the L2 together.
    ms = device_ms(lambda x, r: fused_epilogue.add_rmsnorm_forward(x, r, scale),
                   48, inputs=cold_copies(x, r))
    call_ms = cuda_ms(kernel, 50)
    plain_ms, plain_call_ms = device_ms(plain, 20), cuda_ms(plain, 50)
    rows = x.numel() // shape[-1]
    # x and residual read, y and normed written (bf16), scale read; about 6
    # float32 operations an element.
    n_bytes = 4 * x.numel() * 2 + shape[-1] * 2
    bound_ms, bound_by = bound(n_bytes, 6 * x.numel(), FP32_FLOPS)
    log(f"  {list(shape)} ({rows} rows): max_abs_err {err:.3e}  ms "
        f"{ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bound_ms:.5f} "
        f"({bound_by}, {n_bytes / 1e6:.2f} MB); a call with the host's "
        f"launch (CUDA events): kernel {call_ms:.4f}, plain "
        f"{plain_call_ms:.4f}")
    if row is None:
      row = dict(name="add_rmsnorm", route="cuda",
                 source="cadence_gemma_tpu_torch/csrc/add_rmsnorm.cu",
                 replaces=RMSNORM_REPLACES, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
  row["max_abs_err"] = worst
  return row


def _mm_counts() -> dict[str, int]:
  return {"mha_attention": mha_attention.launches,
          "lru_scan": lru_scan.launches,
          "window_attention": wa.launches,
          "add_rmsnorm": fused_epilogue.launches}


def _use_plain_multimodal(model, encoder, plain: bool) -> None:
  """Routes the towers through the einsum (padded to 128 tokens) and the
  Griffin through the unfused epilogue, sequential scan and einsum
  attention; or back to the kernels."""
  _use_plain_path(model, plain)
  for block in model.blocks:
    block.fused_epilogue = not plain
  for tower in (encoder.dino, encoder.siglip):
    tower.use_flash_attention = False if plain else None
    for block in tower.blocks:
      block.use_flash_attention = tower.use_flash_attention


def _rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
  diff = got.float() - want.float()
  return (diff.square().mean().sqrt()
          / want.float().square().mean().sqrt()).item()


def phase_multimodal(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16, fused_epilogue=True,
      generator=torch.Generator(dev).manual_seed(SEED + 8),
  )
  encoder = vit.DinoSigLIPEncoder(
      device=dev, generator=torch.Generator(dev).manual_seed(SEED + 9)
  )
  torch.cuda.synchronize()
  n_vision = sum(p.numel() for p in encoder.parameters())
  log(f"== multimodal path: DINOv2-L || SigLIP-so400m (blocks 0-22 of "
      f"each, {n_vision / 1e6:.1f} M float32 parameters, bf16 compute) -> "
      f"connector -> RecurrentGemma-2B with the fused epilogue (built in "
      f"{time.perf_counter() - start:.1f} s)")
  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(SEED + 10)
  prompts = [
      " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4,
                                             MM_PROMPT_TOKENS - 1))
      for _ in range(2)
  ]
  pixels = torch.rand(MM_PIXELS, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED + 11))
  sampler = modal_sampler.ModalSampler(model, vocab, encoder, device=dev)
  n_blocks = len(encoder.dino.blocks) + len(encoder.siglip.blocks)
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  size = encoder.dino_config.image_size

  # The resize on the card against the CPU's.
  resized = vit.preprocess(pixels, vit.DINO_MEAN, vit.DINO_STD, size)
  resize_err = max_err(resized.cpu(), vit.preprocess(
      pixels.cpu(), vit.DINO_MEAN, vit.DINO_STD, size))
  log(f"  resize {list(MM_PIXELS)} -> {size} on the card vs the CPU: "
      f"max_abs_err {resize_err:.3e} (tolerance {RESIZE_MAX_ABS_ERR})")
  if not resize_err <= RESIZE_MAX_ABS_ERR:
    raise AssertionError("The resize on the card disagrees with the CPU's.")

  # Events around the encode and around each model forward, with the
  # counters at the end of each.
  marks = {}
  calls = []

  def event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e

  def encode_start(*_):
    marks["encode_start"] = event()

  def encode_end(*_):
    marks["encode_end"] = event()
    marks["encode_counts"] = _mm_counts()

  def forward_start(*_):
    calls.append([event()])

  def forward_end(*_):
    calls[-1] += [event(), _mm_counts()]

  hooks = [encoder.register_forward_pre_hook(encode_start),
           encoder.register_forward_hook(encode_end),
           model.register_forward_pre_hook(forward_start),
           model.register_forward_hook(forward_end)]
  probe = DecodeProbe(_mm_counts)
  run_kw = dict(total_generation_steps=MM_DECODE_STEPS, pixels=pixels,
                return_logits=True, end_sampling_at_eos_token=False)
  try:
    # Warm-up with the measured run's shapes (its decode graph is captured
    # here); it also keeps the inputs that this run (the same as the
    # measured one) gives each kernel's first call.
    captures = [CaptureFirstCall(mha_attention, "flash_mha_attention"),
                CaptureFirstCall(fused_epilogue, "fused_add_rmsnorm"),
                CaptureFirstCall(lru_scan, "lru_scan"),
                CaptureFirstCall(wa, "window_attention")]
    try:
      sampler(prompts, **run_kw)
    finally:
      for capture in captures:
        capture.restore()
    torch.cuda.synchronize()
    calls.clear()
    probe.reset()
    torch.cuda.reset_peak_memory_stats()
    mha_attention.launches = fused_epilogue.launches = 0
    lru_scan.launches = wa.launches = 0
    reset_scan_routes()
    start = time.perf_counter()
    out = sampler(prompts, **run_kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = probe.run_launches(_mm_counts())
    replays, step_launches = probe.replays, probe.step_launches
    decode_ms = probe.decode_ms()
  finally:
    probe.close()
    for hook in hooks:
      hook.remove()
  check_scan_routes(lru_scan.launches)
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  log(f"  launches in the run {launches}; after the encode "
      f"{marks['encode_counts']}; after the prefill {calls[0][2]}; a "
      f"captured decode step {step_launches}, replayed {replays} times")
  want_encode = {"mha_attention": n_blocks, "lru_scan": 0,
                 "window_attention": 0, "add_rmsnorm": 0}
  want_prefill = {"mha_attention": n_blocks, "lru_scan": n_recurrent,
                  "window_attention": config.num_layers - n_recurrent,
                  "add_rmsnorm": config.num_layers}
  want_run = dict(want_prefill,
                  add_rmsnorm=config.num_layers * MM_DECODE_STEPS)
  if (len(calls) + replays != MM_DECODE_STEPS
      or marks["encode_counts"] != want_encode
      or calls[0][2] != want_prefill or launches != want_run):
    raise AssertionError(
        f"Launches: {len(calls)} forwards and {replays} replays, encode "
        f"{marks['encode_counts']} (want {want_encode}), prefill "
        f"{calls[0][2]} (want {want_prefill}), run {launches} (want "
        f"{want_run}).")
  # Each of the 31 decode forwards (replays of the captured step) launched
  # add_rmsnorm once per block, and no other kernel.
  want_step = dict.fromkeys(want_prefill, 0)
  want_step["add_rmsnorm"] = config.num_layers
  if step_launches != want_step or replays != MM_DECODE_STEPS - 1:
    raise AssertionError(f"A captured decode step launched {step_launches} "
                         f"(want {want_step}), replayed {replays} times.")
  tokens = torch.stack(out.tokens)
  logits = torch.stack(out.logits)
  if tokens.shape != (2, MM_DECODE_STEPS) or logits.shape != (
      2, MM_DECODE_STEPS, config.vocab_size):
    raise AssertionError(f"Shapes {tokens.shape}, {logits.shape}.")
  if not torch.isfinite(logits).all():
    raise AssertionError("Non-finite logits.")

  encode_ms = marks["encode_start"].elapsed_time(marks["encode_end"])
  ttft_ms = marks["encode_start"].elapsed_time(calls[0][1])
  prefill_ms = calls[0][0].elapsed_time(calls[0][1])
  spliced = MM_PROMPT_TOKENS + config.vision_tokens
  log(f"  pixels {list(MM_PIXELS)}, prompts 2 x {MM_PROMPT_TOKENS} tokens, "
      f"spliced prefill 2 x {spliced} tokens, {MM_DECODE_STEPS} greedy steps")
  log(f"  encode_ms {encode_ms:.2f}  prefill_ms (model) {prefill_ms:.2f}  "
      f"ttft_ms (pixels -> prefill logits) {ttft_ms:.2f}  decode_ms_per_step "
      f"{decode_ms:.3f}  wall {wall_s:.3f} s ({2 * MM_DECODE_STEPS / wall_s:.1f}"
      f" generated tokens/s)  peak {peak_gb:.2f} GB")
  log(f"  first tokens {tokens[:, :8].tolist()}")

  # Each kernel against its plain version on the inputs of its first call.
  checks = {"flash_mha_attention": ("mha_attention", check_mha),
            "fused_add_rmsnorm": ("add_rmsnorm", check_add_rmsnorm),
            "lru_scan": ("lru_scan", check_lru),
            "window_attention": ("window_attention",
                                 lambda *a: max(check_attention(*a)))}
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for capture in captures:
    name, check = checks[capture.name]
    if capture.args is None:
      raise AssertionError(f"The multimodal path never called {name}.")
    tensors = [z for z in capture.args if isinstance(z, torch.Tensor)]
    log(f"  {name} on the path's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]}:")
    err = check(*capture.args, **capture.kwargs)
    log(f"  {name} max_abs_err {err:.3e}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    if name in ("mha_attention", "add_rmsnorm"):
      by_name[name]["launches"] = launches[name]
    capture.args = capture.kwargs = None

  compare_multimodal_paths(model, encoder, config, pixels, dev)
  compare_epilogue_decode(sampler, prompts, pixels)
  modal_conversation(sampler, prompts, pixels, by_name)
  if profile:
    profile_multimodal(sampler, prompts, pixels, encode_ms, ttft_ms)


def compare_multimodal_paths(model, encoder, config, pixels, dev) -> None:
  """Fused features and the spliced prefill's last logits through the
  kernels vs the plain path of the same weights."""
  ids = torch.tensor(
      [[1, *np.random.default_rng(SEED + 12).integers(
          4, config.vocab_size, MM_PROMPT_TOKENS - 1)]] * 2, device=dev)
  pos = torch.arange(MM_PROMPT_TOKENS, device=dev)[None].expand(2, -1)

  @torch.inference_mode()
  def run(plain):
    _use_plain_multimodal(model, encoder, plain)
    try:
      features = encoder(pixels).to(torch.bfloat16)
      logits, _ = model(ids, pos, image=features, return_cache=False,
                        last_logits_only=True)
    finally:
      _use_plain_multimodal(model, encoder, False)
    return features, logits

  before = _mm_counts()
  f_k, l_k = run(False)
  after = _mm_counts()
  f_p, l_p = run(True)
  if not all(after[k] > before[k] for k in before):
    raise AssertionError(f"The kernel path missed a kernel: {before} -> "
                         f"{after}.")
  if _mm_counts() != after:
    raise AssertionError("The plain path launched a kernel.")
  f_rel, l_rel = _rel_rms(f_k, f_p), _rel_rms(l_k, l_p)
  log(f"  kernel path vs plain path from pixels: features rel_rms "
      f"{f_rel:.3e} (tolerance {MM_FEATURES_REL_RMS}); last logits of the "
      f"{MM_PROMPT_TOKENS + config.vision_tokens}-token prefill rel_rms "
      f"{l_rel:.3e} (tolerance {MM_LOGITS_REL_RMS}), same argmax "
      f"{(l_k.argmax(-1) == l_p.argmax(-1)).tolist()}")
  if not (torch.isfinite(f_k).all() and torch.isfinite(l_k).all()
          and f_rel <= MM_FEATURES_REL_RMS and l_rel <= MM_LOGITS_REL_RMS):
    raise AssertionError("Kernel path and plain path disagree.")


# Turns of the fused / unfused decode comparison: each side takes positions
# whose sums and sums of squares match (0+3+5+6 = 1+2+4+7, 70 = 70), so a
# host that slows down linearly or quadratically over the run favours
# neither side.
EPILOGUE_TURNS = (True, False, False, True, False, True, True, False)


def compare_epilogue_decode(sampler, prompts, pixels) -> None:
  """Decode ms a step with the fused epilogue and with the unfused one, in
  turns from the same image features: what the kernel does to a step. A
  captured step keeps the model's code path as captured, so each side has a
  sampler (and a graph) of its own, warmed up before the turns."""
  features = sampler.encode(pixels)
  model = sampler.model
  samplers = {True: sampler,
              False: modal_sampler.ModalSampler(model, sampler.vocab,
                                                device=sampler.device)}
  per_step = {True: [], False: []}
  probe = DecodeProbe(_mm_counts)

  def run(fused):
    for block in model.blocks:
      block.fused_epilogue = fused
    samplers[fused](prompts, total_generation_steps=MM_DECODE_STEPS,
                    img_embed=features, end_sampling_at_eos_token=False)
    torch.cuda.synchronize()

  try:
    for fused in (True, False):
      run(fused)
    for fused in EPILOGUE_TURNS:
      run(fused)
      per_step[fused].append(probe.decode_ms())
  finally:
    probe.close()
    for block in model.blocks:
      block.fused_epilogue = True
  log(f"  decode ms a step (captured), in turns {EPILOGUE_TURNS}: fused "
      f"epilogue {[round(ms, 3) for ms in per_step[True]]} (median "
      f"{np.median(per_step[True]):.3f}), unfused "
      f"{[round(ms, 3) for ms in per_step[False]]} (median "
      f"{np.median(per_step[False]):.3f})")


def modal_conversation(sampler, prompts, pixels, by_name) -> None:
  """A pixel first turn with ``return_state``, then a text follow-up from
  its state: the image is encoded and prefilled once, and the follow-up's
  decode steps replay add_rmsnorm inside the captured step. Its first
  logits are held against one teacher-forced call of the whole history
  with the image."""
  model = sampler.model
  config = model.config
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  rng = np.random.default_rng(SEED + 13)
  follow_up = [" ".join(f"w{i}" for i in rng.integers(
      0, config.vocab_size - 4, MODAL_FOLLOWUP_TOKENS)) for _ in prompts]
  kw = dict(total_generation_steps=MODAL_TURN_STEPS,
            end_sampling_at_eos_token=False)
  probe = DecodeProbe(_mm_counts)
  try:
    first = sampler(prompts, pixels=pixels, return_state=True, **kw)
    torch.cuda.synchronize()
    mha_attention.launches = fused_epilogue.launches = 0
    lru_scan.launches = wa.launches = 0
    reset_scan_routes()
    probe.reset()
    got = sampler(follow_up, prefix_state=first.state, return_logits=True,
                  **kw)
    torch.cuda.synchronize()
    launches = probe.run_launches(_mm_counts())
    replays, step_launches = probe.replays, probe.step_launches
  finally:
    probe.close()
  check_scan_routes(lru_scan.launches)
  want = {"mha_attention": 0, "lru_scan": n_recurrent, "window_attention": 0,
          "add_rmsnorm": config.num_layers * MODAL_TURN_STEPS}
  log(f"  image turn ({MODAL_TURN_STEPS} steps, return_state) then a text "
      f"follow-up of 2 x {MODAL_FOLLOWUP_TOKENS} tokens: launches {launches} "
      f"(a captured step {step_launches}, replayed {replays} times)")
  if (launches != want or replays != MODAL_TURN_STEPS - 1
      or step_launches["add_rmsnorm"] != config.num_layers):
    raise AssertionError(f"The follow-up launched {launches}, want {want}.")
  for name in ("lru_scan", "add_rmsnorm"):
    by_name[name]["launches"] += launches[name]

  # The whole history in one call: BOS + prompt, the first turn's tokens
  # and the follow-up, with the image spliced after BOS.
  ids = torch.tensor(
      [sampler.tokenize(p) + t.tolist() + sampler.vocab.EncodeAsIds(f)
       for p, t, f in zip(prompts, first.tokens, follow_up)],
      device=sampler.device)
  pos = torch.arange(ids.shape[1], device=ids.device)[None].expand(2, -1)
  with torch.inference_mode():
    whole, _ = model(ids, pos, image=sampler.encode(pixels),
                     return_cache=False, last_logits_only=True)
  rel = _rel_rms(torch.stack([l[0] for l in got.logits]), whole[:, 0])
  log(f"  follow-up vs the {ids.shape[1]}-token history and the image in "
      f"one call: first logits rel_rms {rel:.3e} (tolerance "
      f"{MM_LOGITS_REL_RMS})")
  if not rel <= MM_LOGITS_REL_RMS:
    raise AssertionError("The follow-up disagrees with its history.")


def profile_multimodal(sampler, prompts, pixels, encode_ms, ttft_ms) -> None:
  """Logs kernel time by name for the encode and for the image-conditioned
  prefill (encode included), against their times without the profiler."""
  for label, fn, wall_ms in (
      ("encode", lambda: sampler.encode(pixels), encode_ms),
      ("multimodal prefill (encode, splice, 2B prefill)",
       lambda: sampler(prompts, total_generation_steps=1, pixels=pixels),
       ttft_ms),
  ):
    times = kernel_times(fn)
    busy = sum(ms for ms, _ in times.values())
    log(f"  {label}: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms (device "
        f"idle share {1 - busy / wall_ms:.3f}); top kernels:")
    for name, (ms, count) in sorted(
        times.items(), key=lambda kv: -kv[1][0])[:12]:
      log(f"    {ms:9.4f} ms  x{count:5d}  {name[:90]}")


def check_lru_a_prod(x, a, h0=None, reverse=False, return_a_prod=True,
                     backprop=False) -> float:
  """Max abs error of the scan kernel with the running product of ``a``
  against its plain loop (all four outputs); raises above the tolerance.
  Takes the wrapper's own arguments, so a captured call replays as it is."""
  del return_a_prod  # always on here
  if backprop:
    kernel, plain = lru_scan.lru_scan_backward, lru_scan.lru_scan_backward_plain
  else:
    kernel, plain = lru_scan.lru_scan_forward, lru_scan.lru_scan_plain
  (y, h), (p, p_last) = kernel(x, a, h0, reverse, return_a_prod=True)
  (y_r, h_r), (p_r, pl_r) = plain(x, a, h0, reverse, return_a_prod=True)
  err = max(max_err(y, y_r), max_err(h, h_r), max_err(p, p_r),
            max_err(p_last, pl_r))
  if not err <= LRU_A_PROD_MAX_ABS_ERR:
    raise AssertionError(f"lru_scan with a_prod disagrees with its plain "
                         f"version: {err}")
  return err


def phase_lru_a_prod(dev) -> dict:
  b, t, d = LRU_SP_SHAPE
  rng = np.random.default_rng(SEED + 40)
  x = torch.tensor(rng.standard_normal(LRU_SP_SHAPE, dtype=np.float32),
                   device=dev).bfloat16()
  a = torch.sigmoid(torch.tensor(
      rng.standard_normal(LRU_SP_SHAPE, dtype=np.float32), device=dev
  )).bfloat16()
  log(f"== lru_scan with the running product of a vs plain at [{b},{t},{d}] "
      f"bf16, the SP prefill's shard (tolerance {LRU_A_PROD_MAX_ABS_ERR} on "
      f"y, h_last, a_prod, a_prod_last)")
  worst = 0.0
  for backprop in (False, True):
    for reverse in (False, True):
      err = check_lru_a_prod(x, a, None, reverse, backprop=backprop)
      log(f"  {'backward' if backprop else 'forward'} walk, reverse={reverse}:"
          f" max_abs_err {err}")
      worst = max(worst, err)
  # Timed as the SP prefill calls it: forward, no carry. Read x and a, write
  # y and a_prod (bf16), h_last and a_prod_last (fp32); three fp32 flops a
  # step (the scan's multiply-add, the product's multiply).
  n_bytes = 4 * b * t * d * 2 + 2 * b * d * 4
  figures = time_scan(
      lambda x, a: lru_scan.lru_scan_forward(x, a, None, False, True), (x, a),
      n_bytes, 3 * b * t * d)
  plain_ms = cuda_ms(lambda: lru_scan.lru_scan_plain(x, a, None, False, True),
                     2)
  log_scan(figures, plain_ms, n_bytes)
  without = device_ms(lru_scan.lru_scan_forward, SCAN_REPS,
                      inputs=cold_copies(x, a))
  log(f"  the scan without the product on the same inputs {without:.4f} ms")
  return dict(name="lru_scan_a_prod", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/lru_scan.cu",
              replaces=LRU_A_PROD_REPLACES, max_abs_err=worst,
              plain_ms=plain_ms, library_ms=None, **figures)


def _halo_case(rng, dev, shard0: bool):
  """q, [halo || local] k and v, segment_pos of one SP shard: shard 0 (a
  zero halo, row 1 left-padded by SP_PAD) or shard 1 (positions continue
  from 4096, a halo of the previous shard's keys)."""
  b, t, n, h = ATTN_SP_SHAPE
  q, k, v = (torch.tensor(rng.standard_normal(s, dtype=np.float32),
                          device=dev).bfloat16()
             for s in ((b, t, n, h), (b, ATTN_WINDOW + t, 1, h),
                       (b, ATTN_WINDOW + t, 1, h)))
  if shard0:
    k[:, :ATTN_WINDOW] = 0
    v[:, :ATTN_WINDOW] = 0
    seg = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    seg[1] = np.maximum(np.arange(t, dtype=np.int32) - SP_PAD, -1)
  else:
    seg = np.tile(np.arange(t, 2 * t, dtype=np.int32), (b, 1))
  return q, k, v, torch.tensor(seg, device=dev)


def phase_attention_kv_prefix(dev) -> dict:
  b, t, n, h = ATTN_SP_SHAPE
  rng = np.random.default_rng(SEED + 41)
  log(f"== window_attention with a {ATTN_WINDOW}-key halo (kv_prefix) vs "
      f"plain: q [{b},{t},{n},{h}], k and v [{b},{ATTN_WINDOW + t},1,{h}] "
      f"bf16, window {ATTN_WINDOW} (tolerance out {ATTN_OUT_MAX_ABS_ERR}, "
      f"lse {ATTN_LSE_MAX_ABS_ERR})")
  errs = []
  for shard0, label in ((False, f"shard 1: continuous positions from {t}"),
                        (True, f"shard 0: zero halo, row 1 left-padded by "
                               f"{SP_PAD}")):
    log(f"  {label}:")
    case = _halo_case(rng, dev, shard0)
    errs += check_attention(*case, ATTN_WINDOW, ATTN_WINDOW)
    if not shard0:
      timed = case
  figures = window_forward_figures(*timed, ATTN_WINDOW)
  log_figures(f"shard 1, the [{t}, {ATTN_WINDOW + t}] band", figures)
  return dict(name="window_attention_kv_prefix", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/window_attention.cu",
              replaces=ATTN_PREFIX_REPLACES, max_abs_err=max(errs),
              **{key: figures[key] for key in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "tflops", "bound_share", "sdpa_ratio")})


def _sp_counts() -> dict[str, int]:
  return {"lru_scan_a_prod": lru_scan.a_prod_launches,
          "window_attention_kv_prefix": wa.kv_prefix_launches,
          "lru_scan": lru_scan.launches,
          "window_attention": wa.launches}


def _reset_sp_counts() -> None:
  lru_scan.a_prod_launches = wa.kv_prefix_launches = 0
  lru_scan.launches = wa.launches = 0
  reset_scan_routes()


def sp_mesh_spec() -> sharding.ShardingSpec:
  """The (1, 4) data x sequence mesh: four shards on one card, or one on
  each of four."""
  count = torch.cuda.device_count()
  mesh = sharding.make_mesh(
      (1, SP_SHARDS), ("data", "sequence"),
      [f"cuda:{i % count}" for i in range(SP_SHARDS)],
  )
  return sharding.ShardingSpec(mesh=mesh, batch_axis_name="data",
                               sequence_axis_name="sequence")


def phase_sequence_parallel(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  spec = sp_mesh_spec()
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16, scan_sharding_spec=spec,
      generator=torch.Generator(dev).manual_seed(SEED + 42),
  )
  ref_model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16,
      generator=torch.Generator(dev).manual_seed(SEED + 42),
  )
  torch.cuda.synchronize()
  for (name, p), p_ref in zip(model.named_parameters(),
                              ref_model.parameters()):
    if not torch.equal(p, p_ref):
      raise AssertionError(f"The two models' {name} differ.")
  log(f"== sequence-parallel serving: RecurrentGemma-2B with "
      f"scan_sharding_spec on {spec.mesh}, and the same weights unsharded "
      f"(both built in {time.perf_counter() - start:.1f} s)")
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  n_attention = config.num_layers - n_recurrent

  # Placing a shard on the operands' card makes a view, not a copy.
  probe = torch.empty(2, max(SP_PROMPT_TOKENS), config.width,
                      dtype=torch.bfloat16, device=dev)
  views = sum(z.untyped_storage().data_ptr() == probe.untyped_storage().data_ptr()
              for row in sharding.shard_activations(probe, spec) for z in row)
  log(f"  shards of a [2, {max(SP_PROMPT_TOKENS)}, {config.width}] "
      f"activation that are views of it: {views} of {SP_SHARDS}")
  if torch.cuda.device_count() == 1 and views != SP_SHARDS:
    raise AssertionError("Sharding on one card copied an activation.")
  del probe

  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(SEED + 43)
  prompts = [
      " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4, n - 1))
      for n in SP_PROMPT_TOKENS
  ]
  samplers = {True: sampler_lib.Sampler(model, vocab, device=dev),
              False: sampler_lib.Sampler(ref_model, vocab, device=dev)}
  calls = []  # per forward: [start event, end event, counts at its end]

  def before_forward(*_):
    calls.append([torch.cuda.Event(enable_timing=True)])
    calls[-1][0].record()

  def after_forward(*_):
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    calls[-1] += [end, _sp_counts()]

  hooks = [m.register_forward_pre_hook(before_forward) for m in
           (model, ref_model)]
  hooks += [m.register_forward_hook(after_forward) for m in
            (model, ref_model)]

  probe = DecodeProbe(_sp_counts)
  run_kw = dict(total_generation_steps=SP_DECODE_STEPS, return_logits=True,
                end_sampling_at_eos_token=False)
  try:
    # Warm-up of both with the measured runs' shapes (their decode graphs
    # are captured here); the SP one keeps the inputs of each kernel's
    # first call.
    captures = [CaptureFirstCall(lru_scan, "lru_scan_forward"),
                CaptureFirstCall(wa, "window_attention")]
    try:
      samplers[True](prompts, **run_kw)
    finally:
      for capture in captures:
        capture.restore()
    samplers[False](prompts, **run_kw)
    torch.cuda.synchronize()

    calls.clear()
    probe.reset()
    torch.cuda.reset_peak_memory_stats()
    _reset_sp_counts()
    start = time.perf_counter()
    out = samplers[True](prompts, **run_kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = probe.run_launches(_sp_counts())
    replays, step_launches = probe.replays, probe.step_launches
    decode_ms = probe.decode_ms()
  finally:
    probe.close()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  sp_calls = list(calls)

  want_prefill = {"lru_scan_a_prod": n_recurrent * SP_SHARDS,
                  "window_attention_kv_prefix": n_attention * SP_SHARDS,
                  "lru_scan": 0, "window_attention": 0}
  log(f"  launches in the run {launches}; after the prefill {sp_calls[0][2]}"
      f"; a captured decode step {step_launches}, replayed {replays} times")
  check_scan_routes(launches["lru_scan_a_prod"] + launches["lru_scan"])
  if (len(sp_calls) + replays != SP_DECODE_STEPS
      or replays != SP_DECODE_STEPS - 1 or sp_calls[0][2] != want_prefill
      or launches != want_prefill or any(step_launches.values())):
    raise AssertionError(
        f"Launches: {len(sp_calls)} forwards and {replays} replays, prefill "
        f"{sp_calls[0][2]}, run {launches}, a captured step "
        f"{step_launches}; want {want_prefill} in the prefill and none in "
        f"decode.")
  tokens = torch.stack(out.tokens)
  logits = torch.stack(out.logits)
  if tokens.shape != (2, SP_DECODE_STEPS) or logits.shape != (
      2, SP_DECODE_STEPS, config.vocab_size):
    raise AssertionError(f"Shapes {tokens.shape}, {logits.shape}.")
  if not torch.isfinite(logits).all():
    raise AssertionError("Non-finite logits.")
  prefill_ms = sp_calls[0][0].elapsed_time(sp_calls[0][1])
  prompt_rate = sum(SP_PROMPT_TOKENS) / prefill_ms * 1e3
  log(f"  prompts {SP_PROMPT_TOKENS} tokens (padded to "
      f"{max(SP_PROMPT_TOKENS)}, {SP_LOCAL_TOKENS} a shard), "
      f"{SP_DECODE_STEPS} greedy steps, decode captured")
  log(f"  SP prefill_ms {prefill_ms:.2f} ({prompt_rate:.0f} prompt tokens/s) "
      f" decode_ms_per_step {decode_ms:.3f}  wall {wall_s:.3f} s  peak "
      f"{peak_gb:.2f} GB (both models' weights included)")

  # Each kernel against its plain version on the inputs of its first call.
  checks = {"lru_scan_forward": ("lru_scan_a_prod", check_lru_a_prod),
            "window_attention": ("window_attention_kv_prefix",
                                 lambda *a, **k: max(check_attention(*a, **k)))}
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for capture in captures:
    name, check = checks[capture.name]
    if capture.args is None:
      raise AssertionError(f"The SP prefill never called {name}.")
    tensors = [z for z in capture.args if isinstance(z, torch.Tensor)]
    log(f"  {name} on the path's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]} "
        f"{capture.kwargs}:")
    err = check(*capture.args, **capture.kwargs)
    log(f"  {name} max_abs_err {err:.3e}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    by_name[name]["launches"] = launches[name]
    capture.args = capture.kwargs = None

  # The same weights unsharded: the first step's logits (the prefill's last
  # position) and the generation's tokens.
  calls.clear()
  ref = samplers[False](prompts, total_generation_steps=SP_DECODE_STEPS,
                        return_logits=True, end_sampling_at_eos_token=False)
  torch.cuda.synchronize()
  ref_counts = calls[0][2]
  if ref_counts["lru_scan"] != n_recurrent or ref_counts[
      "window_attention"] != n_attention:
    raise AssertionError(f"The unsharded prefill launched {ref_counts}.")
  ref_tokens = torch.stack(ref.tokens)
  ref_logits = torch.stack(ref.logits)
  rel = _rel_rms(logits[:, 0], ref_logits[:, 0])
  agree = (tokens == ref_tokens).float().mean().item()
  first_diff = [int((row_a != row_b).nonzero()[0]) if (row_a != row_b).any()
                else None for row_a, row_b in zip(tokens, ref_tokens)]
  log(f"  SP vs unsharded, last prompt position: logits rel_rms {rel:.3e} "
      f"(tolerance {SP_LOGITS_REL_RMS}), max_abs "
      f"{max_err(logits[:, 0], ref_logits[:, 0]):.3e}, same argmax "
      f"{(logits[:, 0].argmax(-1) == ref_logits[:, 0].argmax(-1)).tolist()}")
  log(f"  token agreement of the two {SP_DECODE_STEPS}-token generations "
      f"{agree:.4f} (first difference per row {first_diff})")
  if not (torch.isfinite(ref_logits).all() and rel <= SP_LOGITS_REL_RMS):
    raise AssertionError("SP and unsharded logits disagree.")

  # SP and unsharded prefill in balanced turns.
  per_side = {True: [], False: []}
  for sp in SP_TURNS:
    calls.clear()
    samplers[sp](prompts, total_generation_steps=1)
    torch.cuda.synchronize()
    per_side[sp].append(calls[0][0].elapsed_time(calls[0][1]))
  for hook in hooks:
    hook.remove()
  log(f"  prefill ms in turns {SP_TURNS}: SP "
      f"{[round(ms, 2) for ms in per_side[True]]} (median "
      f"{np.median(per_side[True]):.2f}), unsharded "
      f"{[round(ms, 2) for ms in per_side[False]]} (median "
      f"{np.median(per_side[False]):.2f}); ratio of medians "
      f"{np.median(per_side[True]) / np.median(per_side[False]):.4f}")
  if profile:
    profile_sequence_parallel(samplers, prompts,
                              float(np.median(per_side[True])))


def profile_sequence_parallel(samplers, prompts, prefill_ms) -> None:
  """Logs kernel time by name for one SP prefill and its idle share, and the
  copies (memcpy, memset) of an SP and an unsharded prefill."""
  for sp in (True, False):
    times = kernel_times(lambda: samplers[sp](prompts,
                                              total_generation_steps=1))
    copies = {name: count for name, (_, count) in times.items()
              if "Memcpy" in name or "Memset" in name}
    if not sp:
      log(f"  unsharded prefill: memcpy/memset {copies}")
      continue
    busy = sum(ms for ms, _ in times.values())
    log(f"  SP prefill: kernels busy {busy:.3f} ms of {prefill_ms:.3f} ms "
        f"(device idle share {1 - busy / prefill_ms:.3f}); memcpy/memset "
        f"{copies}; top kernels:")
    for name, (ms, count) in sorted(times.items(),
                                    key=lambda kv: -kv[1][0])[:14]:
      log(f"    {ms:9.4f} ms  x{count:5d}  {name[:90]}")


def phase_lru_backward_a_prod(dev) -> dict:
  b, t, d = LRU_SP_TRAIN_SHAPE
  rng = np.random.default_rng(SEED + 50)
  g = torch.tensor(rng.standard_normal(LRU_SP_TRAIN_SHAPE, dtype=np.float32),
                   device=dev).bfloat16()
  a = torch.sigmoid(torch.tensor(
      rng.standard_normal(LRU_SP_TRAIN_SHAPE, dtype=np.float32), device=dev
  )).bfloat16()
  dh_last = torch.tensor(rng.standard_normal((b, d), dtype=np.float32),
                         device=dev)
  log(f"== lru_scan_backward with the running product of a vs plain at "
      f"[{b},{t},{d}] bf16, the SP training step's shard (tolerance "
      f"{LRU_A_PROD_MAX_ABS_ERR} on dx, dh0, a_prod, a_prod_last)")
  worst = 0.0
  for reverse in (False, True):
    for carry in (None, dh_last):
      err = check_lru_a_prod(g, a, carry, reverse, backprop=True)
      log(f"  reverse={reverse} dh_last={carry is not None}: max_abs_err "
          f"{err}")
      worst = max(worst, err)
  # Timed as SP training calls it: the forward scan's cotangents, no carry
  # (the loss does not reach h_last). Read g and a, write dx and a_prod
  # (bf16), dh0 and a_prod_last (fp32); three fp32 flops a step.
  n_bytes = 4 * b * t * d * 2 + 2 * b * d * 4
  figures = time_scan(
      lambda g, a: lru_scan.lru_scan_backward(g, a, None, False, True),
      (g, a), n_bytes, 3 * b * t * d)
  plain_ms = cuda_ms(lambda: lru_scan.lru_scan_backward_plain(
      g, a, None, False, True), 2)
  log_scan(figures, plain_ms, n_bytes)
  without = device_ms(lru_scan.lru_scan_backward, SCAN_REPS,
                      inputs=cold_copies(g, a))
  log(f"  the cotangent scan without the product on the same inputs "
      f"{without:.4f} ms")
  return dict(name="lru_scan_backward_a_prod", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/lru_scan.cu",
              replaces=LRU_BWD_A_PROD_REPLACES, max_abs_err=worst,
              plain_ms=plain_ms, library_ms=None, **figures)


def _halo_training_case(rng, dev, shard0: bool):
  """q, [halo || local] k and v, segment_pos and an output cotangent of one
  SP training shard: shard 0 (a zero halo, positions from 0) or shard 2
  (positions from 8192, a halo of the previous shard's keys)."""
  b, t, n, h = ATTN_SP_TRAIN_SHAPE
  q, k, v, g = (torch.tensor(rng.standard_normal(s, dtype=np.float32),
                             device=dev).bfloat16()
                for s in ((b, t, n, h), (b, ATTN_WINDOW + t, 1, h),
                          (b, ATTN_WINDOW + t, 1, h), (b, t, n, h)))
  start = 0 if shard0 else 2 * t
  if shard0:
    k[:, :ATTN_WINDOW] = 0
    v[:, :ATTN_WINDOW] = 0
  seg = torch.arange(start, start + t, device=dev)[None].repeat(b, 1)
  return q, k, v, seg, g


def phase_attention_kv_prefix_backward(dev) -> list[dict]:
  b, t, n, h = ATTN_SP_TRAIN_SHAPE
  rng = np.random.default_rng(SEED + 51)
  log(f"== window_attention dq and dk/dv with a {ATTN_WINDOW}-key halo vs "
      f"plain: q [{b},{t},{n},{h}], k and v [{b},{ATTN_WINDOW + t},1,{h}] "
      f"bf16, window {ATTN_WINDOW} (tolerance {ATTN_BWD_REL_ERR} of the "
      f"largest gradient)")
  errs = {"dq": 0.0, "dkv": 0.0}
  for shard0, label in ((True, "shard 0: zero halo"),
                        (False, f"shard 2: continuous positions from "
                                f"{2 * t}")):
    log(f"  {label}:")
    q, k, v, seg, g = _halo_training_case(rng, dev, shard0)
    out, lse = wa.window_attention_forward(q, k, v, seg, ATTN_WINDOW,
                                           ATTN_WINDOW)
    args = (q, k, v, seg, lse, wa.attention_delta(out, g), g, ATTN_WINDOW,
            ATTN_WINDOW)
    errs["dq"] = max(errs["dq"], check_dq(*args))
    errs["dkv"] = max(errs["dkv"], check_dkv(*args))
    if shard0:
      dk, dv = wa.window_attention_dkv(*args)
      if dk[:, :ATTN_WINDOW].any() or dv[:, :ATTN_WINDOW].any():
        raise AssertionError("Shard 0's zero halo got a gradient.")
  log(f"  timed at shard 2 over the [{t}, {ATTN_WINDOW + t}] band:")
  return backward_rows(args, errs["dq"], errs["dkv"], suffix="_kv_prefix")


def _sp_training_counts() -> dict[str, int]:
  return {"lru_scan_a_prod": lru_scan.a_prod_launches,
          "lru_scan_backward_a_prod": lru_scan.backward_a_prod_launches,
          "window_attention_kv_prefix": wa.kv_prefix_launches,
          "window_attention_dq_kv_prefix": wa.dq_kv_prefix_launches,
          "window_attention_dkv_kv_prefix": wa.dkv_kv_prefix_launches,
          **_launch_counts()}


def _reset_sp_training_counts() -> None:
  _reset_launch_counts()
  lru_scan.a_prod_launches = lru_scan.backward_a_prod_launches = 0
  wa.kv_prefix_launches = wa.dq_kv_prefix_launches = 0
  wa.dkv_kv_prefix_launches = 0


def _use_sharding(model: griffin.Griffin, spec) -> None:
  """Puts the model's scans and attention on ``spec`` (None: unsharded),
  as ``_use_plain_path`` routes its kernels; the weights stay."""
  model.scan_sharding_spec = spec
  for block in model.blocks:
    if block.temporal_block_type is common.TemporalBlockType.RECURRENT:
      block.recurrent_block.rg_lru.scan_sharding_spec = spec
    else:
      block.attention_block.sharding_spec = spec


def sp_training_batch(vocab_size: int) -> data_lib.TrainingInput:
  """One row of random tokens after BOS: 15000 real ones, right-padded to
  16384; the loss covers the second half of the real tokens."""
  rng = np.random.default_rng(SEED + 52)
  tokens = rng.integers(4, vocab_size, (1, SP_TRAIN_TOKENS)).astype(np.int32)
  tokens[:, 0] = 1
  tokens[:, SP_TRAIN_REAL_TOKENS:] = 0
  mask = np.zeros(tokens.shape, bool)
  mask[:, SP_TRAIN_REAL_TOKENS // 2:SP_TRAIN_REAL_TOKENS] = True
  return data_lib.TrainingInput(input_tokens=tokens, target_mask=mask)


def phase_sp_training(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  spec = sp_mesh_spec()
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16, scan_sharding_spec=spec,
      generator=torch.Generator(dev).manual_seed(SEED + 53),
  )
  torch.cuda.synchronize()
  log(f"== sequence-parallel training: RecurrentGemma-2B with "
      f"scan_sharding_spec on {spec.mesh} (built in "
      f"{time.perf_counter() - start:.1f} s); train_loop, {SP_TRAIN_STEPS} "
      f"AdamW steps at learning rate {TRAIN_LEARNING_RATE}, one row of "
      f"{SP_TRAIN_TOKENS} tokens ({SP_TRAIN_REAL_TOKENS} real, "
      f"{SP_TRAIN_LOCAL_TOKENS} a shard)")
  batch = sp_training_batch(config.vocab_size)
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  n_attention = config.num_layers - n_recurrent

  steps = []

  def log_metrics(metrics, step):
    steps.append((step, metrics["train_loss"], time.perf_counter()))

  captures = [CaptureFirstCall(lru_scan, "lru_scan_backward"),
              CaptureFirstCall(wa, "window_attention_dq"),
              CaptureFirstCall(wa, "window_attention_dkv")]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _reset_sp_training_counts()
  start = time.perf_counter()
  try:
    train_loop_lib.train_loop(
        model, [batch] * SP_TRAIN_STEPS,
        train_loop_lib.TrainingConfig(learning_rate=TRAIN_LEARNING_RATE,
                                      eval_every_n=1,
                                      max_steps=SP_TRAIN_STEPS),
        log_metrics=log_metrics, device=dev,
    )
  finally:
    for capture in captures:
      capture.restore()
  torch.cuda.synchronize()
  launches = _sp_training_counts()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  per_step = {"lru_scan_a_prod": 2 * n_recurrent * SP_SHARDS,
              "lru_scan_backward_a_prod": n_recurrent * SP_SHARDS,
              "window_attention_kv_prefix": 2 * n_attention * SP_SHARDS,
              "window_attention_dq_kv_prefix": n_attention * SP_SHARDS,
              "window_attention_dkv_kv_prefix": n_attention * SP_SHARDS,
              **{name: 0 for name in _launch_counts()}}
  want = {name: SP_TRAIN_STEPS * count for name, count in per_step.items()}
  log(f"  launches in the {SP_TRAIN_STEPS} steps {launches}")
  if launches != want:
    raise AssertionError(f"SP training launched {launches}, want {want} "
                         f"({per_step} a step).")
  check_scan_routes(sum(launches[name] for name in (
      "lru_scan", "lru_scan_backward", "lru_scan_a_prod",
      "lru_scan_backward_a_prod")))
  losses = [loss for _, loss, _ in steps]
  times = [start] + [t for _, _, t in steps]
  step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
  log(f"  losses {losses}")
  if len(losses) != SP_TRAIN_STEPS or not all(np.isfinite(losses)):
    raise AssertionError(f"Non-finite or missing losses: {losses}.")
  if not losses[-1] < losses[0]:
    raise AssertionError(f"The loss did not fall: {losses}.")
  steady_ms = float(np.mean(step_ms[1:]))
  log(f"  ms per step {[round(ms, 1) for ms in step_ms]} (the first "
      f"includes warm-up); steady {steady_ms:.1f} ms "
      f"({SP_TRAIN_REAL_TOKENS / steady_ms * 1e3:.0f} real tokens/s); peak "
      f"{peak_gb:.2f} GB")

  # Each backward kernel against its plain version on the inputs the first
  # step gave it (for the scan: the first shard's cotangent walk).
  checks = {
      "lru_scan_backward": ("lru_scan_backward_a_prod",
                            lambda *a, **k: check_lru_a_prod(
                                *a, **k, backprop=True)),
      "window_attention_dq": ("window_attention_dq_kv_prefix", check_dq),
      "window_attention_dkv": ("window_attention_dkv_kv_prefix", check_dkv),
  }
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for capture in captures:
    name, check = checks[capture.name]
    if capture.args is None:
      raise AssertionError(f"SP training never called {name}.")
    tensors = [z for z in capture.args if isinstance(z, torch.Tensor)]
    log(f"  {name} on the SP step's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]} "
        f"{[z for z in capture.args if not isinstance(z, torch.Tensor)]}:")
    err = check(*capture.args, **capture.kwargs)
    log(f"  {name} max_abs_err {err}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    by_name[name]["launches"] = launches[name]
    capture.args = capture.kwargs = None
  del captures
  compare_sp_gradients(model, batch, spec, dev)
  if profile:
    profile_training(model, batch, dev, steady_ms)
  del model
  torch.cuda.empty_cache()


def compare_sp_gradients(model, batch, spec, dev) -> None:
  """The SP gradients of one batch against the unsharded gradients of the
  same model (its spec switched off), leaf by leaf; then SP and unsharded
  training steps in balanced turns."""
  model.zero_grad(set_to_none=True)
  torch.cuda.empty_cache()
  tokens = torch.as_tensor(batch.input_tokens, device=dev).long()
  mask = torch.as_tensor(batch.target_mask, device=dev)

  def loss_and_grads():
    loss = trainer.accumulate_gradients(model, 0, tokens, mask)
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads

  _reset_sp_training_counts()
  loss_sp, grads_sp = loss_and_grads()
  sp_counts = _sp_training_counts()
  _use_sharding(model, None)
  try:
    loss_ref, grads_ref = loss_and_grads()
  finally:
    _use_sharding(model, spec)
  ref_counts = {name: count - sp_counts[name]
                for name, count in _sp_training_counts().items()}
  if ref_counts["lru_scan_backward"] == 0 or ref_counts[
      "window_attention_dq"] == 0 or ref_counts["lru_scan_a_prod"]:
    raise AssertionError(f"The unsharded step launched {ref_counts}.")
  rel_loss = abs(loss_sp - loss_ref) / abs(loss_ref)
  stats = _leaf_stats(grads_sp, grads_ref)
  log(f"  SP vs unsharded, same weights and batch: loss {loss_sp:.6f} vs "
      f"{loss_ref:.6f} (rel {rel_loss:.2e}, tolerance {MODEL_LOSS_REL_ERR}); "
      f"gradients of {len(stats)} leaves, limits per leaf rel_rms <= "
      f"{GRAD_LEAF_REL_RMS}, cosine >= {GRAD_LEAF_MIN_COSINE}")
  _log_leaf_stats("SP vs unsharded", stats)
  del grads_sp, grads_ref
  bad = [x for x in stats
         if not (x[0] <= GRAD_LEAF_REL_RMS and x[1] >= GRAD_LEAF_MIN_COSINE)]
  if not (np.isfinite(loss_sp) and rel_loss <= MODEL_LOSS_REL_ERR) or bad:
    raise AssertionError(f"SP and unsharded gradients disagree: {bad[:5]}.")

  # Whole steps (forward, backward, AdamW) in turns, from one optimizer.
  optimizer = trainer.make_optimizer(model, TRAIN_LEARNING_RATE)
  per_side = {True: [], False: []}
  for sp in (True, *SP_TRAIN_TURNS):  # the first SP step allocates state
    _use_sharding(model, spec if sp else None)
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.train_step(model, optimizer, 0, tokens, mask).item()
    per_side[sp].append((time.perf_counter() - start) * 1e3)
  _use_sharding(model, spec)
  sp_ms, ref_ms = per_side[True][1:], per_side[False]
  log(f"  training step ms in turns {SP_TRAIN_TURNS}: SP "
      f"{[round(ms, 1) for ms in sp_ms]}, unsharded "
      f"{[round(ms, 1) for ms in ref_ms]}; ratio of means "
      f"{np.mean(sp_ms) / np.mean(ref_ms):.4f}")
  del optimizer
  model.zero_grad(set_to_none=True)
  torch.cuda.empty_cache()


def _components(*values) -> list[torch.Tensor]:
  """The real and imaginary tensors of Complex values, in order."""
  return [z for v in values for z in (v.real, v.imag)]


def _complex_operands(shape, dev, seed: int, dtype=torch.bfloat16):
  """x, a and h0 of the complex scan as Complex pairs from a seeded numpy
  generator: x and h0 normal, a a sigmoid plus 0.1i times a normal (a decay
  of modulus near the real scan's); x and a in ``dtype``, h0 float32."""
  b, t, d = shape
  rng = np.random.default_rng(seed)
  normal = lambda *s: torch.tensor(rng.standard_normal(s, dtype=np.float32),
                                   device=dev)
  x = complex_lib.Complex(normal(b, t, d), normal(b, t, d)).to(dtype)
  a = complex_lib.Complex(torch.sigmoid(normal(b, t, d)),
                          0.1 * normal(b, t, d)).to(dtype)
  return x, a, complex_lib.Complex(normal(b, d), normal(b, d))


def check_lru_complex(x, a, h0=None, reverse=False, return_a_prod=False,
                      backprop=False) -> float:
  """Max abs error of a complex scan entry point against its plain loop
  over every output component; raises above the tolerance. Takes the
  wrapper's own arguments, so a captured call replays as it is."""
  if backprop:
    kernel, plain = lru_scan.lru_scan_backward, lru_scan.lru_scan_backward_plain
  else:
    kernel, plain = lru_scan.lru_scan_forward, lru_scan.lru_scan_plain
  got = kernel(x, a, h0, reverse, return_a_prod=return_a_prod)
  want = plain(x, a, h0, reverse, return_a_prod=return_a_prod)
  if return_a_prod:
    got, want = (*got[0], *got[1]), (*want[0], *want[1])
  err = max(max_err(g, w)
            for g, w in zip(_components(*got), _components(*want)))
  if not err <= LRU_COMPLEX_MAX_ABS_ERR:
    raise AssertionError(f"The complex scan ({'backward' if backprop else 'forward'}"
                         f", a_prod={return_a_prod}) disagrees with its "
                         f"plain version: {err}")
  return err


# The complex scan's four entry points: (name, backward walk, product).
COMPLEX_ENTRIES = (("lru_scan_complex", False, False),
                   ("lru_scan_complex_backward", True, False),
                   ("lru_scan_complex_a_prod", False, True),
                   ("lru_scan_complex_backward_a_prod", True, True))


def _off_ring(z: torch.Tensor) -> torch.Tensor:
  """A copy of ``z`` whose base lies 4 bytes past a 16-byte boundary: TMA
  cannot describe it, so a complex scan over such copies takes the
  per-thread walk (with bf16 pairs, 4-byte aligned)."""
  buf = torch.empty(z.numel() * z.element_size() + 4, dtype=torch.uint8,
                    device=z.device)
  out = buf[4:].view(z.dtype).view(z.shape)
  out.copy_(z)
  return out


def complex_scan_call(kernel, a_prod: bool, reverse: bool = False):
  """The complex scan wrapper ``kernel`` as a function of its operands'
  components (x.real, x.imag, a.real, a.imag and, if given, h0's two), for
  :func:`time_scan`."""
  def call(xr, xi, ar, ai, *h):
    return kernel(complex_lib.Complex(xr, xi), complex_lib.Complex(ar, ai),
                  complex_lib.Complex(*h) if h else None, reverse, a_prod)
  return call


def complex_scan_work(shape, with_carry: bool, a_prod: bool):
  """(bytes, float32 operations) a complex scan must move and do: read x
  and a, write y (and a_prod), two components each in the input type
  (bf16 here); the carry in, h_last (and a_prod_last) out, two float32
  components each; per element and step 8 operations, 14 with the
  product."""
  b, t, d = shape
  states = 1 + with_carry + a_prod
  n_bytes = (8 if a_prod else 6) * b * t * d * 2 + 2 * states * b * d * 4
  return n_bytes, (14 if a_prod else 8) * b * t * d


def reset_complex_routes() -> None:
  lru_scan.complex_ring_launches = lru_scan.complex_thread_walk_launches = 0


def complex_routes() -> tuple[int, int]:
  return (lru_scan.complex_ring_launches,
          lru_scan.complex_thread_walk_launches)


def phase_lru_complex(dev) -> list[dict]:
  b, t, d = LRU_COMPLEX_SHAPE
  x, a, h0 = _complex_operands(LRU_COMPLEX_SHAPE, dev, SEED + 60)
  log(f"== the complex scan's four entry points vs plain at [{b},{t},{d}] "
      f"bf16 components (tolerance {LRU_COMPLEX_MAX_ABS_ERR} on every "
      f"output component)")
  entries = []
  for name, backprop, a_prod in COMPLEX_ENTRIES:
    worst = 0.0
    for reverse in (False, True):
      for carry in (None, h0):
        err = check_lru_complex(x, a, carry, reverse, a_prod, backprop)
        worst = max(worst, err)
    kernel = lru_scan.lru_scan_backward if backprop else lru_scan.lru_scan_forward
    plain = (lru_scan.lru_scan_backward_plain if backprop
             else lru_scan.lru_scan_plain)
    # Timed as the complex path calls it: the unsharded walks with a carry,
    # a shard's (with the product) without.
    carry = None if a_prod else h0
    inputs = tuple(_components(x, a, *([] if carry is None else [carry])))
    call = complex_scan_call(kernel, a_prod)
    n_bytes, flops = complex_scan_work(LRU_COMPLEX_SHAPE, carry is not None,
                                       a_prod)
    reset_complex_routes()
    figures = time_scan(call, inputs, n_bytes, flops)
    ring_routes = complex_routes()
    # The per-thread walk, the route before the ring, on copies TMA cannot
    # describe: the same bits, timed the same way.
    reset_complex_routes()
    walk = time_scan(call, inputs, n_bytes, flops, copy=_off_ring)
    walk_routes = complex_routes()
    if not (ring_routes[0] and not ring_routes[1]
            and walk_routes[1] and not walk_routes[0]):
      raise AssertionError(f"{name}: routes (ring, per-thread walk) "
                           f"{ring_routes} timing the ring, {walk_routes} "
                           f"timing the per-thread walk.")
    got = call(*(_off_ring(z) for z in inputs))
    want = plain(x, a, carry, False, return_a_prod=a_prod)
    if a_prod:
      got, want = (*got[0], *got[1]), (*want[0], *want[1])
    walk_err = max(max_err(g, w)
                   for g, w in zip(_components(*got), _components(*want)))
    if walk_err != 0.0:
      raise AssertionError(f"{name}: the per-thread walk differs from the "
                           f"plain loop by {walk_err}.")
    plain_ms = cuda_ms(lambda: plain(x, a, carry, False, a_prod), 1)
    log(f"  {name}: max_abs_err {worst} (reverse and carry both ways)")
    log_scan(figures, plain_ms, n_bytes)
    log(f"  per-thread walk (inputs off 16 B; max_abs_err {walk_err}): ms "
        f"{walk['ms']:.4f}, {walk['gbps']:.0f} GB/s, "
        f"{100 * walk['bound_share']:.1f}% of the bound, host "
        f"{walk['host_us']:.1f} us a call; the ring takes "
        f"{figures['ms'] / walk['ms']:.4f} of its time")
    entries.append(dict(name=name, route="cuda",
                        source="cadence_gemma_tpu_torch/csrc/lru_scan_complex.cu",
                        replaces=LRU_COMPLEX_REPLACES, max_abs_err=worst,
                        plain_ms=plain_ms, library_ms=None,
                        **{k: figures[k] for k in ("ms", "bound_ms",
                                                   "bound_by")}))
  # float32 components: the ring's fp32 stages and the unpaired loads.
  err = check_lru_complex(x.to(torch.float32), a.to(torch.float32), h0, True)
  log(f"  float32 components, forward, reverse, with h0: max_abs_err {err}")
  entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], err)
  return entries


def _complex_counts() -> dict[str, int]:
  return {"lru_scan_complex": lru_scan.complex_launches,
          "lru_scan_complex_backward": lru_scan.complex_backward_launches,
          "lru_scan_complex_a_prod": lru_scan.complex_a_prod_launches,
          "lru_scan_complex_backward_a_prod":
              lru_scan.complex_backward_a_prod_launches}


def _reset_complex_counts() -> None:
  lru_scan.complex_launches = lru_scan.complex_backward_launches = 0
  lru_scan.complex_a_prod_launches = 0
  lru_scan.complex_backward_a_prod_launches = 0
  reset_complex_routes()


def check_complex_routes(routes: tuple[int, int], scans: int) -> None:
  """Every complex scan launch of a run (``scans`` of them) took the TMA
  ring of ``csrc/lru_scan_complex.cu``."""
  log(f"  complex scan routes: {routes[0]} launches on the TMA ring, "
      f"{routes[1]} on the per-thread walk (want {scans}, 0)")
  if routes != (scans, 0):
    raise AssertionError(f"Complex scan routes (ring, per-thread walk) "
                         f"{routes}, want ({scans}, 0).")


def _complex_scan_and_grads(x, a, h0, gy, gh, **kwargs):
  """``ops.scan.linear_scan`` of Complex operands: (y and h_last
  components, gradients of <y, gy> + <h_last, gh> with respect to the
  components of x, a and h0), the host's ms of the forward and backward."""
  leaves = [z.clone().requires_grad_() for z in _components(x, a, h0)]
  pairs = [complex_lib.Complex(*leaves[i:i + 2]) for i in range(0, 6, 2)]
  torch.cuda.synchronize()
  start = time.perf_counter()
  y, h = scan_lib.linear_scan(*pairs, **kwargs)
  loss = sum((u.float() * g).sum() for u, g in zip(_components(y, h),
                                                   _components(gy, gh)))
  grads = torch.autograd.grad(loss, leaves)
  torch.cuda.synchronize()
  ms = (time.perf_counter() - start) * 1e3
  return [z.detach() for z in _components(y, h)], grads, ms


_COMPLEX_LEAVES = ("x.real", "x.imag", "a.real", "a.imag", "h0.real",
                   "h0.imag")


def phase_complex_path(dev, kernels: list[dict]) -> None:
  """The slice's path: ``ops.scan.linear_scan`` with Complex operands,
  forward and gradients, unsharded and over the (1, 4) mesh."""
  by_name = {kernel["name"]: kernel for kernel in kernels}
  b, t, d = LRU_COMPLEX_SHAPE
  x, a, h0 = _complex_operands(LRU_COMPLEX_SHAPE, dev, SEED + 61)
  gy, _, gh = _complex_operands(LRU_COMPLEX_SHAPE, dev, SEED + 62,
                                torch.float32)
  log(f"== the complex path: ops.scan.linear_scan of Complex [{b},{t},{d}] "
      f"bf16 operands with h0, forward and torch.autograd.grad of x, a, h0; "
      f"AUTO (the kernels) vs LINEAR_NATIVE (the plain loop through "
      f"autograd) on the same card")
  _reset_complex_counts()
  out, grads, ms = _complex_scan_and_grads(x, a, h0, gy, gh)
  launches, routes = _complex_counts(), complex_routes()
  want = {"lru_scan_complex": 1, "lru_scan_complex_backward": 1,
          "lru_scan_complex_a_prod": 0, "lru_scan_complex_backward_a_prod": 0}
  log(f"  launches {launches}; forward + backward {ms:.1f} ms")
  if launches != want:
    raise AssertionError(f"The complex path launched {launches}, want {want}.")
  check_complex_routes(routes, 2)
  for name in ("lru_scan_complex", "lru_scan_complex_backward"):
    by_name[name]["launches"] = launches[name]
  out_ref, grads_ref, ms_ref = _complex_scan_and_grads(
      x, a, h0, gy, gh, scan_type=common.ScanType.LINEAR_NATIVE)
  y_err = max(max_err(u, v) for u, v in zip(out, out_ref))
  rel = [_rel_rms(g, r) for g, r in zip(grads, grads_ref)]
  limits = [COMPLEX_PATH_DA_REL_RMS if name.startswith("a.")
            else COMPLEX_PATH_GRAD_REL_RMS for name in _COMPLEX_LEAVES]
  log(f"  LINEAR_NATIVE {ms_ref:.1f} ms; y and h_last max_abs_err {y_err} "
      f"(tolerance 0.0); gradients rel_rms "
      f"{dict(zip(_COMPLEX_LEAVES, (f'{r:.3e}' for r in rel)))} (limits: a "
      f"{COMPLEX_PATH_DA_REL_RMS}, x and h0 {COMPLEX_PATH_GRAD_REL_RMS})")
  if not (y_err == 0.0 and all(r <= lim for r, lim in zip(rel, limits))):
    raise AssertionError("The complex kernel path and the plain path differ.")
  del out, grads, out_ref, grads_ref, x, a, h0, gy, gh
  torch.cuda.empty_cache()

  spec = sp_mesh_spec()
  b, t, d = LRU_COMPLEX_SP_SHAPE
  x, a, h0 = _complex_operands(LRU_COMPLEX_SP_SHAPE, dev, SEED + 63)
  gy, _, gh = _complex_operands(LRU_COMPLEX_SP_SHAPE, dev, SEED + 64,
                                torch.float32)
  log(f"== the complex path sequence-sharded: [{b},{t},{d}] bf16 with h0 on "
      f"{spec.mesh} ({t // SP_SHARDS} steps a shard), forward and "
      f"gradients, vs the same call with no spec")
  captures = [CaptureFirstCall(lru_scan, "lru_scan_forward"),
              CaptureFirstCall(lru_scan, "lru_scan_backward")]
  _reset_complex_counts()
  try:
    out, grads, ms = _complex_scan_and_grads(x, a, h0, gy, gh,
                                             sharding_spec=spec)
  finally:
    for capture in captures:
      capture.restore()
  launches, routes = _complex_counts(), complex_routes()
  want = {"lru_scan_complex": 0, "lru_scan_complex_backward": 0,
          "lru_scan_complex_a_prod": SP_SHARDS,
          "lru_scan_complex_backward_a_prod": SP_SHARDS}
  log(f"  launches {launches}; forward + backward {ms:.1f} ms")
  if launches != want:
    raise AssertionError(f"The SP complex path launched {launches}, want "
                         f"{want}.")
  check_complex_routes(routes, 2 * SP_SHARDS)
  for name in ("lru_scan_complex_a_prod", "lru_scan_complex_backward_a_prod"):
    by_name[name]["launches"] = launches[name]
  # Each kernel with the product against its plain loop on the inputs the
  # path gave its first call (the first shard's).
  for capture, name, backprop in zip(
      captures, ("lru_scan_complex_a_prod", "lru_scan_complex_backward_a_prod"),
      (False, True)):
    err = check_lru_complex(*capture.args, **capture.kwargs,
                            backprop=backprop)
    log(f"  {name} on the path's first shard [{capture.args[0].shape}]: "
        f"max_abs_err {err}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    # The shard timed as phase 13 times batch 2: a batch-1 walk takes as
    # long, for half the bytes.
    args = inspect.signature(capture.wrapper).bind(
        *capture.args, **capture.kwargs).arguments
    operands = list(args.values())[:2]
    n_bytes, flops = complex_scan_work(operands[0].shape, False, True)
    figures = time_scan(
        complex_scan_call(capture.wrapper, True, args["reverse"]),
        tuple(_components(*operands)), n_bytes, flops)
    log(f"  {name} on the shard: ms {figures['ms']:.4f} (queue full, cold "
        f"inputs), {figures['gbps']:.0f} GB/s, "
        f"{100 * figures['bound_share']:.1f}% of its bound "
        f"{figures['bound_ms']:.4f} ms; host {figures['host_us']:.1f} us a "
        f"call")
  del captures
  out_ref, grads_ref, ms_ref = _complex_scan_and_grads(x, a, h0, gy, gh)
  y_rel = max(_rel_rms(u, v) for u, v in zip(out[:2], out_ref[:2]))
  h_rel = max(max_err(u, v) / v.abs().max().item()
              for u, v in zip(out[2:], out_ref[2:]))
  stats = [(_rel_rms(g, r), torch.nn.functional.cosine_similarity(
      g.float().flatten(), r.float().flatten(), dim=0).item())
           for g, r in zip(grads, grads_ref)]
  log(f"  unsharded {ms_ref:.1f} ms; y rel_rms {y_rel:.3e} (limit "
      f"{COMPLEX_SP_Y_REL_RMS}); h_last max err / max {h_rel:.3e} (limit "
      f"{COMPLEX_SP_H_REL_ERR}); gradients (rel_rms, cosine) "
      f"{dict(zip(_COMPLEX_LEAVES, ((f'{r:.3e}', f'{c:.6f}') for r, c in stats)))}"
      f" (limits {COMPLEX_SP_GRAD_REL_RMS}, {COMPLEX_SP_GRAD_MIN_COSINE})")
  if not (y_rel <= COMPLEX_SP_Y_REL_RMS and h_rel <= COMPLEX_SP_H_REL_ERR
          and all(r <= COMPLEX_SP_GRAD_REL_RMS
                  and c >= COMPLEX_SP_GRAD_MIN_COSINE for r, c in stats)):
    raise AssertionError("The SP complex path and the unsharded one differ.")
  del out, grads, out_ref, grads_ref
  # Both again, warm, in turns.
  turns = {True: [], False: []}
  for sharded in (True, False, False, True):
    turns[sharded].append(_complex_scan_and_grads(
        x, a, h0, gy, gh, sharding_spec=spec if sharded else None)[2])
  log(f"  forward + backward ms in turns (SP, unsharded, unsharded, SP): SP "
      f"{[round(v, 2) for v in turns[True]]}, unsharded "
      f"{[round(v, 2) for v in turns[False]]}")


def logscan_flops(st: int) -> float:
  """Variant B's float32 operations an element: three on each row r >= k
  of the log2(st) rounds (rows below k do none), two in the fix-up."""
  rounds = st.bit_length() - 1
  return 3 * (rounds - (st - 1) / st) + 2


def phase_kernel_lab(dev) -> list[dict]:
  """The lab's entry point, then every configuration of each variant
  against its plain version, and the probe."""
  b, t, d = kernel_lab.SHAPE
  log(f"== kernel lab: cadence_gemma_tpu_torch.benchmarks.kernel_lab.main() "
      f"at [{b},{t},{d}] bf16")
  kernel_lab.unrolled_launches = kernel_lab.logscan_launches = 0
  lines = {line["name"]: line for line in kernel_lab.main(dev)}
  launches = {"kernel_lab_unrolled": kernel_lab.unrolled_launches,
              "kernel_lab_logscan": kernel_lab.logscan_launches}
  log(f"  launches {launches}")
  if not all(launches.values()):
    raise AssertionError(f"The lab launched {launches}.")
  x, a, h0 = kernel_lab.make_inputs(device=dev)
  st = LAB_UNROLLED_ST
  st_b, dl = LAB_LOGSCAN_TILE
  y_seq, h_seq = kernel_lab.reference(x, a, h0)
  # Variant A at every tile length of its sweep, bit for bit.
  errs_a = {}
  for st_a in kernel_lab.UNROLLED_SWEEP:
    y, h = kernel_lab.run_unrolled(x, a, h0, st_a)
    errs_a[st_a] = max(max_err(y, y_seq), max_err(h, h_seq))
  err_a = max(errs_a.values())
  # Variant B at every tile of its sweep, bit for bit; its worst tile
  # against the sequential scan.
  errs_b, y_excess, h_seq_err = {}, -np.inf, 0.0
  for tile in kernel_lab.LOGSCAN_SWEEP:
    y, h = kernel_lab.run_logscan(x, a, h0, *tile)
    y_ref, h_ref = kernel_lab.logscan_plain(x, a, h0, *tile)
    errs_b[tile] = max(max_err(y, y_ref), max_err(h, h_ref))
    y_excess = max(y_excess, ((y.float() - y_seq.float()).abs()
                              - LAB_Y_ABS_ERR - LAB_Y_REL_ERR
                              * y_seq.float().abs()).max().item())
    h_seq_err = max(h_seq_err, max_err(h, h_seq))
  err_b = max(errs_b.values())
  log(f"  unrolled vs its plain version (the sequential scan), max_abs_err "
      f"by st: {errs_a} (tolerance 0.0); logscan vs its plain version, "
      f"max_abs_err by (st, dl): {errs_b} (tolerance 0.0); the worst tile "
      f"vs the sequential scan: y within {LAB_Y_REL_ERR} of |y| + "
      f"{LAB_Y_ABS_ERR} (excess {y_excess:.3e}), h_last {h_seq_err} "
      f"(tolerance {LAB_H_MAX_ABS_ERR})")
  if err_a != 0.0 or err_b != 0.0:
    raise AssertionError("A lab kernel disagrees with its plain version.")
  if y_excess > 0.0 or h_seq_err > LAB_H_MAX_ABS_ERR:
    raise AssertionError("The log-scan kernel strays from the sequential "
                         "scan beyond one bf16 step.")
  st256 = {tile: lines[f"logscan st={tile[0]} dl={tile[1]}"]["us"] / 1e3
           for tile in kernel_lab.LOGSCAN_SWEEP if tile[0] == 256}
  log(f"  logscan's st = 256 lines (the same kernel on the same work), ms: "
      f"{ {k: round(v, 5) for k, v in st256.items()} }, spread "
      f"{max(st256.values()) / min(st256.values()) - 1:.4f} of the fastest")
  # Each logscan call zeroes its scratch buffer (ticket and carry words)
  # on the stream before its kernel; its lines above include that.
  scratch = kernel_lab.logscan_scratch(x, st_b)
  zero_ms = kernel_lab.device_ms(
      lambda: kernel_lab.logscan_scratch(x, st_b), 20)
  log(f"  logscan's scratch zero-fill alone ({scratch.numel() * 8} bytes at "
      f"st={st_b}): ms {zero_ms:.4f}, part of each logscan call")
  # Read x and a, write y (bf16); h0 in, h_last out (float32). A does two
  # float32 operations a step.
  n_bytes = 3 * b * t * d * 2 + 2 * b * d * 4
  row1 = lines[kernel_lab.SCAN_ROW]["us"] / 1e3
  same = lines[f"unrolled st={st}"]["us"] / 1e3 / row1
  log(f"  unrolled st={st} / the library's scan: {same:.4f} (limit 1 +- "
      f"{LAB_SAME_AS_SCAN_REL})")
  if abs(same - 1.0) > LAB_SAME_AS_SCAN_REL:
    raise AssertionError(f"Variant A at st={st} takes "
                         f"{same:.4f} x the library's scan, which runs its "
                         f"code.")
  entries = []
  for name, label, flops, plain, err, replaces in (
      ("kernel_lab_unrolled", f"unrolled st={st}", 2,
       lambda: kernel_lab.reference(x, a, h0), err_a,
       LAB_UNROLLED_REPLACES),
      ("kernel_lab_logscan", f"logscan st={st_b} dl={dl}",
       logscan_flops(st_b),
       lambda: kernel_lab.logscan_plain(x, a, h0, st_b, dl), err_b,
       LAB_LOGSCAN_REPLACES)):
    ms = lines[label]["us"] / 1e3
    plain_ms = cuda_ms(plain, 1)
    bound_ms, bound_by = bound(n_bytes, flops * b * t * d, FP32_FLOPS)
    log(f"  {name} ({label}): ms {ms:.4f} (the library's scan kernel at the "
        f"same shape {row1:.4f})  plain_ms {plain_ms:.3f}  bound_ms "
        f"{bound_ms:.4f} ({bound_by}, {n_bytes / 1e6:.2f} MB): "
        f"{100 * bound_ms / ms:.1f}% of the bound")
    entries.append(dict(name=name, route="cuda",
                        source="cadence_gemma_tpu_torch/csrc/kernel_lab.cu",
                        replaces=replaces, launches=launches[name],
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
  phase_lab_probe(dev)
  return entries


def phase_lab_probe(dev) -> None:
  """Variant B, time-parallel, beside the library's sequential walk on one
  SP shard's shape: what a parallel-in-time walk could save the batch-1
  shards."""
  b, t, d = LAB_PROBE_SHAPE
  st_b, dl = LAB_PROBE_TILE
  x, a, h0 = kernel_lab.make_inputs(LAB_PROBE_SHAPE, device=dev, seed=1)
  y, h = kernel_lab.run_logscan(x, a, h0, st_b, dl)
  y_ref, h_ref = kernel_lab.logscan_plain(x, a, h0, st_b, dl)
  err = max(max_err(y, y_ref), max_err(h, h_ref))
  log(f"== lab probe at [{b},{t},{d}] bf16 (one SP shard of the 2B): logscan "
      f"st={st_b} vs its plain version max_abs_err {err} (tolerance 0.0)")
  if err != 0.0:
    raise AssertionError("The log-scan kernel disagrees with its plain "
                         "version at the probe's shape.")
  n_bytes = 3 * b * t * d * 2 + 2 * b * d * 4
  walk = time_scan(lru_scan.lru_scan_forward, (x, a, h0), n_bytes,
                   2 * b * t * d)
  tree = time_scan(lambda *xs: kernel_lab.run_logscan(*xs, st_b, dl),
                   (x, a, h0), n_bytes, logscan_flops(st_b) * b * t * d)
  for label, f in (("lru_scan_forward (the ring's batch-1 walk)", walk),
                   (f"logscan st={st_b} (time-parallel)", tree)):
    log(f"  {label}: ms {f['ms']:.4f} (cold inputs, queue full), bound_ms "
        f"{f['bound_ms']:.4f} ({f['bound_by']}): {f['gbps']:.0f} GB/s, "
        f"{100 * f['bound_share']:.1f}% of the bound; host "
        f"{f['host_us']:.1f} us a call")
  log(f"  logscan / lru_scan_forward: {tree['ms'] / walk['ms']:.4f}")


def main() -> int:
  profile = "--profile" in sys.argv[1:]
  if not torch.cuda.is_available():
    print("chip_smoke.py needs a CUDA device; none is available.",
          file=sys.stderr)
    return 1
  # References in float32 mean full float32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  start = time.perf_counter()

  device = phase_card()
  phase_build()
  kernels = [phase_lru(dev), phase_attention(dev)]
  model, vocab, prompts, sampler, single = phase_main_path(dev, kernels,
                                                           profile)
  phase_serving(dev, model, vocab, prompts, sampler, single, kernels, profile)
  del model, vocab, prompts, sampler, single
  torch.cuda.empty_cache()
  kernels += [phase_lru_backward(dev), *phase_attention_backward(dev)]
  torch.cuda.empty_cache()
  phase_training(dev, kernels, profile)
  torch.cuda.empty_cache()
  kernels += [phase_mha(dev), phase_add_rmsnorm(dev)]
  phase_multimodal(dev, kernels, profile)
  torch.cuda.empty_cache()
  kernels += [phase_lru_a_prod(dev), phase_attention_kv_prefix(dev)]
  torch.cuda.empty_cache()
  phase_sequence_parallel(dev, kernels, profile)
  torch.cuda.empty_cache()
  kernels += [phase_lru_backward_a_prod(dev),
              *phase_attention_kv_prefix_backward(dev)]
  torch.cuda.empty_cache()
  phase_sp_training(dev, kernels, profile)
  torch.cuda.empty_cache()
  phase_start = time.perf_counter()
  kernels += phase_lru_complex(dev)
  torch.cuda.empty_cache()
  phase_complex_path(dev, kernels)
  torch.cuda.empty_cache()
  kernels += phase_kernel_lab(dev)
  log(f"== the complex scan and lab phases {time.perf_counter() - phase_start:.1f}"
      f" s; total {time.perf_counter() - start:.1f} s")
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": device}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
