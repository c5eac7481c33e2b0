"""Tensor-parallel serving and training on the card (skips without one).

A TP-2 ``Sampler`` over a mesh that repeats the card launches each shard's
RG-LRU scan and window attention at the shard's width (twice the unsharded
count), none in its captured decode, and gives the unsharded model's
tokens. The backward kernels at the shard shapes of the 2B's training step
(the cotangent scan at half and quarter width and on one data row, bit for
bit its plain loop; dq and dk/dv at TP-2's 5 query heads and TP-4's 3
covering heads, within 2e-2 of the largest gradient) against their plain
versions; one DP x TP step's gradients against the unsharded model's. The
TP-2 towers launch the MHA kernel once a block a shard at half the heads,
reading the gathered qkv in place, within 5e-2 (rel. RMS) of the unsharded
features; a TP-2 multi-LoRA batcher's captured ticks give its eager ticks'
tokens; a TP-2 export's loaded prefill is the live TP forward bit for bit.
This file imports no JAX: run it on the card with
``python -m pytest --noconftest tests/test_torch_port_tp_cuda.py -q``.
"""

import functools

import numpy as np
import pytest
import torch

import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.checkpoint import export as export_lib
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.models import vit
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import mha_attention
from cadence_gemma_tpu_torch.ops import window_attention
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel
from cadence_gemma_tpu_torch.training import trainer


def test_tp_sampler_on_the_card_launches_the_kernels():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  config = common.GriffinConfig(
      vocab_size=512, width=512, mlp_expanded_width=1024, num_heads=2,
      block_types=(common.TemporalBlockType.RECURRENT,
                   common.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=128,
      logits_soft_cap=30.0, lru_width=512)
  model = port.Griffin(config, dtype=torch.bfloat16)
  vocab = port.SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  mesh = sharding.make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
  prompt = [" ".join(f"w{(7 * i) % 500}" for i in range(300))]
  tp = sampler_lib.Sampler(model, vocab, mesh=mesh)
  tp(prompt, total_generation_steps=8)  # captures the decode step
  before = (lru_scan.launches, window_attention.launches)
  got = tp(prompt, total_generation_steps=8)
  assert lru_scan.launches - before[0] == 2
  assert window_attention.launches - before[1] == 2
  want = sampler_lib.Sampler(model, vocab)(prompt, total_generation_steps=8)
  assert got.tokens[0].tolist() == want.tokens[0].tolist()


@pytest.mark.parametrize("shape", [(2, 4096, 1280), (1, 4096, 1280),
                                   (2, 4096, 640)])
def test_lru_backward_at_the_shard_shapes(shape):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  gen = torch.Generator("cuda").manual_seed(0)
  g = torch.randn(shape, generator=gen, device="cuda").bfloat16()
  a = torch.rand(shape, generator=gen, device="cuda").bfloat16()
  dh_last = torch.randn(shape[0], shape[2], generator=gen, device="cuda")
  before = lru_scan.backward_launches
  dx, dh0 = lru_scan.lru_scan_backward(g, a, dh_last)
  assert lru_scan.backward_launches == before + 1
  want_dx, want_dh0 = lru_scan.lru_scan_backward_plain(g, a, dh_last)
  assert torch.equal(dx, want_dx) and torch.equal(dh0, want_dh0)


@pytest.mark.parametrize("heads", [5, 3])
def test_attention_backward_at_the_shard_heads(heads):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  b, t, h, window = 2, 4096, 256, 2048
  gen = torch.Generator("cuda").manual_seed(1)
  q, k, v, d_out = (torch.randn(s, generator=gen, device="cuda").bfloat16()
                    for s in ((b, t, heads, h), (b, t, 1, h), (b, t, 1, h),
                              (b, t, heads, h)))
  tokens = torch.ones(b, t, dtype=torch.long, device="cuda")
  tokens[1, 3000:] = 0  # the training batch's padded row
  seg = trainer.get_positions(tokens, 0)
  out, lse = window_attention.window_attention(q, k, v, seg, window)
  args = (q, k, v, seg, lse, window_attention.attention_delta(out, d_out),
          d_out, window)
  got = (window_attention.window_attention_dq(*args),
         *window_attention.window_attention_dkv(*args))
  want = (window_attention.window_attention_dq_plain(*args),
          *window_attention.window_attention_dkv_plain(*args))
  for x, y in zip(got, want):
    err = (x.float() - y.float()).abs().max().item()
    assert err <= 2e-2 * y.float().abs().max().item()


def test_dp_tp_step_gradients_match_unsharded_on_the_card():
  """One (2, 2) step over the card repeated: the reduced gradients of
  every leaf against the unsharded model's (rel. RMS 0.1, cosine 0.99)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  config = common.GriffinConfig(
      vocab_size=512, width=512, mlp_expanded_width=1024, num_heads=2,
      block_types=(common.TemporalBlockType.RECURRENT,
                   common.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=128,
      logits_soft_cap=30.0, lru_width=512)
  model = port.Griffin(config, dtype=torch.bfloat16)
  rng = np.random.default_rng(0)
  tokens = torch.tensor(rng.integers(3, 512, (4, 300)), device="cuda")
  tokens[:, 0] = 1
  tokens[1, 200:] = 0
  mask = tokens != 0
  trainer.accumulate_gradients(model, 0, tokens, mask)
  want = {n: p.grad for n, p in model.named_parameters()
          if p.grad is not None}
  model.zero_grad(set_to_none=True)
  mesh = sharding.make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)
  _, shard_params = trainer.make_sharded_train_step(
      model, functools.partial(trainer.make_optimizer, learning_rate=1e-3),
      mesh, 0, example_params=model.state_dict())
  sharded = shard_params(model.state_dict())
  before = (lru_scan.backward_launches, window_attention.dq_launches)
  trainer.sharded_accumulate_gradients(sharded, 0, tokens, mask)
  assert lru_scan.backward_launches - before[0] == 4
  assert window_attention.dq_launches - before[1] == 4
  sharded.reduce_gradients()
  got = sharded.gradients()
  assert set(got) == set(want)
  for name, g in got.items():
    x, y = g.float().flatten(), want[name].float().flatten()
    rel = ((x - y).square().mean().sqrt() / y.square().mean().sqrt()).item()
    cos = torch.nn.functional.cosine_similarity(x, y, dim=0).item()
    assert rel <= 0.1 and cos >= 0.99, (name, rel, cos)


def _small_config(**kwargs):
  return common.GriffinConfig(
      vocab_size=512, width=512, mlp_expanded_width=1024, num_heads=2,
      block_types=(common.TemporalBlockType.RECURRENT,
                   common.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=128,
      logits_soft_cap=30.0, lru_width=512, **kwargs)


def test_tp_towers_on_the_card_launch_the_mha_kernel_per_head_group():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  dino = vit.ViTConfig(embed_dim=256, depth=2, num_heads=4,
                       mlp_hidden_dim=512, patch_size=14, image_size=112,
                       output_layer=1, num_prefix_tokens=5,
                       use_layer_scale=True)
  siglip = vit.ViTConfig(embed_dim=288, depth=2, num_heads=4,
                         mlp_hidden_dim=576, patch_size=14, image_size=112,
                         output_layer=1, gelu_approximate=True)
  encoder = vit.DinoSigLIPEncoder(dino, siglip)
  mesh = sharding.make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
  tp = tensor_parallel.tensor_parallel_encoder(encoder, mesh)
  pixels = torch.rand(2, 3, 120, 160, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
  with torch.no_grad():
    want = encoder(pixels)
    before = (mha_attention.launches, mha_attention.strided_copies)
    got = tp(pixels)
  assert mha_attention.launches - before[0] == 2 * 4
  assert mha_attention.strided_copies == before[1]
  diff = got.float() - want.float()
  rel = (diff.square().mean().sqrt() / want.float().square().mean().sqrt())
  assert rel.item() <= 5e-2


def test_tp_multi_lora_captured_ticks_match_eager_on_the_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  model = port.Griffin(_small_config(), dtype=torch.bfloat16, lora_rank=4)
  gen = torch.Generator("cuda").manual_seed(2)
  with torch.no_grad():
    for name, p in model.adapter_leaves().items():
      p.normal_(0.0, 0.05, generator=gen)
  vocab = port.SimpleVocab([f"w{i}" for i in range(508)])
  mesh = sharding.make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
  drawn = [{n: 0.05 * torch.randn(p.shape, device="cuda", generator=gen,
                                  dtype=p.dtype)
            for n, p in model.adapter_leaves().items()} for _ in range(2)]
  prompts = [" ".join(f"w{(5 * i + k) % 500}" for i in range(200))
             for k in range(3)]
  got = []
  for captured in (True, False):
    s = sampler_lib.Sampler(model, vocab, mesh=mesh, jit_compile=captured)
    b = serving.ContinuousBatcher(s, num_slots=4, max_steps_default=12,
                                  multi_lora=True)
    rids = [b.add_request(prompts[0], adapters=drawn[0]),
            b.add_request(prompts[1])]
    b.step(4)
    rids.append(b.add_request(prompts[2], adapters=drawn[1]))
    out = {r: list(t) for r, t, _ in b.run_until_drained(4)}
    got.append([out[r] for r in rids])
  assert got[0] == got[1]


def test_tp_export_on_the_card_is_the_live_tp_forward(tmp_path):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  model = port.Griffin(_small_config(), dtype=torch.bfloat16)
  mesh = sharding.make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
  params = dict(model.named_parameters())
  exp = export_lib.export_serving(model, params, 2, 256, mesh=mesh)
  export_lib.save_serving_export(exp, str(tmp_path))
  loaded = export_lib.load_serving_export(str(tmp_path), mesh=mesh)
  placed = sharding.place_state_dict(
      params, partitioning.griffin_param_shardings(mesh, params))
  tokens = torch.randint(3, 512, (2, 256), dtype=torch.int32, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(3))
  positions = torch.arange(256, dtype=torch.int32,
                           device="cuda")[None].repeat(2, 1)
  before = lru_scan.launches
  got, _ = loaded.prefill(placed, tokens, positions)
  assert lru_scan.launches - before == 2
  tp = tensor_parallel.tensor_parallel(model, mesh)
  with torch.no_grad():
    want, _ = tp(tokens, positions, last_logits_only=True)
  assert torch.equal(got, want)
