"""Sequence parallelism in the PyTorch port vs the JAX package, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
under ``shard_map``, its Pallas kernels in interpret mode; the port's meshes
repeat the CPU device (``make_mesh(..., devices=["cpu"] * n)``), its kernel
wrappers taking their plain versions on CPU tensors. Inputs are seeded numpy
arrays handed to both.

Tolerances: float32 on both sides, the same operations in the same order,
except that XLA may fuse a multiply into the next add (one float32 rounding,
~1e-7 relative): scans 1e-5, the whole model 2e-4 (the JAX package's own
``TestShardedModel`` tolerance). Attention sums in other orders: 2e-5 (the
JAX package's tolerance between its kernel and the einsum). bfloat16
outputs are one rounding of the same float32 value, or one bf16 step apart.
"""

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.ops import pallas_attention as jpa
from cadence_gemma_tpu.ops import pallas_lru as jlru
from cadence_gemma_tpu.ops import scan as jscan
from cadence_gemma_tpu.parallel import sharding as jsh
from cadence_gemma_tpu.parallel import sp_attention as jsp
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch import tokenizers
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.models import modules
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import scan
from cadence_gemma_tpu_torch.ops import window_attention as wa
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import sp_attention

P = jax.sharding.PartitionSpec
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_ATOL = 2e-5
MODEL_ATOL = 2e-4
# One bf16 rounding step (2^-8 relative) between two roundings of nearly the
# same float32 value.
BF16_TOL = dict(atol=2e-2, rtol=8e-3)


def _mesh_pair(axis_shapes, axis_names):
  """(JAX mesh over the first virtual devices, the port's over the CPU)."""
  n = int(np.prod(axis_shapes))
  return (jsh.make_mesh(axis_shapes, axis_names, jax.devices()[:n]),
          sharding.make_mesh(axis_shapes, axis_names, ["cpu"] * n))


def _spec_pair(axis_shapes=(4,), axis_names=("sequence",)):
  jmesh, tmesh = _mesh_pair(axis_shapes, axis_names)
  batch = "data" if "data" in axis_names else None
  return (jsh.ShardingSpec(mesh=jmesh, batch_axis_name=batch,
                           sequence_axis_name="sequence"),
          sharding.ShardingSpec(mesh=tmesh, batch_axis_name=batch,
                                sequence_axis_name="sequence"))


def _lru_inputs(b, t, d, seed=0, reset_at=None):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((b, t, d), dtype=np.float32)
  a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, d))))).astype(
      np.float32)
  h0 = rng.standard_normal((b, d), dtype=np.float32)
  if reset_at is not None:
    a[:, reset_at] = 0.0  # a document start inside a shard
  return x, a, h0


# -- (a) multi_shard_correction ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse,shift_a_prod,sync_h_last,with_h0", [
    (False, False, True, True),
    (True, False, True, True),
    (False, True, True, True),
    (True, True, False, False),
    (False, False, False, True),
])
def test_multi_shard_correction_matches_jax(dtype, reverse, shift_a_prod,
                                            sync_h_last, with_h0):
  n, b, t, d = 4, 2, 24, 6
  rng = np.random.default_rng(1)
  y = rng.standard_normal((b, n * t, d), dtype=np.float32)
  a_prod = rng.uniform(0.1, 1.0, (b, n * t, d)).astype(np.float32)
  h_last = rng.standard_normal((n, b, d), dtype=np.float32)
  a_last = rng.uniform(0.1, 1.0, (n, b, d)).astype(np.float32)
  h0 = rng.standard_normal((b, d), dtype=np.float32)
  jdt = jnp.dtype(dtype)
  tdt = getattr(torch, dtype)
  mesh = jsh.make_mesh((n,), ("sequence",), jax.devices()[:n])

  def local(y, a_prod, h_last, a_last, h0):
    out = jsh.multi_shard_correction(
        y=y, a_prod=a_prod, h0=h0 if with_h0 else None, reverse=reverse,
        h_last=h_last[0], a_prod_last=a_last[0], seq_axis="sequence",
        shift_a_prod=shift_a_prod, sync_h_last=sync_h_last,
    )
    return out[0], out[1][None], out[2][None]

  seq = P(None, "sequence")
  run = jax.jit(jax.shard_map(
      local, mesh=mesh,
      in_specs=(seq, seq, P("sequence"), P("sequence"), P()),
      out_specs=(seq, P("sequence"), P("sequence")), check_vma=False,
  ))
  want = run(jnp.asarray(y, jdt), jnp.asarray(a_prod, jdt),
             jnp.asarray(h_last), jnp.asarray(a_last), jnp.asarray(h0))

  ys = torch.tensor(y).to(tdt).chunk(n, dim=1)
  aps = torch.tensor(a_prod).to(tdt).chunk(n, dim=1)
  h_all = list(torch.tensor(h_last))
  a_all = list(torch.tensor(a_last))
  got = [sharding.multi_shard_correction(
      y=ys[j], a_prod=aps[j], h0=torch.tensor(h0) if with_h0 else None,
      reverse=reverse, h_last=h_all[j], a_prod_last=a_all[j],
      h_last_all=h_all, a_last_all=a_all, shard_index=j,
      shift_a_prod=shift_a_prod, sync_h_last=sync_h_last,
  ) for j in range(n)]
  y_got = torch.cat([g[0] for g in got], dim=1)
  assert y_got.dtype == tdt
  tol = SCAN_TOL if dtype == "float32" else BF16_TOL
  np.testing.assert_allclose(y_got.float().numpy(),
                             np.asarray(want[0], np.float32), **tol)
  for k in (1, 2):
    np.testing.assert_allclose(torch.stack([g[k] for g in got]).numpy(),
                               np.asarray(want[k]), **SCAN_TOL)


def test_multi_shard_correction_one_shard_is_identity():
  y = torch.randn(1, 5, 3)
  h_last = torch.randn(1, 3)
  out = sharding.multi_shard_correction(y=y, a_prod=torch.rand(1, 5, 3),
                                        h0=None, h_last=h_last,
                                        a_prod_last=torch.rand(1, 3))
  assert out[0] is y and out[1] is h_last
  assert not out[2].any()
  with pytest.raises(ValueError, match="float32"):
    sharding.multi_shard_correction(y=y, a_prod=y, h0=h_last.double(),
                                    h_last=h_last, a_prod_last=h_last)


# -- (b) the running product of `a` --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backprop", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lru_a_prod_plain_matches_pallas(dtype, backprop, reverse):
  # d = 136 is not a multiple of the TPU kernel's 128 lanes.
  x, a, _ = _lru_inputs(2, 16, 136, seed=2)
  jdt = jnp.dtype(dtype)
  call = jax.jit(lambda x, a: jlru._lru_pallas_call(
      x, a, None, reverse=reverse, backprop=backprop, compute_a_prod=True))
  with pltpu.force_tpu_interpret_mode():
    y_j, h_j, p_j, pl_j = call(jnp.asarray(x, jdt), jnp.asarray(a, jdt))
  xt, at = (torch.tensor(z).to(getattr(torch, dtype)) for z in (x, a))
  plain = (lru_scan.lru_scan_backward_plain if backprop
           else lru_scan.lru_scan_plain)
  (y, h), (p, p_last) = plain(xt, at, None, reverse, return_a_prod=True)
  # The product is the same chain of float32 multiplies: exact. The scan's
  # multiply-add may be fused by XLA in float32.
  np.testing.assert_array_equal(p.float().numpy(), np.asarray(p_j, np.float32))
  np.testing.assert_array_equal(p_last.numpy(), np.asarray(pl_j))
  tol = SCAN_TOL if dtype == "float32" else BF16_TOL
  np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j, np.float32),
                             **tol)
  np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **SCAN_TOL)
  # The wrappers take the same plain versions on a CPU tensor.
  fn = lru_scan.lru_scan_backward if backprop else lru_scan.lru_scan_forward
  (y2, _), (p2, _) = fn(xt, at, None, reverse, return_a_prod=True)
  assert torch.equal(y2, y) and torch.equal(p2, p)


def test_associative_scan_a_prod_matches_sequential():
  x, a, h0 = (torch.tensor(z) for z in _lru_inputs(2, 37, 8, seed=3))
  for reverse in (False, True):
    (y1, h1), (p1, pl1) = scan.lru_linear_scan(x, a, h0, reverse, True)
    (y2, h2), (p2, pl2) = scan.lru_associative_scan(x, a, h0, reverse, True)
    for got, want in ((y2, y1), (h2, h1), (p2, p1), (pl2, pl1)):
      torch.testing.assert_close(got, want, **SCAN_TOL)


# -- (c) linear_scan over a sequence mesh --------------------------------------

_SCAN_TYPES = [
    (jcommon.ScanType.LINEAR_PALLAS, common.ScanType.LINEAR_PALLAS),
    (jcommon.ScanType.LINEAR_NATIVE, common.ScanType.LINEAR_NATIVE),
    (jcommon.ScanType.ASSOCIATIVE_NATIVE, common.ScanType.ASSOCIATIVE_NATIVE),
]


@pytest.mark.parametrize("scan_types", _SCAN_TYPES, ids=lambda s: s[0].name)
@pytest.mark.parametrize("with_h0,reverse", [(False, False), (True, True)])
def test_sharded_linear_scan_matches_jax(scan_types, with_h0, reverse):
  jtype, ttype = scan_types
  jspec, tspec = _spec_pair()
  # 4 shards of 16 steps; a reset (a = 0) inside shard 2.
  x, a, h0 = _lru_inputs(2, 64, 24, seed=4, reset_at=37)
  h0_j = jnp.asarray(h0) if with_h0 else None
  run = jax.jit(lambda x, a, h0: jscan.linear_scan(
      x, a, h0, reverse=reverse, scan_type=jtype, sharding_spec=jspec))
  with pltpu.force_tpu_interpret_mode():
    y_j, h_j = run(jnp.asarray(x), jnp.asarray(a), h0_j)
  y, h = scan.linear_scan(torch.tensor(x), torch.tensor(a),
                          torch.tensor(h0) if with_h0 else None,
                          reverse=reverse, scan_type=ttype,
                          sharding_spec=tspec)
  np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **SCAN_TOL)
  np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **SCAN_TOL)
  # And the unsharded scan.
  y_ref, h_ref = scan.lru_linear_scan(torch.tensor(x), torch.tensor(a),
                                      torch.tensor(h0) if with_h0 else None,
                                      reverse)
  torch.testing.assert_close(y, y_ref, **SCAN_TOL)
  torch.testing.assert_close(h, h_ref, **SCAN_TOL)


def test_sharded_scan_data_by_sequence_mesh_bf16():
  """A (2, 4) data x sequence mesh in bfloat16, the model's dtype: the
  correction's bf16 multiply and add as JAX rounds them."""
  jspec, tspec = _spec_pair((2, 4), ("data", "sequence"))
  x, a, h0 = _lru_inputs(2, 64, 24, seed=5, reset_at=21)
  xj, aj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(a, jnp.bfloat16)
  run = jax.jit(lambda x, a, h0: jscan.linear_scan(
      x, a, h0, scan_type=jcommon.ScanType.LINEAR_PALLAS,
      sharding_spec=jspec))
  with pltpu.force_tpu_interpret_mode():
    y_j, h_j = run(xj, aj, jnp.asarray(h0))
  y, h = scan.linear_scan(torch.tensor(x).bfloat16(),
                          torch.tensor(a).bfloat16(), torch.tensor(h0),
                          sharding_spec=tspec)
  assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
  np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j, np.float32),
                             **BF16_TOL)
  np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **SCAN_TOL)


def test_sharded_scan_index_groups_are_independent_domains():
  """Two groups of a 4-way sequence axis scan as two sequences, each from
  h0; h_last is the first group's (shard 0's) global final state."""
  mesh = sharding.make_mesh((4,), ("sequence",), ["cpu"] * 4)
  spec = sharding.ShardingSpec(mesh=mesh, sequence_axis_name="sequence",
                               sequence_axis_index_groups=[[0, 1], [2, 3]])
  x, a, h0 = (torch.tensor(z) for z in _lru_inputs(1, 32, 8, seed=6))
  y, h = scan.linear_scan(x, a, h0, sharding_spec=spec)
  y0, h_first = scan.lru_linear_scan(x[:, :16], a[:, :16], h0)
  y1, _ = scan.lru_linear_scan(x[:, 16:], a[:, 16:], h0)
  torch.testing.assert_close(y, torch.cat([y0, y1], dim=1), **SCAN_TOL)
  torch.testing.assert_close(h, h_first, **SCAN_TOL)


def test_sharded_native_scan_gradients_match_unsharded():
  """The native paths stay differentiable across shards (JAX
  ``TestShardedScan.test_gradients``)."""
  _, tspec = _spec_pair()
  base = [torch.tensor(z) for z in _lru_inputs(2, 32, 6, seed=7)]

  def grads(sharded):
    inputs = [z.clone().requires_grad_() for z in base]
    if sharded:
      y, h = scan.linear_scan(*inputs, scan_type=common.ScanType.LINEAR_NATIVE,
                              sharding_spec=tspec)
    else:
      y, h = scan.lru_linear_scan(*inputs)
    return torch.autograd.grad(y.square().sum() + h.square().sum(), inputs)

  for got, want in zip(grads(True), grads(False)):
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# -- (d) window attention with a key halo --------------------------------------

def _attn_inputs(b, t, n, h, prefix, seed=0, start=0, pad=0, docs=False):
  """q [b, t, n, h], k and v [b, prefix + t, 1, h], segment_pos [b, t]:
  positions from `start`; row 0 left-padded by `pad`; with `docs`, row 1
  restarts its document at t // 3."""
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, t, n, h), dtype=np.float32)
  k = rng.standard_normal((b, prefix + t, 1, h), dtype=np.float32)
  v = rng.standard_normal((b, prefix + t, 1, h), dtype=np.float32)
  seg = np.tile(np.arange(start, start + t, dtype=np.int32), (b, 1))
  if pad:
    seg[0] = np.maximum(np.arange(t, dtype=np.int32) - pad, -1)
  if docs:
    seg[1, t // 3:] = np.arange(t - t // 3, dtype=np.int32)
  return q, k, v, seg


@pytest.mark.parametrize("case", [
    dict(start=1000),                  # a later shard, one long document
    dict(start=1000, docs=True),       # a document starts inside the shard
    dict(start=0, pad=70, docs=True),  # shard 0: left padding, zero halo
])
def test_window_attention_plain_kv_prefix_matches_jax(case):
  prefix, window = 128, 128
  q, k, v, seg = _attn_inputs(2, 256, 2, 128, prefix, seed=8, **case)
  if case["start"] == 0:
    k[:, :prefix] = 0.0
    v[:, :prefix] = 0.0
  run = jax.jit(lambda *z: jpa._flash_window_forward(
      *z, window, kv_prefix=prefix))
  with pltpu.force_tpu_interpret_mode():
    out_j, lse_j = run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(seg))
  out, lse = wa.window_attention(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), torch.tensor(seg), window,
                                 kv_prefix=prefix)
  np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATTN_ATOL)
  np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :256, 0],
                             atol=1e-4, rtol=1e-6)
  if case.get("pad"):
    assert not out[0, :case["pad"]].any()
    assert (lse[0, :, :case["pad"]] == wa.MASKED_LSE).all()


def test_window_attention_plain_kv_prefix_is_the_unsharded_band():
  """Query rows of the second half attending [halo || own keys] equal the
  same rows of the attention over the whole sequence."""
  window, t = 64, 192
  q, k, v, seg = _attn_inputs(2, t, 2, 16, 0, seed=9, docs=True)
  q, k, v, seg = (torch.tensor(z) for z in (q, k, v, seg))
  full, lse_full = wa.window_attention_plain(q, k, v, seg, window)
  half = t // 2
  out, lse = wa.window_attention_plain(q[:, half:], k[:, half - window:],
                                       v[:, half - window:], seg[:, half:],
                                       window, kv_prefix=window)
  torch.testing.assert_close(out, full[:, half:], atol=1e-6, rtol=1e-6)
  torch.testing.assert_close(lse, lse_full[:, :, half:], atol=1e-6, rtol=1e-6)


# -- (e) sequence_sharded_attention --------------------------------------------

def _doc_positions(b, t, seed):
  rng = np.random.default_rng(seed)
  starts = rng.random((b, t)) < 0.05
  starts[:, 0] = True
  idx = np.arange(t)[None]
  doc_start = np.maximum.accumulate(np.where(starts, idx, 0), axis=1)
  return (idx - doc_start).astype(np.int32)


@pytest.mark.parametrize("docs", [False, True])
def test_sequence_sharded_attention_matches_jax(docs):
  jspec, tspec = _spec_pair((1, 4), ("data", "sequence"))
  t, window = 1024, 128
  rng = np.random.default_rng(10)
  q = rng.standard_normal((1, t, 2, 128), dtype=np.float32)
  k = rng.standard_normal((1, t, 1, 128), dtype=np.float32)
  v = rng.standard_normal((1, t, 1, 128), dtype=np.float32)
  seg = (_doc_positions(1, t, 11) if docs
         else np.arange(t, dtype=np.int32)[None])
  assert sp_attention.can_sequence_shard(tspec, t, window)
  run = jax.jit(lambda *z: jsp.sequence_sharded_attention(
      *z, window, jspec))
  with pltpu.force_tpu_interpret_mode():
    want = run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               jnp.asarray(seg))
  got = sp_attention.sequence_sharded_attention(
      torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(seg),
      window, tspec,
  )
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL)
  ref = wa.reference_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), torch.tensor(seg), window)
  torch.testing.assert_close(got, ref, atol=ATTN_ATOL, rtol=0)


def test_sharding_places_no_copy_on_a_repeated_device():
  """With every shard on the operands' device the split makes views and the
  collectives move nothing."""
  _, tspec = _spec_pair((2, 4), ("data", "sequence"))
  x = torch.randn(2, 64, 3)
  shards = sharding.shard_activations(x, tspec)
  for row in shards:
    for z in row:
      assert z.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
  pairs = [(z[:, -1], z[:, 0]) for z in shards[0]]
  for got in sharding.all_gather(pairs, [torch.device("cpu")] * 4):
    assert all(g[0] is p[0] and g[1] is p[1] for g, p in zip(got, pairs))
  moved = sharding.ppermute([z for z in shards[0]],
                            [torch.device("cpu")] * 4, [(0, 1), (1, 2)])
  assert moved[1] is shards[0][0] and moved[2] is shards[0][1]
  assert not moved[0].any() and not moved[3].any()
  torch.testing.assert_close(sharding.unshard(shards, x.device), x)


# -- (f) the whole model -------------------------------------------------------

def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types)
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


def _tiny_config(scan_type, window=128):
  return jcommon.GriffinConfig(
      vocab_size=48, width=32, mlp_expanded_width=64, num_heads=2,
      block_types=(jcommon.TemporalBlockType.RECURRENT,
                   jcommon.TemporalBlockType.ATTENTION,
                   jcommon.TemporalBlockType.RECURRENT),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=window,
      logits_soft_cap=30.0, lru_width=32, scan_type=scan_type,
  )


def _tiny_params(config, seed=0):
  model = jgriffin.Griffin(config, dtype=jnp.float32,
                           param_dtype=jnp.float32,
                           gradient_checkpointing=False)
  # Only the tree's shapes: every leaf is drawn from numpy below.
  with pltpu.force_tpu_interpret_mode():
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 4), jnp.int32),
                            jnp.arange(4)[None])["params"]
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map(
      lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32),
      shapes)


def _port_model(config, params, spec=None):
  return convert.griffin_from_flax_params(
      params, _port_config(config), device="cpu", dtype=torch.float32,
      use_flash_attention=True, scan_sharding_spec=spec,
  )


@pytest.mark.parametrize("mesh_shape,jax_flash", [((2, 4), False),
                                                  ((1, 4), True)])
@torch.no_grad()
def test_sequence_parallel_griffin_matches_jax(mesh_shape, jax_flash):
  """A tiny Griffin, window 128 at 1024 tokens (256 a shard), SP over a data
  x sequence mesh: the port through its kernel paths (the scan with the
  running product, the halo attention; plain versions on the CPU) vs the
  JAX Griffin with the same spec and weights, and vs the port unsharded.

  JAX scans with ``ASSOCIATIVE_NATIVE`` (its ``LINEAR_*`` scans compile for
  tens of seconds here). On the (1, 4) mesh JAX takes its own halo path,
  the flash kernel in interpret mode; on the (2, 4) mesh it attends by
  einsum, because interpret-mode Pallas on all 8 virtual devices does not
  finish on an 8-core host.
  """
  config = _tiny_config(jcommon.ScanType.ASSOCIATIVE_NATIVE)
  params = _tiny_params(config)
  jspec, tspec = _spec_pair(mesh_shape, ("data", "sequence"))
  t = 1024
  rng = np.random.default_rng(12)
  tokens = rng.integers(0, config.vocab_size, (2, t)).astype(np.int32)
  seg = np.tile(np.arange(t, dtype=np.int32), (2, 1))
  seg[1] = np.maximum(np.arange(t) - 300, -1)  # row 1 left-padded by 300
  seg[0, 700:] = np.arange(t - 700)  # row 0 starts a document in shard 2
  model_j = jgriffin.Griffin(config, scan_sharding_spec=jspec,
                             dtype=jnp.float32, param_dtype=jnp.float32,
                             gradient_checkpointing=False,
                             use_flash_attention=jax_flash)
  apply = jax.jit(lambda p, tok, pos: model_j.apply(
      {"params": p}, tok, pos, return_cache=False)[0])
  with pltpu.force_tpu_interpret_mode():
    logits_j = apply(params, jnp.asarray(tokens), jnp.asarray(seg))

  kernel_config = config._replace(scan_type=jcommon.ScanType.LINEAR_PALLAS)
  sp_calls = []
  real = sp_attention.sequence_sharded_attention

  def spy(*args, **kwargs):
    sp_calls.append(args[0].shape)
    return real(*args, **kwargs)

  sp_attention.sequence_sharded_attention = spy
  try:
    logits_sp, _ = _port_model(kernel_config, params, tspec)(
        torch.tensor(tokens).long(), torch.tensor(seg), return_cache=False)
  finally:
    sp_attention.sequence_sharded_attention = real
  assert sp_calls == [(2, t, 2, 16)]
  logits, _ = _port_model(kernel_config, params)(
      torch.tensor(tokens).long(), torch.tensor(seg), return_cache=False)
  # JAX's einsum attention lets left padding attend padding, where the
  # kernels give padded rows zeros: on that path only real positions agree.
  real_rows = (seg >= 0)[..., None] if not jax_flash else True
  np.testing.assert_allclose(np.where(real_rows, logits_sp.numpy(), 0.0),
                             np.where(real_rows, np.asarray(logits_j), 0.0),
                             atol=MODEL_ATOL)
  torch.testing.assert_close(logits_sp, logits, atol=MODEL_ATOL, rtol=0)


# -- (g) the Sampler -----------------------------------------------------------

def test_sampler_over_sequence_parallel_model_matches_unsharded():
  config = _tiny_config(jcommon.ScanType.LINEAR_NATIVE)
  params = _tiny_params(config, seed=1)
  _, tspec = _spec_pair((1, 4), ("data", "sequence"))
  vocab = tokenizers.SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(13)
  # BOS + 511 and BOS + 449 words: padded to 512, 128 tokens a shard.
  prompts = [" ".join(f"w{i}" for i in rng.integers(0, 44, n))
             for n in (511, 449)]
  outs = []
  for spec in (tspec, None):
    model = _port_model(config, params, spec)
    outs.append(sampler_lib.Sampler(model, vocab, device="cpu")(
        prompts, total_generation_steps=6, return_logits=True,
        end_sampling_at_eos_token=False))
  sp, ref = outs
  for got, want in zip(sp.tokens, ref.tokens):
    assert torch.equal(got, want)
  for got, want in zip(sp.logits, ref.logits):
    torch.testing.assert_close(got, want, atol=MODEL_ATOL, rtol=0)


# -- (h) gates and refusals ----------------------------------------------------

def test_can_sequence_shard_gates_match_jax():
  jspec, tspec = _spec_pair((1, 4), ("data", "sequence"))
  cases = [(1024, 128), (1000, 128), (1024, 512), (1024, 96), (512, 128),
           (1536, 256)]
  for t, w in cases:
    assert (sp_attention.can_sequence_shard(tspec, t, w)
            == jsp.can_sequence_shard(jspec, t, w)), (t, w)
  assert not sp_attention.can_sequence_shard(None, 1024, 128)
  assert not sp_attention.can_sequence_shard(tspec._replace(mesh=None), 1024,
                                             128)
  assert not sp_attention.can_sequence_shard(
      tspec._replace(sequence_axis_index_groups=[[0, 1], [2, 3]]), 1024, 128)
  assert not sp_attention.can_sequence_shard(
      tspec._replace(sequence_axis_name="model"), 1024, 128)


def test_sequence_axis_groups():
  """Shard counts and positions within a scan domain, with and without
  index groups (``sharding.py:112-139``)."""
  _, tspec = _spec_pair((2, 4), ("data", "sequence"))
  groups = [[0, 2], [1, 3]]
  assert sharding.num_sequence_shards(tspec) == 4
  assert sharding.num_sequence_shards(tspec, groups) == 2
  assert [sharding.sequence_shard_index(i) for i in range(4)] == [0, 1, 2, 3]
  assert [sharding.sequence_shard_index(i, groups) for i in range(4)] == [
      0, 0, 1, 1]
  assert sharding.seq_axis_groups(4) == [[0, 1, 2, 3]]
  assert sharding.seq_axis_groups(4, groups) == groups
  with pytest.raises(ValueError, match="once each"):
    sharding.seq_axis_groups(4, [[0, 1], [1, 2]])
  assert sharding.shard_devices(tspec) == [[torch.device("cpu")] * 4] * 2


def test_attention_block_falls_back_at_short_shards(monkeypatch):
  """At t // n <= window the block skips the halo path and runs the
  unsharded attention on the whole sequence, as JAX does: the kernel
  auto-dispatch is taken at the local length."""
  card = torch.device("cuda")  # the dispatch's rule for a card's tensors
  assert not modules._should_use_flash_attention(128, 128, None, card)
  assert modules._should_use_flash_attention(256, 128, None, card)
  # Run the CPU block under the card's rule.
  rule = modules._should_use_flash_attention
  monkeypatch.setattr(modules, "_should_use_flash_attention",
                      lambda t, w, override, _: rule(t, w, override, card))
  _, tspec = _spec_pair((1, 4), ("data", "sequence"))
  block = modules.LocalAttentionBlock(32, 2, 128, sharding_spec=tspec,
                                      device="cpu")
  for p in block.parameters():
    torch.nn.init.normal_(p, std=0.2, generator=torch.Generator().manual_seed(0))
  real = sp_attention.sequence_sharded_attention
  calls = []
  sp_attention.sequence_sharded_attention = lambda *a, **k: (
      calls.append(1), real(*a, **k))[1]
  try:
    with torch.no_grad():
      for t, want_sp in ((512, False), (1024, True)):
        x = torch.randn(1, t, 32, generator=torch.Generator().manual_seed(t))
        seg = torch.arange(t)[None]
        calls.clear()
        out, _ = block(x, seg, return_cache=False)
        block.sharding_spec = None
        want, _ = block(x, seg, return_cache=False)
        block.sharding_spec = tspec
        assert bool(calls) == want_sp, t
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
  finally:
    sp_attention.sequence_sharded_attention = real


def test_sequence_parallel_refusals():
  """JAX's pmap regime needs its axis bound to a process group (an unbound
  name raises as JAX's does; the regime itself is held against jax.pmap in
  tests/test_torch_port_process_per_card.py); a channel-sharded scan runs
  and equals the unsharded one."""
  x, a, h0 = (torch.tensor(z) for z in _lru_inputs(2, 16, 4))
  with pytest.raises(NameError, match="pmap"):
    scan.linear_scan(x, a, sharding_spec=sharding.ShardingSpec(
        mesh=None, sequence_axis_name="seq"))
  _, tspec = _spec_pair()
  channels = sharding.ShardingSpec(
      mesh=sharding.make_mesh((4, 2), ("sequence", "model"), ["cpu"] * 8),
      sequence_axis_name="sequence", activations_axis_name="model")
  got = scan.linear_scan(x, a, h0, sharding_spec=channels)
  want = scan.linear_scan(x, a, h0)
  for g, w in zip(got, want):
    torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
  with pytest.raises(ValueError, match="divide"):
    scan.linear_scan(x[:, :15], a[:, :15], sharding_spec=tspec)
  with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
    torch_cuda = torch.cuda.is_available
    try:
      torch.cuda.is_available = lambda: False
      sharding.make_mesh((4,), ("sequence",))
    finally:
      torch.cuda.is_available = torch_cuda
  # The kernel path of a multi-shard scan and the halo attention take
  # gradients (SP training); their values are held against JAX in
  # tests/test_torch_port_sp_training.py.
  xg = x.clone().requires_grad_()
  y, h = scan.linear_scan(xg, a, h0, sharding_spec=tspec)
  (dx,) = torch.autograd.grad(y.sum() + h.sum(), xg)
  assert dx.shape == x.shape and torch.isfinite(dx).all() and dx.any()
  q, k, v, seg = (torch.tensor(z)
                  for z in _attn_inputs(1, 8, 1, 8, 4, start=100))
  kg = k.clone().requires_grad_()
  out, _ = wa.window_attention(q.requires_grad_(), kg, v, seg, 4,
                               kv_prefix=4)
  dq, dk = torch.autograd.grad(out.sum(), (q, kg))
  assert dq.shape == q.shape and dk.shape == k.shape
  assert dk[:, :4].any()  # the halo keys' gradient
  with pytest.raises(ValueError, match="kv_prefix"):
    wa.window_attention_forward(q, k[:, 1:], v[:, 1:], seg, 4, kv_prefix=4)
