"""Sequence-parallel training of the PyTorch port vs the JAX package, on CPU.

The gradients of the port's sequence-parallel (SP) paths -- the window
attention with a key halo, the halo exchange, the sharded kernel-path scan,
and a whole Griffin behind the trainer -- against ``jax.grad`` of the JAX
package's ``shard_map`` paths on the 8 virtual CPU devices of
``tests/conftest.py``, its Pallas kernels in interpret mode. The port's
meshes repeat the CPU device; its kernel wrappers take their plain versions
on CPU tensors. Inputs and cotangents are seeded numpy arrays handed to
both. Every JAX call is jitted: eager ``shard_map`` runs op by op.

Tolerances, float32 unless stated: attention gradients 3e-5 absolute (the
JAX package's own between its flash backward and the einsum's), the SP
attention 5e-5 (its own between SP and unsharded gradients); scans 1e-5
(the same operations, XLA may fuse a multiply into an add); bfloat16 scan
gradients two bf16 steps (one rounding of nearly the same float32 value,
then a bf16 product); the whole model 1e-4 of each leaf's largest gradient
(the tolerance of ``tests/test_torch_port_training.py``: float32
reassociation over three blocks, the chunked loss and the scans).
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import optax
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.ops import pallas_attention as jpa
from cadence_gemma_tpu.ops import scan as jscan
from cadence_gemma_tpu.parallel import sharding as jsh
from cadence_gemma_tpu.parallel import sp_attention as jsp
from cadence_gemma_tpu.training import trainer as jtrainer
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import scan
from cadence_gemma_tpu_torch.ops import window_attention as wa
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import sp_attention
from cadence_gemma_tpu_torch.training import data
from cadence_gemma_tpu_torch.training import train_loop as tl
from cadence_gemma_tpu_torch.training import trainer

ATTN_GRAD_ATOL = 3e-5
SP_ATTN_GRAD_ATOL = 5e-5
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_GRAD_TOL = dict(atol=4e-2, rtol=1.6e-2)
LEAF_REL_ATOL = 1e-4
PAD = 0


def _spec_pair(axis_shapes=(1, 4), axis_names=("data", "sequence"),
               groups=None):
  """(JAX spec over the first virtual devices, the port's over the CPU)."""
  n = int(np.prod(axis_shapes))
  batch = "data" if "data" in axis_names else None
  kw = dict(batch_axis_name=batch, sequence_axis_name="sequence",
            sequence_axis_index_groups=groups)
  return (jsh.ShardingSpec(
              mesh=jsh.make_mesh(axis_shapes, axis_names, jax.devices()[:n]),
              **kw),
          sharding.ShardingSpec(
              mesh=sharding.make_mesh(axis_shapes, axis_names, ["cpu"] * n),
              **kw))


def _assert_grads(got, want, names, **tol):
  for name, g, w in zip(names, got, want):
    np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                               err_msg=name, **tol)


# -- the window attention with a key halo --------------------------------------

def _halo_inputs(prefix, t, shard0, seed=0):
  """q [2, t, 2, 128], k and v [2, prefix + t, 1, 128], segment_pos [2, t]
  and an output cotangent: a later shard (positions from 1000) or shard 0
  (a zero halo, row 0 left-padded by 70). Row 1 starts a document at
  t // 3, so row 0 runs without documents and row 1 with them."""
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((2, t, 2, 128), dtype=np.float32)
  k = rng.standard_normal((2, prefix + t, 1, 128), dtype=np.float32)
  v = rng.standard_normal((2, prefix + t, 1, 128), dtype=np.float32)
  g = rng.standard_normal((2, t, 2, 128), dtype=np.float32)
  start = 0 if shard0 else 1000
  seg = np.tile(np.arange(start, start + t, dtype=np.int32), (2, 1))
  seg[1, t // 3:] = np.arange(t - t // 3, dtype=np.int32)
  if shard0:
    k[:, :prefix] = 0.0
    v[:, :prefix] = 0.0
    seg[0] = np.maximum(np.arange(t, dtype=np.int32) - 70, -1)
  return q, k, v, seg, g


@functools.partial(jax.jit, static_argnums=(5, 6))
def _jax_halo_grads(q, k, v, seg, g, window, prefix):
  """JAX's dq, dk, dv of ``sum(g * flash_window_attention(kv_prefix))``;
  jitted once for both cases of the test below."""

  def loss(q, k, v):
    return jnp.sum(g * jpa.flash_window_attention(q, k, v, seg, window,
                                                  kv_prefix=prefix))

  return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("shard0", [False, True])
def test_window_attention_kv_prefix_gradients_match_jax(shard0):
  """dq, dk, dv (halo rows included) of the attention with ``kv_prefix``
  through the port's autograd Function -- its dq and dk/dv wrappers, plain
  on the CPU -- vs ``jax.grad`` of ``flash_window_attention(kv_prefix=...)``
  through the Pallas ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode
  (``tests/test_flash_attention.py:129-166``)."""
  prefix, t, window = 128, 256, 128
  q, k, v, seg, g = _halo_inputs(prefix, t, shard0, seed=1)
  with pltpu.force_tpu_interpret_mode():
    want = _jax_halo_grads(*(jnp.asarray(z) for z in (q, k, v, seg, g)),
                           window, prefix)
  qkv = [torch.tensor(z).requires_grad_() for z in (q, k, v)]
  out, _ = wa.window_attention(*qkv, torch.tensor(seg), window,
                               kv_prefix=prefix)
  got = torch.autograd.grad(out, qkv, torch.tensor(g))
  _assert_grads(got, want, ("dq", "dk", "dv"), atol=ATTN_GRAD_ATOL)
  halo = got[1][:, :prefix].abs().amax()
  if shard0:
    # Shard 0's zero halo is masked for every row: no gradient reaches it,
    # and the left-padded rows get none either.
    assert halo == 0 and not got[2][:, :prefix].any()
    assert not got[0][0, :70].any()
  else:
    # Both rows' halo keys get a gradient, with and without a document.
    assert (got[1][:, :prefix].abs().amax(dim=(1, 2, 3)) > 0).all()
    assert (got[2][:, :prefix].abs().amax(dim=(1, 2, 3)) > 0).all()


def test_window_attention_kv_prefix_backward_is_the_unsharded_band():
  """The halo backward of a sequence's second half equals the unsharded
  backward under a cotangent that is zero on the first half: dq on the
  second half's rows, dk and dv on the halo's and the half's keys."""
  window, t = 64, 192
  half = t // 2
  rng = np.random.default_rng(2)
  q, k, v, g = (torch.tensor(rng.standard_normal(s, dtype=np.float32))
                for s in ((2, t, 2, 16), (2, t, 1, 16), (2, t, 1, 16),
                          (2, t, 2, 16)))
  seg = torch.arange(t)[None].repeat(2, 1)
  seg[1, 150:] = torch.arange(t - 150)
  g[:, :half] = 0.0
  out, lse = wa.window_attention(q, k, v, seg, window)
  dq, dk, dv = wa.window_attention_backward_plain(q, k, v, seg, out, lse, g,
                                                  window)
  lo = half - window
  out_h, lse_h = wa.window_attention(q[:, half:], k[:, lo:], v[:, lo:],
                                     seg[:, half:], window, kv_prefix=window)
  dq_h, dk_h, dv_h = wa.window_attention_backward_plain(
      q[:, half:], k[:, lo:], v[:, lo:], seg[:, half:], out_h, lse_h,
      g[:, half:], window, kv_prefix=window)
  tol = dict(atol=1e-6, rtol=1e-5)
  torch.testing.assert_close(dq_h, dq[:, half:], **tol)
  torch.testing.assert_close(dk_h, dk[:, lo:], **tol)
  torch.testing.assert_close(dv_h, dv[:, lo:], **tol)
  assert not dk[:, :lo].any()  # keys before the halo feed no second-half row


# -- sequence_sharded_attention ------------------------------------------------

def test_sequence_sharded_attention_gradients_match_jax():
  """The halo exchange's gradient on a (1, 4) mesh, 128 tokens a shard (one
  window), with documents that start inside shards 1 and 2: each shard's
  halo dk/dv return to the shard that sent them, shard 0's zero halo gets
  none (``tests/test_flash_attention.py:169-201``)."""
  jspec, tspec = _spec_pair()
  t, window = 512, 128
  rng = np.random.default_rng(3)
  q = rng.standard_normal((1, t, 2, 128), dtype=np.float32)
  k = rng.standard_normal((1, t, 1, 128), dtype=np.float32)
  v = rng.standard_normal((1, t, 1, 128), dtype=np.float32)
  g = rng.standard_normal((1, t, 2, 128), dtype=np.float32)
  seg = np.arange(t, dtype=np.int32)[None]
  seg[0, 150:] = np.arange(t - 150)  # a document starts inside shard 1
  seg[0, 350:] = np.arange(t - 350)  # and another inside shard 2

  def loss_j(q, k, v):
    out = jsp.sequence_sharded_attention(q, k, v, jnp.asarray(seg), window,
                                         jspec)
    return jnp.sum(out * jnp.asarray(g))

  with pltpu.force_tpu_interpret_mode():
    want = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  qkv = [torch.tensor(z).requires_grad_() for z in (q, k, v)]
  before = wa.dq_kv_prefix_launches, wa.dkv_kv_prefix_launches
  out = sp_attention.sequence_sharded_attention(*qkv, torch.tensor(seg),
                                                window, tspec)
  got = torch.autograd.grad(out, qkv, torch.tensor(g))
  # CPU tensors take the plain versions: no kernel launched.
  assert (wa.dq_kv_prefix_launches, wa.dkv_kv_prefix_launches) == before
  _assert_grads(got, want, ("dq", "dk", "dv"), atol=SP_ATTN_GRAD_ATOL)
  # And the port's unsharded gradient.
  qkv_ref = [z.detach().clone().requires_grad_() for z in qkv]
  out_ref, _ = wa.window_attention(*qkv_ref, torch.tensor(seg), window)
  for a, b in zip(got, torch.autograd.grad(out_ref, qkv_ref, torch.tensor(g))):
    torch.testing.assert_close(a, b, atol=SP_ATTN_GRAD_ATOL, rtol=0)


# -- the sharded kernel-path scan ----------------------------------------------

def _scan_inputs(b, t, d, seed):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((b, t, d), dtype=np.float32)
  a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, d))))).astype(
      np.float32)
  a[:, t // 2 + 5] = 0.0  # a document start inside a shard
  h0 = rng.standard_normal((b, d), dtype=np.float32)
  gy = rng.standard_normal((b, t, d), dtype=np.float32)
  gh = rng.standard_normal((b, d), dtype=np.float32)
  return x, a, h0, gy, gh


@pytest.mark.parametrize("dtype,reverse,with_h0,mesh", [
    ("float32", False, True, (1, 4)),
    ("float32", True, False, (1, 4)),
    ("bfloat16", True, True, (2, 4)),
])
def test_sharded_kernel_scan_gradients_match_jax(dtype, reverse, with_h0,
                                                 mesh):
  """``dx``, ``da`` and ``dh0`` of ``linear_scan(LINEAR_PALLAS,
  sharding_spec)``: the port's sharded autograd Function (the psum of the
  ``h_last`` cotangents, the cotangent scan with the product of ``a``, the
  reversed correction, the corrected ``h0`` at each boundary) vs ``jax.grad``
  through ``_lru_bwd`` in interpret mode (``tests/test_scan.py:132-150``)."""
  jspec, tspec = _spec_pair(mesh)
  x, a, h0, gy, gh = _scan_inputs(2, 32, 24, seed=4)
  got, want = _scan_grads(jspec, tspec, x, a, h0 if with_h0 else None, gy,
                          gh, reverse, dtype)
  tol = SCAN_TOL if dtype == "float32" else BF16_GRAD_TOL
  _assert_grads(got[:2], want[:2], ("dx", "da"), **tol)
  if with_h0:
    _assert_grads(got[2:], want[2:], ("dh0",), **SCAN_TOL)


def _scan_grads(jspec, tspec, x, a, h0, gy, gh, reverse=False,
                dtype="float32"):
  """(the port's, JAX's) gradients of ``sum(y * gy) + sum(h_last * gh)``
  with respect to ``x``, ``a`` and, if given, ``h0``."""
  jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
  argnums = (0, 1) if h0 is None else (0, 1, 2)
  h0 = np.zeros(x.shape[::2], np.float32) if h0 is None else h0

  def loss_j(x, a, h0):
    y, h = jscan.linear_scan(x, a, h0 if len(argnums) == 3 else None,
                             reverse=reverse,
                             scan_type=jcommon.ScanType.LINEAR_PALLAS,
                             sharding_spec=jspec)
    return (jnp.sum(y.astype(jnp.float32) * jnp.asarray(gy))
            + jnp.sum(h * jnp.asarray(gh)))

  with pltpu.force_tpu_interpret_mode():
    want = jax.jit(jax.grad(loss_j, argnums=argnums))(
        jnp.asarray(x, jdt), jnp.asarray(a, jdt), jnp.asarray(h0))
  inputs = [torch.tensor(x).to(tdt).requires_grad_(),
            torch.tensor(a).to(tdt).requires_grad_(),
            torch.tensor(h0).requires_grad_()]
  before = lru_scan.backward_a_prod_launches
  y, h = scan.linear_scan(inputs[0], inputs[1],
                          inputs[2] if len(argnums) == 3 else None,
                          reverse=reverse,
                          scan_type=common.ScanType.LINEAR_PALLAS,
                          sharding_spec=tspec)
  loss = ((y.float() * torch.tensor(gy)).sum()
          + (h * torch.tensor(gh)).sum())
  got = torch.autograd.grad(loss, inputs[:len(argnums)])
  assert lru_scan.backward_a_prod_launches == before  # plain on the CPU
  assert [z.dtype for z in got[:2]] == [tdt, tdt]
  return got, want


def test_sharded_kernel_scan_index_group_gradients():
  """A (1, 4) mesh split into the index groups [[0, 1], [2, 3]]: two
  independent scan domains, each from h0; ``h_last`` is the first group's
  final state (shard 0's), as in the forward.

  Under the ``y`` cotangent the port's gradients equal JAX's. Under the
  ``h_last`` cotangent they are the gradient of what the forward returns:
  the first group's scan alone, zero on the second group. JAX's differ
  there (ROADMAP queue 3): its ``shard_map`` hands each of the 4 shards a
  quarter of the cotangent of the output it treats as replicated, and the
  ``psum`` over each group gives each group half, so JAX's gradient is that
  of the mean of the two groups' final states, not of the state it returns.
  """
  jspec, tspec = _spec_pair(groups=[[0, 1], [2, 3]])
  x, a, h0, gy, gh = _scan_inputs(2, 64, 24, seed=8)
  got, want = _scan_grads(jspec, tspec, x, a, h0, gy, gh)
  # Each group's own scan, unsharded: its gradients under the y cotangent
  # and, apart, under the h_last cotangent.
  by_y, by_h = [], []
  for sl in (slice(0, 32), slice(32, 64)):
    inputs = [torch.tensor(z[:, sl]).requires_grad_() for z in (x, a)]
    inputs.append(torch.tensor(h0).requires_grad_())
    y, h = lru_scan.lru_scan(*inputs)
    by_y.append(torch.autograd.grad((y * torch.tensor(gy[:, sl])).sum(),
                                    inputs, retain_graph=True))
    by_h.append(torch.autograd.grad((h * torch.tensor(gh)).sum(), inputs))

  def combine(parts, w_first, w_second):
    return [torch.cat([w_first * parts[0][i], w_second * parts[1][i]], dim=1)
            for i in (0, 1)] + [w_first * parts[0][2] + w_second * parts[1][2]]

  y_part = combine(by_y, 1.0, 1.0)
  port_want = [a + b for a, b in zip(y_part, combine(by_h, 1.0, 0.0))]
  jax_want = [a + b for a, b in zip(y_part, combine(by_h, 0.5, 0.5))]
  for name, g, w in zip(("dx", "da", "dh0"), got, port_want):
    torch.testing.assert_close(g, w, **SCAN_TOL, msg=name)
  _assert_grads(jax_want, want, ("dx", "da", "dh0"), **SCAN_TOL)


def test_sharded_kernel_scan_gradients_equal_unsharded():
  """In float32 the sharded gradients equal the unsharded scan's up to
  reassociation, forward and reverse."""
  _, tspec = _spec_pair((2, 4))
  x, a, h0, gy, gh = (torch.tensor(z) for z in _scan_inputs(2, 64, 8, 5))
  for reverse in (False, True):
    grads = []
    for spec in (tspec, None):
      inputs = [z.clone().requires_grad_() for z in (x, a, h0)]
      y, h = scan.linear_scan(*inputs, reverse=reverse, sharding_spec=spec)
      grads.append(torch.autograd.grad((y * gy).sum() + (h * gh).sum(),
                                       inputs))
    for got, want in zip(*grads):
      torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_psum_of_shard_cotangents():
  """Each shard receives the sum in shard order; None counts as zero."""
  cpu = [torch.device("cpu")] * 3
  a, b = torch.tensor([1.0, 2.0]), torch.tensor([0.5, -1.0])
  for got in sharding.psum([a, None, b], cpu):
    torch.testing.assert_close(got, a + b)
  assert sharding.psum([None, None], cpu[:2]) == [None, None]


# -- the whole model -----------------------------------------------------------

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


T = 1024  # 4 shards of 256 tokens, two windows each


def _training_batch():
  """One row of 1024 tokens holding 700 real ones, right-padded, so its pad
  positions fill shard 3 and part of shard 2; the loss covers the second
  half of the real tokens. (One row: interpret-mode Pallas under
  ``shard_map`` costs JAX ~10 s of CPU time a row.)"""
  rng = np.random.default_rng(6)
  tokens = rng.integers(3, 48, (1, T)).astype(np.int32)
  tokens[:, 0] = 1
  tokens[:, 700:] = PAD
  mask = np.zeros(tokens.shape, bool)
  mask[:, 350:700] = True
  return tokens, mask


@pytest.fixture(scope="module")
def jax_sp_training():
  """(tiny config, seeded params, the JAX SP model, its loss and gradient
  tree, and one JAX ``train_step``'s loss and params) on a (1, 4) mesh."""
  config = _tiny_config(jcommon.ScanType.ASSOCIATIVE_NATIVE)
  jspec, _ = _spec_pair()
  model = jgriffin.Griffin(config, scan_sharding_spec=jspec,
                           dtype=jnp.float32, param_dtype=jnp.float32,
                           gradient_checkpointing=False,
                           use_flash_attention=True)
  # Only the tree's shapes: every leaf is drawn from numpy below.
  unsharded = jgriffin.Griffin(config, dtype=jnp.float32,
                               param_dtype=jnp.float32,
                               gradient_checkpointing=False)
  shapes = jax.eval_shape(unsharded.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 4), jnp.int32),
                          jnp.arange(4)[None])["params"]
  rng = np.random.default_rng(7)
  params = jax.tree_util.tree_map(
      lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32),
      shapes)
  tokens, mask = (jnp.asarray(z) for z in _training_batch())
  lr = 1e-3
  optimizer = jtrainer.make_optimizer(lr)
  params_j = jax.tree_util.tree_map(jnp.array, params)
  with pltpu.force_tpu_interpret_mode():
    # train_step's own value_and_grad, then its update (one compile).
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtrainer.forward_and_loss_fn(
            p, model=model, input_tokens=tokens, input_mask=mask,
            positions=jtrainer.get_positions(tokens, PAD))))(params_j)
    # Wait inside the context: the interpret mode's callbacks deadlock with
    # a dispatch from this thread while they run.
    loss, grads = jax.block_until_ready((loss, grads))
  # ... and train_step's update, in one program.
  stepped = jax.jit(lambda p, g: optax.apply_updates(
      p, optimizer.update(g, optimizer.init(p), p)[0]))(params_j, grads)
  stepped = jax.tree_util.tree_map(np.asarray, stepped)
  return dict(config=config, params=params, loss=float(loss), grads=grads,
              stepped=stepped, lr=lr)


def _port_sp_model(jax_case, spec):
  """The port's tiny Griffin through its kernel paths (the sharded scan with
  the product, the halo attention), remat on, as it trains."""
  config = jax_case["config"]._replace(
      scan_type=jcommon.ScanType.LINEAR_PALLAS)
  return convert.griffin_from_flax_params(
      jax_case["params"], _port_config(config), device="cpu",
      dtype=torch.float32, use_flash_attention=True,
      scan_sharding_spec=spec)


def test_sequence_parallel_griffin_loss_and_gradients_match_jax(
    jax_sp_training):
  """A tiny Griffin (R, A, R; window 128; 1024 tokens, 256 a shard) under SP
  on a (1, 4) mesh: the port's loss and every gradient leaf vs the JAX
  ``forward_and_loss_fn`` gradient with the same spec and weights. JAX
  scans with ``ASSOCIATIVE_NATIVE`` (its ``LINEAR_*`` scans compile for tens
  of seconds here) and takes its halo path, the flash kernels in interpret
  mode."""
  _, tspec = _spec_pair()
  port = _port_sp_model(jax_sp_training, tspec)
  tokens, mask = (torch.tensor(z) for z in _training_batch())
  calls = []
  real = sp_attention.sequence_sharded_attention

  def spy(*args, **kwargs):
    calls.append(args[0].shape)
    return real(*args, **kwargs)

  sp_attention.sequence_sharded_attention = spy
  try:
    loss = trainer.accumulate_gradients(port, PAD, tokens.long(), mask)
  finally:
    sp_attention.sequence_sharded_attention = real
  # One halo attention in the forward and one in the remat replay.
  assert calls == [(1, T, 2, 16)] * 2
  np.testing.assert_allclose(float(loss), jax_sp_training["loss"], rtol=1e-5)
  want = convert.state_dict_from_flax({"params": jax_sp_training["grads"]})
  named = dict(port.named_parameters())
  assert set(want) == set(named)
  for name, g_want in want.items():
    g_got = named[name].grad
    if name.startswith("vl_connector."):
      assert g_got is None and not g_want.any(), name
      continue
    scale = max(float(g_want.abs().max()), 1e-6)
    np.testing.assert_allclose(g_got.numpy() / scale, g_want.numpy() / scale,
                               atol=LEAF_REL_ATOL, err_msg=name)


def test_sequence_parallel_train_step_matches_jax(jax_sp_training):
  """One AdamW step (decay mask, clip 1.0, b2 0.96) of the SP model gives
  the JAX trainer's params, to the bound of
  ``test_torch_port_training.py::test_one_train_step_matches_jax``: 1% of
  lr where a gradient stands above the two frameworks' 1e-4 disagreement,
  Adam's lr per step where it does not."""
  _, tspec = _spec_pair()
  port = _port_sp_model(jax_sp_training, tspec)
  tokens, mask = (torch.tensor(z) for z in _training_batch())
  lr = jax_sp_training["lr"]
  loss = trainer.train_step(port, trainer.make_optimizer(port, lr), PAD,
                            tokens.long(), mask)
  np.testing.assert_allclose(float(loss), jax_sp_training["loss"], rtol=1e-5)
  grads = convert.state_dict_from_flax({"params": jax_sp_training["grads"]})
  want = convert.state_dict_from_flax({"params": jax_sp_training["stepped"]})
  state = port.state_dict()
  for name, p_want in want.items():
    g = grads[name].abs().numpy()
    undetermined = LEAF_REL_ATOL * g.max() / (g + 1e-8)
    tol = lr * np.minimum(2.0, 1e-2 + undetermined)
    err = np.abs(state[name].numpy() - p_want.numpy())
    assert (err <= tol).all(), (name, float((err - tol).max()))


def test_sequence_parallel_train_loop_lowers_the_loss(jax_sp_training):
  """``train_loop`` trains the SP model as any other (no mesh argument);
  a batch length that does not divide into the mesh raises before the step,
  and ``train_loop(mesh=...)`` stays refused. 512 tokens here, 128 a shard
  (one window, the halo path's least)."""
  _, tspec = _spec_pair()
  port = _port_sp_model(jax_sp_training, tspec)
  tokens, mask = (z[:, :T // 2] for z in _training_batch())
  batch = data.TrainingInput(tokens, mask)
  logged = []
  tl.train_loop(port, [batch] * 2,
                tl.TrainingConfig(learning_rate=1e-2, eval_every_n=1),
                log_metrics=lambda metrics, step: logged.append(metrics),
                device="cpu")
  losses = [m["train_loss"] for m in logged]
  assert len(losses) == 2 and np.isfinite(losses).all()
  assert losses[1] < losses[0]
  val = trainer.validation_step(port, PAD, torch.tensor(tokens).long(),
                                torch.tensor(mask))
  assert float(val) < losses[1]

  before = {n: p.clone() for n, p in port.state_dict().items()}
  odd = data.TrainingInput(tokens[:, :T // 2 - 2], mask[:, :T // 2 - 2])
  with pytest.raises(ValueError, match="divide"):
    tl.train_loop(port, [odd], tl.TrainingConfig(eval_every_n=1),
                  log_metrics=lambda *_: None, device="cpu")
  for name, p in port.state_dict().items():
    assert torch.equal(p, before[name]), name
  with pytest.raises(NotImplementedError, match="scan_sharding_spec"):
    tl.train_loop(port, [batch], tl.TrainingConfig(), device="cpu",
                  mesh=tspec.mesh)
