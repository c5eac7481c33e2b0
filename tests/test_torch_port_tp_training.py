"""DP x TP training: the port's sharded steps and loop against JAX's.

A tiny Griffin (width 16, two heads of 8, blocks R and A, window 4, vocab
32, a connector of width 12, float32, ``LINEAR_NATIVE`` scans, seeded
normal weights of std 0.3 in the JAX tree's shapes) in both packages, on
meshes of ``["cpu"] * n`` against ``jax.devices()[:n]``: ``(1, 2)``,
``(2, 2)``, ``(data, sequence, model) = (2, 2, 2)`` (the sequence axis
shards nothing) and a 4-way model axis on which the two heads do not divide
(the gates replicate; each shard evaluates the heads covering its
features). The batch is ragged, so the data rows hold different numbers of
targets and only the global token-weighted mean matches JAX's loss.

Held to JAX's own tolerances: one sharded step's loss (rtol 1e-4) and
weights (atol 2e-5; ``test_training.py:209-213``), the sharded LoRA step
on a bf16 and an int8 base (``test_lora.py:397-444, 509-554``) and
``train_loop(mesh=)``, full and LoRA (losses rtol 1e-5, weights atol 1e-5;
``test_train_loop.py:303-362``). Accumulation and resume on the mesh are
held to the port's own unsharded loop and uninterrupted run; the optimizer
state's layouts (``opt_state_shardings``) to JAX's spec for spec. Every JAX
call is jitted, once a module.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.ops import quantization as jquant
from cadence_gemma_tpu.parallel import partitioning as jpart
from cadence_gemma_tpu.parallel import sharding as jsharding
from cadence_gemma_tpu.training import data as jdata
from cadence_gemma_tpu.training import lora as jlora
from cadence_gemma_tpu.training import train_loop as jtl
from cadence_gemma_tpu.training import trainer as jtrainer
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel
from cadence_gemma_tpu_torch.training import data
from cadence_gemma_tpu_torch.training import lora
from cadence_gemma_tpu_torch.training import train_loop as tl
from cadence_gemma_tpu_torch.training import trainer
from tests import test_torch_port_partitioning as part_tests

LR = 1e-3
MESHES = {
    "(1, 2)": ((1, 2), ("data", "model")),
    "(2, 2)": ((2, 2), ("data", "model")),
    "(2, 2, 2)": ((2, 2, 2), ("data", "sequence", "model")),
    "4-way, heads indivisible": ((1, 4), ("data", "model")),
}


def _jax_config():
  return jcommon.GriffinConfig(
      vocab_size=32, width=16, mlp_expanded_width=32, num_heads=2,
      block_types=(jcommon.TemporalBlockType.RECURRENT,
                   jcommon.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=4,
      logits_soft_cap=30.0, lru_width=16,
      scan_type=jcommon.ScanType.LINEAR_NATIVE, vision_tokens=2,
      vision_width=8, vl_expanded_width=12)


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types)
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


def _jax_model(**kwargs):
  return jgriffin.Griffin(_jax_config(), dtype=jnp.float32,
                          param_dtype=jnp.float32,
                          gradient_checkpointing=False, **kwargs)


def _seeded_params(model, seed: int):
  rng = np.random.default_rng(seed)
  shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.ones((1, 4), jnp.int32),
                          jnp.arange(4)[None])["params"]
  return jax.tree_util.tree_map(
      lambda x: (0.3 * rng.standard_normal(x.shape)).astype(np.float32),
      shapes)


def _port_model(params, **kwargs):
  return convert.griffin_from_flax_params(
      params, _port_config(_jax_config()), device="cpu", dtype=torch.float32,
      **kwargs)


def _batch(seed=0, b=4, t=10, image=True):
  """A ragged batch: rows right-padded after 10, 6, 8 and 4 tokens, each
  row's loss over its real tokens after the third."""
  rng = np.random.default_rng(seed)
  tokens = rng.integers(3, 32, (b, t)).astype(np.int32)
  tokens[:, 0] = 1
  mask = np.zeros((b, t), bool)
  for row, real in enumerate((10, 6, 8, 4)[:b]):
    tokens[row, real:] = 0
    mask[row, 3:real] = True
  img = (rng.standard_normal((b, 2, 8)).astype(np.float32) if image
         else None)
  return tokens, mask, img


def _meshes(name):
  shape, names = MESHES[name]
  n = int(np.prod(shape))
  return (sharding.make_mesh(shape, names, devices=["cpu"] * n),
          jsharding.make_mesh(shape, names, jax.devices()[:n]))


def _port_tree(tree):
  return convert.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, tree))


def _assert_state_close(got, want_tree, atol):
  want = _port_tree(want_tree)
  for name, value in want.items():
    np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                               atol=atol, rtol=0, err_msg=name)


def _loader_batches(n=3):
  return [_batch(seed=20 + i, image=False)[:2] for i in range(n)]


def _jax_loop(model, params, batches, cfg, mesh):
  logged = []
  out = jtl.train_loop(
      model, jax.tree_util.tree_map(jnp.asarray, params),
      [jdata.TrainingInput(t, m) for t, m in batches], cfg, pad_id=0,
      log_metrics=lambda m, s: logged.append(m["train_loss"]), mesh=mesh)
  return jax.tree_util.tree_map(np.asarray, out), logged


def _port_loop(model, batches, cfg, mesh, **kwargs):
  logged = []
  tl.train_loop(model, [data.TrainingInput(t, m) for t, m in batches], cfg,
                pad_id=0, device="cpu", mesh=mesh,
                log_metrics=lambda m, s: logged.append(m["train_loss"]),
                **kwargs)
  return logged


def _jax_references(rank: int):
  """JAX on the (2, 2) mesh from seeded weights: one step of the sharded
  step (``make_sharded_train_step``, or ``make_sharded_lora_step`` with
  adapters of ``rank``) on the first batch, and ``train_loop(mesh=)`` over
  three batches (full) or two (LoRA), whose step is the same program (the
  persistent compilation cache serves it)."""
  jmodel = _jax_model(lora_rank=rank)
  params = _seeded_params(jmodel, 3)
  batches = _loader_batches()
  _, jmesh = _meshes("(2, 2)")
  tokens, mask = batches[0]
  if rank:
    adapters, base = jlora.split_lora(params)
    tx = jlora.make_optimizer(LR)
    step_fn, shard = jlora.make_sharded_lora_step(jmodel, tx, jmesh, 0,
                                                  adapters, base)
    sh_a, sh_b = shard(jax.tree_util.tree_map(jnp.asarray, adapters),
                       jax.tree_util.tree_map(jnp.asarray, base))
    loss, after, _ = step_fn(sh_a, sh_b, tx.init(sh_a), tokens, mask, None)
  else:
    tx = jtrainer.make_optimizer(LR)
    step_fn, shard = jtrainer.make_sharded_train_step(
        jmodel, tx, jmesh, pad_id=0, example_params=params)
    placed = shard(jax.tree_util.tree_map(jnp.asarray, params))
    loss, after, _ = step_fn(placed, tx.init(placed), tokens, mask, None)
  step = (float(loss), jax.tree_util.tree_map(np.asarray, after))
  steps = 2 if rank else 3
  loop = _jax_loop(jmodel, params, batches, jtl.TrainingConfig(
      learning_rate=LR, max_steps=steps, eval_every_n=1,
      checkpoint_every_n=None, lora=bool(rank)), jmesh)
  return params, batches, step, loop


@pytest.fixture(scope="module")
def full_ref():
  return _jax_references(0)


@pytest.fixture(scope="module")
def lora_ref():
  return _jax_references(2)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_train_step_matches_jax(full_ref, mesh_name):
  """One step of ``make_sharded_train_step`` on each mesh against JAX's:
  loss rtol 1e-4, weights atol 2e-5; the model holds the new weights and
  its pieces really are split."""
  params, batches, (want_loss, want), _ = full_ref
  model = _port_model(params)
  mesh, _ = _meshes(mesh_name)
  factory = functools.partial(trainer.make_optimizer, learning_rate=LR)
  step_fn, shard_params = trainer.make_sharded_train_step(
      model, factory, mesh, pad_id=0, example_params=model.state_dict())
  sharded = shard_params(model.state_dict())
  optimizer = factory(sharded)
  tokens, mask = (torch.tensor(x) for x in batches[0])
  loss, sharded, optimizer = step_fn(sharded, optimizer, tokens.long(), mask)
  np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
  _assert_state_close(model.state_dict(), want, 2e-5)
  shape, names = MESHES[mesh_name]
  assert len(sharded.rows) == shape[0]
  tp = sharded.rows[0]
  model_size = shape[names.index("model")]
  assert len(tp.blocks[0].temporal.s.shards) == model_size
  # Every logical element trains once: the pieces partition the tree.
  counts = {}
  for name, t in sharded.named_parameters():
    counts[name] = counts.get(name, 0) + t.numel()
  assert counts == {n: p.numel() for n, p in model.named_parameters()}
  if model_size == 4:  # two heads on four shards: the gates replicate
    assert not tp.blocks[0].temporal.gates_split
    assert any(a.dim is not None for a in tp.aliases)


@pytest.mark.parametrize("mesh_name", ["(2, 2)", "4-way, heads indivisible"])
def test_reduced_gradients_are_the_unsharded_gradients(mesh_name):
  """After ``reduce_gradients`` row 0's pieces hold the unsharded model's
  gradient tree, leaf for leaf (the clip's global norm is the tree's)."""
  params = _seeded_params(_jax_model(), 1)
  model, ref = _port_model(params), _port_model(params)
  tokens, mask, img = (torch.tensor(x) for x in _batch(seed=3))
  trainer.accumulate_gradients(ref, 0, tokens.long(), mask, img_embed=img)
  mesh, _ = _meshes(mesh_name)
  _, shard_params = trainer.make_sharded_train_step(
      model, lambda p: None, mesh, 0, example_params=model.state_dict())
  sharded = shard_params(model.state_dict())
  trainer.sharded_accumulate_gradients(sharded, 0, tokens.long(), mask,
                                       img_embed=img)
  sharded.reduce_gradients()
  got = sharded.gradients()
  for name, p in ref.named_parameters():
    torch.testing.assert_close(got[name], p.grad, atol=1e-5, rtol=1e-5,
                               msg=name)
  assert all(t.grad is None for tp in sharded.rows[1:]
             for t in tp.train_tensors())


@pytest.mark.parametrize("base", ["bf16", "int8"])
def test_sharded_lora_step_matches_jax(lora_ref, base):
  """``make_sharded_lora_step`` on (2, 2) against JAX's on a float base and
  on an int8 (``quantize_params``) base: loss rtol 1e-5, adapters atol
  1e-5; the base is split and keeps no gradient."""
  quantized = base == "int8"
  params, batches, (want_loss, want), _ = lora_ref
  tokens, mask = batches[0]
  jadapters, jbase = jlora.split_lora(params)
  if quantized:
    jbase = jax.tree_util.tree_map(np.asarray, jquant.quantize_params(jbase))
    jmodel = _jax_model(lora_rank=2, quantized=True)
    tx = jlora.make_optimizer(LR)
    _, jmesh = _meshes("(2, 2)")
    jstep, jshard = jlora.make_sharded_lora_step(jmodel, tx, jmesh, 0,
                                                 jadapters, jbase)
    sh_a, sh_b = jshard(jax.tree_util.tree_map(jnp.asarray, jadapters),
                        jax.tree_util.tree_map(jnp.asarray, jbase))
    want_loss, want, _ = jstep(sh_a, sh_b, tx.init(sh_a), tokens, mask, None)

  model = convert.griffin_from_flax_params(
      jlora.merge_params(jbase, jadapters), _port_config(_jax_config()),
      device="cpu", dtype=torch.float32, quantized=quantized, lora_rank=2)
  adapters, pbase = lora.split_lora(model.state_dict())
  mesh, _ = _meshes("(2, 2)")
  factory = lambda p: lora.make_optimizer(lora.lora_parameters(p), LR)
  step_fn, shard_fn = lora.make_sharded_lora_step(model, factory, mesh, 0,
                                                  adapters, pbase)
  sharded = shard_fn(adapters, pbase)
  before = {k: v.clone() for k, v in pbase.items()}
  loss, sharded, _ = step_fn(sharded, factory(sharded),
                             torch.tensor(tokens).long(), torch.tensor(mask))
  np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
  _assert_state_close(model.state_dict(), want, 1e-5)
  for name, value in lora.split_lora(model.state_dict())[1].items():
    assert torch.equal(value, before[name]), name
  if quantized:
    shard = sharded.rows[0].blocks[0].temporal.s.shards[0]
    assert shard.linear_x.kernel_q.dtype == torch.int8
    assert shard.linear_x.kernel_q.shape[0] == 8
  assert not any(p.tensor.requires_grad for tp in sharded.rows
                 for n, pieces in tp.leaves.items()
                 if not lora.is_lora_path(n) for p in pieces)


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_train_loop_mesh_matches_jax(full_ref, lora_ref, kind):
  """``train_loop(mesh=)`` on (2, 2) against JAX's: full (3 steps) and LoRA
  (2 steps, ``lora_b`` nonzero) -- losses rtol 1e-5, weights atol 1e-5."""
  rank = 2 if kind == "lora" else 0
  params, batches, _, (want, want_losses) = lora_ref if rank else full_ref
  mesh, _ = _meshes("(2, 2)")
  model = _port_model(params, lora_rank=rank)
  cfg = tl.TrainingConfig(learning_rate=LR, max_steps=len(want_losses),
                          eval_every_n=1, checkpoint_every_n=None,
                          lora=bool(rank))
  losses = _port_loop(model, batches, cfg, mesh)
  assert len(losses) == (2 if rank else 3)
  np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
  _assert_state_close(model.state_dict(), want, 1e-5)


def test_accumulation_composes_with_the_mesh():
  """Two-microbatch windows on (2, 2) give the unsharded loop's weights
  (``test_train_loop.py:263-290``), with validation on the mesh."""
  params = _seeded_params(_jax_model(), 4)
  batches = [b for b in _loader_batches(2) for _ in range(2)]
  cfg = tl.TrainingConfig(learning_rate=1e-3, max_steps=4, eval_every_n=2,
                          checkpoint_every_n=None,
                          gradient_accumulation_steps=2)
  mesh, _ = _meshes("(2, 2)")
  one, sharded = _port_model(params), _port_model(params)
  val = [data.TrainingInput(*batches[0])]
  want = _port_loop(one, batches, cfg, None, validation_data=val)
  got = _port_loop(sharded, batches, cfg, mesh, validation_data=val)
  np.testing.assert_allclose(got, want, rtol=1e-5)
  for name, value in one.state_dict().items():
    torch.testing.assert_close(sharded.state_dict()[name], value, atol=1e-5,
                               rtol=0, msg=name)


def test_mesh_resume_matches_uninterrupted(tmp_path):
  """A (2, 2) run checkpointed within an accumulation window, after an
  update, and resumed on the mesh equals the uninterrupted run
  (``test_train_loop.py:363-393``); the state is the logical tree: whole
  leaves by name, the window's gradients among them."""
  accumulate = 2
  params = _seeded_params(_jax_model(), 5)
  batches = _loader_batches(4)
  mesh, _ = _meshes("(2, 2)")
  base = dict(learning_rate=1e-3, eval_every_n=100, checkpoint_every_n=None,
              gradient_accumulation_steps=accumulate)
  full = _port_model(params)
  _port_loop(full, batches, tl.TrainingConfig(max_steps=4, **base), mesh)
  first = _port_model(params)
  _port_loop(first, batches, tl.TrainingConfig(**{
      **base, "max_steps": 3, "checkpoint_every_n": 3,
      "checkpoint_dir": str(tmp_path)}), mesh)
  saved, state, step = checkpoint_io.load_train_state(
      os.path.join(tmp_path, "step_3"), device="cpu")
  assert step == 3 and state["micro_step"] == 1
  assert set(state["optimizer_leaves"]) == set(saved)
  for name, leaf in state["optimizer_leaves"].items():
    assert leaf["exp_avg"].shape == saved[name].shape, name
  assert state["grads"]  # the text batches reach all but the connector
  for name, grad in state["grads"].items():
    assert grad.shape == saved[name].shape, name
  resumed = _port_model(params)
  _port_loop(resumed, batches, tl.TrainingConfig(
      max_steps=4, resume_from=os.path.join(tmp_path, "step_3"), **base),
             mesh)
  for name, value in full.state_dict().items():
    torch.testing.assert_close(resumed.state_dict()[name], value, atol=1e-6,
                               rtol=0, msg=name)


def test_two_stage_sft_passes_the_mesh_to_stage_2_alone(monkeypatch):
  """``two_stage_sft(mesh=)``: stage 1 on one device, stage 2 on the mesh
  (JAX ``train_loop.py:386-399``), the same weights as without a mesh."""
  params = _seeded_params(_jax_model(), 6)
  mesh, _ = _meshes("(2, 2)")
  tokens, mask, img = _batch(seed=7)
  batches = [data.TrainingInput(tokens, mask, pixels=img)] * 2
  stage = tl.TrainingConfig(learning_rate=1e-3, max_steps=2, eval_every_n=100,
                            checkpoint_every_n=None)
  run = tl.train_loop
  meshes = []

  def recording(*args, **kwargs):
    meshes.append(kwargs.get("mesh"))
    return run(*args, **kwargs)

  monkeypatch.setattr(tl, "train_loop", recording)
  encode = lambda pixels: pixels
  one, sharded = _port_model(params), _port_model(params)
  tl.two_stage_sft(one, lambda: batches, stage, stage, device="cpu",
                   encode_image=encode)
  tl.two_stage_sft(sharded, lambda: batches, stage, stage, device="cpu",
                   encode_image=encode, mesh=mesh)
  assert meshes == [None, None, None, mesh]
  for name, value in one.state_dict().items():
    torch.testing.assert_close(sharded.state_dict()[name], value, atol=1e-5,
                               rtol=0, msg=name)


def test_refresh_copies_what_is_not_a_view():
  """A piece that is a copy (another card's, in a mesh over several) takes
  the update, and the model and the other rows receive it."""
  params = _seeded_params(_jax_model(), 8)
  mesh, _ = _meshes("(2, 2)")
  tokens, mask, img = (torch.tensor(x) for x in _batch(seed=9))
  results = []
  for copies in (False, True):
    model = _port_model(params)
    factory = functools.partial(trainer.make_optimizer, learning_rate=LR)
    step_fn, shard_params = trainer.make_sharded_train_step(
        model, factory, mesh, 0, example_params=model.state_dict())
    sharded = shard_params(model.state_dict())
    if copies:
      for tp in sharded.rows:
        for t in tp.train_tensors():
          t.data = t.data.clone()
    step_fn(sharded, factory(sharded), tokens.long(), mask, img)
    results.append(model.state_dict())
    if copies:
      for tp in sharded.rows:
        for name, pieces in tp.leaves.items():
          for piece in pieces:
            torch.testing.assert_close(
                piece.tensor, tensor_parallel.region(
                    model.state_dict()[name], piece), msg=name)
  for name, value in results[0].items():
    torch.testing.assert_close(results[1][name], value, msg=name)


@pytest.mark.parametrize("tree,mesh_name", [
    ("bf16", "(2, 2)"), ("bf16", "4-way, heads indivisible"),
    ("lora", "(2, 2)"), ("int8", "(2, 2)")])
def test_opt_state_shardings_equal_jax(tree, mesh_name):
  """Adam's moments take their leaves' specs and the counter replicates,
  spec for spec against JAX's ``opt_state_shardings`` (a tiny tree, whose
  two heads replicate the gates on the 4-way axis; its LoRA adapters; its
  int8 tree), and every leaf replicates without a model axis."""
  shapes, state = part_tests._trees("tiny", tree)  # pylint: disable=protected-access
  if tree == "lora":
    shapes, _ = jlora.split_lora(shapes)
    state, _ = lora.split_lora(state)
  mesh, jmesh = _meshes(mesh_name)
  jtree = jpart.opt_state_shardings(jmesh, optax.adam(1e-3), shapes)
  adam = jtree[0]
  got = partitioning.opt_state_shardings(
      mesh, lambda p: torch.optim.Adam(list(p.parameters()), 1e-3), state)
  assert set(got) == set(state)
  assert adam.count.spec == jax.sharding.PartitionSpec()
  for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
    want = part_tests._jax_specs_as_port(  # pylint: disable=protected-access
        jax.tree_util.tree_map(lambda s: s.spec, getattr(adam, jkey)), shapes)
    for name, value in state.items():
      assert part_tests._normalized(got[name][key].spec, value.ndim) == (  # pylint: disable=protected-access
          want[name]), (name, key)
  assert all(s["step"].spec == () for s in got.values())
  if mesh_name.startswith("4-way"):
    gate = "blocks.0.recurrent_block.rg_lru.input_gate.w"
    assert got[gate]["exp_avg"].spec == ()
  data_only = sharding.make_mesh((4,), ("data",), devices=["cpu"] * 4)
  replicated = partitioning.opt_state_shardings(
      data_only, functools.partial(trainer.make_optimizer, learning_rate=1.0),
      state)
  assert all(s.spec == () for leaf in replicated.values()
             for s in leaf.values())


def test_mesh_errors():
  """JAX's errors: ``freeze_llm`` with a mesh, a missing ``example_params``
  with a model axis; a batch that does not divide into the data axis raises
  before any update; an SP model under a mesh names item 14g."""
  params = _seeded_params(_jax_model(), 10)
  model = _port_model(params)
  mesh, _ = _meshes("(2, 2)")
  with pytest.raises(ValueError, match="freeze_llm"):
    tl.train_loop(model, [], tl.TrainingConfig(freeze_llm=True),
                  device="cpu", mesh=mesh)
  with pytest.raises(ValueError, match="example_params"):
    trainer.make_sharded_train_step(model, lambda p: None, mesh, 0)
  tokens, mask, _ = _batch(b=3, image=False)
  before = {k: v.clone() for k, v in model.state_dict().items()}
  with pytest.raises(ValueError, match="does not divide"):
    tl.train_loop(model, [data.TrainingInput(tokens, mask)],
                  tl.TrainingConfig(), device="cpu", mesh=mesh)
  for name, value in model.state_dict().items():
    assert torch.equal(value, before[name]), name
  sp = griffin.Griffin(model.config, device="cpu", scan_sharding_spec=(
      sharding.ShardingSpec(mesh=mesh, sequence_axis_name="model")))
  with pytest.raises(NotImplementedError, match="item 14g"):
    tl.train_loop(sp, [], tl.TrainingConfig(), device="cpu", mesh=mesh)
