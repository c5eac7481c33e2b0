"""Pipeline parallelism: the port's ``GriffinPipeline`` against JAX's.

JAX's tiny config (``tests/test_pipeline.py:31-40``: width 16, two heads,
12 blocks (R, R, A) x 4, window 4, ``LINEAR_NATIVE`` scans, 3 x 12 vision
features) and the 2B's 26-block pattern (R, R, A) x 8 + (R, R) at the same
width, float32 on the CPU. The weights are seeded numpy normals in the JAX
tree's shapes, carried into the port with ``convert.state_dict_from_flax``
(through ``griffin_from_flax_params``); the batches are seeded numpy draws.
Port meshes are ``["cpu"] * n``, JAX's ``jax.devices()[:n]``.

Tolerances: logits and losses ``atol = rtol = 1e-4``
(``tests/test_torch_port_model.py:29``); every gradient leaf within 1e-4 of
its largest entry, as JAX's own pipeline test holds it; the schedule's
properties and ``stack_params`` exactly. The JAX side is its plain
``Griffin`` (one jitted program a shape), except the one direct comparison
with JAX's ``GriffinPipeline``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.ops import quantization as jquant
from cadence_gemma_tpu.parallel import pipeline as jpp
from cadence_gemma_tpu.training import trainer as jtrainer
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.parallel import pipeline
from cadence_gemma_tpu_torch.parallel import sharding

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4
JR, JA = jcommon.TemporalBlockType.RECURRENT, jcommon.TemporalBlockType.ATTENTION
PATTERNS = {"12 blocks": (JR, JR, JA) * 4,
            "26 blocks": (JR, JR, JA) * 8 + (JR, JR)}
BATCH, SEQ = 8, 6


def _jax_config(blocks: str):
  return jcommon.GriffinConfig(
      vocab_size=32, width=16, mlp_expanded_width=32, num_heads=2,
      block_types=PATTERNS[blocks], embeddings_scale_by_sqrt_dim=True,
      attention_window_size=4, logits_soft_cap=30.0, lru_width=16,
      scan_type=jcommon.ScanType.LINEAR_NATIVE, vision_tokens=3,
      vision_width=12, vl_expanded_width=20)


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types)
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


def _jax_model(blocks: str, quantized: bool = False):
  return jgriffin.Griffin(_jax_config(blocks), dtype=jnp.float32,
                          param_dtype=jnp.float32,
                          gradient_checkpointing=False, quantized=quantized)


def _seeded_params(model, seed: int):
  """Seeded normals in the JAX tree's shapes: matrices scaled by their
  fan-in (dimension -2), vectors by 0.3."""
  rng = np.random.default_rng(seed)
  shapes = jax.eval_shape(
      model.init, jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
      jnp.arange(4)[None], image=jnp.ones((1, 3, 12)))["params"]

  def draw(s):
    z = rng.standard_normal(s.shape).astype(np.float32)
    return z / np.sqrt(s.shape[-2]) if z.ndim >= 2 else 0.3 * z

  return jax.tree_util.tree_map(draw, shapes)


def _batch(seed: int = 3):
  """Tokens, positions, a mask without the first two targets, images."""
  rng = np.random.default_rng(seed)
  tokens = rng.integers(1, 32, (BATCH, SEQ)).astype(np.int32)
  pos = np.tile(np.arange(SEQ, dtype=np.int32)[None], (BATCH, 1))
  mask = np.ones((BATCH, SEQ), bool)
  mask[:, :2] = False
  img = rng.standard_normal((BATCH, 3, 12)).astype(np.float32)
  return tokens, pos, mask, img


def _t(x):
  return torch.as_tensor(np.asarray(x))


class _Pair:
  """One pattern's JAX model and weights, the port's model over the same
  weights, and JAX's plain outputs cached by case."""

  def __init__(self, blocks: str, quantized: bool = False):
    self.blocks = blocks
    base = _seeded_params(_jax_model(blocks), seed=len(PATTERNS[blocks]))
    self.params = jquant.quantize_params(base) if quantized else base
    self.jmodel = _jax_model(blocks, quantized)
    self.model = convert.griffin_from_flax_params(
        self.params, _port_config(_jax_config(blocks)), device="cpu",
        dtype=torch.float32, quantized=quantized)
    self._apply = jax.jit(self.jmodel.apply,
                          static_argnames=("return_cache",))
    self._logits = {}

  def logits(self, image: bool):
    if image not in self._logits:
      tokens, pos, _, img = _batch()
      out, _ = self._apply({"params": self.params}, tokens, pos,
                           image=img if image else None, return_cache=False)
      self._logits[image] = np.asarray(out)
    return self._logits[image]

  def pipeline(self, mesh_shape=(4,), num_microbatches=4, interleave=1):
    names = ("stage", "data")[:len(mesh_shape)]
    mesh = sharding.make_mesh(mesh_shape, names,
                              devices=["cpu"] * int(np.prod(mesh_shape)))
    pipe = pipeline.GriffinPipeline(self.model, mesh, num_microbatches,
                                    interleave=interleave)
    stacked, shared = pipe.stack_params(self.model.state_dict())
    return pipe, sharding.place_state_dict(stacked,
                                           pipe.stage_sharding(stacked)), shared


@pytest.fixture(scope="module")
def pairs():
  cache = {}

  def get(blocks: str, quantized: bool = False):
    if (blocks, quantized) not in cache:
      cache[blocks, quantized] = _Pair(blocks, quantized)
    return cache[blocks, quantized]

  return get


# -- the schedule's arithmetic -----------------------------------------------


@pytest.fixture(scope="module")
def schedule_models():
  return {blocks: (_jax_model(blocks),
                   griffin.Griffin(_port_config(_jax_config(blocks)),
                                   device="meta", dtype=torch.float32))
          for blocks in PATTERNS}


def _build(make):
  """``make()``'s result or its ValueError, and the warnings it gave."""
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    try:
      out = make()
    except ValueError as e:
      out = e
  return out, [str(w.message) for w in caught]


PROPERTIES = ("num_stages", "num_chunks", "pipelined_layers",
              "layers_per_stage", "layers_per_chunk", "schedule_steps",
              "bubble_fraction", "tail_layers")


@pytest.mark.parametrize("num_microbatches", range(1, 9))
@pytest.mark.parametrize("interleave", (1, 2, 3))
@pytest.mark.parametrize("stages", (1, 2, 4))
@pytest.mark.parametrize("blocks", list(PATTERNS))
def test_schedule_matches_jax(schedule_models, blocks, stages, interleave,
                              num_microbatches):
  """Every property, the refusal of a pattern with no uniform prefix and
  the poor-split warning, exactly as JAX's for the same counts."""
  jmodel, model = schedule_models[blocks]
  jmesh = jax.sharding.Mesh(np.array(jax.devices()[:stages]), ("stage",))
  mesh = sharding.make_mesh((stages,), ("stage",), devices=["cpu"] * stages)
  want, want_warned = _build(lambda: jpp.GriffinPipeline(
      jmodel, jmesh, num_microbatches, interleave=interleave))
  got, got_warned = _build(lambda: pipeline.GriffinPipeline(
      model, mesh, num_microbatches, interleave=interleave))
  assert got_warned == want_warned
  if isinstance(want, ValueError):
    assert isinstance(got, ValueError) and "identical-pattern" in str(got)
    assert "identical-pattern" in str(want)
    return
  for name in PROPERTIES:
    assert getattr(got, name) == getattr(want, name), name
  chunks = stages * interleave
  types = model.config.block_types
  assert pipeline.pipelined_prefix_length(types, chunks) == (
      jpp.pipelined_prefix_length(PATTERNS[blocks], chunks))
  assert [t.name for t in pipeline.stage_block_types(types, chunks)] == [
      t.name for t in jpp.stage_block_types(PATTERNS[blocks], chunks)]


def test_schedule_refusals_match_jax():
  R, A = common.TemporalBlockType.RECURRENT, common.TemporalBlockType.ATTENTION
  assert pipeline.pipelined_prefix_length((R, R, A, R), 2) == 2
  assert pipeline.stage_block_types((R, R, A, R), 2) == (R,)
  for call in (pipeline.pipelined_prefix_length, jpp.pipelined_prefix_length):
    types = (R, A) if call is pipeline.pipelined_prefix_length else (JR, JA)
    with pytest.raises(ValueError, match="identical-pattern"):
      call(types, 2)
    with pytest.raises(ValueError, match="num_stages must be >= 1"):
      call(types, 0)


# -- the parameter layout ----------------------------------------------------


@pytest.mark.parametrize("blocks,stages,interleave", [
    ("12 blocks", 4, 1), ("12 blocks", 2, 2), ("26 blocks", 4, 2)])
def test_stack_params_matches_jax(pairs, blocks, stages, interleave):
  """The port's stacked leaves equal the converted leaves of JAX's
  ``stack_params`` at every position; ``shared`` holds the same names; the
  round trip gives back every tensor bit for bit."""
  pair = pairs(blocks)
  pipe, _, _ = pair.pipeline((stages,), 4, interleave)
  jmesh = jax.sharding.Mesh(np.array(jax.devices()[:stages]), ("stage",))
  jpipe = jpp.GriffinPipeline(pair.jmodel, jmesh, 4, interleave=interleave)
  jstacked, jshared = jax.tree_util.tree_map(
      np.asarray, jpipe.stack_params(pair.params))
  state = pair.model.state_dict()
  stacked, shared = pipe.stack_params(state)
  assert set(shared) == set(convert.state_dict_from_flax(jshared))
  want = {}
  for slot, tree in jstacked.items():
    for p in range(pipe.num_chunks):
      at_p = jax.tree_util.tree_map(lambda leaf, p=p: leaf[p], tree)
      for name, value in convert.state_dict_from_flax(at_p).items():
        want.setdefault(f"{slot}.{name}", []).append(value)
  assert set(stacked) == set(want)
  for name, values in want.items():
    torch.testing.assert_close(stacked[name], torch.stack(values), atol=0,
                               rtol=0, msg=name)
  back = pipe.unstack_params(stacked, shared)
  assert set(back) == set(state)
  for name, tensor in state.items():
    assert torch.equal(back[name], tensor), name


@pytest.mark.parametrize("mesh_shape,interleave", [((4,), 1), ((2,), 2),
                                                   ((4, 2), 1)])
def test_stage_positions_hold_their_chunks(pairs, mesh_shape, interleave):
  """Placed by ``stage_sharding``, stage position ``d`` holds positions
  [d*v, (d+1)*v) of each stacked leaf, as a view of it (the mesh repeats
  the stacked tensors' device), and nothing else."""
  pipe, placed, _ = pairs("12 blocks").pipeline(mesh_shape, 2, interleave)
  stacked, _ = pipe.stack_params(pipe.model.state_dict())
  v, stages = interleave, mesh_shape[0]
  for name, pieces in placed.items():
    assert len(pieces) == stages
    whole = stacked[name]
    for d, piece in enumerate(pieces):
      assert piece.shape == (v,) + whole.shape[1:]
      torch.testing.assert_close(piece, whole[d * v:(d + 1) * v], atol=0,
                                 rtol=0)
  # Placing the stacked tensors themselves: every piece a view of them.
  placed = sharding.place_state_dict(stacked, pipe.stage_sharding(stacked))
  for name, pieces in placed.items():
    for d, piece in enumerate(pieces):
      assert piece._base is stacked[name]  # pylint: disable=protected-access
      assert piece.data_ptr() == stacked[name][d * v].data_ptr()


# -- the forward --------------------------------------------------------------

FORWARD = {
    # name: (blocks, mesh shape, M, v, image)
    "GPipe": ("12 blocks", (4,), 4, 1, False),
    "GPipe, image": ("12 blocks", (4,), 4, 1, True),
    "M > S": ("12 blocks", (4,), 8, 1, False),
    "v=2, 26 blocks, M=2": ("26 blocks", (4,), 2, 2, False),
    "v=2, 26 blocks, M=4": ("26 blocks", (4,), 4, 2, False),
    "v=2, 26 blocks, M=8": ("26 blocks", (4,), 8, 2, False),
    "(stage 4, data 2), v=1": ("12 blocks", (4, 2), 2, 1, True),
    "(stage 4, data 2), v=2": ("26 blocks", (4, 2), 2, 2, False),
}


def _count_chunks(monkeypatch):
  calls = []
  run = pipeline.GriffinPipeline._chunk  # pylint: disable=protected-access

  def counted(self, piece, lap, h, pos):
    calls.append((lap, h.shape[0]))
    return run(self, piece, lap, h, pos)

  monkeypatch.setattr(pipeline.GriffinPipeline, "_chunk", counted)
  return calls


@pytest.mark.parametrize("case", list(FORWARD))
def test_forward_matches_jax(pairs, monkeypatch, case):
  """Logits equal JAX's plain Griffin's, and the schedule runs each
  microbatch's C chunks once: no chunk in a bubble slot."""
  blocks, mesh_shape, n_mb, v, image = FORWARD[case]
  pair = pairs(blocks)
  pipe, placed, shared = pair.pipeline(mesh_shape, n_mb, v)
  tokens, pos, _, img = _batch()
  calls = _count_chunks(monkeypatch)
  with torch.no_grad():
    got = pipe(placed, shared, _t(tokens).long(), _t(pos),
               image=_t(img) if image else None)
  dp = int(np.prod(mesh_shape[1:]))
  assert len(calls) == dp * n_mb * pipe.num_chunks
  assert {rows for _, rows in calls} == {BATCH // (dp * n_mb)}
  np.testing.assert_allclose(got.numpy(), pair.logits(image), **TOL)


def test_quantized_forward_matches_jax(pairs):
  """A weight-only int8 model (JAX's ``quantize_params``) pipelines."""
  pair = pairs("12 blocks", quantized=True)
  pipe, placed, shared = pair.pipeline((4,), 4)
  assert any(name.endswith("_q") for name in placed)
  tokens, pos, _, _ = _batch()
  with torch.no_grad():
    got = pipe(placed, shared, _t(tokens).long(), _t(pos))
  np.testing.assert_allclose(got.numpy(), pair.logits(False), **TOL)


def test_forward_matches_jax_pipeline(pairs):
  """The one direct comparison with JAX's own ``GriffinPipeline``
  (``shard_map`` over 4 virtual devices, S = 4, M = 4, v = 1)."""
  pair = pairs("12 blocks")
  jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("stage",))
  jpipe = jpp.GriffinPipeline(pair.jmodel, jmesh, 4)
  jstacked, jshared = jpipe.stack_params(pair.params)
  jstacked = jax.device_put(jstacked, jpipe.stage_sharding(jstacked))
  tokens, pos, _, img = _batch()
  want = jax.jit(lambda st, sh, t, p, i: jpipe(st, sh, t, p, image=i))(
      jstacked, jshared, tokens, pos, img)
  pipe, placed, shared = pair.pipeline((4,), 4)
  with torch.no_grad():
    got = pipe(placed, shared, _t(tokens).long(), _t(pos), image=_t(img))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  with torch.no_grad():
    hidden = pipe(placed, shared, _t(tokens).long(), _t(pos), image=_t(img),
                  return_hidden=True)
  assert hidden.shape == (BATCH, SEQ + 3, 16)


# -- the loss, the gradients and the train step ------------------------------


@pytest.fixture(scope="module")
def jax_gradients(pairs):
  """JAX's plain loss and gradient tree (by the port's names) on the
  12-block pair, with an image."""
  pair = pairs("12 blocks")
  tokens, pos, mask, img = _batch()
  loss, grads = jax.jit(jax.value_and_grad(
      lambda p, t, m, q, i: jtrainer.forward_and_loss_fn(
          p, model=pair.jmodel, input_tokens=t, input_mask=m, positions=q,
          image=i)))(pair.params, tokens, mask, pos, img)
  return float(loss), grads


def _assert_gradients_close(got, want_tree):
  want = convert.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, want_tree))
  assert set(got) == set(want)
  for name, value in want.items():
    scale = max(float(value.abs().max()), 1e-6)
    np.testing.assert_allclose(got[name].detach().numpy() / scale,
                               value.numpy() / scale, atol=GRAD_TOL, rtol=0,
                               err_msg=name)


GRADIENTS = {"v=1": ((4,), 4, 1), "v=2": ((2,), 4, 2),
             "(stage 2, data 2)": ((2, 2), 2, 1)}


@pytest.mark.parametrize("case", list(GRADIENTS))
def test_loss_and_gradients_match_jax(pairs, jax_gradients, case):
  """The loss equals JAX's ``trainer.forward_and_loss_fn``, and the whole
  gradient tree, unstacked, JAX's plain gradients; the stage pieces'
  gradients stay on their positions."""
  mesh_shape, n_mb, v = GRADIENTS[case]
  pair = pairs("12 blocks")
  pipe, placed, shared = pair.pipeline(mesh_shape, n_mb, v)
  want_loss, want = jax_gradients
  tokens, pos, mask, img = _batch()
  params = pipe.parameters(placed, shared)
  loss = pipe.loss_fn(placed, shared, _t(tokens).long(), _t(mask), _t(pos),
                      image=_t(img))
  loss.backward()
  np.testing.assert_allclose(loss.item(), want_loss, **TOL)
  g_stacked, g_shared = pipe.gradients(placed, shared)
  for name, grads in g_stacked.items():
    assert [g.shape[0] for g in grads] == [v] * mesh_shape[0], name
  _assert_gradients_close(pipe.unstack_params(g_stacked, g_shared), want)
  for p in params:
    p.grad = None


def test_sgd_step_matches_jax(pairs, jax_gradients):
  """One ``make_train_step`` step with ``torch.optim.SGD`` equals JAX's
  ``optax.sgd`` step of the same rate on the plain gradients, leaf for
  leaf; the updated weights are the pieces themselves."""
  lr = 0.1
  pair = pairs("12 blocks")
  model = convert.griffin_from_flax_params(
      pair.params, pair.model.config, device="cpu", dtype=torch.float32)
  mesh = sharding.make_mesh((4,), ("stage",), devices=["cpu"] * 4)
  pipe = pipeline.GriffinPipeline(model, mesh, 4)
  stacked, shared = pipe.stack_params(model.state_dict())
  placed = sharding.place_state_dict(stacked, pipe.stage_sharding(stacked))
  factory = lambda params: torch.optim.SGD(params, lr=lr)
  step = pipe.make_train_step(factory)
  opt = factory(pipe.parameters(placed, shared))
  tokens, pos, mask, img = _batch()
  want_loss, grads = jax_gradients
  sgd = optax.sgd(lr)
  updates, _ = sgd.update(grads, sgd.init(pair.params), pair.params)
  want = optax.apply_updates(pair.params, updates)
  loss, placed_out, shared_out, opt_out = step(
      placed, shared, opt, _t(tokens).long(), _t(mask), _t(pos), _t(img))
  assert placed_out is placed and shared_out is shared and opt_out is opt
  np.testing.assert_allclose(loss.item(), want_loss, **TOL)
  got = pipe.unstack_params(placed, shared)
  want = convert.state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             want))
  assert set(got) == set(want)
  for name, value in want.items():
    np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                               **TOL, err_msg=name)
  # The shared tensors are the model's own (state_dict views): updated too.
  torch.testing.assert_close(model.final_norm.scale.detach(),
                             shared["final_norm.scale"].detach())


def test_adam_steps_lower_the_loss(pairs):
  """Three Adam steps lower the loss and leave every stage piece the same
  tensor on its position, a view of its stacked leaf."""
  pair = pairs("12 blocks")
  model = convert.griffin_from_flax_params(
      pair.params, pair.model.config, device="cpu", dtype=torch.float32)
  mesh = sharding.make_mesh((2,), ("stage",), devices=["cpu"] * 2)
  pipe = pipeline.GriffinPipeline(model, mesh, 2, interleave=2)
  stacked, shared = pipe.stack_params(model.state_dict())
  placed = sharding.place_state_dict(stacked, pipe.stage_sharding(stacked))
  pieces = {name: [p.data_ptr() for p in value]
            for name, value in placed.items()}
  step = pipe.make_train_step(lambda p: torch.optim.Adam(p, lr=5e-2))
  opt = torch.optim.Adam(pipe.parameters(placed, shared), lr=5e-2)
  tokens, pos, mask, _ = _batch()
  losses = []
  for _ in range(3):
    loss, placed, shared, opt = step(placed, shared, opt, _t(tokens).long(),
                                     _t(mask), _t(pos))
    losses.append(loss.item())
  assert losses[-1] < losses[0], losses
  for name, value in placed.items():
    assert [p.data_ptr() for p in value] == pieces[name]
    for d, p in enumerate(value):
      assert p._base is stacked[name] and p.grad is None  # pylint: disable=protected-access
      assert opt.state[p]["exp_avg"].shape == (2,) + stacked[name].shape[1:]
    torch.testing.assert_close(torch.cat(value), stacked[name])


# -- errors -------------------------------------------------------------------


def test_indivisible_batch_raises(pairs):
  pipe, placed, shared = pairs("12 blocks").pipeline((4, 2), 2)
  tokens, pos, _, _ = _batch()
  with pytest.raises(ValueError, match=r"num_microbatches 2 x data-parallel 2"):
    pipe(placed, shared, _t(tokens[:6]).long(), _t(pos[:6]))


def test_pattern_refusals_and_warning(pairs):
  """No uniform prefix, an interleave the pattern cannot split into,
  ``interleave < 1`` and the poor-split warning, as JAX's."""
  R, A = common.TemporalBlockType.RECURRENT, common.TemporalBlockType.ATTENTION
  model = pairs("12 blocks").model
  mesh = sharding.make_mesh((4,), ("stage",), devices=["cpu"] * 4)
  with pytest.raises(ValueError, match="identical-pattern"):
    pipeline.GriffinPipeline(model, mesh, 4, interleave=2)  # 8 chunks
  with pytest.raises(ValueError, match="interleave must be >= 1"):
    pipeline.GriffinPipeline(model, mesh, 4, interleave=0)
  two = sharding.make_mesh((2,), ("stage",), devices=["cpu"] * 2)
  mixed = griffin.Griffin(model.config._replace(block_types=(R, A)),
                          device="meta")
  with pytest.raises(ValueError, match="identical-pattern"):
    pipeline.GriffinPipeline(mixed, two, 2)
  poor = griffin.Griffin(
      model.config._replace(block_types=(R, R, A, A, A, A)), device="meta")
  with pytest.warns(UserWarning, match="Pipeline split is poor"):
    pipe = pipeline.GriffinPipeline(poor, two, 2)
  assert pipe.pipelined_layers == 2 and pipe.tail_layers == (2, 3, 4, 5)


@pytest.mark.parametrize("kind", ["lora_rank", "lora_rows", "SP"])
def test_unsupported_models_refused(pairs, kind):
  config = pairs("12 blocks").model.config
  mesh = sharding.make_mesh((4,), ("stage",), devices=["cpu"] * 4)
  kwargs = {"lora_rank": dict(lora_rank=2),
            "lora_rows": dict(lora_rank=2, lora_rows=2),
            "SP": dict(scan_sharding_spec=sharding.ShardingSpec(
                mesh=sharding.make_mesh((1, 2), ("data", "sequence"),
                                        devices=["cpu"] * 2),
                sequence_axis_name="sequence"))}[kind]
  model = griffin.Griffin(config, device="meta", **kwargs)
  reason = {"lora_rank": "lora_rank", "lora_rows": "lora_rank",
            "SP": "scan_sharding_spec"}[kind]
  with pytest.raises(ValueError, match=reason):
    pipeline.GriffinPipeline(model, mesh, 4)


def test_cuda_mesh_raises_without_a_card(pairs, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  mesh = sharding.make_mesh((4,), ("stage",), devices=["cuda:0"] * 4)
  with pytest.raises(RuntimeError, match="No CUDA device"):
    pipeline.GriffinPipeline(pairs("12 blocks").model, mesh, 4)


def test_train_step_needs_placed_weights(pairs):
  pipe, placed, shared = pairs("12 blocks").pipeline((4,), 4)
  stacked, _ = pipe.stack_params(pipe.model.state_dict())
  with pytest.raises(ValueError, match="not placed"):
    pipe.parameters(stacked, shared)
  with pytest.raises(TypeError, match="optimizer"):
    pipe.make_train_step(torch.optim.SGD(pipe.parameters(placed, shared),
                                         lr=0.1))
