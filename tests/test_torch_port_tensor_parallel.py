"""Tensor-parallel serving: the port's ``Sampler(mesh=)`` against JAX's.

A tiny Griffin (width 16, two heads of 8, an R and an A block, window 8,
float32, seeded normal weights of std 0.5 in the JAX tree's shapes) in both
packages. On a ``(1, 2)`` mesh -- JAX's two virtual CPU devices, the port's
``devices=["cpu"] * 2`` -- the port's TP sampler must give JAX's TP
sampler's tokens and its logits within the parity bound (``atol=2e-4``,
float32 summed in other orders), and the port's unsharded sampler's: single
shot, chunked, prefix continuations, a conversation; an int8
(``quantize_params``) model, a LoRA model (JAX ``test_lora.py:496``), and a
``(1, 4)`` mesh whose two heads do not divide into it (the gates replicate
and each shard evaluates the heads covering its features). The TP batcher
(JAX ``test_serving.py:847-900``), TP speculation (``test_speculative.py:
527``), the front end over a TP batcher (``test_server.py:1905``) and
``load_parameters(sharding=...)`` match their unsharded counterparts; the
parameters and the batcher's recurrent cache really are split. What stays
refused raises ``NotImplementedError`` naming its ROADMAP item (training
over a mesh is ``test_torch_port_tp_training.py``'s; the sharded towers, TP
multi-LoRA and the TP export are ``test_torch_port_tp_extras.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.inference import sampler as jsampler
from cadence_gemma_tpu.inference import speculative as jspeculative
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.ops import quantization as jquant
from cadence_gemma_tpu.parallel import sharding as jsharding
from cadence_gemma_tpu.tokenizers import SimpleVocab as JaxVocab
import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import server as server_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.inference import speculative
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel

WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
ATOL = 2e-4  # tests/test_torch_port_sampler.py:78
RAGGED = ["alpha beta", "gamma delta eps zeta eta theta alpha"]
LONG = "alpha beta gamma delta eps zeta eta theta alpha beta"


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types)
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


class Tiny:
  """One tiny model in both packages: ``kind`` is ``bf16`` (float32
  weights, the name of the unquantized tree), ``int8`` or ``lora``."""

  def __init__(self, kind="bf16"):
    self.jvocab = JaxVocab(WORDS)
    self.vocab = port.SimpleVocab(WORDS)
    self.config = jcommon.GriffinConfig(
        vocab_size=self.jvocab.GetPieceSize(), width=16,
        mlp_expanded_width=32, num_heads=2,
        block_types=(jcommon.TemporalBlockType.RECURRENT,
                     jcommon.TemporalBlockType.ATTENTION),
        embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
        logits_soft_cap=30.0, lru_width=16,
        scan_type=jcommon.ScanType.LINEAR_NATIVE)
    rank = 2 if kind == "lora" else 0
    self.jmodel = jgriffin.Griffin(self.config, dtype=jnp.float32,
                                   param_dtype=jnp.float32,
                                   gradient_checkpointing=False,
                                   lora_rank=rank)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(self.jmodel.init, jax.random.PRNGKey(0),
                            jnp.ones((1, 4), jnp.int32),
                            jnp.arange(4)[None])["params"]
    params = jax.tree_util.tree_map(
        lambda x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32),
        shapes)
    if kind == "int8":
      params = jax.tree_util.tree_map(np.asarray,
                                      jquant.quantize_params(params))
      self.jmodel = jgriffin.Griffin(self.config, dtype=jnp.float32,
                                     param_dtype=jnp.float32,
                                     gradient_checkpointing=False,
                                     quantized=True)
    self.jparams = jax.tree_util.tree_map(jnp.asarray, params)
    self.model = convert.griffin_from_flax_params(
        params, _port_config(self.config), device="cpu",
        dtype=torch.float32, quantized=kind == "int8", lora_rank=rank)

  def mesh(self, n):
    return sharding.make_mesh((1, n), ("data", "model"), devices=["cpu"] * n)

  def jmesh(self, n):
    return jsharding.make_mesh((1, n), ("data", "model"), jax.devices()[:n])

  def port(self, n=None, **kwargs):
    mesh = None if n is None else self.mesh(n)
    return sampler_lib.Sampler(self.model, self.vocab, device="cpu",
                               mesh=mesh, **kwargs)

  def jax(self, n, **kwargs):
    return jsampler.Sampler(self.jmodel, self.jvocab, self.jparams,
                            bucket_prompt_lengths=False, mesh=self.jmesh(n),
                            **kwargs)


@pytest.fixture(scope="module")
def tiny():
  return Tiny()


def _same(got, want, logits=True):
  """Identical tokens, logits within ``ATOL``."""
  for a, b in zip(got.tokens, want.tokens):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
  if logits:
    for a, b in zip(got.logits, want.logits):
      np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("kind,n", [("bf16", 2), ("bf16", 4), ("int8", 2),
                                    ("lora", 2)])
def test_sampler_matches_jax_tp_and_unsharded(tiny, kind, n):
  """Single shot on a ragged batch: the port's TP sampler equals JAX's TP
  sampler and the port's unsharded one; the parameters are split."""
  model = tiny if kind == "bf16" else Tiny(kind)
  kw = dict(total_generation_steps=6, return_logits=True,
            end_sampling_at_eos_token=False)
  got = model.port(n)(RAGGED, **kw)
  _same(got, model.jax(n)(RAGGED, **kw))
  _same(got, model.port()(RAGGED, **kw))
  tp = model.port(n).model
  lru = model.config.lru_width
  shards = tp.blocks[0].temporal.s.shards
  assert len(shards) == n
  linear_x = shards[0].linear_x
  weight = linear_x.kernel_q if kind == "int8" else linear_x.kernel
  assert weight.shape[0] == lru // n
  shardings = partitioning.griffin_param_shardings(
      model.mesh(n), model.model.state_dict())
  assert any(not s.is_fully_replicated for s in shardings.values())
  if n == 4:  # two heads on four shards: the gates replicate
    gate = shardings["blocks.0.recurrent_block.rg_lru.input_gate.w"]
    assert gate.is_fully_replicated
    assert not tp.blocks[0].temporal.gates_split


def test_int8_act_quant_prefill_matches_unsharded():
  """``prefill_act_quant``: a row-parallel shard quantizes its slice of
  each row with the whole row's scale (the rows' absmax gathered over the
  shards), so the TP prefill's int8 activations are the unsharded ones."""
  model = Tiny("int8")
  kw = dict(total_generation_steps=5, return_logits=True,
            end_sampling_at_eos_token=False)
  _same(model.port(2, prefill_act_quant=True)(RAGGED, **kw),
        model.port(prefill_act_quant=True)(RAGGED, **kw))


def test_chunked_prefix_and_conversation_match(tiny):
  """Chunks of 3 and prefix continuations against JAX's TP sampler; a
  two-turn conversation against the port's unsharded one."""
  kw = dict(total_generation_steps=5, return_logits=True,
            end_sampling_at_eos_token=False)
  got = tiny.port(2, prefill_chunk_size=3)(RAGGED, **kw)
  _same(got, tiny.jax(2, prefill_chunk_size=3)(RAGGED, **kw))
  _same(got, tiny.port(prefill_chunk_size=3)(RAGGED, **kw))
  tp, jtp, one = tiny.port(2), tiny.jax(2), tiny.port()
  prefix = "alpha beta gamma delta"
  cont = ["eps zeta", "eta theta"]
  got = tp(cont, prefix_state=tp.prefill_prefix(prefix), **kw)
  _same(got, jtp(cont, prefix_state=jtp.prefill_prefix(prefix), **kw))
  _same(got, one(cont, prefix_state=one.prefill_prefix(prefix), **kw))
  turn = dict(total_generation_steps=4, return_state=True)
  a, b = tp(["alpha beta"], **turn), one(["alpha beta"], **turn)
  _same(tp(["gamma"], prefix_state=a.state, **kw),
        one(["gamma"], prefix_state=b.state, **kw))
  assert set(a.state.cache) == {"blocks.0.shard0", "blocks.0.shard1",
                                "blocks.1"}


def _solo(sampler, prompt, steps):
  return sampler([prompt], total_generation_steps=steps).tokens[0].tolist()


def _check(got, solo_tokens, steps, eos_id):
  assert got == list(solo_tokens[:len(got)]), (got, list(solo_tokens))
  assert len(got) == steps or got[-1] == eos_id, (got, steps)


def test_tp_batcher_matches_solo_with_its_cache_sharded(tiny):
  """JAX ``TestShardedBatcher``: three slots, then staggered joins; the
  recurrent state the batcher owns is split over the model axis."""
  one, steps = tiny.port(), 8
  batcher = serving.ContinuousBatcher(tiny.port(2), num_slots=3,
                                      max_steps_default=steps, device="cpu")
  prompts = ["alpha beta", "gamma delta eps", "zeta"]
  rids = {batcher.add_request(p, max_steps=steps): p for p in prompts}
  for rid, tokens, _ in batcher.run_until_drained(3):
    _check(tokens, _solo(one, rids[rid], steps), steps, tiny.vocab.eos_id())
  state = batcher._cache["blocks.0.shard1"].rg_lru_state
  assert tuple(state.shape) == (3, tiny.config.lru_width // 2)
  assert "blocks.0" not in batcher._cache
  staggered = serving.ContinuousBatcher(tiny.port(2), num_slots=2,
                                        max_steps_default=steps, device="cpu")
  r1 = staggered.add_request("alpha beta gamma", max_steps=steps)
  staggered.step(2)
  r2 = staggered.add_request("delta eps", max_steps=steps)
  results = {}
  for _ in range(40):
    staggered.step(2)
    results.update({r: t for r, t, _ in staggered.pop_finished()})
    if len(results) == 2:
      break
  _check(results[r1], _solo(one, "alpha beta gamma", steps), steps,
         tiny.vocab.eos_id())
  _check(results[r2], _solo(one, "delta eps", steps), steps,
         tiny.vocab.eos_id())


def _trim(tokens, eos):
  tokens = list(tokens)
  return tokens[:tokens.index(eos) + 1] if eos in tokens else tokens


def test_tp_speculative_matches_jax_and_unsharded(tiny):
  """JAX ``TestShardedSpeculative``, and a speculative TP batcher."""
  prompts = ["alpha beta alpha beta alpha", "gamma delta"]
  eos = tiny.vocab.eos_id()
  got = speculative.SpeculativeSampler(tiny.port(2), draft_len=3, ngram=2)(
      prompts, 10)
  jax_tp = jspeculative.SpeculativeSampler(tiny.jax(2), draft_len=3,
                                           ngram=2)(prompts, 10)
  one = speculative.SpeculativeSampler(tiny.port(), draft_len=3, ngram=2)(
      prompts, 10)
  for a, b, c in zip(got.tokens, jax_tp.tokens, one.tokens):
    assert _trim(a.tolist(), eos) == _trim(np.asarray(b).tolist(), eos)
    assert a.tolist() == c.tolist()
  batcher = serving.ContinuousBatcher(tiny.port(2), num_slots=2,
                                      max_steps_default=8, draft_len=3,
                                      ngram=2, device="cpu")
  rids = {batcher.add_request(p): p for p in prompts}
  plain = tiny.port()
  for rid, tokens, _ in batcher.run_until_drained(2):
    _check(tokens, _solo(plain, rids[rid], 8), 8, eos)


def test_frontend_over_tp_batcher_matches_solo(tiny):
  """JAX ``TestShardedFrontend``: three prompts through two slots."""
  one, steps = tiny.port(), 8
  batcher = serving.ContinuousBatcher(tiny.port(2), num_slots=2,
                                      max_steps_default=steps, device="cpu")
  fe = server_lib.ServingFrontend(batcher, step_size=2, device="cpu")
  try:
    prompts = ["alpha beta", "gamma delta eps", "zeta eta"]
    subs = [fe.submit(p) for p in prompts]
    for p, sub in zip(prompts, subs):
      tokens, _ = sub.result(timeout=120)
      _check(tokens, _solo(one, p, steps), steps, tiny.vocab.eos_id())
  finally:
    fe.close()


def test_load_parameters_replicated_and_by_a_sharding_tree(tiny, tmp_path):
  """JAX ``io.py:32-72``: ``"replicated"`` gives the state dict whole; a
  ``griffin_param_shardings`` tree gives the placed pieces, which build a
  TP model whose sampler equals the unsharded one."""
  path = str(tmp_path / "lm")
  state = tiny.model.state_dict()
  checkpoint_io.save_parameters(path, state)
  whole = checkpoint_io.load_parameters(path, device="cpu",
                                        sharding="replicated")
  assert all(torch.equal(whole[k], state[k]) for k in state)
  mesh = tiny.mesh(2)
  tree = partitioning.griffin_param_shardings(mesh, state)
  placed = checkpoint_io.load_parameters(path, sharding=tree)
  name = "blocks.0.recurrent_block.linear_out.kernel"
  assert [tuple(p.shape) for p in placed[name]] == [(16, 8)] * 2
  assert torch.equal(torch.cat(placed[name], 1), state[name])
  model = tensor_parallel.TensorParallelGriffin(
      tiny.model.config, placed, mesh, dtype=torch.float32)
  kw = dict(total_generation_steps=5, return_logits=True)
  _same(sampler_lib.Sampler(model, tiny.vocab, mesh=mesh)(RAGGED, **kw),
        tiny.port()(RAGGED, **kw))


def test_tp_model_forward_and_cache_layout(tiny):
  """The TP model's forward has ``Griffin.forward``'s signature: hidden
  states, prefill logits and the pending cache of a verify chunk match the
  unsharded model's; ``shard_cache`` / ``unshard_cache`` are inverses."""
  tp = tensor_parallel.tensor_parallel(tiny.model, tiny.mesh(2))
  tokens = torch.tensor([[1, 4, 5, 6, 7, 3]])
  pos = torch.arange(6)[None]
  with torch.no_grad():
    want, cache = tiny.model(tokens, pos)
    got, tp_cache = tp(tokens, pos)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    back = tp.unshard_cache(tp_cache)
    for name in cache:
      for a, b in zip(cache[name], back[name]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    hidden, _ = tp(tokens, pos, return_hidden=True, last_logits_only=True)
    want_hidden, _ = tiny.model(tokens, pos, return_hidden=True,
                                last_logits_only=True)
    torch.testing.assert_close(hidden, want_hidden, atol=ATOL, rtol=0)
    # An image through the column / row connector, spliced after BOS.
    image = 0.1 * torch.randn(1, 3, tiny.model.config.vision_width,
                              generator=torch.Generator().manual_seed(1))
    got, _ = tp(tokens, pos, image=image, return_cache=False)
    want, _ = tiny.model(tokens, pos, image=image, return_cache=False)
    assert got.shape == (1, 9, tiny.model.config.vocab_size)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    chunk = torch.tensor([[8, 9, 10]])
    _, pending = tp(chunk, pos[:, :3] + 6, tp.shard_cache(cache),
                    pending_cache=True)
    _, want_pending = tiny.model(chunk, pos[:, :3] + 6, cache,
                                 pending_cache=True)
    got_pending = tp.unshard_cache(pending)
    for name in cache:
      for a, b in zip(want_pending[name], got_pending[name]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def _two_processes(tiny):
  """Tensor parallelism over a model axis whose positions belong to two
  processes (the mesh's ranks; no group: the refusal comes first)."""
  flat = np.empty(2, dtype=object)
  flat[:] = [torch.device("cpu")] * 2
  mesh = sharding.Mesh(flat.reshape(1, 2), ("data", "model"),
                       np.array([[0, 1]]))
  return tensor_parallel.tensor_parallel(tiny.model, mesh)


REFUSALS = {
    "SP and TP": ("14g", lambda t, mp: tensor_parallel.tensor_parallel(
        port.Griffin(t.model.config, device="cpu", scan_sharding_spec=(
            sharding.ShardingSpec(mesh=t.mesh(2), sequence_axis_name="model"))),
        t.mesh(2))),
    "multihost": ("14g", lambda t, mp: _two_processes(t)),
}


@pytest.mark.parametrize("feature", list(REFUSALS))
def test_left_out_features_name_their_item(tiny, feature, monkeypatch):
  item, call = REFUSALS[feature]
  with pytest.raises(NotImplementedError, match=f"item {item}"):
    call(tiny, monkeypatch)


def test_no_fallback_hides_the_card(tiny, monkeypatch):
  """A CUDA mesh raises without a card; a captured decode over several
  cards raises naming the process-per-card item."""
  cards = sharding.make_mesh((1, 2), ("data", "model"),
                             devices=["cuda:0", "cuda:1"])
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="No CUDA device"):
    sampler_lib.Sampler(tiny.model, tiny.vocab, mesh=cards)
  with pytest.raises(RuntimeError, match="No CUDA device"):
    tensor_parallel.tensor_parallel(tiny.model, cards)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  with pytest.raises(NotImplementedError, match="item 14g"):
    sampler_lib.Sampler(tiny.model, tiny.vocab, mesh=cards)
  with pytest.raises(ValueError, match="first device"):
    sampler_lib.Sampler(tiny.model, tiny.vocab, device="cpu",
                        mesh=sharding.make_mesh((1, 2), ("data", "model"),
                                                devices=["cuda:0"] * 2))
