"""The port's multi-LoRA serving vs the JAX package's, on the CPU.

``tests/test_torch_port_serving.py``'s tiny Griffin (an R and an A block,
width 16, window 8, float32, seeded normal weights) built with rank-4
adapters in both packages, the sampler's own adapters and each request's
seeded numpy normals:

  * ``lora_rows`` ``Dense`` / ``Einsum`` over a float32 and an int8 base
    against JAX's ``lora_rows`` layers, and against the same layer run row
    by row with that row's adapters (within 1e-5 of the largest output); an
    all-zero row gives the base layer's output exactly;
  * a ``lora_rows`` model (JAX's ``clone(lora_rows=...)``, the port's
    ``adapter_twin``) against JAX's, whose base tensors are the sampler's;
  * the ``multi_lora`` batcher against JAX's on the same requests, adapters
    and step sizes: identical greedy tokens with mixed adapters, a reused
    slot, adapter-less requests, chunked admission, ``prefix_state`` with
    adapters and an image request with adapters (the golden fixture's tiny
    towers); each request's tokens are a solo port ``Sampler``'s on the
    merged weights; JAX's misuse errors;
  * the front end's ``adapter_resolver`` over HTTP gives the direct
    batcher's tokens, and an unknown adapter or a missing resolver answers
    400.

One card test holds the captured multi-LoRA tick against the eager one,
with two batchers of different adapters sharing the captured graph.
"""

import numpy as np
import pytest
import torch

import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.inference import modal_sampler
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import server as server_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.models import layers
from cadence_gemma_tpu_torch.training import lora

requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)

RANK = 4
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]


def _jax_np():
  """jax and jax.numpy, imported here so the card test runs without JAX."""
  import jax  # pylint: disable=import-outside-toplevel
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  return jax, jnp


def _tree_map(fn, tree):
  """``fn`` over the leaves of nested dicts."""
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


def _jax():
  """The JAX modules, imported here so the card test runs without JAX."""
  from cadence_gemma_tpu import common as jcommon  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.inference import modal_sampler as jmodal  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.inference import sampler as jsampler  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.inference import serving as jserving  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.models import griffin as jgriffin  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.models import layers as jlayers  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.tokenizers import SimpleVocab  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.training import lora as jlora  # pylint: disable=import-outside-toplevel
  return dict(common=jcommon, modal=jmodal, sampler=jsampler,
              serving=jserving, griffin=jgriffin, layers=jlayers,
              vocab=SimpleVocab, lora=jlora)


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types)
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


def _seeded(shapes, seed, std):
  rng = np.random.default_rng(seed)
  return _tree_map(
      lambda s: (std * rng.standard_normal(s.shape)).astype(np.float32),
      shapes)


class LoraPair:
  """One LoRA model in both packages: the base and the sampler's own
  adapters seeded normals, and seeded adapters for requests."""

  def __init__(self, config=None, vocab_words=WORDS, params=None):
    jax, jnp = _jax_np()
    j = _jax()
    self.j = j
    self.jvocab = j["vocab"](vocab_words)
    self.vocab = port.SimpleVocab(vocab_words)
    if config is None:
      config = j["common"].GriffinConfig(
          vocab_size=self.jvocab.GetPieceSize(), width=16,
          mlp_expanded_width=32, num_heads=2,
          block_types=(j["common"].TemporalBlockType.RECURRENT,
                       j["common"].TemporalBlockType.ATTENTION),
          embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
          logits_soft_cap=30.0, lru_width=16,
          scan_type=j["common"].ScanType.LINEAR_NATIVE)
    self.config = config
    self.jmodel = j["griffin"].Griffin(
        config, dtype=jnp.float32, param_dtype=jnp.float32,
        gradient_checkpointing=False, lora_rank=RANK)
    shapes = jax.eval_shape(self.jmodel.init, jax.random.PRNGKey(0),
                            jnp.ones((1, 4), jnp.int32),
                            jnp.arange(4)[None])["params"]
    self.adapter_shapes, base_shapes = j["lora"].split_lora(shapes)
    base = params if params is not None else _seeded(base_shapes, 0, 0.5)
    self.params = j["lora"].merge_params(base, self.adapters_j(1))
    self.jparams = _tree_map(jnp.asarray, self.params)
    self.model = self.port_model(self.params)
    self._jax_samplers = {}

  def adapters_j(self, seed):
    return _seeded(self.adapter_shapes, seed, 0.3)

  def adapters(self, seed):
    """(JAX tree, port leaves) of the same seeded adapters."""
    tree = self.adapters_j(seed)
    return _tree_map(_jax_np()[1].asarray, tree), \
        convert.state_dict_from_flax(tree)

  def port_model(self, params):
    return convert.griffin_from_flax_params(
        params, _port_config(self.config), device="cpu",
        dtype=torch.float32, lora_rank=RANK)

  def port_sampler(self, model=None, **kwargs):
    return sampler_lib.Sampler(model or self.model, self.vocab, device="cpu",
                               **kwargs)

  def jax_sampler(self, **kwargs):
    key = tuple(sorted(kwargs.items()))
    if key not in self._jax_samplers:
      self._jax_samplers[key] = self.j["sampler"].Sampler(
          self.jmodel, self.jvocab, self.jparams,
          bucket_prompt_lengths=False, **kwargs)
    return self._jax_samplers[key]

  def merged_sampler(self, seed):
    """A solo port Sampler on ``merge_params(base, adapters(seed))``."""
    merged = self.j["lora"].merge_params(self.params, self.adapters_j(seed))
    return self.port_sampler(self.port_model(merged))


@pytest.fixture(scope="module")
def pair():
  return LoraPair()


def _batcher(sampler, num_slots=2, steps=8, **kwargs):
  return serving.ContinuousBatcher(sampler, num_slots=num_slots,
                                   max_steps_default=steps, device="cpu",
                                   multi_lora=True, **kwargs)


def _solo(sampler, prompt, steps, **kwargs):
  return sampler([prompt], total_generation_steps=steps,
                 **kwargs).tokens[0].tolist()


def _check(got, solo_tokens, steps, eos_id):
  assert got == list(solo_tokens[:len(got)]), (got, list(solo_tokens))
  assert len(got) == steps or got[-1] == eos_id, (got, steps)


# -- the layers -------------------------------------------------------------

_LAYER_CASES = [(kind, quantized) for kind in ("dense", "einsum")
                for quantized in (False, True)]
ROWS = 3


@pytest.mark.parametrize("kind,quantized", _LAYER_CASES)
def test_lora_rows_layers_match_jax(kind, quantized):
  """Row 1 of the stack is zero: its output is the base layer's, exactly."""
  jax, jnp = _jax_np()
  jlayers = _jax()["layers"]
  rng = np.random.default_rng(5)
  x = rng.standard_normal((ROWS, 5, 24)).astype(np.float32)
  if kind == "dense":
    jmod = jlayers.QuantizableDense(features=12, lora_rank=RANK,
                                    lora_rows=ROWS, quantized=quantized)
  else:
    jmod = jlayers.Einsum(w_shape=(2, 24, 12), b_shape=(2, 1, 1, 12),
                          eqn="...td,cdD->c...tD", lora_rank=RANK,
                          lora_rows=ROWS, quantized=quantized)
  shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"]
  params = {}
  for name, s in shapes.items():
    if s.dtype == jnp.int8:
      params[name] = rng.integers(-127, 128, s.shape).astype(np.int8)
    elif name.endswith("scale"):
      params[name] = rng.uniform(0.01, 0.02, s.shape).astype(np.float32)
    else:
      params[name] = (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
  for leaf in ("lora_a", "lora_b"):
    params[leaf][1] = 0.0

  def port_layer(p, rows, rank=RANK):
    kw = dict(device="cpu", dtype=torch.float32, quantized=quantized,
              lora_rank=rank, lora_rows=rows)
    if kind == "dense":
      layer = layers.Dense(24, 12, **kw)
    else:
      layer = layers.Einsum((2, 24, 12), (2, 1, 1, 12), "...td,cdD->c...tD",
                            **kw)
    convert.load_flax_params(layer, p)
    return layer

  want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
  row_axis = 0 if kind == "dense" else 1
  with torch.no_grad():
    got = port_layer(params, ROWS)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for i in range(ROWS):
      row = dict(params, lora_a=params["lora_a"][i],
                 lora_b=params["lora_b"][i])
      solo = port_layer(row, 0)(torch.tensor(x[i:i + 1])).numpy()
      np.testing.assert_allclose(np.take(got, [i], axis=row_axis), solo,
                                 rtol=0, atol=1e-5 * np.abs(solo).max())
    base = {k: v for k, v in params.items() if not k.startswith("lora")}
    plain = port_layer(base, 0, rank=0)(torch.tensor(x[1:2])).numpy()
  np.testing.assert_array_equal(np.take(got, [1], axis=row_axis), plain)
  with pytest.raises(ValueError, match="lora_rows=3"):
    port_layer(params, ROWS)(torch.tensor(x[:2]))


def test_lora_rows_model_matches_jax_and_shares_the_base(pair):
  """The port's ``adapter_twin(3)`` holding JAX's stacked adapters gives
  JAX's ``clone(lora_rows=3)`` logits (1e-4, ``test_torch_port_model``'s
  tolerance); ``convert`` builds the same model from the stacked tree; the
  twin's base tensors are the model's own, its adapters new zeros."""
  jnp = _jax_np()[1]
  jl = pair.j["lora"]
  rows = [pair.adapters_j(s) for s in (10, 11)]
  rows.insert(1, _tree_map(np.zeros_like, rows[0]))
  stacked = _jax_np()[0].tree_util.tree_map(lambda *xs: np.stack(xs), *rows)
  base = jl.split_lora(pair.params)[1]
  tokens = np.array([[1, 5, 6, 7, 2], [1, 3, 3, 9, 4], [1, 8, 2, 6, 5]])
  pos = np.tile(np.arange(5)[None], (3, 1))
  want, _ = pair.jmodel.clone(lora_rows=3).apply(
      {"params": jl.merge_params(base, stacked)}, jnp.asarray(tokens),
      jnp.asarray(pos), return_cache=False)

  twin = pair.model.adapter_twin(3)
  named = dict(pair.model.named_parameters())
  for name, p in twin.named_parameters():
    if lora.is_lora_path(name):
      assert p.data_ptr() != named[name].data_ptr() and not p.any()
      assert p.shape == (3, *named[name].shape)
    else:
      assert p.data_ptr() == named[name].data_ptr(), name
  stacks = lora.split_lora(dict(twin.named_parameters()))[0]
  for i, row in enumerate(rows):
    lora.scatter_adapters(stacks, convert.state_dict_from_flax(row), i)
  built = convert.griffin_from_flax_params(
      jl.merge_params(base, stacked), _port_config(pair.config),
      device="cpu", dtype=torch.float32, lora_rank=RANK, lora_rows=3)
  t, p = torch.tensor(tokens), torch.tensor(pos)
  with torch.no_grad():
    got = twin(t, p, return_cache=False)[0].numpy()
    np.testing.assert_array_equal(built(t, p, return_cache=False)[0].numpy(),
                                  got)
  np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
  # The model's own adapters are untouched by the twin's.
  assert all(torch.equal(v, named[n]) for n, v in
             convert.state_dict_from_flax(
                 jl.split_lora(pair.params)[0]).items())
  with pytest.raises(ValueError, match="lora_rank > 0"):
    twin.adapter_twin(2)


# -- the batcher against JAX's ----------------------------------------------


def _drive(batcher, schedule, resolve):
  """Runs a join schedule; returns {name: tokens}."""
  names, results = {}, {}
  for op in schedule:
    if op[0] == "add":
      _, name, prompt, kwargs = op
      names[batcher.add_request(prompt, **resolve(kwargs))] = name
    elif op[0] == "step":
      batcher.step(op[1])
    else:
      for rid, tokens, _ in batcher.run_until_drained(op[1]):
        results[names[rid]] = list(tokens)
  return results


MIXED = [("add", "a", "alpha beta", {"adapters": 100}),
         ("add", "own", "gamma delta eps", {}),
         ("step", 4),
         ("add", "b", "zeta eta", {"adapters": 200}),
         ("drain", 4)]
REUSE = [("add", "a", "alpha beta", {"adapters": 300}),
         ("drain", 2),
         ("add", "own", "gamma delta eps", {}),
         ("drain", 2),
         ("add", "b", "theta alpha", {"adapters": 301}),
         ("drain", 3)]
ADAPTERLESS = [("add", "x", "alpha beta gamma", {}),
               ("step", 2),
               ("add", "y", "delta", {"max_steps": 10}),
               ("drain", 3)]
CHUNKED = [("add", "short", "alpha", {"adapters": 400}),
           ("step", 2),
           ("add", "long", "alpha beta gamma delta eps zeta eta theta alpha",
            {"adapters": 401, "max_steps": 6}),
           ("drain", 1)]
PREFIXED = [("add", "free", "zeta", {"adapters": 500}),
            ("add", "p1", "delta eps", {"prefix_state": True,
                                        "adapters": 501}),
            ("step", 2),
            ("add", "p2", "theta", {"prefix_state": True}),
            ("drain", 2)]

BATCHER_CASES = {
    "mixed": (dict(), dict(num_slots=3, steps=12), MIXED),
    "slot_reuse": (dict(), dict(num_slots=1, steps=6), REUSE),
    "adapterless": (dict(), dict(), ADAPTERLESS),
    "chunked": (dict(prefill_chunk_size=4),
                dict(admission_chunks_per_tick=1), CHUNKED),
    "prefix_state": (dict(), dict(num_slots=3, steps=6), PREFIXED),
}


def _schedule_steps(batcher_kw):
  return batcher_kw.pop("steps", 8)


@pytest.mark.parametrize("case", list(BATCHER_CASES))
def test_multi_lora_tokens_match_jax_batcher(pair, case):
  sampler_kw, batcher_kw, schedule = BATCHER_CASES[case]
  batcher_kw = dict(batcher_kw)
  steps = _schedule_steps(batcher_kw)
  num_slots = batcher_kw.pop("num_slots", 2)
  got = {}
  for side in ("jax", "port"):
    if side == "jax":
      s = pair.jax_sampler(**sampler_kw)
      b = pair.j["serving"].ContinuousBatcher(
          s, num_slots=num_slots, max_steps_default=steps, multi_lora=True,
          **batcher_kw)
    else:
      s = pair.port_sampler(**sampler_kw)
      b = _batcher(s, num_slots=num_slots, steps=steps, **batcher_kw)
    prefix = s.prefill_prefix("alpha beta gamma")

    def resolve(kwargs, side=side, prefix=prefix):
      out = dict(kwargs)
      if "adapters" in out:
        out["adapters"] = pair.adapters(out["adapters"])[side == "port"]
      if out.pop("prefix_state", False):
        out["prefix_state"] = prefix
      return out

    got[side] = _drive(b, schedule, resolve)
  assert got["port"] == got["jax"]
  assert len(got["port"]) == sum(op[0] == "add" for op in schedule)

  # Each request is a solo port Sampler on its merged weights.
  s = pair.port_sampler(**sampler_kw)
  for op in schedule:
    if op[0] != "add":
      continue
    _, name, prompt, kwargs = op
    seed = kwargs.get("adapters")
    solo = s if seed is None else pair.merged_sampler(seed)
    if sampler_kw:
      solo = pair.port_sampler(solo.model, **sampler_kw)
    budget = kwargs.get("max_steps", steps)
    if kwargs.get("prefix_state"):
      # The prefix stays as the sampler prefilled it.
      want = solo([prompt], total_generation_steps=budget,
                  prefix_state=s.prefill_prefix("alpha beta gamma"))
      want = want.tokens[0].tolist()
    else:
      want = _solo(solo, prompt, budget)
    _check(got["port"][name], want, budget, pair.vocab.eos_id())


@pytest.fixture(scope="module")
def golden_lora():
  """The golden fixture's model with seeded rank-4 adapters, and its tiny
  towers, in both packages."""
  from tests import make_golden_fixture as gold  # pylint: disable=import-outside-toplevel

  jnp = _jax_np()[1]
  jvocab, tower, enc, jconfig, _ = gold.build()
  params = convert.read_npz_params(gold.FIXTURE, "p")
  vparams = convert.read_npz_params(gold.FIXTURE, "v")
  lp = LoraPair(config=jconfig, vocab_words=gold.WORDS, params=params)
  ptower = port.ViTConfig(**{f: getattr(tower, f)
                             for f in port.ViTConfig.__dataclass_fields__})
  tenc = convert.encoder_from_flax_params(vparams, ptower, ptower,
                                          device="cpu", dtype=torch.float32)
  ts = modal_sampler.ModalSampler(lp.model, lp.vocab, tenc, device="cpu")
  js = lp.j["modal"].ModalSampler(
      lp.jmodel, jvocab, lp.jparams, vision_encoder=enc,
      vision_params=_tree_map(jnp.asarray, vparams),
      bucket_prompt_lengths=False)
  rng = np.random.default_rng(3)
  pixels = rng.uniform(size=(1, 3, tower.image_size, tower.image_size))
  return lp, js, ts, pixels.astype(np.float32), gold


def test_image_request_with_adapters_matches_jax(golden_lora):
  lp, js, ts, pixels, gold = golden_lora
  jnp = _jax_np()[1]
  got = []
  for side, s, px in (("jax", js, jnp.asarray(pixels)),
                      ("port", ts, torch.tensor(pixels))):
    if side == "jax":
      b = lp.j["serving"].ContinuousBatcher(s, num_slots=2,
                                            max_steps_default=6,
                                            multi_lora=True)
    else:
      b = _batcher(ts, steps=6)
    r_text = b.add_request("the red car",
                           adapters=lp.adapters(7)[side == "port"])
    b.step(2)
    r_img = b.add_request(gold.MM_PROMPT, pixels=px,
                          adapters=lp.adapters(8)[side == "port"])
    res = {r: list(t) for r, t, _ in b.run_until_drained(2)}
    got.append((res[r_text], res[r_img]))
  assert got[1] == got[0]
  merged = lp.j["lora"].merge_params(lp.params, lp.adapters_j(8))
  solo = modal_sampler.ModalSampler(lp.port_model(merged), lp.vocab,
                                    ts.vision_encoder, device="cpu")
  want = solo([gold.MM_PROMPT], total_generation_steps=6,
              pixels=torch.tensor(pixels)).tokens[0].tolist()
  _check(got[1][1], want, 6, lp.vocab.eos_id())


def test_multi_lora_misuse_matches_jax(pair):
  """JAX's errors: a model without adapters, adapters without
  ``multi_lora``, a tree that does not match."""
  from tests.test_torch_port_serving import Pair  # pylint: disable=import-outside-toplevel

  jnp = _jax_np()[1]
  plain = Pair()
  for side in ("jax", "port"):
    if side == "jax":
      batcher = lambda s, **kw: pair.j["serving"].ContinuousBatcher(  # pylint: disable=g-long-lambda
          s, num_slots=2, **kw)
      plain_s, lora_s = plain.jax_sampler(), pair.jax_sampler()
      bogus = {"bogus": jnp.zeros((2, 2))}
    else:
      batcher = lambda s, **kw: serving.ContinuousBatcher(  # pylint: disable=g-long-lambda
          s, num_slots=2, device="cpu", **kw)
      plain_s, lora_s = plain.port_sampler(), pair.port_sampler()
      bogus = {"bogus": torch.zeros(2, 2)}
    with pytest.raises(ValueError, match="lora_rank > 0"):
      batcher(plain_s, multi_lora=True)
    with pytest.raises(ValueError, match="multi_lora=True"):
      batcher(lora_s).add_request(
          "alpha", adapters=pair.adapters(9)[side == "port"])
    with pytest.raises(ValueError, match="does not match"):
      batcher(lora_s, multi_lora=True).add_request("alpha", adapters=bogus)
  _, leaves = pair.adapters(9)
  wrong = dict(leaves)
  name = next(iter(wrong))
  wrong[name] = wrong[name][..., :1]
  with pytest.raises(ValueError, match="does not match"):
    _batcher(pair.port_sampler()).add_request("alpha", adapters=wrong)


def test_twins_share_the_sampler_base(pair):
  """The tick's twin and the admission twin hold the sampler model's base
  tensors (the same storage) and adapter tensors of their own; serving
  leaves the sampler's adapters as they were."""
  s = pair.port_sampler()
  b = _batcher(s, num_slots=2)
  named = dict(s.model.named_parameters())
  before = {n: p.clone() for n, p in named.items() if lora.is_lora_path(n)}
  for twin in (b._model_ml, b._prefill_sampler.model):
    for name, p in twin.named_parameters():
      same = p.data_ptr() == named[name].data_ptr()
      assert same != lora.is_lora_path(name), name
  b.add_request("alpha beta", adapters=pair.adapters(12)[1])
  b.add_request("gamma")
  b.run_until_drained(2)
  assert all(torch.equal(named[n], v) for n, v in before.items())
  assert b._adapter_rows[name].shape[0] == 2
  # The two slots hold the request's adapters and the sampler's own.
  _, leaves = pair.adapters(12)
  assert torch.equal(b._adapter_rows[name][0], leaves[name])
  assert torch.equal(b._adapter_rows[name][1], named[name])


def test_multi_lora_tick_is_a_config_of_its_own(pair):
  s = pair.port_sampler()
  plain = serving.ContinuousBatcher(s, num_slots=2, device="cpu")
  assert _batcher(s)._programs is not plain._programs
  assert _batcher(s)._programs is _batcher(s)._programs


# -- the front end ----------------------------------------------------------


def test_http_adapter_matches_the_direct_batcher(pair):
  from tests.test_torch_port_server import _post, _post_error  # pylint: disable=import-outside-toplevel

  names = {"a": 600, "b": 601}
  direct = _batcher(pair.port_sampler(), steps=6)
  rids = {direct.add_request("alpha beta", adapters=pair.adapters(600)[1]):
          "a", direct.add_request("gamma delta"): None}
  want = {rids[r]: list(t) for r, t, _ in direct.run_until_drained(2)}

  fe = server_lib.ServingFrontend(
      _batcher(pair.port_sampler(), steps=6), step_size=2, device="cpu",
      adapter_resolver=lambda ref: pair.adapters(names[ref])[1])
  srv = server_lib.ServingHTTPServer(fe, port=0)
  try:
    _, body = _post(srv.port, "/v1/generate",
                    {"prompt": "alpha beta", "max_tokens": 6, "adapter": "a"})
    assert body["tokens"] == want["a"]
    _, body = _post(srv.port, "/v1/generate",
                    {"prompt": "gamma delta", "max_tokens": 6})
    assert body["tokens"] == want[None]
    err = _post_error(srv.port, "/v1/generate",
                      {"prompt": "alpha", "adapter": "unknown"})
    assert "KeyError" in err, err
  finally:
    srv.close()

  bare = server_lib.ServingHTTPServer(server_lib.ServingFrontend(
      _batcher(pair.port_sampler()), device="cpu"), port=0)
  try:
    err = _post_error(bare.port, "/v1/generate",
                      {"prompt": "alpha", "adapter": "a"})
    assert "adapter_resolver" in err, err
  finally:
    bare.close()
  with pytest.raises(ValueError, match="adapter_resolver"):
    bare.frontend.submit("alpha", adapter="a")


# -- on the card ------------------------------------------------------------


@requires_cuda
def test_captured_multi_lora_tick_matches_eager():
  """Two multi-LoRA batchers of one configuration share a captured tick:
  each copies its own stacks in before its replays, so each gives the eager
  tick's tokens."""
  torch.backends.cuda.matmul.allow_tf32 = False
  config = common.GriffinConfig(
      vocab_size=len(WORDS) + 4, width=64, mlp_expanded_width=128,
      num_heads=2,
      block_types=(common.TemporalBlockType.RECURRENT,
                   common.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
      logits_soft_cap=30.0, lru_width=64)
  g = torch.Generator("cuda").manual_seed(0)
  model = griffin.Griffin(config, device="cuda", dtype=torch.float32,
                          generator=g, lora_rank=RANK)
  with torch.no_grad():
    for p in model.parameters():
      p.normal_(0.0, 0.5, generator=g)
  vocab = port.SimpleVocab(WORDS)

  def adapters(seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    return {n: 0.3 * torch.randn(t.shape, device="cuda", generator=gen)
            for n, t in lora.split_lora(model.state_dict())[0].items()}

  samplers = {captured: sampler_lib.Sampler(model, vocab,
                                           jit_compile=captured)
              for captured in (False, True)}

  def run(captured, seeds):
    b = serving.ContinuousBatcher(samplers[captured], num_slots=4,
                                  max_steps_default=10, multi_lora=True)
    rids = [b.add_request(p, adapters=None if seed is None else adapters(seed))
            for p, seed in zip(("alpha beta", "gamma", "delta eps zeta"),
                               seeds)]
    b.step(3)
    rids.append(b.add_request("theta", adapters=adapters(99)))
    res = {r: list(t) for r, t, _ in b.run_until_drained(4)}
    return [res[r] for r in rids], b

  graphs = []
  for seeds in ((1, None, 2), (3, 4, None)):
    eager, _ = run(False, seeds)
    captured, b = run(True, seeds)
    assert captured == eager, seeds
    graphs.append(b._programs)
  assert graphs[0] is graphs[1] and graphs[0]  # one shared capture
