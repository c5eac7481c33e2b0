"""The sharded vision towers, multi-LoRA over a tensor-parallel sampler and
the tensor-parallel serving export, against JAX's, on the CPU.

Meshes are ``(1, n)`` ``("data", "model")`` meshes: JAX's ``n`` virtual CPU
devices, the port's ``devices=["cpu"] * n``. Tolerances:

  * the vision tree's ``param_shardings_or_replicated`` specs equal JAX's
    leaf for leaf (mapped through ``convert.py``'s layouts), for the 2B's
    towers (shapes only) and tiny towers in float32 and int8;
  * float32 features of the port's sharded encoder against JAX's sharded
    encode (its ``vision_params`` placed on the mesh) and the port's
    unsharded encode within 1e-4 of the largest feature (summation order),
    at TP-2 and TP-4 on towers whose heads divide into the axis (each shard
    attends over its own head group) and at TP-8 on JAX's tiny tower of
    ``tests/test_serving.py:960`` (2 heads: the attention runs once); the
    int8 (``act_quant``) towers within the same bound of the unsharded
    int8 encode;
  * ``ModalSampler(mesh=)`` tokens equal JAX's (``test_multimodal_smoke.py:
    130``), and a batcher over a TP-8 ``ModalSampler`` gives the solo run's
    tokens (``TestShardedModalServing``), whose 16 tower kernels are split;
  * a ``multi_lora`` batcher over a TP-2 sampler gives the tokens of JAX's
    ``multi_lora`` batcher over a ``(1, 2)`` mesh and of the port's
    unsharded batcher, in two join orders, eager and with
    ``jit_compile=True`` (on the CPU both run eagerly; the card test holds
    the captured tick);
  * the TP export's round trip (``TestShardedServingExport``): logits within
    0.05 of the live model's and the greedy token equal, bit for bit the
    live TP forward, ``num_devices == 2``, a load under another mesh shape
    refused; the operators at the shard shapes.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.inference import modal_sampler as jmodal
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.models import vit as jvit
from cadence_gemma_tpu.ops import quantization as jquant
from cadence_gemma_tpu.parallel import partitioning as jpart
from cadence_gemma_tpu.parallel import sharding as jsharding
from cadence_gemma_tpu.tokenizers import SimpleVocab as JaxVocab
import cadence_gemma_tpu_torch as port
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.checkpoint import export as export_lib
from cadence_gemma_tpu_torch.inference import modal_sampler
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.models import vit
from cadence_gemma_tpu_torch.ops import quantization
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel
from tests import make_golden_fixture as gold
from tests import test_torch_port_multi_lora as ml

FEATURES_REL = 1e-4  # of the largest feature: float32 in other orders
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
# JAX's tiny tower (tests/test_serving.py:960), and a pair whose 4 heads
# divide into 2 and 4 shards (the DINO one with prefix tokens and layer
# scales, as DINOv2-L/14-reg4).
TINY = dict(embed_dim=8, depth=2, num_heads=2, mlp_hidden_dim=16,
            patch_size=4, image_size=16, output_layer=1)
DIVIDING = (dict(embed_dim=16, depth=3, num_heads=4, mlp_hidden_dim=32,
                 patch_size=4, image_size=16, output_layer=1,
                 num_prefix_tokens=5, use_layer_scale=True),
            dict(embed_dim=16, depth=2, num_heads=4, mlp_hidden_dim=48,
                 patch_size=4, image_size=16, output_layer=1,
                 gelu_approximate=True))


def _mesh(n):
  return sharding.make_mesh((1, n), ("data", "model"), devices=["cpu"] * n)


def _jmesh(n):
  return jsharding.make_mesh((1, n), ("data", "model"), jax.devices()[:n])


def _normalized(spec, ndim):
  return tuple(spec) + (None,) * (ndim - len(spec))


def _port_spec(name, spec, ndim):
  """A JAX spec in the port's layout of the leaf (``kernel`` transposed)."""
  entries = _normalized(spec, ndim)
  if name.rsplit(".", 1)[-1] in ("kernel", "kernel_q") and ndim == 2:
    entries = entries[::-1]
  return entries


class Towers:
  """One encoder in both packages: float32 weights (seeded normals, biases
  and layer scales included) in JAX's tree, and the port's encoder over
  them; ``int8`` quantizes the tree (``quantize_params``, ``act_quant``)."""

  def __init__(self, dino, siglip, int8=False, seed=0):
    self.jconfigs = (jvit.ViTConfig(**dino), jvit.ViTConfig(**siglip))
    self.configs = (vit.ViTConfig(**dino), vit.ViTConfig(**siglip))
    self.jenc = jvit.DinoSigLIPEncoder(
        *self.jconfigs, dtype=jnp.float32, param_dtype=jnp.float32,
        quantized=int8, act_quant=int8)
    size = self.configs[0].image_size
    shapes = jax.eval_shape(jvit.DinoSigLIPEncoder(
        *self.jconfigs, dtype=jnp.float32, param_dtype=jnp.float32).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, size, size)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)
    if int8:
      params = jax.tree_util.tree_map(np.asarray, jquant.quantize_params(
          jax.tree_util.tree_map(jnp.asarray, params)))
    self.vparams = params
    self.encoder = convert.encoder_from_flax_params(
        params, *self.configs, device="cpu", dtype=torch.float32,
        quantized=int8, act_quant=int8)
    self.pixels = np.random.default_rng(seed + 1).uniform(
        size=(2, 3, size, size)).astype(np.float32)

  def jax_encode(self, n):
    """JAX's encode with the vision params placed on a (1, n) mesh."""
    jparams = jax.tree_util.tree_map(jnp.asarray, self.vparams)
    placed = jax.device_put(jparams, jpart.param_shardings_or_replicated(
        _jmesh(n), jparams))
    return np.asarray(jax.jit(lambda p, x: self.jenc.apply(
        {"params": p}, x))(placed, jnp.asarray(self.pixels)))


@pytest.mark.parametrize("towers,tree,n", [
    ("2b", "bf16", 2), ("2b", "int8", 8), ("tiny", "bf16", 8),
    ("tiny", "int8", 2), ("dividing", "bf16", 4)])
def test_vision_specs_equal_jax_leaf_for_leaf(towers, tree, n):
  """``param_shardings_or_replicated`` of the vision tree on a (1, n) mesh:
  the port's spec of every leaf is JAX's in the port's layout (column
  ``attn_qkv`` / ``mlp_fc1`` with their biases, row ``attn_proj`` /
  ``mlp_fc2``, everything else replicated; an indivisible dimension
  replicates)."""
  if towers == "2b":
    jconfigs = (jvit.DINOV2_LARGE_REG4_384, jvit.SIGLIP_SO400M_384)
    configs = (vit.DINOV2_LARGE_REG4_384, vit.SIGLIP_SO400M_384)
  else:
    cfgs = (TINY, TINY) if towers == "tiny" else DIVIDING
    jconfigs = tuple(jvit.ViTConfig(**c) for c in cfgs)
    configs = tuple(vit.ViTConfig(**c) for c in cfgs)
  size = configs[0].image_size
  shapes = jax.eval_shape(jvit.DinoSigLIPEncoder(*jconfigs).init,
                          jax.random.PRNGKey(0),
                          jnp.zeros((1, 3, size, size)))["params"]
  if tree == "int8":
    shapes = jax.eval_shape(jquant.quantize_params, shapes)
  state = vit.DinoSigLIPEncoder(*configs, device="meta",
                                quantized=tree == "int8").state_dict()
  jshard = jpart.param_shardings_or_replicated(_jmesh(n), shapes)
  flat_specs = convert._flatten(jax.tree_util.tree_map(  # pylint: disable=protected-access
      lambda s: s.spec, jshard))
  flat_shapes = convert._flatten(shapes)  # pylint: disable=protected-access
  got = partitioning.param_shardings_or_replicated(_mesh(n), state)
  assert set(got) == set(flat_specs)
  split = 0
  for name, s in got.items():
    want = _port_spec(name, flat_specs[name], flat_shapes[name].ndim)
    assert _normalized(s.spec, state[name].ndim) == want, name
    split += "model" in want
  # Four kernels a block are split (their biases and int8 scales too).
  blocks = sum(c.last_block + 1 for c in configs)
  assert split >= 4 * blocks


@pytest.mark.parametrize("case,n", [("dividing", 2), ("dividing", 4),
                                    ("tiny", 8), ("int8", 2)])
def test_sharded_encoder_matches_jax_and_unsharded(case, n):
  """Features of the port's sharded towers against JAX's sharded encode and
  the port's unsharded one (1e-4 of the largest feature)."""
  towers = Towers(*((TINY, TINY) if case == "tiny" else DIVIDING),
                  int8=case == "int8")
  tp = tensor_parallel.tensor_parallel_encoder(towers.encoder, _mesh(n))
  block = tp.dino.blocks[0]
  assert block.head_groups == (case != "tiny")
  assert len(block.attn_qkv.parts) == len(block.mlp_fc2.parts) == n
  pixels = torch.tensor(towers.pixels)
  with torch.no_grad():
    got = tp(pixels)
    want = towers.encoder(pixels)
  bound = FEATURES_REL * want.abs().max().item()
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=bound)
  if case != "int8":  # JAX's int8 path is compared unsharded below
    np.testing.assert_allclose(got.numpy(), towers.jax_encode(n), rtol=0,
                               atol=bound)
  else:
    want_j = np.asarray(jax.jit(lambda p, x: towers.jenc.apply(
        {"params": p}, x))(
            jax.tree_util.tree_map(jnp.asarray, towers.vparams),
            jnp.asarray(towers.pixels)))
    # JAX's int8 activations round in another order: one int8 step of the
    # scale at most, as test_torch_port_quantization holds the towers.
    np.testing.assert_allclose(got.numpy(), want_j, rtol=0,
                               atol=0.05 * np.abs(want_j).max())


def test_int8_pieces_off_16_sit_in_padded_rows():
  """The int8 towers' pieces at TP-2: a depth off 16 (``attn_proj``'s 8 and
  SigLIP's ``mlp_fc2``'s 24 columns a shard) is stored once in rows padded
  to 16, which the wgmma forward's tensor map reads in place; every other
  int8 piece is contiguous."""
  towers = Towers(*DIVIDING, int8=True)
  tp = tensor_parallel.tensor_parallel_encoder(towers.encoder, _mesh(2))
  depths = set()
  for name, p in tp.named_parameters():
    if p.dtype == torch.int8:
      k = p.shape[-1]
      assert p.stride() == (k + -k % 16, 1), name
      depths.add(k)
  assert {8, 24} <= depths and 16 in depths


def test_encoder_without_model_axis_replicates():
  """A mesh without a model axis replicates every leaf, as JAX does: the
  towers run whole on its first device and equal the unsharded encode."""
  towers = Towers(*DIVIDING)
  mesh = sharding.make_mesh((2,), ("data",), devices=["cpu"] * 2)
  tp = tensor_parallel.tensor_parallel_encoder(towers.encoder, mesh)
  assert len(tp.dino.blocks[0].attn_qkv.parts) == 1
  pixels = torch.tensor(towers.pixels)
  with torch.no_grad():
    torch.testing.assert_close(tp(pixels), towers.encoder(pixels), rtol=0,
                               atol=0)


def _port_vit(tower):
  return vit.ViTConfig(**{f: getattr(tower, f)
                          for f in vit.ViTConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def golden():
  """The golden fixture's model and tiny towers in both packages."""
  jvocab, tower, enc, jconfig, jmodel = gold.build()
  params = convert.read_npz_params(gold.FIXTURE, "p")
  vparams = convert.read_npz_params(gold.FIXTURE, "v")
  fields = jconfig._asdict()
  fields["block_types"] = tuple(common.TemporalBlockType[b.name]
                                for b in jconfig.block_types)
  fields["scan_type"] = common.ScanType[jconfig.scan_type.name]
  model = convert.griffin_from_flax_params(
      params, common.GriffinConfig(**fields), device="cpu",
      dtype=torch.float32)
  encoder = convert.encoder_from_flax_params(
      vparams, _port_vit(tower), _port_vit(tower), device="cpu",
      dtype=torch.float32)
  return dict(jvocab=jvocab, enc=enc, jmodel=jmodel,
              jparams=jax.tree_util.tree_map(jnp.asarray, params),
              jvparams=jax.tree_util.tree_map(jnp.asarray, vparams),
              model=model, encoder=encoder, vocab=port.SimpleVocab(gold.WORDS))


def test_tp_modal_sampler_matches_jax(golden):
  """Pixels -> tokens over a TP-2 mesh: the port's tokens are JAX's TP-2
  ``ModalSampler``'s and the port's unsharded one's, from a path and from
  pixels; ``encode_image`` runs sharded and equals the unsharded encode."""
  photo = str(gold.FIXTURE).replace("golden_tiny.npz", "dog.jpg")
  jtp = jmodal.ModalSampler(
      golden["jmodel"], golden["jvocab"], golden["jparams"],
      vision_encoder=golden["enc"], vision_params=golden["jvparams"],
      bucket_prompt_lengths=False, mesh=_jmesh(2))
  want = jtp([gold.MM_PROMPT], total_generation_steps=4, img_path=photo)
  tp = modal_sampler.ModalSampler(golden["model"], golden["vocab"],
                                  golden["encoder"], device="cpu",
                                  mesh=_mesh(2))
  assert isinstance(tp.vision_encoder, tensor_parallel.TensorParallelEncoder)
  one = modal_sampler.ModalSampler(golden["model"], golden["vocab"],
                                   golden["encoder"], device="cpu")
  got = tp([gold.MM_PROMPT], total_generation_steps=4, img_path=photo)
  assert got.tokens[0].tolist() == np.asarray(want.tokens[0]).tolist()
  assert got.tokens[0].tolist() == one(
      [gold.MM_PROMPT], total_generation_steps=4,
      img_path=photo).tokens[0].tolist()
  pixels = golden["encoder"].preprocess_path(photo)
  by_pixels = tp([gold.MM_PROMPT], total_generation_steps=4, pixels=pixels)
  assert by_pixels.tokens[0].tolist() == got.tokens[0].tolist()
  torch.testing.assert_close(tp.encode_image(photo), one.encode_image(photo),
                             rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def modal_tp8():
  """JAX's TestShardedModalServing setup in both packages: its config,
  init seeds 11 and 12, an 8-way model axis."""
  jvocab = JaxVocab(WORDS)
  tower = jvit.ViTConfig(**TINY)
  enc = jvit.DinoSigLIPEncoder(dino_config=tower, siglip_config=tower,
                               dtype=jnp.float32, param_dtype=jnp.float32)
  config = jcommon.GriffinConfig(
      vocab_size=jvocab.GetPieceSize(), width=16, mlp_expanded_width=32,
      num_heads=2, block_types=(jcommon.TemporalBlockType.RECURRENT,
                                jcommon.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
      logits_soft_cap=30.0, lru_width=16,
      scan_type=jcommon.ScanType.LINEAR_NATIVE,
      vision_tokens=tower.num_patches, vision_width=2 * tower.embed_dim,
      vl_expanded_width=24)
  jmodel = jgriffin.Griffin(config, dtype=jnp.float32,
                            param_dtype=jnp.float32,
                            gradient_checkpointing=False)
  params = jax.jit(jmodel.init)(jax.random.PRNGKey(11),
                                jnp.ones((1, 4), jnp.int32),
                                jnp.arange(4)[None])["params"]
  vparams = jax.jit(enc.init)(jax.random.PRNGKey(12),
                              jnp.zeros((1, 3, 16, 16)))["params"]
  fields = config._asdict()
  fields["block_types"] = tuple(common.TemporalBlockType[b.name]
                                for b in config.block_types)
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
  model = convert.griffin_from_flax_params(
      as_np(params), common.GriffinConfig(**fields), device="cpu",
      dtype=torch.float32)
  encoder = convert.encoder_from_flax_params(
      as_np(vparams), _port_vit(tower), _port_vit(tower), device="cpu",
      dtype=torch.float32)
  vocab = port.SimpleVocab(WORDS)
  solo = modal_sampler.ModalSampler(model, vocab, encoder, device="cpu")
  tp = modal_sampler.ModalSampler(model, vocab, encoder, device="cpu",
                                  mesh=_mesh(8))
  jsolo = jmodal.ModalSampler(jmodel, jvocab, params, vision_encoder=enc,
                              vision_params=vparams,
                              bucket_prompt_lengths=False)
  pixels = np.asarray(jax.random.uniform(jax.random.PRNGKey(3),
                                         (1, 3, 16, 16)))
  return dict(solo=solo, tp=tp, jsolo=jsolo, pixels=pixels, vocab=vocab)


def test_tower_weights_are_distributed(modal_tp8):
  """The 16 tower kernels (2 towers x 2 blocks x 4 matmuls) are split: each
  shard's piece is smaller than the leaf."""
  tp, solo = modal_tp8["tp"], modal_tp8["solo"]
  full = dict(solo.vision_encoder.named_parameters())
  checked = 0
  for tower in ("dino", "siglip"):
    for i, block in enumerate(getattr(tp.vision_encoder, tower).blocks):
      for name in ("attn_qkv", "attn_proj", "mlp_fc1", "mlp_fc2"):
        shards = getattr(block, name)
        assert len(shards.parts) == 8, (tower, i, name)
        leaf = full[f"{tower}.block{i}.{name}.kernel"]
        for shard in shards.shards:
          assert shard.kernel.numel() == leaf.numel() // 8
          # A view of the encoder's own weights: nothing is copied.
          assert shard.kernel.untyped_storage().data_ptr() == (
              leaf.untyped_storage().data_ptr())
        checked += 1
  assert checked == 16


def test_tp_modal_batcher_matches_solo(modal_tp8):
  """Pixels through the batcher over the TP-8 ``ModalSampler``: the solo
  unsharded run's tokens, and JAX's solo run's."""
  steps, pixels = 6, modal_tp8["pixels"]
  want = modal_tp8["solo"](["alpha beta"], total_generation_steps=steps,
                           pixels=torch.tensor(pixels)).tokens[0].tolist()
  jwant = np.asarray(modal_tp8["jsolo"](
      ["alpha beta"], total_generation_steps=steps,
      pixels=jnp.asarray(pixels)).tokens[0]).tolist()
  assert want == jwant
  batcher = serving.ContinuousBatcher(modal_tp8["tp"], num_slots=2,
                                      max_steps_default=steps, device="cpu")
  rid = batcher.add_request("alpha beta", pixels=torch.tensor(pixels))
  other = batcher.add_request("gamma delta")
  got = {r: list(t) for r, t, _ in batcher.run_until_drained(2)}
  assert got[rid] == want[:len(got[rid])] and len(got[rid]) == steps
  text = modal_tp8["solo"](["gamma delta"], total_generation_steps=steps)
  assert got[other] == text.tokens[0].tolist()[:len(got[other])]


@pytest.fixture(scope="module")
def lora_pair():
  return ml.LoraPair()


ORDERS = {"A": ml.MIXED,
          "B": [("add", "b", "zeta eta", {"adapters": 200}),
                ("add", "a", "alpha beta", {"adapters": 100}),
                ("step", 3),
                ("add", "own", "gamma delta eps", {}),
                ("drain", 4)]}


@pytest.mark.parametrize("order", list(ORDERS))
def test_multi_lora_over_tp_matches_jax_and_unsharded(lora_pair, order):
  """A 3-slot ``multi_lora`` batcher over a TP-2 sampler: JAX's
  ``multi_lora`` batcher over a (1, 2) mesh, the port's unsharded batcher
  and the port's TP batcher built with ``jit_compile`` on and off give the
  same tokens; each request is a solo Sampler's on its merged weights."""
  schedule = ORDERS[order]
  got = {}
  for side in ("jax", "port", "tp", "tp eager"):
    if side == "jax":
      s = lora_pair.jax_sampler(mesh=_jmesh(2))
      b = lora_pair.j["serving"].ContinuousBatcher(
          s, num_slots=3, max_steps_default=12, multi_lora=True)
    else:
      s = lora_pair.port_sampler(
          mesh=None if side == "port" else _mesh(2),
          jit_compile=side != "tp eager")
      b = ml._batcher(s, num_slots=3, steps=12)  # pylint: disable=protected-access

    def resolve(kwargs, side=side):
      out = dict(kwargs)
      if "adapters" in out:
        out["adapters"] = lora_pair.adapters(out["adapters"])[side != "jax"]
      return out

    got[side] = ml._drive(b, schedule, resolve)  # pylint: disable=protected-access
  assert got["tp"] == got["jax"] == got["port"] == got["tp eager"]
  for op in schedule:
    if op[0] == "add":
      _, name, prompt, kwargs = op
      seed = kwargs.get("adapters")
      solo = (lora_pair.port_sampler() if seed is None
              else lora_pair.merged_sampler(seed))
      ml._check(got["tp"][name], ml._solo(solo, prompt, 12), 12,  # pylint: disable=protected-access
                lora_pair.vocab.eos_id())


def test_tp_adapter_twin_shares_the_base(lora_pair):
  """``TensorParallelGriffin.adapter_twin(3)``: its base pieces are the TP
  model's own tensors; its stacks are whole ``[3, ...]`` zeros on the first
  device that every shard reads through a view, and its forward over three
  rows of adapters is the unsharded twin's (within the TP tests' 2e-4); a
  shard's copy (a broken view, as on another device) is refreshed by
  ``refresh_adapters``."""
  tp = tensor_parallel.tensor_parallel(lora_pair.model, _mesh(2))
  twin = tp.adapter_twin(3)
  own = dict(tp.named_parameters())
  for name, p in twin.named_parameters():
    if name.rsplit(".", 1)[-1] not in ("lora_a", "lora_b"):
      assert p.data_ptr() == own[name].data_ptr(), name
  stacks = twin.adapter_leaves()
  want = lora_pair.model.adapter_leaves()
  assert {n: (3, *t.shape) for n, t in want.items()} == {
      n: tuple(t.shape) for n, t in stacks.items()}
  assert all(not t.any() for t in stacks.values())
  # Three rows of adapters: the twin's forward is the unsharded twin's, and
  # so is a stacked Griffin placed directly (its stacks replicated).
  gtwin = lora_pair.model.adapter_twin(3)
  for row in range(3):
    rows = lora_pair.adapters(20 + row)[1]
    ml.lora.scatter_adapters(stacks, rows, row)
    ml.lora.scatter_adapters(gtwin.adapter_leaves(), rows, row)
  tokens = torch.tensor([[1, 5, 6, 7, 2], [1, 3, 3, 9, 4], [1, 8, 2, 6, 5]])
  pos = torch.arange(5)[None].repeat(3, 1)
  with torch.no_grad():
    logits = gtwin(tokens, pos, return_cache=False)[0]
    placed = tensor_parallel.tensor_parallel(gtwin, _mesh(2))
    for got in (twin(tokens, pos, return_cache=False)[0],
                placed(tokens, pos, return_cache=False)[0]):
      torch.testing.assert_close(got, logits, rtol=0, atol=2e-4)
  _, adapters = lora_pair.adapters(9)
  alias = next(a for a in twin.aliases
               if a.name.endswith("lora_b") and a.dim is not None)
  alias.tensor.data = alias.tensor.data.clone()  # a copy, not a view
  for row in range(3):
    ml.lora.scatter_adapters(stacks, adapters, row)
  assert not torch.equal(alias.tensor, tensor_parallel.region(
      twin.leaves[alias.name][0].tensor, alias))
  twin.refresh_adapters()
  assert torch.equal(alias.tensor, tensor_parallel.region(
      twin.leaves[alias.name][0].tensor, alias))
  # The TP model's own adapters, whole, are the unsharded model's.
  for name, t in tp.adapter_leaves().items():
    assert torch.equal(t, want[name]), name
  with pytest.raises(ValueError, match="lora_rank > 0"):
    twin.adapter_twin(2)


# -- the tensor-parallel export ---------------------------------------------

BATCH, PROMPT = 1, 4


def _export_setup(**flags):
  """JAX's ``_tiny_model`` config (``tests/test_export.py``) on the port's
  kernel paths, seeded float32 weights."""
  from tests import test_torch_port_export as te  # pylint: disable=import-outside-toplevel

  jmodel = jgriffin.Griffin(te._jax_config(), dtype=jnp.float32,  # pylint: disable=protected-access
                            param_dtype=jnp.float32,
                            gradient_checkpointing=False)
  shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.ones((1, 4), jnp.int32),
                          jnp.arange(4)[None])["params"]
  rng = np.random.default_rng(0)
  params = jax.tree_util.tree_map(
      lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
      shapes)
  model = convert.griffin_from_flax_params(
      params, te._port_config(), device="cpu", dtype=torch.float32,  # pylint: disable=protected-access
      use_flash_attention=True, **flags)
  return jmodel, params, model


def _placed(params, mesh):
  return sharding.place_state_dict(
      params, partitioning.griffin_param_shardings(mesh, params))


def test_tp_export_round_trip(tmp_path):
  """``TestShardedServingExport``: the loaded TP artifact's prefill and
  decode step within 0.05 of the live model's (and of JAX's jitted live
  functions), the greedy token equal; bit for bit the live TP forward; the
  meta's ``num_devices`` and ``mesh_axes``; another mesh shape refused; the
  programs hold each shard's operator at its width (the LRU scan at 8 of 16
  features, the window attention at one of two heads), none in the
  decode step."""
  jmodel, jparams, model = _export_setup()
  mesh = sharding.make_mesh((2,), ("model",), devices=["cpu"] * 2)
  params = dict(model.named_parameters())
  exp = export_lib.export_serving(model, params, BATCH, PROMPT,
                                  cache_dtype=torch.float32, mesh=mesh)
  assert exp.meta["num_devices"] == 2
  assert exp.meta["mesh_axes"] == {"model": 2}
  assert _op_shapes(exp) == [{"lru_scan_forward": [(1, 4, 8)] * 2,
                              "window_attention_forward": [(1, 4, 1, 8)] * 2},
                             {}]
  export_lib.save_serving_export(exp, str(tmp_path / "tp"))
  loaded = export_lib.load_serving_export(str(tmp_path / "tp"), mesh=mesh)
  placed = _placed(params, mesh)
  tokens = torch.tensor([[3, 5, 7, 9]], dtype=torch.int32)
  positions = torch.arange(4, dtype=torch.int32)[None]
  got, cache = loaded.prefill(placed, tokens, positions)
  tok = got[:, -1].argmax(-1, keepdim=True).int()
  pos = torch.full((1, 1), 4, dtype=torch.int32)
  step, _ = loaded.decode_step(placed, cache, tok, pos)
  tp = tensor_parallel.tensor_parallel(model, mesh)
  with torch.no_grad():
    want, want_cache = model(tokens, positions, last_logits_only=True)
    live, live_cache = tp(tokens, positions, last_logits_only=True)
    want_step, _ = model(tok, pos, cache=want_cache)
    live_step, _ = tp(tok, pos, cache=live_cache)
  assert torch.equal(got, live) and torch.equal(step, live_step)
  torch.testing.assert_close(got, want, rtol=0, atol=0.05)
  torch.testing.assert_close(step, want_step, rtol=0, atol=0.05)
  assert torch.equal(tok, want[:, -1].argmax(-1, keepdim=True).int())
  from cadence_gemma_tpu.checkpoint import export as jexport  # pylint: disable=import-outside-toplevel
  jprefill, jdecode = jexport.make_serving_functions(jmodel)
  jwant, jcache = jax.jit(jprefill)({"params": jparams},
                                    jnp.asarray(tokens.numpy()),
                                    jnp.asarray(positions.numpy()))
  np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0,
                             atol=0.05)
  jstep, _ = jax.jit(jdecode)({"params": jparams}, jcache,
                              jnp.asarray(tok.numpy()), jnp.asarray(pos))
  np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=0,
                             atol=0.05)
  for other in (None, sharding.make_mesh((4,), ("model",),
                                         devices=["cpu"] * 4)):
    with pytest.raises(ValueError, match="mesh of shape"):
      export_lib.load_serving_export(str(tmp_path / "tp"), mesh=other)
  unsharded = dict(exp.meta, num_devices=1, mesh_axes=None)
  with pytest.raises(ValueError, match="mesh of shape None"):
    export_lib.LoadedServing(exp.prefill, exp.decode_step, unsharded, mesh)


def _op_shapes(exp: export_lib.ServingExport) -> list[dict[str, list]]:
  """Each program's (prefill, decode step) operator calls, by operator:
  the shapes of their first tensor argument."""
  out = []
  for blob in (exp.prefill, exp.decode_step):
    program = torch.export.load(io.BytesIO(blob))
    found = {}
    for node in program.graph.nodes:
      name = getattr(node.target, "name", lambda: "")()
      if name.startswith("cadence_gemma_tpu_torch::"):
        arg = node.args[0].meta["val"]
        found.setdefault(name.split("::")[1], []).append(tuple(arg.shape))
    out.append(found)
  return out


def test_tp_export_ops_at_shard_shapes(tmp_path):
  """A TP-2 export of the int8 (``quantize_params``) model with the fused
  epilogue holds each shard's operator at its shard's width (the LRU scan at
  8 of 16 features, the window attention at one of two heads, each shard's
  int8 products) and the epilogue's on the replicated residual, once a
  block; the loaded artifact reproduces the live TP int8 model bit for
  bit."""
  _, _, model = _export_setup()
  params = quantization.quantize_params(model.state_dict())
  model = griffin.Griffin(model.config, device="meta", dtype=torch.float32,
                          use_flash_attention=True, quantized=True,
                          fused_epilogue=True)
  mesh = _mesh(2)
  exp = export_lib.export_serving(model, params, 2, 12,
                                  cache_dtype=torch.float32, mesh=mesh)
  prefill, decode = _op_shapes(exp)
  assert prefill["lru_scan_forward"] == [(2, 12, 8)] * 2
  assert [s[2] for s in prefill["window_attention_forward"]] == [1, 1]
  assert len(prefill["add_rmsnorm"]) == len(decode["add_rmsnorm"]) == 2
  # Every product of both shards (the single KV head's once) and each
  # shard's logits: more than the unsharded model's 14.
  assert len(prefill["int8_weight_matmul"]) == len(
      decode["int8_weight_matmul"]) > 14
  export_lib.save_serving_export(exp, str(tmp_path))
  loaded = export_lib.load_serving_export(str(tmp_path), mesh=mesh)
  live = griffin.Griffin(model.config, device="meta", dtype=torch.float32,
                         use_flash_attention=True, quantized=True,
                         fused_epilogue=True)
  live.to_empty(device="cpu")
  live.load_state_dict(params)
  tp = tensor_parallel.tensor_parallel(live, mesh)
  tokens = torch.tensor(np.random.default_rng(6).integers(
      0, 32, (2, 12)), dtype=torch.int32)
  positions = torch.arange(12, dtype=torch.int32)[None].repeat(2, 1)
  got, _ = loaded.prefill(_placed(params, mesh), tokens, positions)
  with torch.no_grad():
    want, _ = tp(tokens, positions, last_logits_only=True)
  assert torch.equal(got, want)


def test_tp_export_refuses_several_cards(monkeypatch):
  """A mesh of several distinct cards is refused naming the process-per-
  card item (a mesh that repeats one card exports)."""
  _, _, model = _export_setup()
  cards = sharding.make_mesh((1, 2), ("data", "model"),
                             devices=["cuda:0", "cuda:1"])
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  with pytest.raises(NotImplementedError, match="item 14g"):
    export_lib.export_serving(model, model.state_dict(), 1, 4, mesh=cards)
