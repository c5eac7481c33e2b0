"""The port's image SFT and two-stage recipe vs the JAX package, on the CPU.

A tiny Griffin (blocks R, A; width 16; window 8; 4 visual tokens of width
12) with JAX's seeded float32 weights in both packages, the sequential scan
and the einsum attention on each side, so the two differ only in summation
order:

  * the multimodal loss (visual positions padded out of the targets)
    within 1e-5 relative, each gradient leaf within 1e-4 of its largest
    value;
  * ``frozen_train_step`` over 3 steps (one of them on a batch without an
    image, where the connector gets no gradient and AdamW still decays it):
    the connector within 1e-4 of each leaf's largest value, every other
    weight bit for bit;
  * ``two_stage_sft`` on a tiny JPEG dataset (``DatasetBuilder`` with
    ``load_pixels``, a fixed pooled projection of the pixels standing in
    for the towers), with and without gradient accumulation: each logged
    loss within 1e-4 relative; the final weights within 1e-4 of each leaf's
    largest value but for at most 0.1 % of the elements, and those within
    Adam's bound of 2 lr an update. Adam moves a weight by about lr whatever
    its gradient's size, so a gradient that float32 summation order leaves
    at noise level (1-2 elements of 6596 here) moves its weight by up to lr
    either way;
  * the data: image records' tokens, masks and paths equal JAX's, and the
    ctypes loader's pixels equal JAX's ``load_jpeg_batch`` bit for bit
    (one native library; PIL for a PNG).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu import tokenizers as jtokenizers
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.training import data as jdata
from cadence_gemma_tpu.training import train_loop as jtrain_loop
from cadence_gemma_tpu.training import trainer as jtrainer
from cadence_gemma_tpu.utils import image_cpp as jimage_cpp
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch import tokenizers
from cadence_gemma_tpu_torch.training import data
from cadence_gemma_tpu_torch.training import train_loop as tl
from cadence_gemma_tpu_torch.training import trainer
from cadence_gemma_tpu_torch.utils import image_cpp

PAD = 0
WORDS = [f"w{i}" for i in range(40)]


def _jax_config():
  return jcommon.GriffinConfig(
      vocab_size=len(WORDS) + 4, width=16, mlp_expanded_width=32,
      num_heads=2,
      block_types=(jcommon.TemporalBlockType.RECURRENT,
                   jcommon.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
      logits_soft_cap=30.0, lru_width=16,
      scan_type=jcommon.ScanType.LINEAR_NATIVE, vision_tokens=4,
      vision_width=12, vl_expanded_width=20,
  )


def _port_config():
  config = _jax_config()
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types)
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


@pytest.fixture(scope="module")
def jax_pair():
  model = jgriffin.Griffin(_jax_config(), dtype=jnp.float32,
                           param_dtype=jnp.float32)
  params = model.init(jax.random.PRNGKey(0), jnp.ones((1, 6), jnp.int32),
                      jnp.arange(6)[None])["params"]
  # Seeded normals of std 0.3: the initializer's scales give a tiny model
  # whose gradients are too small to move Adam off its first-step bound.
  rng = np.random.default_rng(0)
  params = jax.tree_util.tree_map(
      lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32),
      params)
  return model, params


def _port_model(params):
  return convert.griffin_from_flax_params(
      params, _port_config(), device="cpu", dtype=torch.float32)


def _batch(seed=1):
  """Two rows of 12 tokens (row 1 right-padded after 9), their loss mask
  and [2, 4, 12] image features."""
  rng = np.random.default_rng(seed)
  tokens = rng.integers(4, len(WORDS) + 4, (2, 12)).astype(np.int32)
  tokens[:, 0] = 1
  tokens[1, 9:] = PAD
  mask = np.zeros(tokens.shape, bool)
  mask[0, 5:] = True
  mask[1, 4:9] = True
  img = rng.standard_normal((2, 4, 12)).astype(np.float32)
  return tokens, mask, img


def _t(tokens, mask, img):
  return (torch.tensor(tokens).long(), torch.tensor(mask),
          None if img is None else torch.tensor(img))


def _assert_leaves_close(got: dict, want: dict, rel: float, only=None):
  for name, value in want.items():
    if only is not None and not only(name):
      continue
    tol = rel * max(float(value.abs().max()), 1e-6)
    torch.testing.assert_close(got[name], value, atol=tol, rtol=0, msg=name)


def test_multimodal_loss_and_gradients_match_jax(jax_pair):
  model, params = jax_pair
  tokens, mask, img = _batch()

  def loss_fn(p):
    return jtrainer.forward_and_loss_fn(
        p, model=model, input_tokens=jnp.asarray(tokens),
        input_mask=jnp.asarray(mask),
        positions=jtrainer.get_positions(jnp.asarray(tokens), PAD),
        image=jnp.asarray(img), vocab_chunk_size=8)

  loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
  port = _port_model(params)
  t_tokens, t_mask, t_img = _t(tokens, mask, img)
  loss = trainer.forward_and_loss_fn(
      port, t_tokens, t_mask, trainer.get_positions(t_tokens, PAD),
      image=t_img, vocab_chunk_size=8)
  loss.backward()
  np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
  want = convert.state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             grads_j))
  grads = {n: p.grad for n, p in port.named_parameters()}
  assert all(g is not None for g in grads.values())
  assert float(grads["vl_connector.ffw_up.w"].abs().max()) > 0
  _assert_leaves_close(grads, want, 1e-4)
  # The visual positions take no loss: the text alone through the
  # validation step gives another value, the image one the same.
  with torch.no_grad():
    assert float(trainer.validation_step(port, PAD, t_tokens, t_mask,
                                         t_img)) == pytest.approx(
                                             float(loss), rel=1e-6)
  np.testing.assert_allclose(
      float(jtrainer.validation_step(model, params, PAD, jnp.asarray(tokens),
                                     jnp.asarray(mask), jnp.asarray(img))),
      float(loss), rtol=1e-5)


def test_frozen_train_step_matches_jax(jax_pair):
  """Three connector-only AdamW steps (decay on every connector leaf, clip
  over the connector's gradient alone), the second without an image."""
  model, params = jax_pair
  lr = 1e-2
  batches = [_batch(1), (*_batch(2)[:2], None), _batch(3)]
  optimizer_j = jtrainer.make_optimizer(lr, use_decay_mask=False)
  params_j = jax.tree_util.tree_map(jnp.array, params)
  state_j = optimizer_j.init(params_j["vl_connector"])
  losses_j = []
  for tokens, mask, img in batches:
    loss_j, params_j, state_j = jtrainer.frozen_train_step(
        model, params_j, optimizer_j, state_j, PAD, jnp.asarray(tokens),
        jnp.asarray(mask), None if img is None else jnp.asarray(img))
    losses_j.append(float(loss_j))

  port = _port_model(params)
  before = {n: v.clone() for n, v in port.state_dict().items()}
  optimizer = trainer.make_optimizer(port.vl_connector, lr,
                                     use_decay_mask=False)
  losses = []
  for i, batch in enumerate(batches):
    losses.append(float(trainer.frozen_train_step(port, optimizer, PAD,
                                                  *_t(*batch))))
    if i == 1:
      # No image: no gradient reached the connector, AdamW decayed it.
      after = port.vl_connector.ffw_up.w.detach()
      assert not torch.equal(after, before["vl_connector.ffw_up.w"])
  np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
  want = convert.state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             params_j))
  state = port.state_dict()
  _assert_leaves_close(state, want, 1e-4,
                       only=lambda n: n.startswith("vl_connector."))
  for name, value in before.items():
    if not name.startswith("vl_connector."):
      assert torch.equal(state[name], value), name
  assert all(p.grad is None for p in port.parameters())
  assert all(p.requires_grad for p in port.parameters())
  with pytest.raises(ValueError, match="connector alone"):
    trainer.frozen_train_step(port, trainer.make_optimizer(port, lr), PAD,
                              *_t(*batches[0]))


# A fixed "encoder": each image pooled to 2 x 2 cells of its 3 channels,
# projected to the connector's 12 features, the same in both packages.
_PROJECTION = np.random.default_rng(9).standard_normal((3, 12)).astype(
    np.float32)


def _encode_jax(pixels):
  b = pixels.shape[0]
  pooled = pixels.reshape(b, 3, 2, 192, 2, 192).mean(axis=(3, 5))
  cells = jnp.transpose(pooled.reshape(b, 3, 4), (0, 2, 1))
  return (cells - 0.5) * 4.0 @ jnp.asarray(_PROJECTION)


def _encode_port(pixels):
  b = pixels.shape[0]
  pooled = pixels.reshape(b, 3, 2, 192, 2, 192).mean(dim=(3, 5))
  cells = pooled.reshape(b, 3, 4).transpose(1, 2)
  return (cells - 0.5) * 4.0 @ torch.tensor(_PROJECTION)


def _write_images(root, n):
  from PIL import Image  # pylint: disable=import-outside-toplevel

  rng = np.random.default_rng(4)
  for i in range(n):
    # Smooth colour ramps plus noise, 96 x 128, so the 2 x 2 cells differ.
    y, x = np.mgrid[0:96, 0:128]
    base = np.stack([x * (i + 1), y * 2, (x + y) * (3 - i % 3)], -1)
    img = (base % 255 + rng.integers(0, 40, base.shape)).clip(0, 255)
    Image.fromarray(img.astype(np.uint8)).save(root / f"im{i}.jpg",
                                               quality=90)


def _records(n):
  return [{"image": f"im{i}.jpg", "conversations": [
      {"from": "human", "value": f"<image>\nw{i} w{i + 1} w{i + 2}"},
      {"from": "gpt", "value": f"w{i + 3} w{(2 * i) % 40} w{i + 5}"}]}
      for i in range(n)]


@pytest.fixture(scope="module")
def image_dataset(tmp_path_factory):
  root = tmp_path_factory.mktemp("images")
  _write_images(root, 6)
  path = root / "records.json"
  path.write_text(json.dumps(_records(6)))
  return root, path


def _builders(image_dataset, **kwargs):
  root, path = image_dataset
  kwargs = dict(json_path=str(path), image_root=str(root), max_seq_len=20,
                batch_size=2, load_pixels=True, **kwargs)
  return (lambda: jdata.DatasetBuilder(jtokenizers.SimpleVocab(WORDS),
                                       **kwargs),
          lambda: data.DatasetBuilder(tokenizers.SimpleVocab(WORDS),
                                      **kwargs))


@pytest.mark.parametrize("accumulate", [1, 2])
def test_two_stage_sft_matches_jax(jax_pair, image_dataset, accumulate):
  """Stage 1 (the connector, 3 steps) then stage 2 (everything, 3 steps)
  through ``two_stage_sft`` on image batches in both packages."""
  model, params = jax_pair
  jax_data, port_data = _builders(image_dataset)
  cfg = dict(learning_rate=1e-2, max_steps=3, eval_every_n=1,
             num_epochs=2, gradient_accumulation_steps=accumulate)
  logged_j, logged = [], []
  out_j = jtrain_loop.two_stage_sft(
      model, jax.tree_util.tree_map(jnp.array, params), jax_data,
      jtrain_loop.TrainingConfig(checkpoint_every_n=None, **cfg),
      jtrain_loop.TrainingConfig(checkpoint_every_n=None, **cfg),
      encode_image=_encode_jax, pad_id=PAD,
      log_metrics=lambda m, s: logged_j.append(m["train_loss"]))
  port = _port_model(params)
  before = {n: v.clone() for n, v in port.state_dict().items()}
  tl.two_stage_sft(
      port, port_data, tl.TrainingConfig(**cfg), tl.TrainingConfig(**cfg),
      encode_image=_encode_port, pad_id=PAD, device="cpu",
      log_metrics=lambda m, s: logged.append(m["train_loss"]))
  assert len(logged) == len(logged_j) == 6
  np.testing.assert_allclose(logged, logged_j, rtol=1e-4)
  want = convert.state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             out_j))
  state = port.state_dict()
  updates = 2 * (cfg["max_steps"] // accumulate)
  outside = total = 0
  for name, value in want.items():
    err = (state[name] - value).abs()
    assert float(err.max()) <= 2 * cfg["learning_rate"] * updates, name
    outside += int((err > 1e-4 * float(value.abs().max())).sum())
    total += value.numel()
  assert outside <= 1e-3 * total, (outside, total)
  assert not torch.equal(state["embedder.input_embedding"],
                         before["embedder.input_embedding"])


def test_train_loop_validates_with_images(jax_pair, image_dataset):
  """``validation_data`` with images: the logged val_loss is the mean of
  JAX's ``validation_step`` over the batches on the same weights."""
  model, params = jax_pair
  jax_data, port_data = _builders(image_dataset)
  want = np.mean([
      float(jtrainer.validation_step(
          model, params, PAD, jnp.asarray(b.input_tokens),
          jnp.asarray(b.target_mask), _encode_jax(jnp.asarray(b.pixels))))
      for b in jax_data()])
  logged = []
  port = _port_model(params)
  tl.train_loop(
      port, list(port_data())[:1],
      tl.TrainingConfig(learning_rate=0.0, weight_decay=0.0,
                        eval_every_n=1),
      validation_data=port_data(), encode_image=_encode_port, device="cpu",
      log_metrics=lambda m, s: logged.append(m["val_loss"]))
  np.testing.assert_allclose(logged, [want], rtol=1e-5)


def test_image_batches_need_an_encoder(jax_pair, image_dataset):
  _, params = jax_pair
  _, port_data = _builders(image_dataset)
  with pytest.raises(ValueError, match="encode_image"):
    tl.train_loop(_port_model(params), port_data(), tl.TrainingConfig(),
                  device="cpu")


def test_dataset_builder_image_records_match_jax(image_dataset):
  """Tokens, masks and paths of image records as JAX's builder gives them;
  a batch with a text-only record carries no paths."""
  root, _ = image_dataset
  records = _records(3) + [{"conversations": _records(1)[0]["conversations"]}]
  path = root / "mixed.json"
  path.write_text(json.dumps(records))
  for load_pixels in (False, True):
    kwargs = dict(json_path=str(path), image_root=str(root), max_seq_len=16,
                  batch_size=2, load_pixels=load_pixels)
    want = list(jdata.DatasetBuilder(jtokenizers.SimpleVocab(WORDS),
                                     **kwargs))
    got = list(data.DatasetBuilder(tokenizers.SimpleVocab(WORDS), **kwargs))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g.input_tokens, w.input_tokens)
      np.testing.assert_array_equal(g.target_mask, w.target_mask)
      assert g.image_paths == w.image_paths
      if w.pixels is None:
        assert g.pixels is None
      else:
        assert g.pixels.shape == (2, 3, 384, 384)
        np.testing.assert_array_equal(g.pixels, w.pixels)
    assert got[0].image_paths == [f"{root}/im0.jpg", f"{root}/im1.jpg"]
    assert got[1].image_paths is None


@pytest.mark.parametrize("fmt", ["jpg", "png"])
def test_image_loader_matches_jax(tmp_path, fmt):
  """The ctypes loader against JAX's on files PIL wrote: a JPEG through the
  native decoder, a PNG through PIL's decode and the native resize."""
  from PIL import Image  # pylint: disable=import-outside-toplevel

  rng = np.random.default_rng(2)
  paths = []
  for i, (h, w) in enumerate([(120, 90), (400, 500)]):
    path = tmp_path / f"x{i}.{fmt}"
    Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
        path)
    paths.append(str(path))
  assert image_cpp.available() == jimage_cpp.available()
  got = image_cpp.load_jpeg_batch(paths, size=384)
  want = jimage_cpp.load_jpeg_batch(paths, size=384)
  assert got.shape == (2, 3, 384, 384) and got.dtype == np.float32
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(image_cpp.load_jpeg(paths[1], 64),
                                jimage_cpp.load_jpeg(paths[1], 64))
