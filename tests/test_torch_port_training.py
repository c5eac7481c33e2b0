"""The PyTorch port's SFT trainer vs the JAX trainer, on the CPU.

A tiny Griffin (blocks R, R, A; width 32; window 8 < 24 tokens) with seeded
numpy weights runs in both packages in float32. The JAX side goes through
its Pallas kernels in interpret mode (``LINEAR_PALLAS`` scan, forced flash
attention) and their ``custom_vjp`` backwards; the port goes through its
autograd Functions, whose forward and backward take the kernels' plain
versions on CPU tensors. Gradients are compared leaf by leaf after mapping
the JAX gradient tree through the port's converter.
"""

import json

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu import tokenizers as jtokenizers
from cadence_gemma_tpu.models import griffin as jgriffin
from cadence_gemma_tpu.training import data as jdata
from cadence_gemma_tpu.training import trainer as jtrainer
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch import tokenizers
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import window_attention as wa
from cadence_gemma_tpu_torch.training import data
from cadence_gemma_tpu_torch.training import train_loop as tl
from cadence_gemma_tpu_torch.training import trainer

PAD = 0
WINDOW = 8
VOCAB_CHUNK = 8  # 23 loss positions: three chunks, the last one padded


def _batch():
  """Row 0: 24 real tokens; row 1: 17, right-padded. Both rows carry a loss
  mask over 8 answer tokens."""
  rng = np.random.default_rng(1)
  tokens = rng.integers(3, 40, (2, 24)).astype(np.int32)
  tokens[:, 0] = 1
  tokens[1, 17:] = PAD
  mask = np.zeros(tokens.shape, bool)
  mask[0, 16:] = True
  mask[1, 9:17] = True
  return tokens, mask


def _jax_config():
  return jcommon.GriffinConfig(
      vocab_size=40, width=32, mlp_expanded_width=64, num_heads=2,
      block_types=(jcommon.TemporalBlockType.RECURRENT,
                   jcommon.TemporalBlockType.RECURRENT,
                   jcommon.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=WINDOW,
      logits_soft_cap=30.0, lru_width=32,
      scan_type=jcommon.ScanType.LINEAR_PALLAS,
  )


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types
  )
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


@pytest.fixture(scope="module")
def jax_pair():
  """(JAX model through the Pallas paths, seeded float32 params)."""
  config = _jax_config()
  model = jgriffin.Griffin(
      config, dtype=jnp.float32, param_dtype=jnp.float32,
      gradient_checkpointing=False, use_flash_attention=True,
  )
  with pltpu.force_tpu_interpret_mode():
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                        jnp.arange(4)[None])["params"]
  rng = np.random.default_rng(0)
  params = jax.tree_util.tree_map(
      lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32),
      params,
  )
  return model, params


def _port_model(params, **kwargs):
  return convert.griffin_from_flax_params(
      params, _port_config(_jax_config()), device="cpu", dtype=torch.float32,
      use_flash_attention=True, **kwargs,
  )


def _port_batch():
  tokens, mask = _batch()
  return torch.tensor(tokens).long(), torch.tensor(mask)


def test_positions_match_jax():
  tokens, _ = _batch()
  want = np.asarray(jtrainer.get_positions(jnp.asarray(tokens), PAD))
  got = trainer.get_positions(torch.tensor(tokens), PAD).numpy()
  np.testing.assert_array_equal(got, want)
  # Right padding repeats the last real position.
  assert (got[1, 17:] == got[1, 16]).all()


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_pair):
  """The JAX trainer's loss and gradient tree on the test batch."""
  model, params = jax_pair
  tokens, mask = _batch()

  def loss_fn(p):
    return jtrainer.forward_and_loss_fn(
        p, model=model, input_tokens=jnp.asarray(tokens),
        input_mask=jnp.asarray(mask),
        positions=jtrainer.get_positions(jnp.asarray(tokens), PAD),
        vocab_chunk_size=VOCAB_CHUNK,
    )

  # The context covers the backward's trace: its own pallas_calls.
  with pltpu.force_tpu_interpret_mode():
    return jax.value_and_grad(loss_fn)(params)


def test_loss_and_gradient_tree_match_jax(jax_pair, jax_loss_and_grads):
  """Loss and every gradient leaf, through both kernels' backward paths."""
  _, params = jax_pair
  loss_j, grads_j = jax_loss_and_grads
  port = _port_model(params)
  t_tokens, t_mask = _port_batch()
  counts = (lru_scan.backward_launches, wa.dq_launches)
  loss = trainer.forward_and_loss_fn(
      port, t_tokens, t_mask, trainer.get_positions(t_tokens, PAD),
      vocab_chunk_size=VOCAB_CHUNK,
  )
  loss.backward()
  # CPU tensors take the plain versions: no kernel launched.
  assert (lru_scan.backward_launches, wa.dq_launches) == counts

  # float32 on both sides, summed in other orders: loss to 1e-5 relative.
  np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
  want = convert.state_dict_from_flax({"params": grads_j})
  named = dict(port.named_parameters())
  assert set(want) == set(named)
  for name, g_want in want.items():
    g_got = named[name].grad
    if name.startswith("vl_connector."):
      # The text-only loss does not reach the connector: no .grad here, a
      # zero gradient in JAX.
      assert g_got is None and not g_want.any(), name
      continue
    assert g_got is not None, name
    # Relative to each leaf's largest gradient: float32 reassociation over
    # three blocks, the chunked loss and the scans stays below 1e-4.
    scale = max(float(g_want.abs().max()), 1e-6)
    np.testing.assert_allclose(g_got.numpy() / scale, g_want.numpy() / scale,
                               atol=1e-4, err_msg=name)


def test_gradient_checkpointing_does_not_change_gradients(jax_pair):
  _, params = jax_pair
  t_tokens, t_mask = _port_batch()
  grads = []
  for remat in (True, False):
    port = _port_model(params)
    port.gradient_checkpointing = remat
    trainer.forward_and_loss_fn(
        port, t_tokens, t_mask, trainer.get_positions(t_tokens, PAD),
        vocab_chunk_size=VOCAB_CHUNK,
    ).backward()
    grads.append({n: p.grad for n, p in port.named_parameters()})
  for name, g in grads[0].items():
    torch.testing.assert_close(g, grads[1][name], atol=1e-6, rtol=1e-5)


def test_one_train_step_matches_jax(jax_pair, jax_loss_and_grads):
  """One AdamW step (decay mask, clip 1.0, b2 0.96) gives the JAX params."""
  model, params = jax_pair
  tokens, mask = _batch()
  lr = 1e-3
  optimizer = jtrainer.make_optimizer(lr)
  params_j = jax.tree_util.tree_map(jnp.array, params)
  with pltpu.force_tpu_interpret_mode():
    loss_j, params_j, _ = jtrainer.train_step(
        model, params_j, optimizer, optimizer.init(params_j), PAD,
        jnp.asarray(tokens), jnp.asarray(mask),
    )

  port = _port_model(params)
  t_tokens, t_mask = _port_batch()
  loss = trainer.train_step(port, trainer.make_optimizer(port, lr), PAD,
                            t_tokens, t_mask)
  np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)

  # Adam's first step moves a weight by lr * g / (|g| + 1e-8) (plus decay):
  # about lr in the gradient's direction. The two frameworks' gradients
  # agree to 1e-4 of each leaf's largest (the test above), so where a
  # gradient stands well above that uncertainty the weights agree to 1% of
  # lr; where it does not, its sign is not determined and only Adam's bound
  # of lr per step holds.
  grads = convert.state_dict_from_flax({"params": jax_loss_and_grads[1]})
  want = convert.state_dict_from_flax({"params": params_j})
  state = port.state_dict()
  for name, p_want in want.items():
    g = grads[name].abs().numpy()
    undetermined = 1e-4 * g.max() / (g + 1e-8)
    tol = lr * np.minimum(2.0, 1e-2 + undetermined)
    err = np.abs(state[name].numpy() - p_want.numpy())
    assert (err <= tol).all(), (name, float((err - tol).max()))
  # The step moved the weights (clipping and decay included).
  moved = state["blocks.0.mlp_block.ffw_down.kernel"]
  original = convert.state_dict_from_flax({"params": params})[
      "blocks.0.mlp_block.ffw_down.kernel"]
  assert (moved - original).abs().max() > lr / 2


def test_weight_decay_mask_matches_jax(jax_pair):
  _, params = jax_pair
  # Each leaf's flag, broadcast to the leaf's shape so the converter maps
  # it like a weight.
  mask_j = jax.tree_util.tree_map(
      lambda flag, p: np.full(p.shape, flag),
      jtrainer.griffin_weight_decay_mask(params), params,
  )
  want = {
      name: bool(value.flatten()[0])
      for name, value in convert.state_dict_from_flax(
          {"params": mask_j}
      ).items()
  }
  port = _port_model(params)
  assert {n: trainer.decays(n) for n, _ in port.named_parameters()} == want
  groups = trainer.make_optimizer(port, 1e-3).param_groups
  assert [g["weight_decay"] for g in groups] == [0.1, 0.0]
  assert sum(len(g["params"]) for g in groups) == len(want)


def _split_rows(tokens, mask):
  return [data.TrainingInput(tokens[i:i + 1], mask[i:i + 1])
          for i in range(tokens.shape[0])]


def test_gradient_accumulation_equals_one_full_batch_step(jax_pair):
  """Two microbatches of one row each, accumulated, give the same update as
  one step on both rows (each row carries the same number of loss tokens,
  so the mean of the rows' mean losses is the batch's mean loss)."""
  _, params = jax_pair
  tokens, mask = _batch()
  config = tl.TrainingConfig(learning_rate=1e-3, eval_every_n=1)
  full = _port_model(params)
  tl.train_loop(full, [data.TrainingInput(tokens, mask)], config,
                log_metrics=lambda *_: None, device="cpu")
  accumulated = _port_model(params)
  tl.train_loop(
      accumulated, _split_rows(tokens, mask),
      tl.TrainingConfig(learning_rate=1e-3, eval_every_n=1,
                        gradient_accumulation_steps=2),
      log_metrics=lambda *_: None, device="cpu",
  )
  for (name, got), want in zip(accumulated.state_dict().items(),
                               full.state_dict().values()):
    # float32 gradients summed in another grouping: the weights agree to
    # a thousandth of the learning rate.
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0, msg=name)


def test_train_loop_lowers_the_loss_and_validates(jax_pair):
  _, params = jax_pair
  tokens, mask = _batch()
  batch = data.TrainingInput(tokens, mask)
  logged = []
  tl.train_loop(
      _port_model(params), [batch] * 4,
      tl.TrainingConfig(learning_rate=1e-2, eval_every_n=2, max_steps=3,
                        num_epochs=2),
      validation_data=[batch], device="cpu",
      log_metrics=lambda metrics, step: logged.append((step, metrics)),
  )
  assert [step for step, _ in logged] == [2]  # max_steps stops at 3
  (_, metrics), = logged
  assert set(metrics) == {"train_loss", "steps_per_sec", "val_loss"}
  # The validation loss is taken after the second update.
  assert metrics["val_loss"] < metrics["train_loss"]


def test_skip_nonfinite_updates_leaves_the_weights(jax_pair):
  _, params = jax_pair
  tokens, mask = _batch()
  port = _port_model(params)
  with torch.no_grad():
    port.embedder.input_embedding[int(tokens[0, 3])] = float("nan")
  before = {n: p.clone() for n, p in port.state_dict().items()}
  logged = []
  tl.train_loop(
      port, [data.TrainingInput(tokens, mask)] * 2,
      tl.TrainingConfig(learning_rate=1e-2, eval_every_n=1,
                        skip_nonfinite_updates=True),
      log_metrics=lambda metrics, step: logged.append(metrics), device="cpu",
  )
  assert [m["consecutive_nonfinite_steps"] for m in logged] == [1.0, 2.0]
  for name, p in port.state_dict().items():
    torch.testing.assert_close(p, before[name], equal_nan=True, msg=name)


_UNPORTED = [
    ({"lora": True}, {}),
    ({"freeze_llm": True}, {}),
    ({"resume_from": "ckpt"}, {}),
    ({"checkpoint_dir": "ckpts"}, {}),
    ({"prefetch_batches": 2}, {}),
    ({"async_checkpoints": True}, {}),
    ({}, {"mesh": object()}),
]


@pytest.mark.parametrize("fields,options", _UNPORTED)
def test_train_loop_refuses_what_is_not_ported(fields, options):
  config = tl.TrainingConfig(**fields)
  with pytest.raises(NotImplementedError):
    tl.train_loop(torch.nn.Linear(1, 1), [], config, device="cpu", **options)


def test_train_loop_refuses_image_batches_and_the_missing_card(monkeypatch,
                                                               jax_pair):
  _, params = jax_pair
  tokens, mask = _batch()
  port = _port_model(params)
  image_batch = data.TrainingInput(tokens, mask, image_paths=["a.jpg"] * 2)
  with pytest.raises(NotImplementedError, match="Image"):
    tl.train_loop(port, [image_batch], tl.TrainingConfig(), device="cpu")
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tl.train_loop(port, [], tl.TrainingConfig())


_RECORDS = [
    {"conversations": [{"from": "human", "value": "w1 w2 <image>"},
                       {"from": "gpt", "value": "w3 w4 w5"}]},
    {"conversations": [{"from": "human", "value": "w6"},
                       {"from": "gpt", "value": "w7"},
                       {"from": "human", "value": "w8 w9"},
                       {"from": "gpt", "value": "w10 w11 w12 w13"}]},
    {"conversations": [{"from": "human", "value": "w2 w2 w2 w2 w2 w2"},
                       {"from": "gpt", "value": "w4 w4 w4 w4 w4 w4 w4"}]},
]
_WORDS = ["<start_of_turn>user\n", "<end_of_turn>\n", "<start_of_turn>model\n"]
_WORDS += [f"w{i}" for i in range(14)]


@pytest.mark.parametrize("max_seq_len,batch_size", [(24, 1), (12, 2)])
def test_dataset_builder_matches_jax(tmp_path, max_seq_len, batch_size):
  path = tmp_path / "records.json"
  path.write_text(json.dumps(_RECORDS))
  kwargs = dict(json_path=str(path), max_seq_len=max_seq_len,
                batch_size=batch_size)
  want = list(jdata.DatasetBuilder(jtokenizers.SimpleVocab(_WORDS), **kwargs))
  got = list(data.DatasetBuilder(tokenizers.SimpleVocab(_WORDS), **kwargs))
  assert len(got) == len(want) == len(_RECORDS) // batch_size
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.input_tokens, w.input_tokens)
    np.testing.assert_array_equal(g.target_mask, w.target_mask)
    assert g.input_tokens.dtype == np.int32 and g.target_mask.dtype == bool
    assert g.image_paths is None and w.image_paths is None
  assert data.apply_it_template("hi") == jdata.apply_it_template("hi")


def test_dataset_builder_refuses_image_records(tmp_path):
  path = tmp_path / "records.json"
  path.write_text(json.dumps([{"image": "a.jpg", **_RECORDS[0]}]))
  builder = data.DatasetBuilder(tokenizers.SimpleVocab(_WORDS), str(path))
  with pytest.raises(NotImplementedError, match="image"):
    list(builder)


def test_the_sampler_path_is_unchanged_by_remat(jax_pair):
  """Under inference mode the blocks run without checkpointing and the
  model gives the same logits as with it switched off."""
  _, params = jax_pair
  tokens = torch.tensor(_batch()[0][:1]).long()
  positions = torch.arange(tokens.shape[1])[None]
  port = _port_model(params)
  with torch.inference_mode():
    with_remat, _ = port(tokens, positions, return_cache=False)
    port.gradient_checkpointing = False
    without, _ = port(tokens, positions, return_cache=False)
  torch.testing.assert_close(with_remat, without, atol=0, rtol=0)
