"""Layers and modules of the PyTorch port vs the JAX package's flax modules.

Each flax module is initialized, its parameters are replaced by seeded
numpy normals (so zero-initialized scales and biases are exercised too) and
carried into the port's module by ``convert.load_flax_params``; both then
run on the same numpy inputs. Everything is float32 on the CPU, where the
two frameworks differ only in summation order: outputs agree to 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu.models import layers as jlayers
from cadence_gemma_tpu.models import modules as jmodules
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.models import layers
from cadence_gemma_tpu_torch.models import modules

TOL = dict(atol=1e-5, rtol=1e-5)
F32 = dict(device="cpu", dtype=torch.float32)

# Row 0: two documents (the second starts at 5); row 1: left-padded by 2.
SEG = np.array([[0, 1, 2, 3, 4, 0, 1, 2, 3, 4],
                [-1, -1, 0, 1, 2, 3, 4, 5, 6, 7]], np.int32)


def _randomized(tree, seed):
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map(
      lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32), tree
  )


def _jax(tree):
  return jax.tree_util.tree_map(jnp.asarray, tree)


# Jitted ``apply`` per (module, keyword arguments). The cache holds the
# module itself, so an id cannot be reused while its entry lives.
_JITTED = {}


def _apply(jmodule, variables, *args, **kwargs):
  key = (id(jmodule), tuple(sorted(kwargs.items())))
  module, fn = _JITTED.get(key, (None, None))
  if module is not jmodule:
    fn = jax.jit(functools.partial(jmodule.apply, **kwargs))
    _JITTED[key] = (jmodule, fn)
  return fn(variables, *_jax(args))


def _setup(jmodule, tmodule, *init_args, seed=0):
  params = jmodule.init(jax.random.PRNGKey(seed), *_jax(init_args))["params"]
  params = _randomized(params, seed)
  convert.load_flax_params(tmodule, params)
  return params


def _x(*shape, seed=1):
  return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(torch_value, jax_value):
  np.testing.assert_allclose(
      torch_value.detach().numpy(), np.asarray(jax_value), **TOL
  )


def test_rmsnorm():
  x = _x(2, 5, 16)
  jm = jlayers.RMSNorm(width=16, param_dtype=jnp.float32)
  tm = layers.RMSNorm(16, **F32)
  params = _setup(jm, tm, x)
  _close(tm(torch.tensor(x)), _apply(jm, {"params": params}, x))


def test_block_diagonal_linear():
  x = _x(2, 5, 16)
  jm = jlayers.BlockDiagonalLinear(width=16, num_blocks=4,
                                   param_dtype=jnp.float32)
  tm = layers.BlockDiagonalLinear(16, 4, **F32)
  params = _setup(jm, tm, x)
  _close(tm(torch.tensor(x)), _apply(jm, {"params": params}, x))


def test_conv1d_forward_decode_and_chunk():
  x = _x(2, 10, 8)
  jm = jlayers.Conv1D(width=8, temporal_width=4, param_dtype=jnp.float32)
  tm = layers.Conv1D(8, 4, **F32)
  params = _setup(jm, tm, x, SEG)
  v = {"params": params}
  # Prompt with a document boundary and a left-padded row.
  out_j, cache_j = _apply(jm, v, x, SEG)
  out_t, cache_t = tm(torch.tensor(x), torch.tensor(SEG))
  _close(out_t, out_j)
  _close(cache_t, cache_j)
  # One decode step from the cache.
  x1, pos1 = _x(2, 1, 8, seed=2), SEG[:, -1:] + 1
  out_j, cache_j = _apply(jm, v, x1, pos1, cache_j)
  out_t, cache_t = tm(torch.tensor(x1), torch.tensor(pos1), cache_t)
  _close(out_t, out_j)
  _close(cache_t, cache_j)
  # A multi-token chunk continuing from the cache.
  x3, pos3 = _x(2, 3, 8, seed=3), SEG[:, -1:] + np.arange(2, 5)[None]
  out_j, cache_j = _apply(jm, v, x3, pos3, cache_j)
  out_t, cache_t = tm(torch.tensor(x3), torch.tensor(pos3), cache_t)
  _close(out_t, out_j)
  _close(cache_t, cache_j)


@pytest.mark.parametrize("scan_type", [common.ScanType.LINEAR_NATIVE,
                                       common.ScanType.ASSOCIATIVE_NATIVE,
                                       common.ScanType.AUTO])
def test_rglru_prompt_and_decode(scan_type):
  x = _x(2, 10, 16)
  jm = jlayers.RGLRU(width=16, num_heads=2,
                     scan_type=jcommon.ScanType.LINEAR_NATIVE,
                     param_dtype=jnp.float32)
  tm = layers.RGLRU(16, 2, scan_type, **F32)
  params = _setup(jm, tm, x, SEG)
  v = {"params": params}
  h0 = _x(2, 16, seed=4)
  y_j, h_j = _apply(jm, v, x, SEG, h0)
  y_t, h_t = tm(torch.tensor(x), torch.tensor(SEG), torch.tensor(h0))
  _close(y_t, y_j)
  _close(h_t, h_j)
  x1, pos1 = _x(2, 1, 16, seed=5), SEG[:, -1:] + 1
  y_j, h_j = _apply(jm, v, x1, pos1, h_j)
  y_t, h_t = tm(torch.tensor(x1), torch.tensor(pos1), h_t)
  _close(y_t, y_j)
  _close(h_t, h_j)


def _attention_pair(window):
  jm = jmodules.LocalAttentionBlock(width=16, num_heads=2, window_size=window,
                                    param_dtype=jnp.float32)
  tm = modules.LocalAttentionBlock(16, 2, window, **F32)
  params = _setup(jm, tm, _x(2, 10, 16), SEG)
  return jm, tm, {"params": params}


def _close_cache(cache_t, cache_j):
  for got, want in zip(cache_t, cache_j):
    _close(got, want)


def test_local_attention_prompt_then_cached_decode():
  """Window 16 > prompt 10: the cache is only partly filled."""
  jm, tm, v = _attention_pair(window=16)
  x = _x(2, 10, 16, seed=6)
  out_j, cache_j = _apply(jm, v, x, SEG)
  out_t, cache_t = tm(torch.tensor(x), torch.tensor(SEG))
  _close(out_t, out_j)
  _close_cache(cache_t, cache_j)
  pos = SEG[:, -1:] + 1
  for step in range(3):
    x1 = _x(2, 1, 16, seed=10 + step)
    out_j, cache_j = _apply(jm, v, x1, pos, cache_j)
    out_t, cache_t = tm(torch.tensor(x1), torch.tensor(pos), cache_t)
    _close(out_t, out_j)
    _close_cache(cache_t, cache_j)
    pos = pos + 1


def test_local_attention_ring_wraparound_and_chunk():
  """Window 4 < prompt 10: decode and a 3-token chunk wrap the ring."""
  jm, tm, v = _attention_pair(window=4)
  x = _x(2, 10, 16, seed=7)
  out_j, cache_j = _apply(jm, v, x, SEG)
  out_t, cache_t = tm(torch.tensor(x), torch.tensor(SEG))
  _close(out_t, out_j)
  _close_cache(cache_t, cache_j)
  pos = SEG[:, -1:] + 1
  for step in range(6):
    x1 = _x(2, 1, 16, seed=20 + step)
    out_j, cache_j = _apply(jm, v, x1, pos, cache_j)
    out_t, cache_t = tm(torch.tensor(x1), torch.tensor(pos), cache_t)
    _close(out_t, out_j)
    _close_cache(cache_t, cache_j)
    pos = pos + 1
  pos3 = pos + np.arange(3)[None]
  x3 = _x(2, 3, 16, seed=30)
  out_j, cache_j = _apply(jm, v, x3, pos3, cache_j)
  out_t, cache_t = tm(torch.tensor(x3), torch.tensor(pos3), cache_t)
  _close(out_t, out_j)
  _close_cache(cache_t, cache_j)


def test_local_attention_flash_path_matches_einsum_path():
  """Forcing the kernel path (its plain version on CPU) changes nothing."""
  jm, tm, v = _attention_pair(window=4)
  x = _x(2, 10, 16, seed=8)
  out_j, _ = _apply(jm, v, x, SEG)
  tm.use_flash_attention = True
  out_t, _ = tm(torch.tensor(x), torch.tensor(SEG))
  _close(out_t[0], np.asarray(out_j)[0])
  # Padded rows: the kernel path zeroes them before proj_final; compare the
  # real positions only.
  _close(out_t[1, 2:], np.asarray(out_j)[1, 2:])


def test_recurrent_block_prompt_and_decode():
  jm = jmodules.RecurrentBlock(width=16, num_heads=2, lru_width=24,
                               scan_type=jcommon.ScanType.LINEAR_NATIVE,
                               param_dtype=jnp.float32)
  tm = modules.RecurrentBlock(16, 2, lru_width=24, **F32)
  x = _x(2, 10, 16, seed=9)
  v = {"params": _setup(jm, tm, x, SEG)}
  out_j, cache_j = _apply(jm, v, x, SEG)
  out_t, cache_t = tm(torch.tensor(x), torch.tensor(SEG))
  _close(out_t, out_j)
  _close_cache(cache_t, cache_j)
  x1, pos1 = _x(2, 1, 16, seed=11), SEG[:, -1:] + 1
  out_j, cache_j = _apply(jm, v, x1, pos1, cache_j)
  out_t, cache_t = tm(torch.tensor(x1), torch.tensor(pos1), cache_t)
  _close(out_t, out_j)
  _close_cache(cache_t, cache_j)


def test_mlp_block():
  jm = jmodules.MLPBlock(width=16, expanded_width=40, param_dtype=jnp.float32)
  tm = modules.MLPBlock(16, 40, **F32)
  x = _x(2, 5, 16, seed=12)
  params = _setup(jm, tm, x)
  _close(tm(torch.tensor(x)), _apply(jm, {"params": params}, x))


@pytest.mark.parametrize("block_type", ["RECURRENT", "ATTENTION"])
def test_residual_block(block_type):
  jm = jmodules.ResidualBlock(
      width=16, mlp_expanded_width=32, num_heads=2, attention_window_size=4,
      temporal_block_type=jcommon.TemporalBlockType[block_type],
      scan_type=jcommon.ScanType.LINEAR_NATIVE, param_dtype=jnp.float32,
  )
  tm = modules.ResidualBlock(
      16, 32, 2, 4, common.TemporalBlockType[block_type], **F32
  )
  x = _x(2, 10, 16, seed=13)
  v = {"params": _setup(jm, tm, x, SEG)}
  out_j, cache_j = _apply(jm, v, x, SEG)
  out_t, cache_t = tm(torch.tensor(x), torch.tensor(SEG))
  _close(out_t, out_j)
  _close_cache(cache_t, cache_j)


def test_embedder_encode_decode():
  jm = jmodules.Embedder(vocab_size=12, embed_dim=16, scale_by_sqrt_dim=True,
                         param_dtype=jnp.float32)
  tm = modules.Embedder(12, 16, True, **F32)
  tokens = np.array([[1, 4, 7, 11], [0, 0, 2, 3]], np.int32)
  params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens), method="encode")["params"]
  params = _randomized(params, 0)
  convert.load_flax_params(tm, params)
  v = {"params": params}
  _close(tm.encode(torch.tensor(tokens).long()),
         _apply(jm, v, tokens, method="encode"))
  h = _x(2, 4, 16, seed=14)
  _close(tm.decode(torch.tensor(h)), _apply(jm, v, h, method="decode"))


def test_convert_rejects_missing_and_misshaped_leaves():
  jm = jlayers.RMSNorm(width=16, param_dtype=jnp.float32)
  params = jm.init(jax.random.PRNGKey(0), jnp.asarray(_x(1, 2, 16)))["params"]
  with pytest.raises(ValueError, match="missing"):
    convert.load_flax_params(layers.RMSNorm(16, **F32), {})
  with pytest.raises(ValueError, match="shape"):
    convert.load_flax_params(layers.RMSNorm(8, **F32), params)
  with pytest.raises(ValueError, match="unexpected"):
    convert.load_flax_params(
        layers.RMSNorm(16, **F32), {**params, "extra": np.zeros(3)}
    )
