"""Kernel modules of the PyTorch port: plain versions vs JAX, kernels vs plain.

CPU tests hold each kernel's plain PyTorch version against the JAX package's
Pallas kernel, run in interpret mode as the JAX package's own tests run it,
and against its einsum / ``lax.scan`` oracle, on the same numpy inputs.

Card tests (skipped without CUDA) build the CUDA kernels and hold them
against the plain versions on the card, at small shapes and at the shapes
of the RecurrentGemma-2B prefill that ``chip_smoke.py`` drives. They import
no JAX, so they also run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_port_kernels.py -k cuda``.
"""

import numpy as np
import pytest
import torch

from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import scan
from cadence_gemma_tpu_torch.ops import window_attention as wa

# A string condition is evaluated when each test is set up, not when the
# module is imported, so every pytest-xdist worker collects the same tests.
requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)


def _lru_inputs(b, t, d, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((b, t, d), dtype=np.float32)
  a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, d), dtype=np.float32)))
  h0 = rng.standard_normal((b, d), dtype=np.float32)
  return x, a.astype(np.float32), h0


def _attn_inputs(b, t, n, h, pad=0, boundary=None, seed=0, offset=0):
  """q, k, v and segment_pos; row 0 left-padded by `pad`, row 1 (if any)
  starts a second document at `boundary`; positions start at `offset`."""
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, t, n, h), dtype=np.float32)
  k = rng.standard_normal((b, t, 1, h), dtype=np.float32)
  v = rng.standard_normal((b, t, 1, h), dtype=np.float32)
  seg = np.tile(np.arange(offset, offset + t, dtype=np.int32), (b, 1))
  if pad:
    seg[0] = np.arange(t, dtype=np.int32) - pad
    seg[0, :pad] = -1
  if boundary is not None and b > 1:
    seg[1, boundary:] = np.arange(t - boundary, dtype=np.int32)
  return q, k, v, seg


def _jax_bf16(x):
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel

  return jnp.asarray(x, jnp.bfloat16)


# -- CPU: plain versions vs the JAX package ---------------------------------

# Both sides run the same float32 recurrence; XLA may fuse the multiply-add,
# so fp32 agrees to 1e-5. bf16 outputs are the same fp32 carry rounded once
# to bf16: one bf16 rounding step (2^-8 relative) covers any difference.
_LRU_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=2e-2, rtol=8e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_plain_matches_jax(dtype, reverse, with_h0):
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import pallas_lru  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import scan as jax_scan  # pylint: disable=import-outside-toplevel

  # d = 200 is not a multiple of the TPU kernel's 128 lanes.
  x, a, h0 = _lru_inputs(2, 40, 200)
  h0_j = jnp.asarray(h0) if with_h0 else None
  jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
  xj, aj = jnp.asarray(x, jdt), jnp.asarray(a, jdt)
  with pltpu.force_tpu_interpret_mode():
    y_pallas, h_pallas = pallas_lru.lru_pallas_scan(xj, aj, h0_j, reverse)
  y_lax, h_lax = jax_scan.lru_linear_scan(xj, aj, h0_j, reverse=reverse)

  y, h = lru_scan.lru_scan(
      torch.tensor(x).to(dtype), torch.tensor(a).to(dtype),
      torch.tensor(h0) if with_h0 else None, reverse,
  )
  assert y.dtype == dtype and h.dtype == torch.float32
  for y_ref, h_ref in ((y_pallas, h_pallas), (y_lax, h_lax)):
    np.testing.assert_allclose(
        y.float().numpy(), np.asarray(y_ref, np.float32), **_LRU_TOL[dtype]
    )
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_sequential(reverse):
  x, a, h0 = _lru_inputs(2, 37, 24, seed=1)
  args = (torch.tensor(x), torch.tensor(a), torch.tensor(h0))
  y1, h1 = scan.lru_linear_scan(*args, reverse=reverse)
  y2, h2 = scan.lru_associative_scan(*args, reverse=reverse)
  # Different summation order in float32 over 37 steps of |a| < 1.
  torch.testing.assert_close(y1, y2, atol=1e-5, rtol=1e-5)
  torch.testing.assert_close(h1, h2, atol=1e-5, rtol=1e-5)


def test_linear_scan_decode_step_is_closed_form():
  x, a, h0 = _lru_inputs(3, 1, 8, seed=2)
  y, h = scan.linear_scan(torch.tensor(x), torch.tensor(a), torch.tensor(h0))
  want = a[:, 0] * h0 + x[:, 0]
  np.testing.assert_allclose(y[:, 0].numpy(), want, atol=1e-6)
  np.testing.assert_allclose(h.numpy(), want, atol=1e-6)


def test_linear_scan_rejects_sharding():
  x, a, _ = _lru_inputs(1, 4, 8)
  with pytest.raises(NotImplementedError):
    scan.linear_scan(torch.tensor(x), torch.tensor(a), sharding_spec=object())


def test_window_attention_plain_matches_jax():
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import pallas_attention as fa  # pylint: disable=import-outside-toplevel

  window = 128
  q, k, v, seg = _attn_inputs(2, 300, 2, 128, pad=40, boundary=150)
  with pltpu.force_tpu_interpret_mode():
    out_j, lse_j = fa._flash_window_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        window,
    )
  out, lse = wa.window_attention(
      torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(seg),
      window,
  )
  # float32 on both sides; the kernel's online softmax sums in another order.
  np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5)
  np.testing.assert_allclose(
      lse.numpy(), np.asarray(lse_j)[:, :, :300, 0], atol=1e-4, rtol=1e-6
  )
  # Left padding: zeros and the masked lse.
  assert not out[0, :40].any()
  assert (lse[0, :, :40] == wa.MASKED_LSE).all()

  # Valid rows also equal the JAX einsum oracle and its port.
  ref_j = np.asarray(fa._reference_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
      window,
  ))
  ref = wa.reference_attention(
      torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(seg),
      window,
  ).numpy()
  np.testing.assert_allclose(out.numpy()[0, 40:], ref_j[0, 40:], atol=2e-5)
  np.testing.assert_allclose(out.numpy()[1], ref_j[1], atol=2e-5)
  np.testing.assert_allclose(ref, ref_j, atol=2e-5)


def test_window_attention_plain_matches_jax_offset_positions():
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.ops import pallas_attention as fa  # pylint: disable=import-outside-toplevel

  # Positions from 500 with no cache before them: qp - segment_pos < 0, so
  # the document bound must stop at key 0 (the JAX kernel clamps it there).
  window = 256
  q, k, v, seg = _attn_inputs(1, 200, 2, 128, offset=500, seed=3)
  with pltpu.force_tpu_interpret_mode():
    out_j, lse_j = fa._flash_window_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        window,
    )
  out, lse = wa.window_attention(
      torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(seg),
      window,
  )
  # float32 on both sides; the kernel's online softmax sums in another order.
  np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5)
  np.testing.assert_allclose(
      lse.numpy(), np.asarray(lse_j)[:, :, :200, 0], atol=1e-4, rtol=1e-6
  )


def test_window_attention_rejects_halo():
  q, k, v, seg = _attn_inputs(1, 8, 1, 8)
  with pytest.raises(NotImplementedError):
    wa.window_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        torch.tensor(seg), 4, kv_prefix=128)


# -- Card: CUDA kernels vs their plain versions ------------------------------

_LRU_CUDA_SHAPES = [(2, 64, 16), (1, 40, 200), (3, 17, 128), (1, 9, 7),
                    (2, 3000, 2560)]


@requires_cuda
@pytest.mark.parametrize("shape", _LRU_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_cuda_kernel_matches_plain(shape, dtype, reverse, with_h0):
  x, a, h0 = _lru_inputs(*shape)
  x = torch.tensor(x, device="cuda").to(dtype)
  a = torch.tensor(a, device="cuda").to(dtype)
  h0 = torch.tensor(h0, device="cuda") if with_h0 else None
  before = lru_scan.launches
  y, h = lru_scan.lru_scan(x, a, h0, reverse)
  torch.cuda.synchronize()
  assert lru_scan.launches == before + 1
  y_ref, h_ref = lru_scan.lru_scan_plain(x, a, h0, reverse)
  # The kernel rounds the multiply and the add separately, as the plain
  # loop's two float32 ops do: the results are identical.
  assert torch.equal(y, y_ref), (y.float() - y_ref.float()).abs().max()
  assert torch.equal(h, h_ref), (h - h_ref).abs().max()


_ATTN_CUDA_CASES = [
    # (b, t, n, h, window, pad, boundary, offset)
    (1, 256, 2, 128, 64, 0, None, 0),
    (2, 300, 2, 128, 128, 40, 150, 0),
    (1, 130, 3, 256, 512, 0, None, 0),
    (2, 700, 2, 256, 256, 100, 333, 0),
    # Positions that start at 500 with t < W: bounds below key 0.
    (2, 300, 2, 256, 2048, 0, None, 500),
    # The 2B prefill of chip_smoke.py: 3000 tokens, a partial last tile.
    (2, 3000, 10, 256, 2048, 700, 1500, 0),
]


@requires_cuda
@pytest.mark.parametrize("case", _ATTN_CUDA_CASES)
def test_window_attention_cuda_kernel_matches_plain(case):
  b, t, n, h, window, pad, boundary, offset = case
  q, k, v, seg = _attn_inputs(b, t, n, h, pad=pad, boundary=boundary,
                              offset=offset)
  q, k, v = (torch.tensor(z, device="cuda").to(torch.bfloat16)
             for z in (q, k, v))
  seg = torch.tensor(seg, device="cuda")
  before = wa.launches
  out, lse = wa.window_attention(q, k, v, seg, window)
  torch.cuda.synchronize()
  assert wa.launches == before + 1
  out_ref, lse_ref = wa.window_attention_plain(q, k, v, seg, window)
  # Same bf16 inputs; the kernel rounds unnormalized probabilities to bf16
  # before PV and its output to bf16: 2e-2 covers both roundings at |o| < 2.
  torch.testing.assert_close(out.float(), out_ref.float(), atol=2e-2,
                             rtol=0)
  # Statistics are float32 on both sides, summed in another order.
  torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-5)
  if pad:
    assert not out[0, :pad].any()
    assert (lse[0, :, :pad] == wa.MASKED_LSE).all()


@requires_cuda
def test_cuda_wrappers_raise_on_unsupported_inputs():
  q, k, v, seg = _attn_inputs(1, 64, 1, 64)
  q, k, v = (torch.tensor(z, device="cuda") for z in (q, k, v))
  with pytest.raises(ValueError, match="bfloat16"):
    wa.window_attention(q, k, v, torch.tensor(seg, device="cuda"), 16)
  q, k, v = (z.bfloat16() for z in (q, k, v))
  with pytest.raises(ValueError, match="head_dim"):
    wa.window_attention(q, k, v, torch.tensor(seg, device="cuda"), 16)
  x = torch.zeros(1, 4, 8, device="cuda", dtype=torch.float16)
  with pytest.raises(ValueError, match="dtype"):
    lru_scan.lru_scan(x, x)
