"""The port's RG-LRU kernel lab vs the JAX package's, and its kernels.

CPU tests hold the plain versions of the lab's two variants
(``cadence_gemma_tpu_torch/benchmarks/kernel_lab.py``) against the JAX
lab's Pallas variants (``benchmarks/kernel_lab.py``, loaded by path and run
in interpret mode) on the same seeded numpy inputs at ``[1, 256, 256]`` in
bf16. Card tests (skipped without CUDA) hold the lab's CUDA kernels against
the plain versions.

Tolerances. The two packages run the same float32 operations, but XLA may
fuse a multiply into an add, so a float32 carry differs by a few units of
its last place (``h_last``: 1e-5) and a bf16 output may round the other
way: one bf16 step, at most 2^-7 of |y|. Variant B reassociates the scan,
so against the sequential reference it is held to that bf16 step and
``h_last`` to 1e-4. On the card each kernel rounds the same float32
operations in the same order as its plain version: equal bit for bit.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from cadence_gemma_tpu_torch.benchmarks import kernel_lab

REPO = pathlib.Path(__file__).resolve().parents[1]

requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)


def _jax_lab():
  spec = importlib.util.spec_from_file_location(
      "jax_kernel_lab", REPO / "benchmarks" / "kernel_lab.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _inputs(b=1, t=256, d=256, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((b, t, d), dtype=np.float32)
  a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, d))))).astype(
      np.float32)
  h0 = rng.standard_normal((b, d), dtype=np.float32)
  return x, a, h0


# One bf16 step of |y| (a rounding that went the other way), and the float32
# carry's few units in the last place.
Y_TOL = dict(rtol=2.0**-7, atol=1e-6)
H_TOL = dict(rtol=1e-5, atol=1e-5)
LOGSCAN_H_ATOL = 1e-4
LOGSCAN_CHANNELS = kernel_lab.LOGSCAN_CHANNELS


@pytest.fixture(scope="module")
def jax_lab_case():
  """The JAX lab module, the numpy inputs and the JAX reference."""
  lab = _jax_lab()
  args = _jax_args()
  return lab, args, lab.reference(*args)


def _torch_args(t=256):
  x, a, h0 = _inputs(t=t)
  return (torch.tensor(x).bfloat16(), torch.tensor(a).bfloat16(),
          torch.tensor(h0))


def _jax_args(t=256):
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel

  x, a, h0 = _inputs(t=t)
  return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(a, jnp.bfloat16),
          jnp.asarray(h0))


def _f32(v):
  if isinstance(v, torch.Tensor):
    return v.float().numpy()
  return np.asarray(v, np.float32)


def _assert_close(got, want, h_tol=H_TOL):
  """``got`` (the port's) against ``want`` (the port's or JAX's)."""
  np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), **Y_TOL)
  np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), **h_tol)


def test_reference_matches_jax(jax_lab_case):
  _, _, want = jax_lab_case
  _assert_close(kernel_lab.reference(*_torch_args()), want)


@pytest.mark.parametrize("st", [64, 128])
def test_unrolled_plain_matches_jax_pallas(jax_lab_case, st):
  """Variant A's plain version vs ``run_unrolled`` (Pallas, interpret)."""
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  import jax  # pylint: disable=import-outside-toplevel

  lab, args, want = jax_lab_case
  with pltpu.force_tpu_interpret_mode():
    got_j = jax.block_until_ready(lab.run_unrolled(*args, st=st))
  before = kernel_lab.unrolled_launches
  got = kernel_lab.run_unrolled(*_torch_args(), st)
  assert kernel_lab.unrolled_launches == before  # plain on the CPU
  _assert_close(got, got_j)
  # The JAX lab's variant A is its own reference, bit for bit.
  np.testing.assert_array_equal(_f32(got_j[0]), _f32(want[0]))
  # The port's is the port's sequential scan, bit for bit.
  ref = kernel_lab.reference(*_torch_args())
  assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("st,dl", [(64, 128), (32, 256), (128, 128),
                                   (512, 256)])
def test_logscan_plain_matches_jax_pallas(jax_lab_case, st, dl):
  """Variant B's plain version vs ``run_logscan`` (Pallas, interpret), and
  both against the sequential reference within one bf16 step; at
  [1, 256, 256], and at [1, 1024, 256] for st = 512 (two tiles)."""
  from jax.experimental.pallas import tpu as pltpu  # pylint: disable=import-outside-toplevel
  import jax  # pylint: disable=import-outside-toplevel

  lab, args, want = jax_lab_case
  t = max(256, 2 * st)
  if t != 256:
    args = _jax_args(t)
    want = lab.reference(*args)
  with pltpu.force_tpu_interpret_mode():
    got_j = jax.block_until_ready(lab.run_logscan(*args, st=st, dl=dl))
  before = kernel_lab.logscan_launches
  got = kernel_lab.run_logscan(*_torch_args(t), st, dl)
  assert kernel_lab.logscan_launches == before
  _assert_close(got, got_j)
  h_tol = dict(rtol=0, atol=LOGSCAN_H_ATOL)
  _assert_close(got, want, h_tol)
  _assert_close(got, kernel_lab.reference(*_torch_args(t)), h_tol)


def test_logscan_plain_does_not_depend_on_dl():
  """``dl`` only tiles the channels, which are independent: at a fixed st
  the plain version (and the CPU path of the wrapper) gives the same
  tensors for any ``dl`` that divides ``d``."""
  args = _torch_args(512)
  narrow = kernel_lab.logscan_plain(*args, 256, 32)
  wide = kernel_lab.logscan_plain(*args, 256, 256)
  assert torch.equal(narrow[0], wide[0]) and torch.equal(narrow[1], wide[1])
  via_wrapper = kernel_lab.run_logscan(*args, 256, 32)
  assert torch.equal(via_wrapper[0], wide[0])
  assert torch.equal(via_wrapper[1], wide[1])


def test_lab_inputs_are_seeded():
  first = kernel_lab.make_inputs((1, 16, 8), device="cpu", seed=3)
  again = kernel_lab.make_inputs((1, 16, 8), device="cpu", seed=3)
  other = kernel_lab.make_inputs((1, 16, 8), device="cpu", seed=4)
  assert all(torch.equal(u, v) for u, v in zip(first, again))
  assert not torch.equal(first[0], other[0])
  x, a, h0 = first
  assert x.dtype == a.dtype == torch.bfloat16 and h0.dtype == torch.float32
  assert ((a > 0) & (a < 1)).all()


def test_lab_rejects_what_its_kernels_do_not_take(monkeypatch):
  x, a, h0 = _torch_args()
  with pytest.raises(ValueError, match="batch 1"):
    kernel_lab.run_logscan(torch.cat([x, x]), torch.cat([a, a]),
                           torch.cat([h0, h0]), 64, 128)
  with pytest.raises(ValueError, match="divide"):
    kernel_lab.run_unrolled(x, a, h0, st=100)
  # Variant A runs on the scans' TMA ring: the tile lengths it is built for,
  # and rows of a multiple of 16 bytes.
  with pytest.raises(ValueError, match="ring is built for"):
    kernel_lab.run_unrolled(x, a, h0, st=32)
  with pytest.raises(ValueError, match="16 bytes"):
    kernel_lab.run_unrolled(x[..., :4], a[..., :4], h0[:, :4], st=64)
  with pytest.raises(ValueError, match="divide"):
    kernel_lab.run_logscan(x, a, h0, 64, dl=96)
  # Variant B: the tile lengths its kernel is built for, named, and whole
  # strips of 16 channels; on the CPU too, so both sides take the same
  # arguments.
  for st in (16, 1024):
    with pytest.raises(ValueError, match=r"built for st in \(32, 64, 128, "
                       r"256, 512\)"):
      kernel_lab.run_logscan(*_torch_args(1024), st, 128)
  with pytest.raises(ValueError, match="16 channels"):
    kernel_lab.run_logscan(x[..., :8], a[..., :8], h0[:, :8], 64, 8)
  with pytest.raises(ValueError, match="h0"):
    kernel_lab.run_unrolled(x, a, h0.bfloat16())
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="card"):
    kernel_lab.main()


# -- Card: the lab's kernels vs their plain versions ----------------------------


@requires_cuda
@pytest.mark.parametrize("shape,dtype,st", [
    ((1, 2048, 2560), torch.bfloat16, 64),
    ((1, 2048, 2560), torch.bfloat16, 128),
    ((1, 2048, 2560), torch.bfloat16, 256),
    # float32 at batch 2 (16 channels a block); st 64, the shortest tile
    # the ring is built for.
    ((2, 256, 192), torch.float32, 64),
])
def test_unrolled_cuda_kernel_matches_plain(shape, dtype, st):
  x, a, h0 = kernel_lab.make_inputs(shape, dtype=dtype, device="cuda")
  before = kernel_lab.unrolled_launches
  y, h = kernel_lab.run_unrolled(x, a, h0, st)
  torch.cuda.synchronize()
  assert kernel_lab.unrolled_launches == before + 1
  y_ref, h_ref = kernel_lab.reference(x, a, h0)
  assert torch.equal(y, y_ref), (y.float() - y_ref.float()).abs().max()
  assert torch.equal(h, h_ref), (h - h_ref).abs().max()


@requires_cuda
@pytest.mark.parametrize("st,dl", kernel_lab.LOGSCAN_SWEEP)
def test_logscan_cuda_kernel_matches_plain(st, dl):
  x, a, h0 = kernel_lab.make_inputs(device="cuda")
  before = kernel_lab.logscan_launches
  y, h = kernel_lab.run_logscan(x, a, h0, st, dl)
  torch.cuda.synchronize()
  assert kernel_lab.logscan_launches == before + 1
  y_ref, h_ref = kernel_lab.logscan_plain(x, a, h0, st, dl)
  assert torch.equal(y, y_ref), (y.float() - y_ref.float()).abs().max()
  assert torch.equal(h, h_ref), (h - h_ref).abs().max()
  # Against the sequential scan: one bf16 step, 1e-4 on the carry.
  y_seq, h_seq = kernel_lab.reference(x, a, h0)
  torch.testing.assert_close(y.float(), y_seq.float(), rtol=2.0**-7,
                             atol=1e-6)
  torch.testing.assert_close(h, h_seq, rtol=0, atol=LOGSCAN_H_ATOL)


@requires_cuda
@pytest.mark.parametrize("shape,dtype,st", [
    # The tile lengths' edges at the lab's shape.
    ((1, 2048, 2560), torch.bfloat16, 32),
    ((1, 2048, 2560), torch.bfloat16, 512),
    # float32 inputs: 4 channels a 16-byte chunk.
    ((1, 1024, 256), torch.float32, 64),
    ((1, 1024, 256), torch.float32, 512),
    # One tile (t = st): one group, h0 in and h_last out of one block.
    ((1, 32, 256), torch.bfloat16, 32),
    ((1, 256, 256), torch.bfloat16, 256),
    ((1, 512, 2560), torch.float32, 512),
    # t = 8 st at d = 256: eight groups chained at st 256 and 512, four of
    # two tiles at st 128.
    ((1, 2048, 256), torch.bfloat16, 256),
    ((1, 4096, 256), torch.bfloat16, 512),
    ((1, 1024, 256), torch.bfloat16, 128),
    # A partial last group (3 tiles, 2 a group) and 3 strips; 3 tiles of
    # 32 in one group of 8.
    ((1, 384, 48), torch.bfloat16, 128),
    ((1, 96, 16), torch.float32, 32),
    # The probe's shape, one SP shard of the 2B.
    ((1, 4096, 2560), torch.bfloat16, 256),
    # 16 strips x 256 groups = 4096 items, many to each resident block: a
    # chain of 256 groups through the scratch words.
    ((1, 65536, 256), torch.bfloat16, 64),
])
def test_logscan_cuda_kernel_edges(shape, dtype, st):
  """Bit for bit with the plain version at the tile, dtype, group and grid
  edges; a second call (on a scratch buffer zeroed anew) repeats the
  bits."""
  x, a, h0 = kernel_lab.make_inputs(shape, dtype=dtype, device="cuda",
                                    seed=st)
  dl = LOGSCAN_CHANNELS
  y, h = kernel_lab.run_logscan(x, a, h0, st, dl)
  y2, h2 = kernel_lab.run_logscan(x, a, h0, st, dl)
  torch.cuda.synchronize()
  y_ref, h_ref = kernel_lab.logscan_plain(x, a, h0, st, dl)
  assert torch.equal(y, y_ref), (y.float() - y_ref.float()).abs().max()
  assert torch.equal(h, h_ref), (h - h_ref).abs().max()
  assert torch.equal(y2, y) and torch.equal(h2, h)


@requires_cuda
def test_logscan_cuda_kernel_repeats_its_bits():
  """Many items to each persistent block (16 strips x 256 groups at st 64):
  48 calls give the same bits, whatever order the blocks' warps run in and
  the tickets fall."""
  x, a, h0 = kernel_lab.make_inputs((1, 65536, 256), device="cuda", seed=3)
  y, h = kernel_lab.run_logscan(x, a, h0, 64, LOGSCAN_CHANNELS)
  y_ref, h_ref = kernel_lab.logscan_plain(x, a, h0, 64, LOGSCAN_CHANNELS)
  assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
  for _ in range(48):
    y2, h2 = kernel_lab.run_logscan(x, a, h0, 64, LOGSCAN_CHANNELS)
    assert torch.equal(y2, y) and torch.equal(h2, h)


@requires_cuda
def test_lab_main_runs_on_the_card():
  lines = kernel_lab.main()
  assert len(lines) == 1 + len(kernel_lab.UNROLLED_SWEEP) + len(
      kernel_lab.LOGSCAN_SWEEP)
  for line in lines:
    assert line["us"] > 0 and line["herr"] <= LOGSCAN_H_ATOL, line
