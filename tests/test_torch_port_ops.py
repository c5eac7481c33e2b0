"""``torch.library.opcheck`` of every operator of the port's kernels.

Each operator of ``ops/fused_epilogue.py``, ``ops/lru_scan.py``,
``ops/window_attention.py`` and ``ops/int8_matmul.py`` runs its CPU
implementation (the plain version) at tiny shapes under opcheck's schema,
autograd-registration, fake-tensor and AOT-dispatch checks: the fake
implementation must give the shapes, dtypes and strides the CPU one does,
and no output may alias an input. The CUDA implementations go through the
same checks on the card in ``chip_smoke.py`` (phase 23), at the shapes of
the serving path.
"""

import numpy as np
import pytest
import torch

from cadence_gemma_tpu_torch.ops import fused_epilogue
from cadence_gemma_tpu_torch.ops import int8_matmul  # noqa: F401
from cadence_gemma_tpu_torch.ops import library
from cadence_gemma_tpu_torch.ops import lru_scan  # noqa: F401
from cadence_gemma_tpu_torch.ops import window_attention as wa

OPS = getattr(torch.ops, library.NAMESPACE)
B, T, D = 2, 5, 8


def _t(*shape, seed=0, dtype=torch.float32, grad=False):
  rng = np.random.default_rng(seed)
  t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
  return t.to(dtype).requires_grad_(grad)


def _decay(seed):
  return torch.sigmoid(_t(B, T, D, seed=seed)).requires_grad_()


def _lru_args(name: str):
  """Arguments of an LRU walk: components of (x, a, h0) and reverse."""
  parts = 2 if "complex" in name else 1
  xs = [_t(B, T, D, seed=i, grad=True) for i in range(parts)]
  as_ = [_decay(10 + i) for i in range(parts)]
  h0s = [_t(B, D, seed=20 + i) for i in range(parts)]
  return (*xs, *as_, *h0s, True)


def _attention_args(backward: bool, kv_prefix: int = 2):
  n, h, window = 2, 8, 3
  q = _t(B, T, n, h, seed=1, grad=True)
  k = _t(B, kv_prefix + T, 1, h, seed=2, grad=True)
  v = _t(B, kv_prefix + T, 1, h, seed=3, grad=True)
  seg = torch.tensor([[0, 1, 2, 3, 4], [-1, 0, 1, 0, 1]], dtype=torch.int32)
  if not backward:
    return (q, k, v, seg, window, kv_prefix)
  out, lse = wa.window_attention_plain(q.detach(), k.detach(), v.detach(),
                                       seg, window, kv_prefix)
  d_out = _t(B, T, n, h, seed=4)
  delta = wa.attention_delta(out, d_out)
  return (q, k, v, seg, lse, delta, d_out, window, kv_prefix)


def _int8_args(dgrad: bool, batches: int = 2, a_batches: int = 1):
  """Small integers and power-of-two scales: every sum is exact, so the
  plain product gives the same bits in any order of summation (opcheck
  compares eager and AOT-traced calls, whose matmuls may order it
  differently)."""
  rng = np.random.default_rng(5)
  ints = lambda *shape: rng.integers(-8, 9, shape)  # noqa: E731
  q = torch.from_numpy(ints(batches, 6, 16).astype(np.int8))
  scale = torch.from_numpy(2.0 ** ints(batches, 6)).float()
  if dgrad:
    g = torch.from_numpy(ints(batches, 3, 6)).float().requires_grad_()
    return (g, q, scale, False)
  a = torch.from_numpy(ints(a_batches, 3, 16)).float().requires_grad_()
  return (a, q, scale)


CASES = {
    "add_rmsnorm": lambda: (_t(B, T, D, grad=True), _t(B, T, D, seed=1),
                            _t(D, seed=2), 1e-6),
    **{f"lru_scan_{kind}{walk}{product}":
       (lambda name=f"lru_scan_{kind}{walk}{product}": _lru_args(name))
       for kind in ("", "complex_") for walk in ("forward", "backward")
       for product in ("", "_a_prod")},
    "lru_scan_carries": lambda: (_t(B, T, D, grad=True), _decay(1),
                                 _t(B, D, seed=2)),
    "window_attention_forward": lambda: _attention_args(False),
    "window_attention_dq": lambda: _attention_args(True),
    "window_attention_dkv": lambda: _attention_args(True),
    "int8_weight_matmul": lambda: _int8_args(False),
    "int8_weight_matmul_dgrad": lambda: _int8_args(True),
}


def test_every_operator_has_a_case():
  """The cases cover every operator the four modules define, and nothing
  else is in the namespace."""
  registered = {
      name.split("::")[1] for name in torch._C._dispatch_get_all_op_names()  # pylint: disable=protected-access
      if name.startswith(library.NAMESPACE + "::")}
  assert registered == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck(name):
  torch.library.opcheck(getattr(OPS, name).default, CASES[name]())


VARIANTS = {
    # A walk without h0, forward.
    "lru_scan_forward": lambda: (_t(B, T, D, grad=True), _decay(1), None,
                                 False),
    # Attention without a halo.
    "window_attention_forward": lambda: _attention_args(False, kv_prefix=0),
    # A per-batch activation.
    "int8_weight_matmul": lambda: _int8_args(False, a_batches=2),
    # A shared activation's gradient, summed over the batches.
    "int8_weight_matmul_dgrad": lambda: (*_int8_args(True)[:3], True),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_opcheck_variants(name):
  torch.library.opcheck(getattr(OPS, name).default, VARIANTS[name]())


def test_cpu_implementation_is_the_plain_version():
  """The wrappers return the plain versions' values on CPU tensors and
  count no launch."""
  x, r, s, eps = CASES["add_rmsnorm"]()
  before = fused_epilogue.launches
  got = fused_epilogue.add_rmsnorm_forward(x.detach(), r, s, eps)
  want = fused_epilogue.reference_add_rmsnorm(x.detach(), r, s, eps)
  assert all(torch.equal(g, w) for g, w in zip(got, want))
  assert fused_epilogue.launches == before
  q, k, v, seg, window, kv_prefix = _attention_args(False)
  args = [z.detach() if z.dtype.is_floating_point else z for z in (q, k, v)]
  got = wa.window_attention_forward(*args, seg, window, kv_prefix)
  want = wa.window_attention_plain(*args, seg, window, kv_prefix)
  assert all(torch.equal(g, w) for g, w in zip(got, want))
