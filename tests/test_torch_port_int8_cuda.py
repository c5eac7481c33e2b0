"""The int8 weight-only CUDA kernels and the int8 x int8 product on the card.

Card tests: they skip without a CUDA device. The weight-only product --
``cg_int8_weight_matmul`` (``csrc/int8_matmul.cu``, mma.sync) below
``int8_matmul.WGMMA_MIN_ROWS`` rows, ``cg_int8_wgmma_forward``
(``csrc/int8_wgmma.cu``) from there on -- against its plain version
(``int8_weight_matmul_plain``, JAX's ``(x @ q.astype(bf16)) * scale``) at
the 2B's four layouts -- a ``Dense`` [2560 -> 2560], the fused ``ffw_up``
(two [2560 -> 7680] over one shared activation, batch stride 0), the gates'
block-diagonal (10 heads of [256 -> 256] read in place from a [m, 2560]
activation) and ``Embedder.decode`` [2560 -> 256000] -- at 1, 2, 8, 17,
255, 256, 257, 3000 and 5554 rows, each on its route's launch counter:
both sum in float32 in other orders, round the sum to bfloat16,
multiply by the bfloat16 scale and round again, so one step of the first
rounding and the second rounding together differ by up to 1.5 x 2^-7 of the
larger value: they must agree within 2^-6 of it (plus 1e-4 of the largest
output for sums that cancel). Two launches give the same bits, and
a captured CUDA graph replays them, on both routes. At decode rows the
wrapper's output is bit for bit a direct call of the mma.sync kernel with
the split rule's slices. The input gradient (``cg_int8_wgmma_dgrad`` at
every shape) against its plain version
(``int8_weight_matmul_dgrad_plain``, JAX's ``(dy * scale.astype(bf16)) @
q.astype(bf16)``) at the same layouts, from 1 row to training rows (odd
ones included, 255 to 257 and 5554), with the plain version's sum taken in
float64: the kernel rounds
the scaled cotangent to bfloat16 as JAX does, sums in float32 and rounds
once, within the same 2^-6 of the exact product. (cuBLAS' own bf16 product
sums the logits' 256000 terms 0.02 beyond that at 2049 rows, so it is not
the yardstick there.) At ragged N and K the kernel is held against the
plain version itself, and ``int8_weight_matmul(...).backward()`` against
the plain expression's autograd gradient. ``int8_act_matmul`` (``torch._int_mm``,
zero rows padded under 17) equals the exact integer product. A small bf16
``Griffin(quantized=True)``: captured decode (the kernel inside the graph)
gives the eager loop's tokens and the prefill_act_quant Sampler runs.

  python -m pytest --noconftest tests/test_torch_port_int8_cuda.py -q
"""

import pytest
import torch

from cadence_gemma_tpu_torch import _build
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.ops import int8_matmul
from cadence_gemma_tpu_torch.ops import quantization
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab

requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)

ROWS = (1, 2, 8, 17, 255, 256, 257, 3000, 5554)
LAYOUTS = ("dense", "ffw_up", "block_diagonal", "embed")


def operands(layout: str, m: int, seed: int = 0):
  """(a, q, scale) on the card as the 2B's layer hands them to the kernel."""
  gen = torch.Generator("cuda").manual_seed(seed)
  dev = "cuda"

  def qs(batches, n, k):
    q = torch.randint(-127, 128, (batches, n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    scale = torch.rand(batches, n, generator=gen, device=dev) * 1e-2
    return q, scale

  x = torch.randn(m, 2560, generator=gen, device=dev).bfloat16()
  if layout == "dense":
    return (x[None], *qs(1, 2560, 2560))
  if layout == "ffw_up":
    return (x[None].expand(2, -1, -1), *qs(2, 7680, 2560))
  if layout == "block_diagonal":
    return (x.view(m, 10, 256).transpose(0, 1), *qs(10, 256, 256))
  return (x[None], *qs(1, 256000, 2560))


def assert_matches_plain(got: torch.Tensor, want: torch.Tensor) -> None:
  got, want = got.float(), want.float()
  big = torch.maximum(got.abs(), want.abs())
  allowed = big * 2.0**-6 + 1e-4 * want.abs().max()
  worst = ((got - want).abs() - allowed).max().item()
  assert worst <= 0, worst


@pytest.fixture(autouse=True)
def _full_precision_reference():
  """The plain version's cuBLAS product keeps float32 partial sums."""
  if not torch.cuda.is_available():
    yield
    return
  saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
  yield
  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved


@requires_cuda
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_int8_weight_matmul_cuda_matches_plain(layout, m):
  a, q, scale = operands(layout, m)
  before = (int8_matmul.launches, int8_matmul.wgmma_launches)
  got = int8_matmul.int8_weight_matmul(a, q, scale)
  wgmma = m >= int8_matmul.WGMMA_MIN_ROWS
  assert (int8_matmul.launches, int8_matmul.wgmma_launches) == (
      before[0] + (not wgmma), before[1] + wgmma)
  want = int8_matmul.int8_weight_matmul_plain(a, q, scale)
  torch.cuda.synchronize()
  assert got.shape == want.shape and got.dtype == torch.bfloat16
  assert got.is_contiguous()
  assert_matches_plain(got, want)


@requires_cuda
@pytest.mark.parametrize("layout,m", [("dense", 2), ("block_diagonal", 8),
                                      ("ffw_up", 17), ("embed", 2),
                                      ("dense", 3000), ("ffw_up", 300),
                                      ("block_diagonal", 5554),
                                      ("embed", 257)])
def test_int8_weight_matmul_cuda_bits_repeat_and_replay(layout, m):
  """Two launches, and the replays of a captured graph, give one result
  (split-K at the decode shapes sums its slices in a fixed order; the
  wgmma kernel's tensor maps are kernel parameters the graph keeps)."""
  a, q, scale = operands(layout, m, seed=1)
  first = int8_matmul.int8_weight_matmul(a, q, scale)
  second = int8_matmul.int8_weight_matmul(a, q, scale)
  torch.cuda.synchronize()
  assert torch.equal(first, second)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    int8_matmul.int8_weight_matmul(a, q, scale)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = int8_matmul.int8_weight_matmul(a, q, scale)
  for _ in range(3):
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


@requires_cuda
@pytest.mark.parametrize("m", (1, 2, 8, 16))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_int8_decode_rows_are_the_mma_sync_kernel(layout, m):
  """Below the crossover the wrapper launches the mma.sync kernel as it
  did before the wgmma kernels existed: its output equals, bit for bit, a
  direct call of ``cg_int8_weight_matmul`` with the split rule's slices."""
  a, q, scale = operands(layout, m, seed=2)
  before = int8_matmul.wgmma_launches
  got = int8_matmul.int8_weight_matmul(a, q, scale)
  assert int8_matmul.wgmma_launches == before
  batches, n, k = q.shape
  splits = int8_matmul.split_k(batches, m, n, k)
  want = torch.empty(batches, m, n, dtype=torch.bfloat16, device="cuda")
  partial = torch.empty(max(splits, 1), batches, m, n, device="cuda")
  fn = _build.function("int8_matmul", "cg_int8_weight_matmul",
                       "pppppiiiillip")
  err = fn(a.data_ptr(), q.data_ptr(), scale.data_ptr(), want.data_ptr(),
           partial.data_ptr() if splits > 1 else None, batches, m, n, k,
           a.stride(0) if a.shape[0] == batches else 0, a.stride(1), splits,
           torch.cuda.current_stream().cuda_stream)
  torch.cuda.synchronize()
  assert err == 0 and torch.equal(got, want)


@requires_cuda
@pytest.mark.parametrize("batches,m,n,k", [
    (1, 333, 200, 80), (3, 257, 7, 16), (2, 300, 300, 2576),
    (1, 129, 200, 80)])
def test_int8_weight_matmul_cuda_ragged_shapes(batches, m, n, k):
  """Tile edges on both routes: N odd or short of the 256-wide tile, K a
  multiple of 16 short of the 64-deep one, M off the 128-row tile."""
  gen = torch.Generator("cuda").manual_seed(m + n)
  a = torch.randn(batches, m, k, generator=gen, device="cuda").bfloat16()
  q = torch.randint(-127, 128, (batches, n, k), generator=gen, device="cuda",
                    dtype=torch.int8)
  scale = torch.rand(batches, n, generator=gen, device="cuda") * 1e-2
  got = int8_matmul.int8_weight_matmul(a, q, scale)
  want = int8_matmul.int8_weight_matmul_plain(a, q, scale)
  torch.cuda.synchronize()
  assert_matches_plain(got, want)
  assert torch.equal(got, int8_matmul.int8_weight_matmul(a, q, scale))


@requires_cuda
def test_int8_weight_matmul_cuda_refuses_what_it_cannot_take():
  a, q, scale = operands("dense", 2)
  with pytest.raises(ValueError, match="bfloat16"):
    int8_matmul.int8_weight_matmul(a.float(), q, scale)
  # A depth off 16 (a tensor-parallel shard's, SigLIP's 4304 / 2) is taken
  # with zero columns added, and matches the plain version.
  got = int8_matmul.int8_weight_matmul(a[..., :40], q[..., :40], scale)
  assert_matches_plain(got, int8_matmul.int8_weight_matmul_plain(
      a[..., :40], q[..., :40], scale))


@requires_cuda
@pytest.mark.parametrize("m", [2, 1458])
@pytest.mark.parametrize("stored", ["contiguous", "padded_rows"])
def test_int8_weight_matmul_cuda_depth_off_16(m, stored):
  """SigLIP's ``mlp_fc2`` row piece at TP-2 ([1152, 2152], its depth off
  16) on both routes, its weight contiguous or in rows padded to 16 as the
  tensor-parallel loader stores it, within 2^-6 of the plain version. The
  wgmma route reads padded rows in place and leaves the caller's tensors
  as they were."""
  gen = torch.Generator("cuda").manual_seed(7)
  a = torch.randn(1, m, 2152, generator=gen, device="cuda").bfloat16()
  q = torch.randint(-127, 128, (1152, 2152), generator=gen, device="cuda",
                    dtype=torch.int8)
  if stored == "padded_rows":
    q = int8_matmul.padded_rows(q, 16)
    assert q.stride() == (2160, 1)
  scale = torch.rand(1, 1152, generator=gen, device="cuda") * 1e-2
  before = int8_matmul.wgmma_launches
  got = int8_matmul.int8_weight_matmul(a, q[None], scale)
  assert int8_matmul.wgmma_launches - before == int(
      int8_matmul.uses_wgmma(m))
  assert_matches_plain(got, int8_matmul.int8_weight_matmul_plain(
      a, q[None], scale))


DGRAD_ROWS = (1, 17, 255, 256, 257, 333, 4096, 5554)


def dgrad_operands(layout: str, m: int, seed: int = 0):
  """(g, q, scale, reduce) on the card: the cotangent of the layer's product
  as the backward hands it to the kernel."""
  a, q, scale = operands(layout, m, seed)
  gen = torch.Generator("cuda").manual_seed(seed + 100)
  g = torch.randn(q.shape[0], m, q.shape[1], generator=gen,
                  device="cuda").bfloat16()
  return g, q, scale, layout == "ffw_up"


@requires_cuda
@pytest.mark.parametrize("m", DGRAD_ROWS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_int8_dgrad_cuda_matches_plain(layout, m):
  """The input gradient at the 2B's four layouts (the fused up-projection
  summed over its two products into the shared activation's gradient)."""
  if layout == "embed" and m >= 4096:
    # The logits' [M, 256000] cotangent at odd rows: 1 and 1.5 GB.
    m = {4096: 2049, 5554: 3001}[m]
  g, q, scale, reduce = dgrad_operands(layout, m)
  before = int8_matmul.dgrad_wgmma_launches
  got = int8_matmul.int8_weight_matmul_dgrad(g, q, scale, reduce)
  assert int8_matmul.dgrad_wgmma_launches == before + 1
  # The plain version's arithmetic, its sum exact: the scaled cotangent
  # rounded to bf16 as JAX rounds it, the product in float64.
  scaled = (g * scale.to(g.dtype)[..., None, :]).double()
  want = (torch.einsum("bmn,bnk->mk", scaled, q.double())[None] if reduce
          else scaled @ q.double())
  torch.cuda.synchronize()
  assert got.shape == want.shape == ((1 if reduce else q.shape[0]), m,
                                     q.shape[2])
  assert got.dtype == torch.bfloat16 and got.is_contiguous()
  assert_matches_plain(got, want)


@requires_cuda
@pytest.mark.parametrize("batches,m,n,k,reduce", [
    (3, 5, 200, 80, False), (3, 5, 200, 80, True), (1, 65, 8, 16, False),
    (2, 129, 72, 2576, True), (3, 333, 200, 80, True),
    (1, 257, 8, 16, False), (2, 300, 72, 2576, True)])
def test_int8_dgrad_cuda_ragged_shapes(batches, m, n, k, reduce):
  """Tile edges: N a multiple of 8 short of the 64-deep tile, K a multiple
  of 16 short of the 64- and 128-wide ones, M off the 128-row tile and
  short of it."""
  gen = torch.Generator("cuda").manual_seed(m + n)
  g = torch.randn(batches, m, n, generator=gen, device="cuda").bfloat16()
  q = torch.randint(-127, 128, (batches, n, k), generator=gen, device="cuda",
                    dtype=torch.int8)
  scale = torch.rand(batches, n, generator=gen, device="cuda") * 1e-2
  got = int8_matmul.int8_weight_matmul_dgrad(g, q, scale, reduce)
  want = int8_matmul.int8_weight_matmul_dgrad_plain(g, q, scale, reduce)
  torch.cuda.synchronize()
  assert_matches_plain(got, want)
  again = int8_matmul.int8_weight_matmul_dgrad(g, q, scale, reduce)
  assert torch.equal(got, again)


@requires_cuda
@pytest.mark.parametrize("layout,m", [("dense", 1000),
                                      ("block_diagonal", 1000),
                                      ("ffw_up", 17)])
def test_int8_dgrad_cuda_bits_repeat_and_replay(layout, m):
  """The wgmma input gradient: two launches and a captured graph's
  replays give one result."""
  g, q, scale, reduce = dgrad_operands(layout, m, seed=5)
  first = int8_matmul.int8_weight_matmul_dgrad(g, q, scale, reduce)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    int8_matmul.int8_weight_matmul_dgrad(g, q, scale, reduce)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = int8_matmul.int8_weight_matmul_dgrad(g, q, scale, reduce)
  for _ in range(3):
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


@requires_cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_int8_weight_matmul_backward_matches_plain_autograd(layout):
  """``int8_weight_matmul(a, ...).backward(g)`` launches the forward and
  the input-gradient kernels once each (at 257 rows the wgmma pair), and
  ``a.grad`` is autograd's of the plain expression; the weight and scale
  get none. The fused up-projection's shared activation is one [1, M, K]
  tensor."""
  m = 257
  a, q, scale = operands(layout, m, seed=3)
  if layout == "ffw_up":
    a = a[:1]
  a = a.detach().clone().requires_grad_()
  ref = a.detach().clone().requires_grad_()
  g = torch.randn(q.shape[0], m, q.shape[1], device="cuda",
                  generator=torch.Generator("cuda").manual_seed(4)).bfloat16()
  before = (int8_matmul.wgmma_launches, int8_matmul.dgrad_wgmma_launches)
  int8_matmul.int8_weight_matmul(a, q, scale).backward(g)
  assert (int8_matmul.wgmma_launches, int8_matmul.dgrad_wgmma_launches) == (
      before[0] + 1, before[1] + 1)
  y = int8_matmul.int8_weight_matmul_plain(ref, q, scale)
  y.float().backward(g.float())  # cuBLAS' bf16 products, as in the forward
  torch.cuda.synchronize()
  assert a.grad.shape == a.shape
  assert_matches_plain(a.grad, ref.grad)
  assert not q.requires_grad and not scale.requires_grad


@requires_cuda
def test_int8_dgrad_cuda_refuses_what_it_cannot_take():
  g, q, scale, _ = dgrad_operands("dense", 2)
  with pytest.raises(ValueError, match="bfloat16"):
    int8_matmul.int8_weight_matmul_dgrad(g.float(), q, scale)
  with pytest.raises(ValueError, match="multiple of 8"):
    int8_matmul.int8_weight_matmul_dgrad(g[..., :36], q[:, :36], scale[:, :36])


@requires_cuda
@pytest.mark.parametrize("m", (1, 5, 16, 17))
def test_int8_act_matmul_cuda_is_exact(m):
  gen = torch.Generator("cuda").manual_seed(m)
  xq = torch.randint(-127, 128, (m, 2560), generator=gen, device="cuda",
                     dtype=torch.int8)
  q = torch.randint(-127, 128, (256, 2560), generator=gen, device="cuda",
                    dtype=torch.int8)
  before = quantization.int_mm_calls
  got = quantization.int8_act_matmul(xq, q)
  assert quantization.int_mm_calls == before + 1
  want = quantization.int8_act_matmul(xq.cpu(), q.cpu())
  assert got.shape == (m, 256) and got.dtype == torch.int32
  assert torch.equal(got.cpu(), want)
  with pytest.raises(ValueError, match="multiples of 8"):
    quantization.int8_act_matmul(xq[:, :36], q[:, :36])


def _tiny_int8_model():
  config = common.GriffinConfig(
      vocab_size=512, width=128, mlp_expanded_width=384, num_heads=2,
      block_types=(common.TemporalBlockType.RECURRENT,
                   common.TemporalBlockType.ATTENTION,
                   common.TemporalBlockType.RECURRENT),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=32,
      logits_soft_cap=30.0, lru_width=128)
  model = griffin.Griffin(config, device="cuda", dtype=torch.bfloat16,
                          generator=torch.Generator("cuda").manual_seed(0))
  with torch.no_grad():
    for p in model.parameters():  # large enough to pick varied tokens
      if p.dtype == torch.bfloat16:
        p.normal_(0.0, 0.5, generator=torch.Generator("cuda").manual_seed(1))
  qmodel = griffin.Griffin(config, device="meta", quantized=True)
  qmodel.to_empty(device="cuda")
  qmodel.load_state_dict(quantization.quantize_params(model.state_dict()))
  return qmodel


@requires_cuda
def test_int8_captured_decode_matches_eager():
  qmodel = _tiny_int8_model()
  vocab = SimpleVocab([f"w{i}" for i in range(508)])
  prompts = ["w1 w7 w9 w300 w2", "w4 w5"]
  runs = {}
  for captured in (True, False):
    s = sampler_lib.Sampler(qmodel, vocab, jit_compile=captured,
                            prefill_act_quant=True)
    s(prompts, total_generation_steps=12, end_sampling_at_eos_token=False)
    int8_matmul.launches = 0
    quantization.int_mm_calls = 0
    out = s(prompts, total_generation_steps=12,
            end_sampling_at_eos_token=False)
    runs[captured] = (torch.stack(out.tokens).cpu(), int8_matmul.launches,
                      quantization.int_mm_calls)
  assert torch.equal(runs[True][0], runs[False][0])
  # The prefill's weight-only launches are the gates' and the logits'; the
  # eager decode launches every product each step, the replays none the
  # counter sees.
  assert runs[True][1] > 0 and runs[False][1] > runs[True][1]
  assert runs[True][2] == runs[False][2] > 0
