"""The captured decode step (a CUDA graph) against the eager decode loop.

Card tests: they skip without a CUDA device. A small float32 Griffin with
the fused epilogue (its add_rmsnorm kernel runs inside the captured step)
decodes the same prompts with ``jit_compile=True`` (one decode step captured
and replayed) and ``jit_compile=False`` (every step launched from Python).
The two run the same kernels on the same inputs: tokens must be identical
for greedy decoding, for categorical decoding from generators seeded alike,
with the repetition penalty and with stop tokens, and the caller's
generator must end where eager sampling leaves it. A capture that fails
raises; nothing falls back to the eager loop.

  python -m pytest --noconftest tests/test_torch_port_sampler_graph.py -q
"""

import numpy as np
import pytest
import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.ops import fused_epilogue
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab

requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)

VOCAB = SimpleVocab([f"w{i}" for i in range(508)])
STEPS = 24


def _prompts():
  rng = np.random.default_rng(3)
  return [" ".join(f"w{i}" for i in rng.integers(0, 508, n))
          for n in (40, 27)]


@pytest.fixture(scope="module")
def model():
  config = common.GriffinConfig(
      vocab_size=512, width=128, mlp_expanded_width=256, num_heads=2,
      block_types=(common.TemporalBlockType.RECURRENT,
                   common.TemporalBlockType.ATTENTION,
                   common.TemporalBlockType.RECURRENT),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=16,
      logits_soft_cap=30.0, lru_width=128,
  )
  dev = torch.device("cuda")
  return griffin.Griffin(config, device=dev, dtype=torch.float32,
                         generator=torch.Generator(dev).manual_seed(0),
                         fused_epilogue=True)


def _run(model, jit_compile, seed=None, **kwargs):
  call_kw = {k: kwargs.pop(k) for k in
             ("echo", "return_logits", "end_sampling_at_eos_token",
              "return_state") if k in kwargs}
  s = sampler_lib.Sampler(model, VOCAB, jit_compile=jit_compile, **kwargs)
  gen = None
  if seed is not None:
    gen = torch.Generator("cuda").manual_seed(seed)
  out = s(_prompts(), STEPS, generator=gen, **call_kw)
  torch.cuda.synchronize()
  return s, out, gen


MODES = {
    "greedy": dict(),
    "categorical": dict(deterministic_sampling=False, temperature=0.8,
                        top_k=50, top_p=0.95, seed=7),
    "penalty": dict(repetition_penalty=1.3),
    "echo_state": dict(echo=True, return_state=True),
}


@requires_cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_captured_decode_matches_eager(model, mode):
  kwargs = dict(MODES[mode], return_logits=True,
                end_sampling_at_eos_token=False)
  s, got, gen = _run(model, True, **kwargs)
  _, want, want_gen = _run(model, False, **kwargs)
  (graph,) = s._graphs.values()
  assert graph.replays == STEPS - 1
  for t, w in zip(got.tokens, want.tokens):
    assert torch.equal(t, w)
  for l, w in zip(got.logits, want.logits):
    torch.testing.assert_close(l, w, atol=1e-5, rtol=1e-5)
  if gen is not None:
    assert torch.equal(gen.get_state(), want_gen.get_state())
  if got.state is not None:
    assert torch.equal(got.state.pending_token, want.state.pending_token)
    assert torch.equal(got.state.length, want.state.length)
    for a, b in zip(sampler_lib._cache_leaves(got.state.cache),
                    sampler_lib._cache_leaves(want.state.cache)):
      torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@requires_cuda
def test_captured_decode_stops_like_eager_and_is_reused(model):
  """A stop token that ends one row mid-decode; the graph of the first call
  serves the second, whose decode steps launch nothing from Python."""
  _, free, _ = _run(model, False, end_sampling_at_eos_token=False)
  stop = int(free.tokens[0][5])
  s, got, _ = _run(model, True, stop_token_ids=[stop])
  _, want, _ = _run(model, False, stop_token_ids=[stop])
  for t, w in zip(got.tokens, want.tokens):
    assert torch.equal(t, w)
  assert (got.tokens[0] == stop).any()
  (graph,) = s._graphs.values()
  replays = graph.replays
  before = fused_epilogue.launches
  again = s(_prompts(), STEPS)
  # Only the prefill's add_rmsnorm launches count: the steps are replays.
  assert fused_epilogue.launches - before == model.config.num_layers
  assert len(s._graphs) == 1 and graph.replays > replays
  for t, w in zip(again.tokens, got.tokens):
    assert torch.equal(t, w)


@requires_cuda
def test_failing_capture_raises(model, monkeypatch):
  """A decode step that reads a value back to the host cannot be captured:
  the call raises instead of decoding eagerly."""
  forward = type(model).forward

  def host_read(self, tokens, *args, **kwargs):
    if tokens.shape[1] == 1:
      tokens.sum().item()
    return forward(self, tokens, *args, **kwargs)

  monkeypatch.setattr(type(model), "forward", host_read)
  s = sampler_lib.Sampler(model, VOCAB)
  with pytest.raises(RuntimeError):
    s(_prompts(), STEPS)
  assert not s._graphs
