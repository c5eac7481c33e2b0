"""Timing lab for the RG-LRU forward scan on the card.

Counterpart of the repository's ``benchmarks/kernel_lab.py`` (the JAX lab
that tuned the Pallas scan on a TPU), with the same two variants written by
hand in CUDA C++ (``csrc/kernel_lab.cu``) and nothing the JAX lab lacks:

  * variant A, :func:`run_unrolled`: a sequential scan over ``st``-step time
    tiles staged in shared memory, one thread a channel, the carry in a
    register; bit for bit :func:`reference`;
  * variant B, :func:`run_logscan`: a Hillis-Steele log-scan of ``(st, dl)``
    tiles with time on the rows, then ``h + p * carry`` from the previous
    tile; batch 1, as the JAX lab asserts. Its association differs from the
    sequential scan's: ``y`` lands within one bf16 step of
    :func:`reference` and ``h_last`` within 1e-4;
  * the scan kernel the library runs (``ops/lru_scan.py::
    lru_scan_forward``) at the same shape, as the baseline line.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor (:func:`reference` for A, whose tiles
change no rounding; :func:`logscan_plain` for B), and counts its launches.

Run on a machine with a card and ``nvcc``:

  python -m cadence_gemma_tpu_torch.benchmarks.kernel_lab

It prints a line per configuration at the lab's shape ``[1, 2048, 2560]``
in bf16: the mean time of a call in µs (CUDA events over 20 calls after a
warm-up), GB/s by the lab's own count of bytes (``3 * b * t * d * 2``: x
and a read, y written), and ``err`` / ``herr``, the largest differences of
``y`` and ``h_last`` from :func:`reference`.

The sweep: A at ``st`` 64, 128 and 256 (the JAX lab's values), 64 channels
a block; B at ``(st, dl)`` = (32, 256), (64, 128),
(128, 64) and (256, 32). The JAX lab swept B up to 256 x 2560 tiles, 5.2 MB
of fp32 ``h`` and ``p`` in a TPU's VMEM; a block here has 227 KB of shared
memory, and B double-buffers ``h`` and ``p`` in fp32 (``16 * st * dl``
bytes), so every B tile holds 8192 elements (128 KB).
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch import _build
from cadence_gemma_tpu_torch.ops import lru_scan

SHAPE = (1, 2048, 2560)
UNROLLED_SWEEP = (64, 128, 256)
UNROLLED_CHANNELS = 64
LOGSCAN_SWEEP = ((32, 256), (64, 128), (128, 64), (256, 32))

# Kernel launches in this process; callers reset them to count one run.
unrolled_launches = 0
logscan_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# A block may use 227 KB of shared memory.
_MAX_SHARED_BYTES = 232448


def make_inputs(shape: tuple[int, int, int] | None = None,
                dtype: torch.dtype = torch.bfloat16, device=None,
                seed: int = 0):
  """``(x, a, h0)`` of ``shape`` (None: :data:`SHAPE`) from a seeded
  ``torch.Generator`` on ``device`` (None: the card): x normal, a =
  sigmoid(normal) in ``dtype``, h0 normal float32 [b, d]."""
  b, t, d = shape or SHAPE
  device = torch.device(device or "cuda")
  gen = torch.Generator(device).manual_seed(seed)
  x = torch.randn(b, t, d, generator=gen, device=device).to(dtype)
  a = torch.sigmoid(torch.randn(b, t, d, generator=gen, device=device))
  h0 = torch.randn(b, d, generator=gen, device=device)
  return x, a.to(dtype), h0


def reference(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
  """The sequential scan with a float32 carry: ``(y, h_last)``."""
  return lru_scan.lru_scan_plain(x, a, h0)


def _check(x, a, h0, st, width):
  if x.ndim != 3 or a.shape != x.shape or a.dtype != x.dtype:
    raise ValueError("`x` and `a` must be [b, t, d] of one shape and dtype.")
  if x.dtype not in _DTYPE_CODES:
    raise ValueError(f"Unsupported dtype {x.dtype}; use float32 or bfloat16.")
  if h0.shape != (x.shape[0], x.shape[2]) or h0.dtype != torch.float32:
    raise ValueError("`h0` must be float32 [b, d].")
  if a.device != x.device or h0.device != x.device:
    raise ValueError("`x`, `a` and `h0` must be on one device.")
  if x.shape[1] % st or x.shape[2] % width:
    raise ValueError(
        f"[b, t, d] = {tuple(x.shape)} must divide into st = {st} steps and "
        f"blocks of {width} channels, as the lab's grid does."
    )


def logscan_plain(x, a, h0, st: int = 64, dl: int = 128):
  """Variant B's plain version: per ``st``-step tile, ``log2(st)``
  Hillis-Steele rounds in float32 (``h_r += p_r * h_{r-k}``, ``p_r *=
  p_{r-k}`` for rows ``r >= k``), then ``h + p * carry``; the tile's last
  row carries on. ``dl`` only tiles the channels, which are independent."""
  del dl
  if x.shape[0] != 1:
    raise ValueError("The log-scan variant takes batch 1, as the lab's does.")
  carry = h0.float()
  rows = torch.arange(st, device=x.device)[:, None]
  ys = []
  for t0 in range(0, x.shape[1], st):
    h = x[0, t0:t0 + st].float()
    p = a[0, t0:t0 + st].float()
    k = 1
    while k < st:
      valid = rows >= k
      h_sh, p_sh = torch.roll(h, k, 0), torch.roll(p, k, 0)
      h, p = torch.where(valid, h + p * h_sh, h), torch.where(valid, p * p_sh, p)
      k *= 2
    h = h + p * carry
    ys.append(h.to(x.dtype))
    carry = h[-1:]
  return torch.cat(ys)[None], carry


def _launch(symbol, signature, x, a, h0, *sizes):
  fn = _build.function("kernel_lab", symbol, signature)
  x, a, h0 = x.contiguous(), a.contiguous(), h0.contiguous()
  y = torch.empty_like(x)
  h_last = torch.empty_like(h0)
  with torch.cuda.device(x.device):
    err = fn(x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
             h_last.data_ptr(), *sizes,
             torch.cuda.current_stream(x.device).cuda_stream)
  if err:
    raise RuntimeError(f"{symbol} CUDA kernel failed: cudaError_t {err}.")
  return y, h_last


def run_unrolled(x, a, h0, st: int = 128):
  """Variant A (:data:`UNROLLED_CHANNELS` channels a block): its kernel on
  the card, :func:`reference` on CPU. Returns ``(y, h_last)``."""
  global unrolled_launches
  _check(x, a, h0, st, UNROLLED_CHANNELS)
  if x.device.type == "cpu":
    return reference(x, a, h0)
  if x.device.type != "cuda":
    raise ValueError(f"The lab runs on CUDA or CPU tensors, not {x.device}.")
  if 2 * st * UNROLLED_CHANNELS * x.element_size() > _MAX_SHARED_BYTES:
    raise ValueError(f"Tile st={st} does not fit one block.")
  b, t, d = x.shape
  out = _launch("cg_lab_unrolled", "pppppiiiiiip", x, a, h0, b, t, d,
                _DTYPE_CODES[x.dtype], st, UNROLLED_CHANNELS)
  unrolled_launches += 1
  return out


def run_logscan(x, a, h0, st: int = 64, dl: int = 128):
  """Variant B (batch 1): its kernel on the card, :func:`logscan_plain` on
  CPU. Returns ``(y, h_last)``."""
  global logscan_launches
  _check(x, a, h0, st, dl)
  if x.shape[0] != 1:
    raise ValueError("The log-scan variant takes batch 1, as the lab's does.")
  if x.device.type == "cpu":
    return logscan_plain(x, a, h0, st, dl)
  if x.device.type != "cuda":
    raise ValueError(f"The lab runs on CUDA or CPU tensors, not {x.device}.")
  if (4 * st * dl + dl) * 4 > _MAX_SHARED_BYTES:
    raise ValueError(f"Tile st={st} x dl={dl} does not fit one block.")
  _, t, d = x.shape
  out = _launch("cg_lab_logscan", "pppppiiiiip", x, a, h0, t, d,
                _DTYPE_CODES[x.dtype], st, dl)
  logscan_launches += 1
  return out


def cuda_ms(fn, reps: int = 20) -> float:
  """Mean time of one call of ``fn`` in ms: CUDA events around ``reps``
  calls after one warm-up."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def errors(got, want) -> tuple[float, float]:
  """``(err, herr)``: the largest differences of ``y`` and ``h_last``."""
  (y, h), (y_ref, h_ref) = got, want
  return ((y.float() - y_ref.float()).abs().max().item(),
          (h - h_ref).abs().max().item())


def main(device=None) -> list[dict]:
  """Runs the sweep on ``device`` (None: the card) and prints a line per
  configuration; returns them as dicts. Raises without a card."""
  device = torch.device(device or "cuda")
  if device.type != "cuda" or not torch.cuda.is_available():
    raise RuntimeError("The kernel lab times CUDA kernels; it needs a card.")
  b, t, d = SHAPE
  x, a, h0 = make_inputs(device=device)
  want = reference(x, a, h0)
  gb = 3 * b * t * d * 2 / 1e9
  runs = [("lru_scan_forward (the library's kernel)",
           lambda: lru_scan.lru_scan_forward(x, a, h0))]
  runs += [(f"unrolled st={st}", lambda st=st: run_unrolled(x, a, h0, st))
           for st in UNROLLED_SWEEP]
  runs += [(f"logscan st={st} dl={dl}",
            lambda st=st, dl=dl: run_logscan(x, a, h0, st, dl))
           for st, dl in LOGSCAN_SWEEP]
  lines = []
  for name, fn in runs:
    err, herr = errors(fn(), want)
    us = cuda_ms(fn) * 1e3
    print(f"{name}: {us:.1f}us ({gb / (us * 1e-6):.0f} GB/s) err={err} "
          f"herr={herr}", flush=True)
    lines.append(dict(name=name, us=us, err=err, herr=herr))
  return lines


if __name__ == "__main__":
  main()
