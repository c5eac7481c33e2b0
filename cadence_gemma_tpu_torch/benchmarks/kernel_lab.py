"""Timing lab for the RG-LRU forward scan on the card.

Counterpart of the repository's ``benchmarks/kernel_lab.py`` (the JAX lab
that tuned the Pallas scan on a TPU), with the same two variants written by
hand in CUDA C++ (``csrc/kernel_lab.cu``) and nothing the JAX lab lacks:

  * variant A, :func:`run_unrolled`: a sequential scan over ``st``-step time
    tiles, the real forward walk of the scans' TMA ring
    (``csrc/lru_ring.cuh``) at that tile length, one thread a channel, the
    carry in a register; bit for bit :func:`reference`. At ``st`` 128 it
    runs the library's forward scan's code, so its line and the baseline's
    time the same walk;
  * variant B, :func:`run_logscan`: a Hillis-Steele log-scan of ``st``-step
    tiles with time on the rows, then ``h + p * carry`` from the previous
    tile; batch 1, as the JAX lab asserts. Its association differs from the
    sequential scan's: ``y`` lands within one bf16 step of
    :func:`reference` and ``h_last`` within 1e-4; against its plain version,
    :func:`logscan_plain`, it is bit for bit. The kernel is time-parallel:
    a warp scans one channel's tile with the rows on its lanes and the
    rounds in registers; an item is 16 channels of 256 rows (one tile at
    ``st`` 512); persistent blocks on every SM draw the items group by
    group, so the time axis runs in parallel, and the carry crosses groups
    by a chained scan through a scratch buffer the wrapper zeroes at each
    call.
    The JAX lab's ``dl`` only tiled its grid's channels, which are
    independent: the wrapper checks that it divides ``d``, as the JAX grid
    needs, and the kernel takes its own;
  * the scan kernel the library runs (``ops/lru_scan.py::
    lru_scan_forward``, the TMA ring of ``csrc/lru_scan.cu``) at the same
    shape, as the baseline line.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor (:func:`reference` for A, whose tiles
change no rounding; :func:`logscan_plain` for B), and counts its launches.

Run on a machine with a card and ``nvcc``:

  python -m cadence_gemma_tpu_torch.benchmarks.kernel_lab

It prints a line per configuration at the lab's shape ``[1, 2048, 2560]``
in bf16: the mean time of a call in µs (:func:`device_ms`: CUDA events
around 20 calls enqueued behind a sleep on the card after a warm-up, so a
call shorter than its launch on the host is timed and not the launch; the
inputs stay in the L2), GB/s by the lab's own count of bytes
(``3 * b * t * d * 2``: x and a read, y written), and ``err`` / ``herr``,
the largest differences of ``y`` and ``h_last`` from :func:`reference`.

The sweep: A at ``st`` 64, 128 and 256 (the JAX lab's values; the ring's
own channels a block and stages); B at the JAX lab's own ``(st, dl)``
tiles, (256, 512), (256, 1280), (512, 640), (128, 2560) and (256, 2560).
The three st = 256 lines run the same kernel on the same work. What
bounds B is the shared-memory pipe and the order of its phases, not the
tile: 10 warp shuffles and ~10 shared-memory accesses an element, and each
item's load, scan, chain and store one after another (PERF.md, section 7).
"""

from __future__ import annotations

import time

import torch

from cadence_gemma_tpu_torch import _build
from cadence_gemma_tpu_torch.ops import lru_scan

SHAPE = (1, 2048, 2560)
UNROLLED_SWEEP = (64, 128, 256)
LOGSCAN_SWEEP = ((256, 512), (256, 1280), (512, 640), (128, 2560),
                 (256, 2560))
# The tile lengths cg_lab_logscan is built for, and its channels a block.
LOGSCAN_STEPS = (32, 64, 128, 256, 512)
LOGSCAN_CHANNELS = 16
SCAN_ROW = "lru_scan_forward (the library's TMA-ring kernel)"

# Kernel launches in this process; callers reset them to count one run.
unrolled_launches = 0
logscan_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _check(x, a, h0, st, width=1):
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
        f"[b, t, d] = {tuple(x.shape)} must divide into st = {st} steps"
        + (f" and blocks of {width} channels" if width > 1 else "")
        + ", as the lab's grid does."
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


def _check_ring(x, st):
  """What variant A's ring takes: a tile length ``csrc/kernel_lab.cu``
  instances, and rows TMA can describe (a multiple of 16 bytes)."""
  if st not in UNROLLED_SWEEP:
    raise ValueError(f"Tile st={st}: the ring is built for st in "
                     f"{UNROLLED_SWEEP}.")
  if x.shape[2] * x.element_size() % 16:
    raise ValueError(f"A row of {x.shape[2]} {x.dtype} channels is not a "
                     "multiple of 16 bytes, which TMA needs.")


def run_unrolled(x, a, h0, st: int = 128):
  """Variant A, the ring's forward walk in ``st``-step tiles: its kernel on
  the card, :func:`reference` on CPU. Returns ``(y, h_last)``."""
  global unrolled_launches
  _check(x, a, h0, st)
  _check_ring(x, st)
  if x.device.type == "cpu":
    return reference(x, a, h0)
  if x.device.type != "cuda":
    raise ValueError(f"The lab runs on CUDA or CPU tensors, not {x.device}.")
  x, a = x.contiguous(), a.contiguous()
  if x.data_ptr() % 16 or a.data_ptr() % 16:
    raise ValueError("TMA needs 16-byte aligned bases of `x` and `a`.")
  b, t, d = x.shape
  out = _launch("cg_lab_unrolled", "pppppiiiiip", x, a, h0, b, t, d,
                _DTYPE_CODES[x.dtype], st)
  unrolled_launches += 1
  return out


def _check_logscan(x, st):
  """What variant B's kernel takes: batch 1, a tile length
  ``csrc/kernel_lab.cu`` instances, and whole strips of 16 channels."""
  if x.shape[0] != 1:
    raise ValueError("The log-scan variant takes batch 1, as the lab's does.")
  if st not in LOGSCAN_STEPS:
    raise ValueError(f"Tile st={st}: the log-scan kernel is built for st in "
                     f"{LOGSCAN_STEPS}.")
  if x.shape[2] % LOGSCAN_CHANNELS:
    raise ValueError(f"d = {x.shape[2]} is not a multiple of the log-scan "
                     f"kernel's {LOGSCAN_CHANNELS} channels a block.")


def logscan_scratch(x, st):
  """Variant B's scratch buffer (its ticket counter and the carry words of
  its chained scan), zeroed on the current stream: the kernel's own size."""
  import ctypes  # pylint: disable=import-outside-toplevel

  n_bytes = ctypes.c_int64()
  err = _build.function("kernel_lab", "cg_lab_logscan_scratch_bytes",
                        "iiip")(x.shape[1], x.shape[2], st,
                                ctypes.addressof(n_bytes))
  if err:
    raise RuntimeError(f"cg_lab_logscan_scratch_bytes failed: cudaError_t "
                       f"{err}.")
  return torch.zeros(n_bytes.value // 8, dtype=torch.int64, device=x.device)


def run_logscan(x, a, h0, st: int = 64, dl: int = 128):
  """Variant B (batch 1): its kernel on the card, :func:`logscan_plain` on
  CPU. Returns ``(y, h_last)``."""
  global logscan_launches
  _check(x, a, h0, st, dl)
  _check_logscan(x, st)
  if x.device.type == "cpu":
    return logscan_plain(x, a, h0, st, dl)
  if x.device.type != "cuda":
    raise ValueError(f"The lab runs on CUDA or CPU tensors, not {x.device}.")
  x, a = x.contiguous(), a.contiguous()
  if x.data_ptr() % 16 or a.data_ptr() % 16:
    raise ValueError("The log-scan kernel reads 16-byte aligned `x` and `a`.")
  _, t, d = x.shape
  scratch = logscan_scratch(x, st)
  out = _launch("cg_lab_logscan", "ppppppiiiip", x, a, h0,
                scratch.data_ptr(), t, d, _DTYPE_CODES[x.dtype], st)
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


# Cycles of the card-side sleep that keeps the launch queue full while
# device_ms enqueues its calls (~50 ms at the H100's 1.98 GHz boost clock).
QUEUE_SLEEP_CYCLES = 100_000_000


def device_ms(fn, reps: int, inputs=None) -> float:
  """Mean device time of one call of ``fn`` with the launch queue full.

  The calls are enqueued behind a sleep on the card and timed by CUDA events
  around them, so they run back to back: the host's launch, which takes
  longer than a short kernel, stays out, and so does the idle time in which
  the L2 would write a call's outputs back to memory unseen. Outputs are
  kept to the end, so every call writes memory of its own. With ``inputs``
  (argument tuples) call i is ``fn(*inputs[i % len])``: copies of a
  byte-bound kernel's inputs that together exceed the L2, so no call reads
  what the call before left in it (``chip_smoke.py``'s ``cold_copies``).
  Raises if the host took longer to enqueue the calls than the card
  slept."""
  def call(i):
    return fn() if inputs is None else fn(*inputs[i % len(inputs)])

  # A first pass warms up and leaves the caching allocator holding every
  # output block the timed pass needs: a fresh cudaMalloc a call would
  # outlast the sleep.
  outputs = [call(i) for i in range(reps)]
  del outputs
  torch.cuda.synchronize()
  asleep, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
  asleep.record()
  torch.cuda._sleep(QUEUE_SLEEP_CYCLES)  # pylint: disable=protected-access
  start.record()
  host_start = time.perf_counter()
  outputs = [call(i) for i in range(reps)]
  host_ms = (time.perf_counter() - host_start) * 1e3
  end.record()
  end.synchronize()
  del outputs
  if host_ms >= asleep.elapsed_time(start):
    raise RuntimeError(f"The launch queue drained: enqueueing took "
                       f"{host_ms:.2f} ms, the card slept "
                       f"{asleep.elapsed_time(start):.2f} ms.")
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
  runs = [(SCAN_ROW,
           lambda: lru_scan.lru_scan_forward(x, a, h0))]
  runs += [(f"unrolled st={st}", lambda st=st: run_unrolled(x, a, h0, st))
           for st in UNROLLED_SWEEP]
  runs += [(f"logscan st={st} dl={dl}",
            lambda st=st, dl=dl: run_logscan(x, a, h0, st, dl))
           for st, dl in LOGSCAN_SWEEP]
  lines = []
  for name, fn in runs:
    err, herr = errors(fn(), want)
    us = device_ms(fn, 20) * 1e3
    print(f"{name}: {us:.1f}us ({gb / (us * 1e-6):.0f} GB/s) err={err} "
          f"herr={herr}", flush=True)
    lines.append(dict(name=name, us=us, err=err, herr=herr))
  return lines


if __name__ == "__main__":
  main()
