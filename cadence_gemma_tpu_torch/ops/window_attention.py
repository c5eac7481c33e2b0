"""Windowed multi-query flash attention: CUDA kernels, plain versions, autograd.

Counterpart of the JAX package's ``flash_window_attention`` with its
``custom_vjp`` (``_flash_window_forward``, ``_flash_window_backward``;
``cadence_gemma_tpu/ops/pallas_attention.py``).
Queries ``[b, t, n, h]`` attend over one shared key/value head
``[b, kv_prefix + t, 1, h]``, whose first ``kv_prefix`` entries precede the
queries in time (a sequence-parallel shard's halo). In the keys' frame query
``i`` sits at ``qp = kv_prefix + i``, and key ``kp`` is visible to it iff
``max(qp - W, qp - segment_pos[i]) <= kp <= qp``: inside the window and
inside the query's document, since positions run contiguously within a
document. Rows with ``segment_pos < 0`` (left padding) output zeros and a
logsumexp of ``1e30``, which keeps a recomputed ``exp(s - lse)`` at zero.

The backward recomputes the probabilities from ``(q, k, lse)``:
``p = exp(s - lse)``, ``ds = p * (dO.v - delta) * scale`` with
``delta = rowsum(dO * O)``; ``dq = ds k``, ``dk = sum_heads ds^T q`` and
``dv = sum_heads p^T dO``.

:func:`window_attention` is differentiable, with or without a halo. Its
forward runs :func:`window_attention_forward` (``csrc/window_attention.cu``)
and its backward :func:`window_attention_dq` and :func:`window_attention_dkv`
(``csrc/window_attention_backward.cu``); with ``kv_prefix > 0`` ``dk`` and
``dv`` cover the halo's rows too, which carries their gradient back to the
shard that sent them. Each wrapper calls its ``torch.library`` operator
(:mod:`ops.library`), whose CUDA implementation launches the kernel and whose
CPU implementation is the plain version; the halo length ``kv_prefix`` is an
int argument of each. A kernel that fails to build or launch raises;
nothing falls back.
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch import _build
from cadence_gemma_tpu_torch.ops import library

# Kernel launches in this process (forward, dq, dk/dv, and each of them with
# a key halo); callers reset them to count one run.
launches = 0
dq_launches = 0
dkv_launches = 0
kv_prefix_launches = 0
dq_kv_prefix_launches = 0
dkv_kv_prefix_launches = 0

MIN_LOGITS_VALUE = -2.3819763e38  # Masked-logit fill of the einsum path.
MASKED_LSE = 1e30  # lse of a row that sees no key.
KERNEL_HEAD_DIMS = (128, 256)  # the presets': Griffin, RecurrentGemma


def band_mask(segment_pos: torch.Tensor, seq_len: int, window: int,
              kv_prefix: int = 0):
  """[b, t(q), kv_prefix + t(k)] visibility of the kernels' band, in the
  keys' frame (``pallas_attention.py:156-204``)."""
  keys = torch.arange(kv_prefix + seq_len, device=segment_pos.device)
  positions = keys[kv_prefix:]
  seg = segment_pos.long()
  lower = torch.maximum(positions[None] - window, positions[None] - seg)
  return (
      (keys[None, None, :] >= lower[..., None])
      & (keys[None, None, :] <= positions[None, :, None])
      & (seg >= 0)[..., None]
  )


def window_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_pos: torch.Tensor,
    window: int,
    kv_prefix: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Masked-einsum attention with the kernel's exact semantics, in float32.

  ``k`` and ``v`` hold ``kv_prefix`` halo rows before the queries' own.
  Returns ``([b, t, n, h] outputs in q.dtype, [b, n, t] float32 lse)``.
  """
  _, seq_len, _, head_dim = q.shape
  visible = band_mask(segment_pos, seq_len, window, kv_prefix)
  logits = torch.einsum(
      "btnh,bsh->bnts", q.float(), k[:, :, 0].float()
  ) * (head_dim**-0.5)
  logits = logits.masked_fill(~visible[:, None], float("-inf"))
  m = logits.amax(dim=-1, keepdim=True)
  m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
  p = torch.exp(logits - m)
  l = p.sum(dim=-1, keepdim=True)
  lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, MASKED_LSE))
  probs = p / torch.where(l > 0, l, torch.ones_like(l))
  out = torch.einsum("bnts,bsh->btnh", probs, v[:, :, 0].float())
  return out.to(q.dtype), lse[..., 0]


def _probabilities_and_ds(q, k, v, segment_pos, lse, delta, d_out, window,
                          kv_prefix=0):
  """The backward's recomputed [b, n, t, kv_prefix + t] probabilities and
  ``ds`` in float32 over the full masked rectangle."""
  _, seq_len, _, head_dim = q.shape
  scale = head_dim**-0.5
  visible = band_mask(segment_pos, seq_len, window, kv_prefix)[:, None]
  s = torch.einsum("btnh,bsh->bnts", q.float(), k[:, :, 0].float()) * scale
  p = torch.where(visible, torch.exp(s - lse[..., None]), 0.0)
  dp = torch.einsum("btnh,bsh->bnts", d_out.float(), v[:, :, 0].float())
  ds = p * (dp - delta[..., None]) * scale
  return p, ds


def window_attention_dq_plain(q, k, v, segment_pos, lse, delta, d_out,
                              window, kv_prefix=0) -> torch.Tensor:
  """``dq = ds k`` in float32, returned in ``q.dtype``."""
  _, ds = _probabilities_and_ds(q, k, v, segment_pos, lse, delta, d_out,
                                window, kv_prefix)
  return torch.einsum("bnts,bsh->btnh", ds, k[:, :, 0].float()).to(q.dtype)


def window_attention_dkv_plain(q, k, v, segment_pos, lse, delta, d_out,
                               window, kv_prefix=0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
  """``(dk, dv)`` over all ``kv_prefix + t`` keys, summed over the query
  heads in float32, in ``k.dtype``."""
  p, ds = _probabilities_and_ds(q, k, v, segment_pos, lse, delta, d_out,
                                window, kv_prefix)
  dk = torch.einsum("bnts,btnh->bsh", ds, q.float())[:, :, None]
  dv = torch.einsum("bnts,btnh->bsh", p, d_out.float())[:, :, None]
  return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(out: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
  """``delta[b, n, t] = rowsum(dO * O)`` in float32 (a plain einsum outside
  the kernels, as in the JAX backward)."""
  return torch.einsum(
      "btnh,btnh->bnt", d_out.float(), out.float()
  ).contiguous()


def window_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_pos: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    window: int,
    kv_prefix: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """``(dq, dk, dv)`` by the kernels' formulas on the full masked rectangle.

  Probabilities come from the forward's ``lse``, not from a new softmax;
  everything is float32 until the results are cast to the inputs' dtypes.
  """
  delta = attention_delta(out, d_out)
  args = (q, k, v, segment_pos, lse, delta, d_out, window, kv_prefix)
  return (window_attention_dq_plain(*args), *window_attention_dkv_plain(*args))


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_pos: torch.Tensor,
    window: int,
) -> torch.Tensor:
  """The einsum formulation of the model's attention (a test oracle).

  Port of ``_reference_attention`` in the JAX package: document ids from
  ``segment_pos == 0``, a causal window of ``window`` past positions, a
  float32 softmax whose probabilities are cast back to ``q.dtype``.
  """
  head_dim = q.shape[-1]
  segment_ids = torch.cumsum(segment_pos == 0, dim=-1)
  positions = torch.arange(q.shape[1], device=q.device)[None]
  same = segment_ids[:, :, None] == segment_ids[:, None, :]
  causal = positions[..., None] >= positions[..., None, :]
  in_window = positions[..., None] <= positions[..., None, :] + window
  mask = (same & causal & in_window)[:, None]
  logits = torch.einsum("btnh,bsnh->bnts", q, k) * (head_dim**-0.5)
  masked = torch.where(
      mask, logits, torch.tensor(MIN_LOGITS_VALUE, dtype=logits.dtype,
                                 device=logits.device)
  )
  probs = torch.softmax(masked.float(), dim=-1).to(q.dtype)
  return torch.einsum("bnts,bsnh->btnh", probs, v)


def _check(q, k, v, segment_pos, kv_prefix=0):
  if q.ndim != 4:
    raise ValueError(f"Expected [b, t, n, h] queries, got {tuple(q.shape)}.")
  if kv_prefix < 0:
    raise ValueError(f"kv_prefix must be >= 0, got {kv_prefix}.")
  batch, seq_len, _, head_dim = q.shape
  kv_shape = (batch, kv_prefix + seq_len, 1, head_dim)
  for name, t in (("k", k), ("v", v)):
    if t.shape != kv_shape:
      raise ValueError(
          f"`{name}` must be [b, kv_prefix + t, 1, h] = {kv_shape}, got "
          f"{tuple(t.shape)}."
      )
    if t.dtype != q.dtype or t.device != q.device:
      raise ValueError(f"`{name}` must match `q` in dtype and device.")
  if segment_pos.shape != (batch, seq_len):
    raise ValueError(
        f"`segment_pos` must be [b, t] = {(batch, seq_len)}, got "
        f"{tuple(segment_pos.shape)}."
    )


def _check_backward(q, k, v, segment_pos, lse, delta, d_out, kv_prefix):
  _check(q, k, v, segment_pos, kv_prefix)
  batch, seq_len, num_heads, _ = q.shape
  if d_out.shape != q.shape or d_out.dtype != q.dtype:
    raise ValueError("`d_out` must match `q` in shape and dtype.")
  for name, t in (("lse", lse), ("delta", delta)):
    if t.shape != (batch, num_heads, seq_len) or t.dtype != torch.float32:
      raise ValueError(
          f"`{name}` must be float32 [b, n, t] = "
          f"{(batch, num_heads, seq_len)}, got {t.dtype} {tuple(t.shape)}."
      )


def _check_cuda(q: torch.Tensor) -> None:
  """Raises unless the CUDA kernels take ``q``'s dtype and width."""
  if q.dtype != torch.bfloat16:
    raise ValueError(
        f"The CUDA window-attention kernels take bfloat16, got {q.dtype}; "
        "run the model in bfloat16 or pass use_flash_attention=False."
    )
  if q.shape[-1] not in KERNEL_HEAD_DIMS:
    raise ValueError(
        f"The CUDA window-attention kernels take head_dim in "
        f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}."
    )


def _contiguous_aligned(*tensors: torch.Tensor) -> list[torch.Tensor]:
  out = [t.contiguous() for t in tensors]
  for t in out:
    if t.data_ptr() % 16:
      raise ValueError("The window-attention kernels need 16-byte alignment.")
  return out


def _stream(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def _forward_cpu(q, k, v, segment_pos, window, kv_prefix):
  out, lse = window_attention_plain(q, k, v, segment_pos, window, kv_prefix)
  return out.contiguous(), lse.contiguous()


def _forward_cuda(q, k, v, segment_pos, window, kv_prefix):
  global launches, kv_prefix_launches
  _check_cuda(q)
  batch, seq_len, num_heads, head_dim = q.shape
  fn = _build.function(
      "window_attention", "cg_window_attention_forward", "ppppppiiiiiifp"
  )
  q, k, v = _contiguous_aligned(q, k, v)
  seg = segment_pos.to(torch.int32).contiguous()
  out = torch.empty_like(q)
  lse = torch.empty(
      batch, num_heads, seq_len, dtype=torch.float32, device=q.device
  )
  with torch.cuda.device(q.device):
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        out.data_ptr(), lse.data_ptr(), batch, seq_len, num_heads, head_dim,
        int(window), int(kv_prefix), float(head_dim**-0.5), _stream(q),
    )
  if kv_prefix:
    kv_prefix_launches += 1
  else:
    launches += 1
  if err:
    raise RuntimeError(
        f"window_attention CUDA kernel failed: cudaError_t {err}."
    )
  return out, lse


def _forward_fake(q, k, v, segment_pos, window, kv_prefix):
  del k, v, segment_pos, window, kv_prefix
  batch, seq_len, num_heads, _ = q.shape
  return (q.new_empty(q.shape),
          q.new_empty((batch, num_heads, seq_len), dtype=torch.float32))


_FORWARD = library.define(
    "window_attention_forward(Tensor q, Tensor k, Tensor v, "
    "Tensor segment_pos, int window, int kv_prefix) -> (Tensor, Tensor)",
    cpu=_forward_cpu, cuda=_forward_cuda, fake=_forward_fake)


def window_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_pos: torch.Tensor,
    window: int,
    kv_prefix: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The forward through its operator: the CUDA kernel for CUDA tensors,
  the plain version for CPU tensors.

  ``k`` and ``v`` are ``[b, kv_prefix + t, 1, h]``; a launch with
  ``kv_prefix > 0`` counts in ``kv_prefix_launches``, one without in
  ``launches``. Returns ``(out, lse)``: [b, t, n, h] outputs in ``q.dtype``
  and the [b, n, t] float32 logsumexp of each query row.
  """
  _check(q, k, v, segment_pos, kv_prefix)
  return _FORWARD(q, k, v, segment_pos, int(window), int(kv_prefix))


def _backward_operands(q, k, v, segment_pos, lse, delta, d_out):
  """The backward's operands contiguous and aligned for a kernel."""
  _check_cuda(q)
  q, k, v, d_out = _contiguous_aligned(q, k, v, d_out)
  seg = segment_pos.to(torch.int32).contiguous()
  return q, k, v, seg, lse.contiguous(), delta.contiguous(), d_out


def _dq_cpu(*args):
  return window_attention_dq_plain(*args).contiguous()


def _dq_cuda(q, k, v, segment_pos, lse, delta, d_out, window, kv_prefix):
  global dq_launches, dq_kv_prefix_launches
  q, k, v, seg, lse, delta, d_out = _backward_operands(
      q, k, v, segment_pos, lse, delta, d_out
  )
  batch, seq_len, num_heads, head_dim = q.shape
  fn = _build.function(
      "window_attention_backward", "cg_window_attention_dq",
      "ppppppppiiiiiifp",
  )
  dq = torch.empty_like(q)
  with torch.cuda.device(q.device):
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), d_out.data_ptr(), dq.data_ptr(),
        batch, seq_len, num_heads, head_dim, int(window), int(kv_prefix),
        float(head_dim**-0.5), _stream(q),
    )
  if kv_prefix:
    dq_kv_prefix_launches += 1
  else:
    dq_launches += 1
  if err:
    raise RuntimeError(
        f"window_attention dq CUDA kernel failed: cudaError_t {err}."
    )
  return dq


def _dq_fake(q, *_):
  return q.new_empty(q.shape)


def _dkv_cpu(*args):
  dk, dv = window_attention_dkv_plain(*args)
  return dk.contiguous(), dv.contiguous()


def _dkv_cuda(q, k, v, segment_pos, lse, delta, d_out, window, kv_prefix):
  global dkv_launches, dkv_kv_prefix_launches
  q, k, v, seg, lse, delta, d_out = _backward_operands(
      q, k, v, segment_pos, lse, delta, d_out
  )
  batch, seq_len, num_heads, head_dim = q.shape
  fn = _build.function(
      "window_attention_backward", "cg_window_attention_dkv",
      "pppppppppiiiiiifp",
  )
  dk = torch.empty_like(k)
  dv = torch.empty_like(v)
  with torch.cuda.device(q.device):
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), d_out.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), batch, seq_len, num_heads, head_dim, int(window),
        int(kv_prefix), float(head_dim**-0.5), _stream(q),
    )
  if kv_prefix:
    dkv_kv_prefix_launches += 1
  else:
    dkv_launches += 1
  if err:
    raise RuntimeError(
        f"window_attention dk/dv CUDA kernel failed: cudaError_t {err}."
    )
  return dk, dv


def _dkv_fake(q, k, v, *_):
  return k.new_empty(k.shape), v.new_empty(v.shape)


_BACKWARD_ARGS = ("(Tensor q, Tensor k, Tensor v, Tensor segment_pos, "
                  "Tensor lse, Tensor delta, Tensor d_out, int window, "
                  "int kv_prefix)")
_DQ = library.define(f"window_attention_dq{_BACKWARD_ARGS} -> Tensor",
                     cpu=_dq_cpu, cuda=_dq_cuda, fake=_dq_fake)
_DKV = library.define(
    f"window_attention_dkv{_BACKWARD_ARGS} -> (Tensor, Tensor)",
    cpu=_dkv_cpu, cuda=_dkv_cuda, fake=_dkv_fake)


def window_attention_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_pos: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    d_out: torch.Tensor,
    window: int,
    kv_prefix: int = 0,
) -> torch.Tensor:
  """dq through its operator: the CUDA kernel for CUDA tensors, the plain
  version for CPU tensors.

  ``lse`` is the forward's, ``delta`` is :func:`attention_delta` and
  ``d_out`` the output cotangent; ``k`` and ``v`` are
  ``[b, kv_prefix + t, 1, h]``. Returns dq [b, t, n, h] in ``q.dtype``; a
  launch with ``kv_prefix > 0`` counts in ``dq_kv_prefix_launches``, one
  without in ``dq_launches``.
  """
  _check_backward(q, k, v, segment_pos, lse, delta, d_out, kv_prefix)
  return _DQ(q, k, v, segment_pos, lse, delta, d_out, int(window),
             int(kv_prefix))


def window_attention_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_pos: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    d_out: torch.Tensor,
    window: int,
    kv_prefix: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
  """(dk, dv) through their operator: the CUDA kernel for CUDA tensors, the
  plain version for CPU tensors.

  The gradients of the one key/value head over all ``kv_prefix + t`` keys,
  summed over the query heads that share it, in ``k.dtype``; a halo key no
  query sees gets zeros. A launch with ``kv_prefix > 0`` counts in
  ``dkv_kv_prefix_launches``, one without in ``dkv_launches``.
  """
  _check_backward(q, k, v, segment_pos, lse, delta, d_out, kv_prefix)
  return _DKV(q, k, v, segment_pos, lse, delta, d_out, int(window),
              int(kv_prefix))


class _WindowAttention(torch.autograd.Function):
  """``flash_window_attention``'s ``custom_vjp``: ``_fwd`` and ``_bwd``."""

  @staticmethod
  def forward(ctx, q, k, v, segment_pos, window, kv_prefix):
    out, lse = window_attention_forward(q, k, v, segment_pos, window,
                                        kv_prefix)
    # The residuals of _fwd; segment_pos gets no gradient.
    ctx.save_for_backward(q, k, v, segment_pos, out, lse)
    ctx.window = window
    ctx.kv_prefix = kv_prefix
    ctx.mark_non_differentiable(lse)
    return out, lse

  @staticmethod
  def backward(ctx, d_out, _):
    q, k, v, segment_pos, out, lse = ctx.saved_tensors
    delta = attention_delta(out, d_out)
    args = (q, k, v, segment_pos, lse, delta, d_out, ctx.window,
            ctx.kv_prefix)
    dq = window_attention_dq(*args)
    dk, dv = window_attention_dkv(*args)
    return dq, dk, dv, None, None, None


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_pos: torch.Tensor,
    window: int,
    kv_prefix: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Differentiable windowed MQA attention: kernels on the card, plain on CPU.

  Args:
    q: [b, t, n, h] queries (RoPE already applied).
    k: [b, kv_prefix + t, 1, h] keys.
    v: [b, kv_prefix + t, 1, h] values.
    segment_pos: [b, t] within-document positions (0 starts a document,
      negative marks padding).
    window: The local attention window size.
    kv_prefix: Leading halo keys and values of a sequence-parallel shard
      (``k`` and ``v`` are then ``[b, kv_prefix + t, 1, h]``, and so are
      their gradients).

  Returns:
    ``(out, lse)``: [b, t, n, h] outputs in ``q.dtype`` and the [b, n, t]
    float32 logsumexp of each query row (no gradient flows through it).
  """
  return _WindowAttention.apply(q, k, v, segment_pos, window, kv_prefix)
