"""Windowed multi-query flash attention (prefill): CUDA kernel + plain version.

Counterpart of the JAX package's ``flash_window_attention`` /
``_flash_window_forward`` (``cadence_gemma_tpu/ops/pallas_attention.py``).
Queries ``[b, t, n, h]`` attend over one shared key/value head
``[b, t, 1, h]``. Key ``kp`` is visible to query ``qp`` iff
``max(qp - W, qp - segment_pos[qp]) <= kp <= qp``: inside the window and
inside the query's document, since positions run contiguously within a
document. Rows with ``segment_pos < 0`` (left padding) output zeros and a
logsumexp of ``1e30``, which keeps a recomputed ``exp(s - lse)`` at zero.

:func:`window_attention` launches ``csrc/window_attention.cu`` for CUDA
tensors and takes :func:`window_attention_plain` only for CPU tensors. A
kernel that fails to build or launch raises; nothing falls back.
"""

from __future__ import annotations

import torch

from cadence_gemma_tpu_torch import _build

# Kernel launches in this process; callers reset it to count one run.
launches = 0

MIN_LOGITS_VALUE = -2.3819763e38  # Masked-logit fill of the einsum path.
MASKED_LSE = 1e30  # lse of a row that sees no key.
KERNEL_HEAD_DIMS = (128, 256)  # the presets': Griffin, RecurrentGemma


def window_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_pos: torch.Tensor,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Masked-einsum attention with the kernel's exact semantics, in float32.

  Returns ``([b, t, n, h] outputs in q.dtype, [b, n, t] float32 lse)``.
  """
  _, seq_len, _, head_dim = q.shape
  positions = torch.arange(seq_len, device=q.device)
  seg = segment_pos.long()
  lower = torch.maximum(positions[None] - window, positions[None] - seg)
  visible = (
      (positions[None, None, :] >= lower[..., None])
      & (positions[None, None, :] <= positions[None, :, None])
      & (seg >= 0)[..., None]
  )  # [b, t, s]
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


def _check(q, k, v, segment_pos):
  if q.ndim != 4:
    raise ValueError(f"Expected [b, t, n, h] queries, got {tuple(q.shape)}.")
  batch, seq_len, _, head_dim = q.shape
  for name, t in (("k", k), ("v", v)):
    if t.shape != (batch, seq_len, 1, head_dim):
      raise ValueError(
          f"`{name}` must be [b, t, 1, h] = {(batch, seq_len, 1, head_dim)}, "
          f"got {tuple(t.shape)}."
      )
    if t.dtype != q.dtype or t.device != q.device:
      raise ValueError(f"`{name}` must match `q` in dtype and device.")
  if segment_pos.shape != (batch, seq_len):
    raise ValueError(
        f"`segment_pos` must be [b, t] = {(batch, seq_len)}, got "
        f"{tuple(segment_pos.shape)}."
    )


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_pos: torch.Tensor,
    window: int,
    kv_prefix: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Windowed MQA attention: the CUDA kernel on the card, plain on CPU.

  Args:
    q: [b, t, n, h] queries (RoPE already applied).
    k: [b, t, 1, h] keys.
    v: [b, t, 1, h] values.
    segment_pos: [b, t] within-document positions (0 starts a document,
      negative marks padding).
    window: The local attention window size.
    kv_prefix: Leading halo keys of a sequence-parallel shard; only 0 is
      supported.

  Returns:
    ``(out, lse)``: [b, t, n, h] outputs in ``q.dtype`` and the [b, n, t]
    float32 logsumexp of each query row.
  """
  global launches
  if kv_prefix:
    raise NotImplementedError(
        "kv_prefix (the sequence-parallel key halo) is not supported."
    )
  _check(q, k, v, segment_pos)
  if q.device.type == "cpu":
    return window_attention_plain(q, k, v, segment_pos, window)
  if q.device.type != "cuda":
    raise ValueError(
        f"window_attention runs on CUDA or CPU tensors, not {q.device}."
    )
  batch, seq_len, num_heads, head_dim = q.shape
  if q.dtype != torch.bfloat16:
    raise ValueError(
        f"The CUDA window-attention kernel takes bfloat16, got {q.dtype}; "
        "run the model in bfloat16 or pass use_flash_attention=False."
    )
  if head_dim not in KERNEL_HEAD_DIMS:
    raise ValueError(
        f"The CUDA window-attention kernel takes head_dim in "
        f"{KERNEL_HEAD_DIMS}, got {head_dim}."
    )

  fn = _build.function(
      "window_attention", "cg_window_attention_forward", "ppppppiiiiifp"
  )

  q = q.contiguous()
  k = k.contiguous()
  v = v.contiguous()
  seg = segment_pos.to(torch.int32).contiguous()
  for t in (q, k, v):
    if t.data_ptr() % 16:
      raise ValueError("The window-attention kernel needs 16-byte alignment.")
  out = torch.empty_like(q)
  lse = torch.empty(
      batch, num_heads, seq_len, dtype=torch.float32, device=q.device
  )
  with torch.cuda.device(q.device):
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        out.data_ptr(), lse.data_ptr(), batch, seq_len, num_heads, head_dim,
        int(window), float(head_dim**-0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
  launches += 1
  if err:
    raise RuntimeError(
        f"window_attention CUDA kernel failed: cudaError_t {err}."
    )
  return out, lse
