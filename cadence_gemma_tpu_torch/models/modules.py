"""Griffin building blocks: local attention, recurrent block, MLP, embedder.

Counterparts of the JAX package's ``cadence_gemma_tpu/models/modules.py``
with the same parameter names and cache semantics:

  * Local sliding-window MQA (one shared KV head), partial RoPE on the first
    half of the head dimensions, a float32 softmax with a large negative mask
    fill, and a ring KV cache of exactly ``window_size`` slots driven by a
    ``num_tokens`` counter. A prompt longer than the window on the card goes
    through the CUDA window-attention kernel; with a sharding spec the
    prompt runs sequence-parallel, each shard against its predecessor's
    last ``window`` keys (the halo exchange of ``parallel/sp_attention.py``).
  * RecurrentBlock: gelu(y-branch) * (Conv1D -> RG-LRU)(x-branch), then an
    output projection. Cache = (fp32 RG-LRU state, conv tail).
  * Gated-GeLU MLP with a fused ``(2, d, D)`` up-projection.
  * The vision-language connector: fused vision features -> model width.
  * The residual block, whose residual add and channel pre-norm can run as
    one fused epilogue (``fused_epilogue=True``, a CUDA kernel on the card).
  * Tied-embedding encoder/decoder with optional ``sqrt(width)`` scaling
    (rounded through bfloat16 to match Gemma training).

Every block takes ``quantized`` (int8 weights in each projection, the gates'
block-diagonal and the embedding table) and ``act_quant`` (int8 activations
in each ``Dense`` and ``Einsum``; see ``layers.py``), as the JAX blocks do,
and ``lora_rank`` / ``lora_alpha`` / ``lora_rows``: an adapter pair (or a
stack of pairs, one a batch row) on every ``Dense`` and
``Einsum`` (``modules.py:358-387, 514-562, 643-675, 702-734, 759-821`` in
JAX); the gates' block-diagonals, the conv, the norms and the embedder get
none.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch
from torch import nn

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import layers
from cadence_gemma_tpu_torch.ops import int8_matmul
from cadence_gemma_tpu_torch.ops import window_attention as window_attention_lib
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import sp_attention

_MIN_LOGITS_VALUE = window_attention_lib.MIN_LOGITS_VALUE
_MAX_WAVELENGTH = 10_000


class RecurrentBlockCache(NamedTuple):
  """State of a recurrent block: RG-LRU hidden state + conv tail."""

  rg_lru_state: torch.Tensor
  conv1d_state: torch.Tensor


class AttentionBlockCache(NamedTuple):
  """Ring KV cache of ``window_size`` slots plus a monotone token counter."""

  keys: torch.Tensor
  values: torch.Tensor
  num_tokens: torch.Tensor


ResidualBlockCache = Union[RecurrentBlockCache, AttentionBlockCache]


def apply_rope(
    inputs: torch.Tensor,
    positions: torch.Tensor,
    max_wavelength: int = _MAX_WAVELENGTH,
) -> torch.Tensor:
  """Rotates the first half of the head dims; passes the rest through.

  Of a head of size ``h``, dims ``[0, h/2)`` are rotated pairwise (split at
  ``h/4``) by position-dependent angles, dims ``[h/2, h)`` are untouched.
  """
  rotated, passthrough = torch.chunk(inputs, 2, dim=-1)
  half = rotated.shape[-1] // 2
  exponents = (
      2.0 * torch.arange(half, dtype=torch.float32, device=inputs.device)
      / rotated.shape[-1]
  )
  inv_timescale = max_wavelength ** (-exponents)
  # positions: [b, t] -> [b, t, 1, 1] to broadcast over heads and dims.
  angles = positions[..., None, None].float() * inv_timescale
  sin = torch.sin(angles).to(inputs.dtype)
  cos = torch.cos(angles).to(inputs.dtype)
  first, second = torch.chunk(rotated, 2, dim=-1)
  return torch.cat(
      [first * cos - second * sin, second * cos + first * sin, passthrough],
      dim=-1,
  )


def _causal_window_mask(
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    window_size: int,
    q_segment_ids: torch.Tensor | None = None,
    k_segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
  """mask[b, q, k] = same segment & k <= q & q <= k + window."""
  if q_segment_ids is not None:
    same_segment = q_segment_ids[..., None] == k_segment_ids[..., None, :]
  else:
    same_segment = (k_positions >= 0)[..., None, :]
  causal = q_positions[..., None] >= k_positions[..., None, :]
  in_window = q_positions[..., None] <= k_positions[..., None, :] + window_size
  return same_segment & causal & in_window


def compute_forward_pass_mask(
    segment_pos: torch.Tensor, window_size: int
) -> torch.Tensor:
  """Mask for full-sequence (prompt) processing; documents split at pos 0."""
  segment_ids = torch.cumsum(segment_pos == 0, dim=-1)
  positions = torch.arange(
      segment_pos.shape[-1], device=segment_pos.device
  ).expand(segment_pos.shape[0], -1)
  return _causal_window_mask(
      positions, positions, window_size, segment_ids, segment_ids
  )


def compute_cache_mask(
    seq_len: int,
    cache_num_tokens: torch.Tensor,
    window_size: int,
    q_segment_pos: torch.Tensor | None = None,
) -> torch.Tensor:
  """Mask for decode steps and chunks against the ring cache.

  Slot ``i`` holds position ``i + k*window`` if that has been written
  (``< num_tokens``), else ``i + (k-1)*window``, where
  ``k = num_tokens // window``. The new queries' positions are appended at
  the end; ``q_segment_pos`` gives them per row for chunks of a left-padded
  batch (pad queries carry -1 and attend nothing).
  """
  device = cache_num_tokens.device
  if q_segment_pos is not None:
    q_positions = q_segment_pos
  else:
    q_positions = (
        torch.arange(seq_len, device=device)[None] + cache_num_tokens[:, None]
    )
  wraps = torch.div(
      cache_num_tokens[:, None], window_size, rounding_mode="floor"
  )
  slots = torch.arange(window_size, device=device)[None]
  pos_current = slots + wraps * window_size
  pos_previous = slots + (wraps - 1) * window_size
  written = pos_current < cache_num_tokens[:, None]
  k_positions = torch.where(written, pos_current, pos_previous)
  k_positions = torch.cat([k_positions, q_positions], dim=-1)
  return _causal_window_mask(q_positions, k_positions, window_size)


def _roll_rows(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
  """Per-row ``torch.roll`` along dim 1 by a [b] tensor of shifts."""
  length = x.shape[1]
  idx = (
      torch.arange(length, device=x.device)[None] - shifts[:, None]
  ) % length
  idx = idx.view(*idx.shape, *([1] * (x.ndim - 2))).expand_as(x)
  return torch.gather(x, 1, idx)


def _right_align_in_window(
    keys: torch.Tensor,
    values: torch.Tensor,
    segment_pos: torch.Tensor,
    window_size: int,
) -> AttentionBlockCache:
  """Builds a fresh ring cache from a processed prompt.

  The last ``min(window, t)`` KVs are rolled so that, with the
  ``num_tokens`` counter, later ring writes land in the right slots.
  """
  w = min(window_size, keys.shape[1])
  num_tokens = segment_pos[:, -1] + 1
  pad = (0, 0, 0, 0, 0, window_size - w)
  return AttentionBlockCache(
      keys=nn.functional.pad(_roll_rows(keys[:, -w:], num_tokens), pad),
      values=nn.functional.pad(_roll_rows(values[:, -w:], num_tokens), pad),
      num_tokens=num_tokens.to(torch.int32),
  )


def update_attention_cache(
    keys: torch.Tensor,
    values: torch.Tensor,
    segment_pos: torch.Tensor,
    cache: AttentionBlockCache,
) -> AttentionBlockCache:
  """Writes new KVs into the ring cache (returns a new cache).

  Single-token decode writes slot ``num_tokens % window``. Multi-token
  chunks fold the cache and the new KVs into a rebuilt ring holding the
  window-suffix of their concatenation.
  """
  seq_len = keys.shape[1]
  window_size = cache.keys.shape[1]

  if seq_len == 1:
    batch_idx = torch.arange(keys.shape[0], device=keys.device)
    slot = (cache.num_tokens % window_size).long()
    new_keys = cache.keys.clone()
    new_values = cache.values.clone()
    new_keys[batch_idx, slot] = keys[:, 0]
    new_values[batch_idx, slot] = values[:, 0]
    return AttentionBlockCache(new_keys, new_values, cache.num_tokens + 1)

  if seq_len >= window_size:
    return _right_align_in_window(keys, values, segment_pos, window_size)

  # Chunked prefill: unroll the ring into time order, append, re-roll. Only
  # real tokens advance the counter: a left-padded row's chunk may start
  # with pads, which land in not-yet-written (masked) slots.
  shift = -(cache.num_tokens.long() % window_size)
  new_n = segment_pos[:, -1].long() + 1

  def fold(ring, new):
    linear = _roll_rows(ring, shift)
    return _roll_rows(torch.cat([linear, new], dim=1)[:, -window_size:],
                      new_n)

  return AttentionBlockCache(
      fold(cache.keys, keys), fold(cache.values, values),
      new_n.to(torch.int32),
  )


def commit_attention_cache(
    keys: torch.Tensor,
    values: torch.Tensor,
    cache: AttentionBlockCache,
    commit_idx: torch.Tensor,
) -> AttentionBlockCache:
  """Masked ring write of a speculative verify chunk (``modules.py:245-284``
  in JAX).

  The chunk's ``t`` tokens take the slots ``(num_tokens + i) % window``,
  distinct while ``t <= window``; a row writes only its tokens up to
  ``commit_idx`` (the accepted prefix), the other slots keep their keys and
  values, and the counter advances by ``commit_idx + 1``: the ring plain
  decode of the accepted tokens leaves. Written as a select over the whole
  ring (slot ``s`` holds chunk token ``(s - num_tokens) % window``), so no
  index depends on the data.
  """
  t = keys.shape[1]
  window = cache.keys.shape[1]
  if t > window:
    raise ValueError(f"A verify chunk of {t} tokens exceeds the window "
                     f"{window}: its ring slots would collide.")
  slots = torch.arange(window, device=keys.device)[None]
  offset = (slots - cache.num_tokens[:, None].long()) % window  # [b, w]
  write = ((offset < t) & (offset <= commit_idx[:, None]))[..., None, None]
  idx = offset.clamp(max=t - 1)[..., None, None].expand(
      -1, -1, *keys.shape[2:])
  return AttentionBlockCache(
      keys=torch.where(write, keys.gather(1, idx), cache.keys),
      values=torch.where(write, values.gather(1, idx), cache.values),
      num_tokens=(cache.num_tokens + commit_idx + 1).to(
          cache.num_tokens.dtype),
  )


def commit_pending_cache(old_cache, pending_cache, commit_idx: torch.Tensor):
  """Turns a ``pending_cache=True`` forward into a decode cache holding the
  first ``commit_idx + 1`` chunk tokens of each row (``modules.py:287-329``
  in JAX):

    * RG-LRU: the per-step fp32 carries ``[b, t, d]``; row by row, step
      ``commit_idx``.
    * Conv1D: the ``[old tail | chunk inputs]``; the ``temporal_width - 1``
      inputs that end at ``commit_idx`` (gathered, so the window may reach
      back into the old tail).
    * Attention: the chunk's rotated keys and values; a masked ring write
      (:func:`commit_attention_cache`).

  The result is the cache plain decode of the accepted tokens would leave.
  """
  idx = commit_idx.long()

  def commit_block(old, pending):
    if isinstance(old, RecurrentBlockCache):
      states = pending.rg_lru_state
      h = states.gather(1, idx[:, None, None].expand(-1, 1, states.shape[2]))
      xcat = pending.conv1d_state
      tail = old.conv1d_state.shape[1]
      rows = idx[:, None] + 1 + torch.arange(tail, device=idx.device)[None]
      conv = xcat.gather(1, rows[..., None].expand(-1, -1, xcat.shape[2]))
      return RecurrentBlockCache(rg_lru_state=h[:, 0],
                                 conv1d_state=conv.to(old.conv1d_state.dtype))
    return commit_attention_cache(pending.keys, pending.values, old, idx)

  return {name: commit_block(old_cache[name], pending_cache[name])
          for name in old_cache}


def _should_use_flash_attention(
    seq_len: int, window_size: int, override: bool | None,
    device: torch.device,
) -> bool:
  """Auto-dispatch for the windowed-attention kernel.

  The kernel only visits the window band and never builds the [t, t]
  logits, so it pays when the sequence exceeds the window; at
  ``t <= window`` the einsum path stays the default. ``override`` forces
  either path (on a CPU tensor the kernel's plain version runs).
  """
  if override is not None:
    return override
  if seq_len <= window_size or seq_len < 256:
    return False
  return device.type == "cuda"


class LocalAttentionBlock(nn.Module):
  """Sliding-window multi-query attention (one shared KV head).

  ``sharding_spec`` runs a prompt (no cache) sequence-parallel when
  :func:`sp_attention.can_sequence_shard` allows it and the kernel dispatch
  would take the kernel at the shards' local length (``modules.py:452-469``
  in JAX); otherwise the unsharded path runs.
  """

  def __init__(
      self,
      width: int,
      num_heads: int,
      window_size: int,
      use_flash_attention: bool | None = None,
      sharding_spec: sharding.ShardingSpec | None = None,
      device=None,
      dtype=None,
      quantized: bool = False,
      act_quant: bool = False,
      lora_rank: int = 0,
      lora_alpha: float | None = None,
      lora_rows: int = 0,
  ):
    super().__init__()
    self.num_heads = num_heads
    self.window_size = window_size
    self.use_flash_attention = use_flash_attention
    self.sharding_spec = sharding_spec
    self.head_dim = width // num_heads
    kw = dict(device=device, dtype=dtype, quantized=quantized,
              act_quant=act_quant, lora_rank=lora_rank,
              lora_alpha=lora_alpha, lora_rows=lora_rows)
    self.proj_q = layers.Dense(width, width, use_bias=False, **kw)
    self.proj_k = layers.Dense(width, self.head_dim, use_bias=False, **kw)
    self.proj_v = layers.Dense(width, self.head_dim, use_bias=False, **kw)
    self.proj_final = layers.Dense(width, width, use_bias=True, **kw)

  def forward(
      self,
      x: torch.Tensor,
      segment_pos: torch.Tensor,
      cache: AttentionBlockCache | None = None,
      return_cache: bool = True,
      pending_cache: bool = False,
  ) -> tuple[torch.Tensor, AttentionBlockCache | None]:
    """Attention over ``x`` (against the ring with a cache) and the new
    cache; with ``pending_cache`` (speculative verify) the chunk's rotated
    keys and values with the old ``num_tokens``, for
    :func:`commit_attention_cache` (``modules.py:418-431`` in JAX)."""
    b, t, _ = x.shape
    queries = self.proj_q(x).unflatten(-1, (self.num_heads, self.head_dim))
    keys = self.proj_k(x)[:, :, None, :]  # single KV head
    values = self.proj_v(x)[:, :, None, :]

    queries = apply_rope(queries, segment_pos)
    keys = apply_rope(keys, segment_pos)

    if cache is not None:
      if not return_cache:
        new_cache = None
      elif pending_cache:
        new_cache = AttentionBlockCache(keys, values, cache.num_tokens)
      else:
        new_cache = update_attention_cache(keys, values, segment_pos, cache)
      keys = torch.cat([cache.keys, keys], dim=1)
      values = torch.cat([cache.values, values], dim=1)
      attn_mask = compute_cache_mask(
          t, cache.num_tokens, self.window_size,
          # Chunks of a ragged batch need true per-row query positions;
          # single-token decode keeps the counter-derived positions.
          q_segment_pos=segment_pos if t > 1 else None,
      )
    else:
      new_cache = (
          _right_align_in_window(keys, values, segment_pos, self.window_size)
          if return_cache
          else None
      )
      spec = self.sharding_spec
      if (
          spec is not None
          and sp_attention.can_sequence_shard(spec, t, self.window_size)
          and _should_use_flash_attention(
              t // spec.mesh.shape[spec.sequence_axis_name],
              self.window_size, self.use_flash_attention, x.device,
          )
      ):
        encoded = sp_attention.sequence_sharded_attention(
            queries, keys, values, segment_pos, self.window_size, spec
        )
        return self.proj_final(encoded.flatten(-2)), new_cache
      if _should_use_flash_attention(
          t, self.window_size, self.use_flash_attention, x.device
      ):
        encoded, _ = window_attention_lib.window_attention(
            queries, keys, values, segment_pos, self.window_size
        )
        return self.proj_final(encoded.flatten(-2)), new_cache
      attn_mask = compute_forward_pass_mask(segment_pos, self.window_size)

    logits = torch.einsum("btnh,bsh->bnts", queries, keys[:, :, 0])
    logits = logits * (self.head_dim**-0.5)
    masked = logits.masked_fill(~attn_mask[:, None], _MIN_LOGITS_VALUE)
    probs = torch.softmax(masked.float(), dim=-1).to(x.dtype)
    encoded = torch.einsum("bnts,bsh->btnh", probs, values[:, :, 0])
    return self.proj_final(encoded.flatten(-2)), new_cache

  @staticmethod
  def init_cache(batch_size: int, window_size: int, head_dim: int, dtype,
                 device=None) -> AttentionBlockCache:
    kw = dict(dtype=dtype, device=device)
    return AttentionBlockCache(
        keys=torch.zeros(batch_size, window_size, 1, head_dim, **kw),
        values=torch.zeros(batch_size, window_size, 1, head_dim, **kw),
        num_tokens=torch.zeros(batch_size, dtype=torch.int32, device=device),
    )


class RecurrentBlock(nn.Module):
  """Griffin's recurrent temporal-mixing block."""

  def __init__(
      self,
      width: int,
      num_heads: int,
      lru_width: int | None = None,
      conv1d_temporal_width: int = 4,
      scan_type: common.ScanType = common.ScanType.AUTO,
      scan_sharding_spec: sharding.ShardingSpec | None = None,
      device=None,
      dtype=None,
      quantized: bool = False,
      act_quant: bool = False,
      lora_rank: int = 0,
      lora_alpha: float | None = None,
      lora_rows: int = 0,
  ):
    super().__init__()
    lru_width = lru_width or width
    kw = dict(device=device, dtype=dtype)
    qkw = dict(kw, quantized=quantized, act_quant=act_quant,
               lora_rank=lora_rank, lora_alpha=lora_alpha,
               lora_rows=lora_rows)
    self.linear_y = layers.Dense(width, lru_width, **qkw)
    self.linear_x = layers.Dense(width, lru_width, **qkw)
    self.linear_out = layers.Dense(lru_width, width, **qkw)
    self.conv_1d = layers.Conv1D(lru_width, conv1d_temporal_width, **kw)
    self.rg_lru = layers.RGLRU(lru_width, num_heads, scan_type,
                               scan_sharding_spec, quantized=quantized, **kw)

  def forward(
      self,
      x: torch.Tensor,
      segment_pos: torch.Tensor,
      cache: RecurrentBlockCache | None = None,
      return_cache: bool = True,
      pending_cache: bool = False,
  ) -> tuple[torch.Tensor, RecurrentBlockCache | None]:
    """With ``pending_cache`` the cache holds the per-step RG-LRU carries
    and the conv's ``[old tail | chunk inputs]`` (see
    :func:`commit_pending_cache`)."""
    y = layers.gelu(self.linear_y(x))
    x = self.linear_x(x)
    x, conv1d_state = self.conv_1d(
        x, segment_pos, None if cache is None else cache.conv1d_state,
        return_cache, pending_cache,
    )
    x, rg_lru_state = self.rg_lru(
        x, segment_pos, None if cache is None else cache.rg_lru_state,
        return_cache, pending_cache,
    )
    x = self.linear_out(x * y)
    if not return_cache:
      return x, None
    return x, RecurrentBlockCache(rg_lru_state, conv1d_state)

  @staticmethod
  def init_cache(batch_size: int, lru_width: int, dtype,
                 conv1d_temporal_width: int = 4,
                 device=None) -> RecurrentBlockCache:
    return RecurrentBlockCache(
        rg_lru_state=layers.RGLRU.init_cache(batch_size, lru_width, device),
        conv1d_state=layers.Conv1D.init_cache(
            batch_size, lru_width, dtype, conv1d_temporal_width, device
        ),
    )


class MLPBlock(nn.Module):
  """Gated-GeLU MLP with a fused gate/up projection."""

  def __init__(self, width: int, expanded_width: int, device=None,
               dtype=None, quantized: bool = False, act_quant: bool = False,
               lora_rank: int = 0, lora_alpha: float | None = None,
               lora_rows: int = 0):
    super().__init__()
    kw = dict(device=device, dtype=dtype, quantized=quantized,
              act_quant=act_quant, lora_rank=lora_rank, lora_alpha=lora_alpha,
              lora_rows=lora_rows)
    self.ffw_up = layers.Einsum(
        w_shape=(2, width, expanded_width),
        b_shape=(2, 1, 1, expanded_width),
        eqn="...td,cdD->c...tD",
        **kw,
    )
    self.ffw_down = layers.Dense(expanded_width, width, **kw)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    gate_and_up = self.ffw_up(x)
    return self.ffw_down(layers.gelu(gate_and_up[0]) * gate_and_up[1])


class VisionLanguageConnector(nn.Module):
  """Vision -> LM projector: an Einsum up-projection, tanh GeLU, and a Dense
  down to the model width (the JAX ``vl_connector`` tree)."""

  def __init__(self, width: int, expanded_width: int, vision_width: int,
               device=None, dtype=None, quantized: bool = False,
               act_quant: bool = False, lora_rank: int = 0,
               lora_alpha: float | None = None, lora_rows: int = 0):
    super().__init__()
    kw = dict(device=device, dtype=dtype, quantized=quantized,
              act_quant=act_quant, lora_rank=lora_rank, lora_alpha=lora_alpha,
              lora_rows=lora_rows)
    self.ffw_up = layers.Einsum(
        w_shape=(1, vision_width, expanded_width),
        b_shape=(1, 1, 1, expanded_width),
        eqn="...td,rdD->r...tD",
        **kw,
    )
    self.ffw_down = layers.Dense(expanded_width, width, **kw)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.ffw_down(layers.gelu(self.ffw_up(x)[0]))


class ResidualBlock(nn.Module):
  """Pre-norm residual block: temporal mixer then MLP.

  ``fused_epilogue=True`` computes the residual add after the temporal mixer
  and the channel pre-norm in one pass (``RMSNorm(x, residual=...)``).
  ``scan_sharding_spec`` goes to the RG-LRU scan or, as ``sharding_spec``,
  to the attention block (``modules.py:580,789,805`` in JAX).
  """

  def __init__(
      self,
      width: int,
      mlp_expanded_width: int,
      num_heads: int,
      attention_window_size: int,
      temporal_block_type: common.TemporalBlockType,
      lru_width: int | None = None,
      conv1d_temporal_width: int = 4,
      scan_type: common.ScanType = common.ScanType.AUTO,
      use_flash_attention: bool | None = None,
      fused_epilogue: bool = False,
      scan_sharding_spec: sharding.ShardingSpec | None = None,
      device=None,
      dtype=None,
      quantized: bool = False,
      act_quant: bool = False,
      lora_rank: int = 0,
      lora_alpha: float | None = None,
      lora_rows: int = 0,
  ):
    super().__init__()
    kw = dict(device=device, dtype=dtype)
    qkw = dict(kw, quantized=quantized, act_quant=act_quant,
               lora_rank=lora_rank, lora_alpha=lora_alpha,
               lora_rows=lora_rows)
    self.temporal_block_type = temporal_block_type
    self.fused_epilogue = fused_epilogue
    self.temporal_pre_norm = layers.RMSNorm(width, **kw)
    if temporal_block_type is common.TemporalBlockType.RECURRENT:
      self.recurrent_block = RecurrentBlock(
          width, num_heads, lru_width, conv1d_temporal_width, scan_type,
          scan_sharding_spec, **qkw
      )
    else:
      self.attention_block = LocalAttentionBlock(
          width, num_heads, attention_window_size, use_flash_attention,
          scan_sharding_spec, **qkw
      )
    self.channel_pre_norm = layers.RMSNorm(width, **kw)
    self.mlp_block = MLPBlock(width, mlp_expanded_width, **qkw)

  @property
  def temporal_block(self) -> nn.Module:
    if self.temporal_block_type is common.TemporalBlockType.RECURRENT:
      return self.recurrent_block
    return self.attention_block

  def forward(
      self,
      x: torch.Tensor,
      segment_pos: torch.Tensor,
      cache: ResidualBlockCache | None = None,
      return_cache: bool = True,
      pending_cache: bool = False,
  ) -> tuple[torch.Tensor, ResidualBlockCache | None]:
    residual = x
    x = self.temporal_pre_norm(x)
    x, cache = self.temporal_block(x, segment_pos, cache, return_cache,
                                   pending_cache)
    if self.fused_epilogue:
      x, residual = self.channel_pre_norm(x, residual=residual)
    else:
      x = x + residual
      residual = x
      x = self.channel_pre_norm(x)
    x = self.mlp_block(x)
    return x + residual, cache


class Embedder(nn.Module):
  """Tied input/output token embedding.

  ``quantized=True`` holds ``input_embedding_q`` (int8 ``[vocab, width]``)
  and ``input_embedding_scale`` (float32 ``[vocab]``), as JAX's
  ``Embedder(quantized=True)`` (``modules.py:885-952``): ``encode`` gathers
  int8 rows and multiplies by their scales in ``dtype``; ``decode``
  contracts against the int8 table through the int8 kernel and applies the
  per-vocabulary scales after the contraction.
  """

  def __init__(self, vocab_size: int, embed_dim: int, scale_by_sqrt_dim: bool,
               device=None, dtype=None, quantized: bool = False):
    super().__init__()
    self.embed_dim = embed_dim
    self.scale_by_sqrt_dim = scale_by_sqrt_dim
    self.quantized = quantized
    # The compute dtype of a quantized table (JAX: ``dtype or bfloat16``).
    self.dtype = dtype or torch.bfloat16
    if quantized:
      self.input_embedding_q = nn.Parameter(
          torch.empty(vocab_size, embed_dim, device=device, dtype=torch.int8),
          requires_grad=False)
      self.input_embedding_scale = nn.Parameter(
          torch.empty(vocab_size, device=device, dtype=torch.float32),
          requires_grad=False)
    else:
      self.input_embedding = nn.Parameter(
          torch.empty(vocab_size, embed_dim, device=device, dtype=dtype)
      )

  def encode(self, x: torch.Tensor) -> torch.Tensor:
    if self.quantized:
      emb = self.input_embedding_q[x].to(self.dtype)
      emb = emb * self.input_embedding_scale[x][..., None].to(self.dtype)
    else:
      emb = self.input_embedding[x]
    if self.scale_by_sqrt_dim:
      # The sqrt is rounded through bfloat16, as the models were trained.
      scale = torch.tensor(math.sqrt(self.embed_dim), dtype=torch.float32)
      emb = emb * scale.to(torch.bfloat16).to(emb.dtype)
    return emb

  def decode(self, x: torch.Tensor) -> torch.Tensor:
    if not self.quantized:
      return x @ self.input_embedding.T
    lead = x.shape[:-1]
    logits = int8_matmul.int8_weight_matmul(
        x.to(self.dtype).reshape(1, -1, self.embed_dim),
        self.input_embedding_q[None], self.input_embedding_scale[None],
    )
    return logits.view(*lead, -1)
