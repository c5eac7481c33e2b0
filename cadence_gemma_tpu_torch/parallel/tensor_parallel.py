"""Tensor-parallel Griffin: the Megatron-sharded text model over a mesh.

JAX's tensor parallelism is GSPMD: ``Sampler(mesh=)`` places the parameters
by ``partitioning.griffin_param_shardings`` and XLA inserts the collectives.
The port has no GSPMD, so :class:`TensorParallelGriffin` writes the sharded
forward out, single-controller as sequence parallelism is
(``parallel/sharding.py``): one program, each model-axis shard's work on its
mesh device, the collectives behind :func:`sharding.psum` and
:func:`sharding.all_gather` / :func:`sharding.all_gather_features`.

Each shard holds the port's own layers at local widths over its pieces of
the placed parameters. A bf16 piece on the parameters' device is a view
(cuBLAS reads a row-parallel ``[out, in / n]`` slice or the fused
up-projection's ``[2, d, D / n]`` slice in place); an int8 piece is made
contiguous and 16-byte aligned once, at construction, as the int8 kernels'
TMA descriptors need:

  * recurrent block: column ``linear_x`` / ``linear_y``, the local conv and
    RG-LRU scan over the shard's lru features, row ``linear_out``, then a
    ``psum`` and the bias once;
  * attention block: the query heads shard (``head_dim`` stays the model's);
    the single-head ``proj_k`` / ``proj_v`` and the KV ring are replicated
    and run once, on the first device; row ``proj_final``, ``psum``, bias;
  * MLP and the vision-language connector: column up-projection, row
    down-projection, ``psum``, bias;
  * embedder: the vocabulary shards; encode is a masked lookup in each
    shard's range and a ``psum``, decode each shard's slice of the logits
    gathered before the soft cap.

Norms, residuals and the soft cap run on the replicated activation on the
first device of the model axis. Where ``_drop_indivisible`` replicates a
leaf (the 2B's 10 gate heads on a 4-way axis) the shard gathers the
feature-sharded input that leaf contracts and evaluates the heads covering
its own features; a feature space that does not divide at all runs once,
unsharded, on the first device. The decode cache follows
``partitioning.griffin_cache_shardings``: each recurrent block's state and
conv tail are one cache entry a shard (``blocks.{i}.shard{j}``, the shard's
lru features, on its device), the attention ring one replicated entry
(``blocks.{i}``), so the samplers and the batcher handle it as any cache.

:meth:`TensorParallelGriffin.adapter_twin` builds the multi-LoRA twin over
the same pieces: its adapters (one pair, or ``[lora_rows, ...]`` stacks) are
whole tensors on the first device, replicated as JAX replicates the stacks
(``serving.py:459-463``), and each shard reads its slice of them (a column
layer's ``lora_b`` output slice, a row layer's ``lora_a`` input slice, whose
partial sum joins the base's ``psum``). :meth:`TensorParallelGriffin.bind`
maps a placed tree onto the model's parameters, which the serving export
traces over.

:class:`TensorParallelEncoder` runs the vision towers over the ViT rules'
pieces (JAX ``partitioning.py:133-147``): ``attn_qkv`` / ``mlp_fc1``
column-parallel with their bias pieces, ``attn_proj`` / ``mlp_fc2``
row-parallel, a ``psum`` and the bias once. JAX's contiguous split of the
fused ``3d`` qkv axis crosses the q / k / v and head boundaries, so the qkv
pieces are gathered and each shard attends over its own head group, whose
output features are exactly its ``attn_proj`` row piece; where the heads do
not divide into the axis the attention runs once and each shard takes its
slice of the output.

The model trains too (``parallel/data_parallel.py`` builds one a data
position): it recomputes each residual block in the backward as ``Griffin``
does, and records one trained tensor a logical leaf (a split leaf's pieces;
a replicated leaf's copy on the first device, into which the shards' other
views of it sum their gradients), so no element has two sets of moments.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Sequence

import torch
from torch import nn
from torch._subclasses import fake_tensor
from torch.nn import functional as F
from torch.utils import checkpoint as checkpoint_lib

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import griffin as griffin_lib
from cadence_gemma_tpu_torch.models import layers
from cadence_gemma_tpu_torch.models import modules
from cadence_gemma_tpu_torch.models import vit
from cadence_gemma_tpu_torch.ops import int8_matmul
from cadence_gemma_tpu_torch.ops import quantization
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel import sharding

def _broadcast(x: torch.Tensor, devices: Sequence[torch.device]
               ) -> list[torch.Tensor]:
  """The replicated activation on every device (a view where it lives)."""
  return [v[0] for v in sharding.all_gather([x], devices)]


def _global_absmax(parts: Sequence[torch.Tensor],
                   devices: Sequence[torch.device]) -> list[torch.Tensor]:
  """Each row's largest magnitude over every shard of a feature-sharded
  activation, on every shard's device (``act_quant``'s row scale)."""
  local = [quantization.row_absmax(p) for p in parts]
  return [torch.stack(g).amax(0) for g in sharding.all_gather(local, devices)]


def _shapes_only(t: torch.Tensor) -> bool:
  """Whether ``t`` holds no memory (``meta``, or a ``FakeTensorMode``'s)."""
  return t.device.type == "meta" or fake_tensor.is_fake(t)


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
  """``t`` if contiguous and 16-byte aligned, else a copy that is. An int8
  matrix whose depth is off 16 (SigLIP's ``mlp_fc2`` row piece, 4304 / 2)
  is copied into rows padded to 16 (``int8_matmul.padded_rows``), which the
  wgmma forward's tensor map reads in place."""
  if (t.dtype == torch.int8 and t.ndim == 2 and t.shape[-1] % 16
      and not _shapes_only(t)):
    return int8_matmul.padded_rows(t, 16)
  if t.is_contiguous() and (_shapes_only(t) or t.data_ptr() % 16 == 0):
    return t
  return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _is_adapter(name: str) -> bool:
  return name.rsplit(".", 1)[-1] in layers.LORA_LEAF_NAMES


def region(whole: torch.Tensor, piece) -> torch.Tensor:
  """The part of ``whole`` a :class:`Piece` or :class:`Alias` covers."""
  if piece.dim is None:
    return whole
  return whole.narrow(piece.dim, piece.offset, piece.tensor.shape[piece.dim])


def copy_unless_same(dst: torch.Tensor, src: torch.Tensor) -> None:
  """``dst.copy_(src)`` unless the two are views of the same memory."""
  if not (dst.device == src.device and dst.data_ptr() == src.data_ptr()
          and dst.shape == src.shape and dst.stride() == src.stride()):
    dst.copy_(src)


def _mesh_devices(mesh: sharding.Mesh, axis: str) -> list[torch.device]:
  """The devices along ``axis``; a CUDA one without a card raises."""
  devices = sharding.axis_devices(mesh, axis)
  for dev in set(devices):
    griffin_lib.resolve_device(dev)
  return devices


def _leaf(placed: Mapping[str, Any], name: str) -> str:
  """``name`` or its int8 twin ``name_q``, whichever the tree holds."""
  return name if name in placed else name + "_q"


class _Shards(nn.Module):
  """The shard modules of one sharded layer and the devices they run on.

  ``parts`` are the model-axis positions that run: all of them when the
  layer's feature space divides into the axis, else the first alone.
  """

  def __init__(self, devices, split: bool):
    super().__init__()
    self.parts = list(range(len(devices))) if split else [0]
    self.devices = [devices[j] for j in self.parts]
    self.shards = nn.ModuleList()
    self.bias = None

  def reduce(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' partial sums summed on the first device, then the
    row-parallel bias, once."""
    out = sharding.psum(partials, self.devices)[0]
    return out + self.bias.to(out.dtype)

  def row_absmax(self, down: layers.Dense, inputs):
    """The whole rows' absmax for a row-parallel ``act_quant`` product."""
    if not getattr(down, "act_quant", False) or len(self.parts) == 1:
      return [None] * len(inputs)
    return _global_absmax(inputs, self.devices)


class Piece(NamedTuple):
  """One trained tensor of a logical leaf: the whole leaf (``dim`` None)
  or its slice from ``offset`` along ``dim``."""

  tensor: torch.Tensor
  dim: int | None
  offset: int


class Alias(NamedTuple):
  """A shard's view of a replicated leaf (``Piece``'s region of the leaf
  ``name``), whose gradient is summed into the leaf's one trained tensor."""

  tensor: torch.Tensor
  name: str
  dim: int | None
  offset: int


class _Loader:
  """Fills meta-built shard modules with pieces of the placed parameters,
  and records which tensor trains each logical leaf.

  A leaf the placement splits trains as its pieces, one a shard. A
  replicated leaf trains once, as one tensor over its first device's copy
  (``owners``); a shard that holds a slice of it, or the whole of it on
  another shard, holds an :class:`Alias`. int8 twins (``_q``, ``_scale``)
  are frozen contiguous copies, shared through ``kernel_copies`` by the
  models built over the same tensors.
  """

  def __init__(self, placed: Mapping[str, Sequence[torch.Tensor]],
               full_shapes: Mapping[str, tuple],
               kernel_copies: dict | None = None):
    self.placed = placed
    self.full_shapes = full_shapes
    self.kernel_copies = {} if kernel_copies is None else kernel_copies
    self.owners: dict[str, nn.Parameter] = {}
    self.leaves: dict[str, list[Piece]] = {}
    self.aliases: list[Alias] = []
    # id(parameter) -> (leaf, shard, dim, offset, length, kernel copy).
    self.sources: dict[int, tuple] = {}

  def piece(self, name: str, j: int, shape, start: int | None = None
            ) -> tuple[torch.Tensor, int | None, int]:
    """Shard ``j``'s piece of ``name`` at the local ``shape``: the placed
    piece, or a view of the local slice of a replicated leaf (the ``j``-th
    slice of that size, or the one from row ``start`` of dimension 0), with
    the dimension and offset of that slice (``None``: the placed piece)."""
    t = self.placed[name][j]
    shape = tuple(shape)
    if tuple(t.shape) == shape:
      return t, None, 0
    dims = [d for d, (a, b) in enumerate(zip(t.shape, shape)) if a != b]
    if len(dims) != 1 or len(t.shape) != len(shape):
      raise ValueError(f"{name}: a {tuple(t.shape)} piece for a {shape} "
                       "shard.")
    d = dims[0]
    offset = j * shape[d] if start is None else start
    return t.narrow(d, offset, shape[d]), d, offset

  def _kernel_ready(self, t: torch.Tensor) -> torch.Tensor:
    """:func:`_kernel_ready` of ``t``, one copy a region of memory."""
    if _shapes_only(t):
      return _kernel_ready(t)
    key = (t.device, t.dtype, t.data_ptr(), tuple(t.shape), t.stride())
    if key not in self.kernel_copies:
      self.kernel_copies[key] = _kernel_ready(t)
    return self.kernel_copies[key]

  def _split_dim(self, name: str, j: int) -> int:
    """The dimension along which the placement split ``name``."""
    placed = tuple(self.placed[name][j].shape)
    return next(d for d, (a, b) in enumerate(zip(placed,
                                                 self.full_shapes[name]))
                if a != b)

  def owner(self, name: str) -> nn.Parameter:
    """The one trained tensor of the replicated leaf ``name``."""
    if name not in self.owners:
      self.owners[name] = nn.Parameter(self.placed[name][0],
                                       requires_grad=False)
      self.leaves[name] = [Piece(self.owners[name], None, 0)]
      self.sources[id(self.owners[name])] = (name, 0, None, 0, 0, False)
    return self.owners[name]

  def fill(self, module: nn.Module, prefix: str, j: int,
           starts: Mapping[str, int] | None = None) -> None:
    """Sets every parameter of ``module`` (built on ``meta`` at shard
    ``j``'s widths) to its piece of ``{prefix}.{name}``; ``starts`` gives
    the first row of a submodule's slice of a replicated leaf."""
    starts = starts or {}
    for name, p in list(module.named_parameters()):
      path, _, leaf = name.rpartition(".")
      owner = module.get_submodule(path)
      full = f"{prefix}.{name}"
      t, dim, offset = self.piece(full, j, p.shape, starts.get(path))
      kernel = leaf.endswith(("_q", "_scale"))
      if kernel:
        param = nn.Parameter(self._kernel_ready(t), requires_grad=False)
      elif tuple(self.placed[full][j].shape) != self.full_shapes[full]:
        if dim is not None:
          raise ValueError(f"{full}: shard {j} takes a slice of its piece.")
        param = nn.Parameter(t, requires_grad=False)
        split = self._split_dim(full, j)
        self.leaves.setdefault(full, []).append(
            Piece(param, split, j * t.shape[split]))
      elif dim is None and j == 0:
        param = self.owner(full)
      else:
        self.owner(full)
        param = nn.Parameter(t, requires_grad=False)
        self.aliases.append(Alias(param, full, dim, offset))
      if id(param) not in self.sources:
        self.sources[id(param)] = (full, j, dim, offset,
                                   0 if dim is None else t.shape[dim], kernel)
      owner._parameters[leaf] = param  # pylint: disable=protected-access

  def replicated(self, name: str) -> nn.Parameter:
    return self.owner(name)


class _TPEmbedder(nn.Module):
  """The vocabulary-sharded embedder."""

  def __init__(self, config, loader, devices, kw):
    super().__init__()
    vocab = config.vocab_size
    name = _leaf(loader.placed, "embedder.input_embedding")
    split = loader.placed[name][0].shape[0] < vocab
    self.s = _Shards(devices, split)
    self.local = vocab // len(self.s.parts)
    self.dtype = kw["dtype"] or torch.bfloat16
    for j in self.s.parts:
      emb = modules.Embedder(self.local, config.width,
                             config.embeddings_scale_by_sqrt_dim,
                             device="meta", dtype=kw["dtype"],
                             quantized=kw["quantized"])
      loader.fill(emb, "embedder", j)
      self.s.shards.append(emb)

  def encode(self, tokens: torch.Tensor) -> torch.Tensor:
    if len(self.s.parts) == 1:
      return self.s.shards[0].encode(tokens)
    embs = []
    for k, t in enumerate(_broadcast(tokens, self.s.devices)):
      local = t - k * self.local
      inside = (local >= 0) & (local < self.local)
      emb = self.s.shards[k].encode(local.clamp(0, self.local - 1))
      embs.append(emb * inside[..., None].to(emb.dtype))
    return sharding.psum(embs, self.s.devices)[0]

  def decode(self, x: torch.Tensor) -> torch.Tensor:
    logits = [shard.decode(h) for shard, h in
              zip(self.s.shards, _broadcast(x, self.s.devices))]
    return sharding.all_gather_features(logits, self.s.devices[:1])[0]


class _TPRecurrent(nn.Module):
  """Column ``linear_x`` / ``linear_y``, the local conv and scan, row
  ``linear_out``."""

  def __init__(self, config, loader, devices, prefix, kw):
    super().__init__()
    lru = config.lru_width or config.width
    heads = config.num_heads
    block = lru // heads
    placed = loader.placed
    split = placed[_leaf(placed, f"{prefix}.linear_x.kernel")][0].shape[0] < lru
    self.s = _Shards(devices, split)
    self.local = lru // len(self.s.parts)
    gate = _leaf(placed, f"{prefix}.rg_lru.input_gate.w")
    self.gates_split = split and placed[gate][0].shape[0] < heads
    # Per shard: the gate heads covering its features, and its offset into
    # their outputs.
    self.cover, self.offset = [], []
    for k, j in enumerate(self.s.parts):
      lo, hi = k * self.local, (k + 1) * self.local
      h0, h1 = lo // block, -(-hi // block)
      self.cover.append((h0 * block, h1 * block))
      self.offset.append(lo - h0 * block)
      rb = modules.RecurrentBlock(
          config.width, 1, self.local, scan_type=config.scan_type,
          device="meta", **kw)
      for gate_name in ("input_gate", "a_gate"):
        setattr(rb.rg_lru, gate_name, layers.BlockDiagonalLinear(
            (h1 - h0) * block, h1 - h0, device="meta", dtype=kw["dtype"],
            quantized=kw["quantized"]))
      rb.linear_out.bias = None
      starts = {} if self.gates_split else {
          "rg_lru.input_gate": h0, "rg_lru.a_gate": h0}
      loader.fill(rb, f"{prefix}", j, starts=starts)
      self.s.shards.append(rb)
    self.s.bias = loader.replicated(f"{prefix}.linear_out.bias")

  def forward(self, hs, segs, caches, return_cache, pending_cache):
    ys, xs, convs = [], [], []
    for k, j in enumerate(self.s.parts):
      rb, cache = self.s.shards[k], caches[k]
      ys.append(layers.gelu(rb.linear_y(hs[j])))
      x, conv = rb.conv_1d(rb.linear_x(hs[j]), segs[j],
                           None if cache is None else cache.conv1d_state,
                           return_cache, pending_cache)
      xs.append(x)
      convs.append(conv)
    if self.gates_split:
      gate_inputs = xs
    else:
      gathered = sharding.all_gather_features(xs, self.s.devices)
      gate_inputs = [g[..., c0:c1] for g, (c0, c1) in zip(gathered,
                                                          self.cover)]
    outs, new_caches = [], []
    for k, j in enumerate(self.s.parts):
      rb, cache = self.s.shards[k], caches[k]
      lru = rb.rg_lru
      gates = (lru.input_gate(gate_inputs[k]), lru.a_gate(gate_inputs[k]))
      if not self.gates_split:
        o = self.offset[k]
        gates = tuple(g[..., o:o + self.local] for g in gates)
      x, state = lru(xs[k], segs[j],
                     None if cache is None else cache.rg_lru_state,
                     return_cache, pending_cache, gates=gates)
      outs.append(x * ys[k])
      new_caches.append(modules.RecurrentBlockCache(state, convs[k])
                        if return_cache else None)
    absmax = self.s.row_absmax(self.s.shards[0].linear_out, outs)
    partials = [rb.linear_out(z, act_absmax=m)
                for rb, z, m in zip(self.s.shards, outs, absmax)]
    return self.s.reduce(partials), new_caches


class _TPAttention(nn.Module):
  """Sharded query heads, the single KV head once, row ``proj_final``."""

  def __init__(self, config, loader, devices, prefix, kw, use_flash):
    super().__init__()
    head_dim = config.width // config.num_heads
    q_width = config.num_heads * head_dim
    placed = loader.placed
    split = (placed[_leaf(placed, f"{prefix}.proj_q.kernel")][0].shape[0]
             < q_width)
    self.s = _Shards(devices, split)
    self.head_dim = head_dim
    self.local = q_width // len(self.s.parts)
    self.whole_heads = self.local % head_dim == 0
    self.cover, self.offset = [], []
    for k, j in enumerate(self.s.parts):
      lo, hi = k * self.local, (k + 1) * self.local
      h0, h1 = lo // head_dim, -(-hi // head_dim)
      self.cover.append((h0 * head_dim, h1 * head_dim))
      self.offset.append(lo - h0 * head_dim)
      att = modules.LocalAttentionBlock(
          config.width, 1, config.attention_window_size, use_flash,
          device="meta", head_dim=head_dim, **kw)
      dense = dict(device="meta", dtype=kw["dtype"],
                   quantized=kw["quantized"], act_quant=kw["act_quant"],
                   lora_rank=kw["lora_rank"], lora_alpha=kw["lora_alpha"],
                   lora_rows=kw["lora_rows"])
      att.proj_q = layers.Dense(config.width, self.local, use_bias=False,
                                **dense)
      att.proj_final = layers.Dense(self.local, config.width, use_bias=False,
                                    **dense)
      if k:  # the single KV head runs once, on the first device
        att.proj_k = att.proj_v = None
      loader.fill(att, prefix, j)
      self.s.shards.append(att)
    self.s.bias = loader.replicated(f"{prefix}.proj_final.bias")

  def forward(self, hs, segs, cache, return_cache, pending_cache):
    first = self.s.shards[0]
    keys, values = first.project_kv(hs[0], segs[0])
    new_cache = first.next_cache(keys, values, segs[0], cache, return_cache,
                                 pending_cache)
    qs = [att.proj_q(hs[j]) for att, j in zip(self.s.shards, self.s.parts)]
    if not self.whole_heads:
      gathered = sharding.all_gather_features(qs, self.s.devices)
      qs = [g[..., c0:c1] for g, (c0, c1) in zip(gathered, self.cover)]
    kvs = sharding.all_gather([(keys, values)], self.s.devices)
    caches = (None if cache is None
              else sharding.all_gather([cache], self.s.devices))
    encoded = []
    for k, j in enumerate(self.s.parts):
      att = self.s.shards[k]
      q = modules.apply_rope(qs[k].unflatten(-1, (-1, self.head_dim)),
                             segs[j])
      (k_j, v_j), = kvs[k]
      enc = att.attend(q, k_j, v_j, segs[j],
                       None if caches is None else caches[k][0]).flatten(-2)
      if not self.whole_heads:
        enc = enc[..., self.offset[k]:self.offset[k] + self.local]
      encoded.append(enc)
    absmax = self.s.row_absmax(first.proj_final, encoded)
    partials = [att.proj_final(z, act_absmax=m)
                for att, z, m in zip(self.s.shards, encoded, absmax)]
    return self.s.reduce(partials), new_cache


class _TPProjection(nn.Module):
  """A column up-projection and a row down-projection: the MLP block's
  gated GeLU, or the vision-language connector's GeLU."""

  def __init__(self, loader, devices, prefix, expanded: int, make,
               gated: bool):
    super().__init__()
    placed = loader.placed
    down = _leaf(placed, f"{prefix}.ffw_down.kernel")
    split = placed[down][0].shape[-1] < expanded
    self.s = _Shards(devices, split)
    self.gated = gated
    for j in self.s.parts:
      module = make(expanded // len(self.s.parts))
      module.ffw_down.bias = None
      loader.fill(module, prefix, j)
      self.s.shards.append(module)
    self.s.bias = loader.replicated(f"{prefix}.ffw_down.bias")

  def forward(self, xs) -> torch.Tensor:
    zs = []
    for module, j in zip(self.s.shards, self.s.parts):
      up = module.ffw_up(xs[j])
      zs.append(layers.gelu(up[0]) * up[1] if self.gated
                else layers.gelu(up[0]))
    absmax = self.s.row_absmax(self.s.shards[0].ffw_down, zs)
    return self.s.reduce([m.ffw_down(z, act_absmax=a)
                          for m, z, a in zip(self.s.shards, zs, absmax)])


class _TPResidualBlock(nn.Module):
  """``ResidualBlock.forward`` over the sharded temporal block and MLP."""

  def __init__(self, config, loader, devices, i, block_type, kw, use_flash,
               fused_epilogue):
    super().__init__()
    prefix = f"blocks.{i}"
    self.index = i
    self.devices = devices
    self.fused_epilogue = fused_epilogue
    self.recurrent = block_type is common.TemporalBlockType.RECURRENT
    norm = dict(device="meta", dtype=kw["dtype"])
    self.temporal_pre_norm = layers.RMSNorm(config.width, **norm)
    self.channel_pre_norm = layers.RMSNorm(config.width, **norm)
    for name in ("temporal_pre_norm", "channel_pre_norm"):
      getattr(self, name).scale = loader.replicated(f"{prefix}.{name}.scale")
    if self.recurrent:
      self.temporal = _TPRecurrent(config, loader, devices,
                                   f"{prefix}.recurrent_block", kw)
    else:
      self.temporal = _TPAttention(config, loader, devices,
                                   f"{prefix}.attention_block", kw, use_flash)
    self.mlp = _TPProjection(
        loader, devices, f"{prefix}.mlp_block", config.mlp_expanded_width,
        lambda d: modules.MLPBlock(config.width, d, device="meta", **kw),
        gated=True)

  def cache_names(self) -> list[str]:
    if self.recurrent:
      return [f"blocks.{self.index}.shard{j}" for j in self.temporal.s.parts]
    return [f"blocks.{self.index}"]

  def forward(self, x, segs, cache, return_cache, pending_cache):
    names = self.cache_names()
    residual = x
    hs = _broadcast(self.temporal_pre_norm(x), self.devices)
    if self.recurrent:
      olds = [None if cache is None else cache[n] for n in names]
      x, news = self.temporal(hs, segs, olds, return_cache, pending_cache)
    else:
      x, new = self.temporal(hs, segs, None if cache is None
                             else cache[names[0]], return_cache,
                             pending_cache)
      news = [new]
    if self.fused_epilogue:
      x, residual = self.channel_pre_norm(x, residual=residual)
    else:
      x = x + residual
      residual = x
      x = self.channel_pre_norm(x)
    x = self.mlp(_broadcast(x, self.devices))
    return x + residual, dict(zip(names, news))


class TensorParallelGriffin(nn.Module):
  """The Griffin forward with its weights split over a mesh's model axis.

  Args:
    config: The model's hyper-parameters.
    params: The placed state dict, ``{name: [piece per model-axis
      device]}``: :func:`sharding.place_state_dict` of a Griffin state dict
      by :func:`partitioning.griffin_param_shardings`, or
      ``checkpoint.io.load_parameters(sharding=<that tree>)``.
    mesh: The mesh; its ``model_axis`` devices hold the shards (a device may
      repeat). Every device must exist: a CUDA mesh without a card raises.
    model_axis: The mesh axis the weights split over.
    dtype, use_flash_attention, fused_epilogue, quantized, act_quant,
      lora_rank, lora_alpha, lora_rows, gradient_checkpointing: As
      :class:`~griffin.Griffin`'s; stacked (``lora_rows``) adapters are
      placed replicated.
    kernel_copies: A dict that the models built over the same tensors share,
      so they share their contiguous int8 pieces too.

  :func:`tensor_parallel` builds one from a ``Griffin``. ``forward`` has
  ``Griffin.forward``'s signature and returns the replicated logits (or
  hidden states) and the cache on the first model-axis device.

  Training: every piece is an ``nn.Parameter`` that requires no gradient
  until a trainer turns it on. ``leaves`` maps each logical leaf to the
  tensors that train it (:class:`Piece`: a split leaf's pieces, or one
  tensor for a replicated leaf, on the first device); ``aliases`` are the
  shards' other views of replicated leaves, whose gradients
  :meth:`sum_replicated_grads` adds into those tensors. The collectives'
  gradients are autograd's: a ``psum``'s is a broadcast, a gather's a slice,
  and a replicated activation's is summed over the shards that read it.
  """

  def __init__(self, config: common.GriffinConfig,
               params: Mapping[str, Sequence[torch.Tensor]],
               mesh: sharding.Mesh,
               model_axis: str = partitioning.MODEL_AXIS,
               dtype: torch.dtype = torch.bfloat16,
               use_flash_attention: bool | None = None,
               fused_epilogue: bool = False, quantized: bool = False,
               act_quant: bool = False, lora_rank: int = 0,
               lora_alpha: float | None = None, lora_rows: int = 0,
               gradient_checkpointing: bool = True,
               kernel_copies: dict | None = None):
    super().__init__()
    devices = _mesh_devices(mesh, model_axis)
    self.config = config
    self.mesh = mesh
    self.model_axis = model_axis
    self.devices = devices
    self.device = devices[0]
    self.quantized = quantized
    self.act_quant = act_quant
    self.lora_rank = lora_rank
    self.lora_rows = lora_rows
    self.gradient_checkpointing = gradient_checkpointing
    # What adapter_twin builds another model over.
    self._flags = dict(dtype=dtype, use_flash_attention=use_flash_attention,
                       fused_epilogue=fused_epilogue, quantized=quantized,
                       act_quant=act_quant, lora_rank=lora_rank,
                       lora_alpha=lora_alpha,
                       gradient_checkpointing=gradient_checkpointing)
    kw = dict(dtype=dtype, quantized=quantized, act_quant=act_quant,
              lora_rank=lora_rank, lora_alpha=lora_alpha, lora_rows=lora_rows)
    full_shapes = {
        name: tuple(t.shape) for name, t in griffin_lib.Griffin(
            config, device="meta", dtype=dtype, quantized=quantized,
            lora_rank=lora_rank, lora_alpha=lora_alpha,
            lora_rows=lora_rows).state_dict().items()}
    self._placed = params
    self._full_shapes = full_shapes
    loader = _Loader(params, full_shapes, kernel_copies)
    self._kernel_copies = loader.kernel_copies
    self.embedder = _TPEmbedder(config, loader, devices, kw)
    self.blocks = nn.ModuleList([
        _TPResidualBlock(config, loader, devices, i, block_type, kw,
                         use_flash_attention, fused_epilogue)
        for i, block_type in enumerate(config.block_types)])
    self.final_norm = layers.RMSNorm(config.width, device="meta", dtype=dtype)
    self.final_norm.scale = loader.replicated("final_norm.scale")
    self.vl_connector = _TPProjection(
        loader, devices, "vl_connector", config.vl_expanded_width,
        lambda d: modules.VisionLanguageConnector(
            config.width, d, config.vision_width, device="meta", **kw),
        gated=False)
    self.leaves = {name: loader.leaves[name] for name in full_shapes
                   if name in loader.leaves}
    self.aliases = loader.aliases
    self._sources = {name: loader.sources[id(p)] for name, p in
                     self.named_parameters(remove_duplicate=False)}

  def bind(self, placed: Mapping[str, Sequence[torch.Tensor]]
           ) -> dict[str, torch.Tensor]:
    """This model's parameters, by their names here, taken from ``placed``
    (a tree of the layout it was built over): the pieces, the slices of
    replicated leaves, contiguous int8 pieces. ``torch.func.functional_call``
    of the model over them is the forward over ``placed``, which the
    tensor-parallel serving export traces."""
    out = {}
    for name, (leaf, j, dim, offset, length, kernel) in self._sources.items():
      t = placed[leaf][j]
      if dim is not None:
        t = t.narrow(dim, offset, length)
      out[name] = t.contiguous() if kernel else t
    return out

  def adapter_twin(self, lora_rows: int = 0) -> "TensorParallelGriffin":
    """``Griffin.adapter_twin`` over the mesh: a model over this one's base
    pieces (the same tensors, nothing copied) with adapters of its own,
    zeros, stacked ``[lora_rows, ...]`` when ``lora_rows > 0``. Each adapter
    is one whole tensor on the first device (:meth:`adapter_leaves`), and
    each shard reads its slice of it; after writing them, call
    :meth:`refresh_adapters`."""
    if not self.lora_rank or self.lora_rows:
      raise ValueError("adapter_twin needs a lora_rank > 0 model with one "
                       "adapter pair a layer (lora_rows=0).")
    rows = (lora_rows,) if lora_rows else ()
    params = dict(self._placed)
    for name, shape in self._full_shapes.items():
      if _is_adapter(name):
        stack = torch.zeros(*rows, *shape, dtype=params[name][0].dtype,
                            device=self.device)
        params[name] = [stack.to(dev) for dev in self.devices]
    return TensorParallelGriffin(self.config, params, self.mesh,
                                 self.model_axis, lora_rows=lora_rows,
                                 kernel_copies=self._kernel_copies,
                                 **self._flags)

  def adapter_leaves(self) -> dict[str, torch.Tensor]:
    """The adapters as whole leaves by name, on the first device: a twin's
    own tensors (write them in place, then :meth:`refresh_adapters`); a
    split leaf's pieces joined into a copy, which a write does not reach
    the shards through."""
    out = {}
    for name, pieces in self.leaves.items():
      if _is_adapter(name):
        out[name] = (pieces[0].tensor.detach() if pieces[0].dim is None
                     else torch.cat([p.tensor.detach().to(self.device)
                                     for p in pieces], dim=pieces[0].dim))
    return out

  @torch.no_grad()
  def refresh_adapters(self) -> None:
    """Copies the adapters into the shards' copies of them on other devices
    (on a mesh that repeats one device every shard reads a view, and
    nothing is copied)."""
    for alias in self.aliases:
      if _is_adapter(alias.name):
        copy_unless_same(alias.tensor, region(
            self.leaves[alias.name][0].tensor, alias))

  def train_tensors(self) -> list[torch.Tensor]:
    """Every tensor that may hold a gradient: the trained pieces and the
    aliases."""
    return ([p.tensor for pieces in self.leaves.values() for p in pieces]
            + [a.tensor for a in self.aliases])

  @torch.no_grad()
  def sum_replicated_grads(self) -> None:
    """Adds each alias's gradient into its leaf's trained tensor (through
    :func:`sharding.psum` onto that tensor's device), once; the aliases'
    gradients are cleared."""
    by_leaf: dict[str, list[torch.Tensor]] = {}
    for alias in self.aliases:
      g = alias.tensor.grad
      if g is None:
        continue
      alias.tensor.grad = None
      owner = self.leaves[alias.name][0].tensor
      if alias.dim is not None:  # a slice: its place in the whole leaf
        whole = g.new_zeros(owner.shape)
        whole.narrow(alias.dim, alias.offset, g.shape[alias.dim]).copy_(g)
        g = whole
      by_leaf.setdefault(alias.name, []).append(g)
    for name, grads in by_leaf.items():
      owner = self.leaves[name][0].tensor
      owner.grad = sharding.psum([owner.grad, *grads], [owner.device])[0]

  def act_quant_view(self) -> "TensorParallelGriffin":
    """This quantized model with int8 activations too, over the same
    pieces (``Griffin.act_quant_view``)."""
    if not self.quantized:
      raise ValueError("act_quant_view requires a quantized=True model.")
    view = griffin_lib._share_parameters(self)  # pylint: disable=protected-access
    for module in view.modules():
      if getattr(module, "quantized", False) and hasattr(module, "act_quant"):
        module.act_quant = True
    return view

  def forward(self, tokens: torch.Tensor, segment_pos: torch.Tensor,
              cache: dict | None = None, return_logits: bool = True,
              return_cache: bool = True, last_logits_only: bool = False,
              return_hidden: bool = False, image: torch.Tensor | None = None,
              pending_cache: bool = False):
    """``Griffin.forward`` (``griffin.py:270-283``), sharded."""
    if not return_logits and not return_cache:
      return None, None
    if pending_cache and cache is None:
      raise ValueError("pending_cache needs a cache (decode mode).")
    x = self.embedder.encode(tokens)
    if image is not None:
      if image.shape[-1] != self.config.vision_width:
        raise ValueError(
            f"image feature width {image.shape[-1]} != config.vision_width "
            f"{self.config.vision_width}; check the vision encoder pairing.")
      visual = self.vl_connector(_broadcast(image.to(x.dtype), self.devices))
      x, segment_pos = griffin_lib.splice_visual(x, segment_pos, visual)
    segs = _broadcast(segment_pos, self.devices)
    remat = self.gradient_checkpointing and torch.is_grad_enabled()
    new_cache = {}
    for block in self.blocks:
      args = (x, segs, cache, return_cache, pending_cache)
      if remat:  # ``Griffin.forward``'s recompute of each block
        x, entries = checkpoint_lib.checkpoint(block, *args,
                                               use_reentrant=False)
      else:
        x, entries = block(*args)
      new_cache.update(entries)
    if not return_logits:
      return None, new_cache
    if last_logits_only:
      x = x[:, -1:]
    x = self.final_norm(x)
    if return_hidden:
      return x, (new_cache if return_cache else None)
    return self.decode_hidden(x), (new_cache if return_cache else None)

  decode_hidden = griffin_lib.Griffin.decode_hidden

  def shard_cache(self, cache: Mapping[str, Any]) -> dict[str, Any]:
    """An unsharded ``Griffin`` cache placed by
    ``partitioning.griffin_cache_shardings``: a recurrent block's entry split
    into one entry a shard, the attention ring kept once, on the first
    device."""
    shardings = partitioning.griffin_cache_shardings(self.mesh, cache,
                                                     self.model_axis)
    out = {}
    for block in self.blocks:
      name = f"blocks.{block.index}"
      entry, placement = cache[name], shardings[name]
      pieces = [sharding.place(leaf, s, self.model_axis)
                for leaf, s in zip(entry, placement)]
      # A replicated entry keeps one copy, on the first device; so does a
      # recurrent block whose features do not divide (its shard 0 runs).
      for j, cache_name in zip(block.temporal.s.parts, block.cache_names()):
        out[cache_name] = type(entry)(*(p[j] for p in pieces))
    return out

  def unshard_cache(self, cache: Mapping[str, Any]) -> dict[str, Any]:
    """The ``Griffin`` cache a :meth:`shard_cache` layout holds, on the
    first device (the shards' features concatenated)."""
    out = {}
    for block in self.blocks:
      names = block.cache_names()
      if not block.recurrent:
        out[names[0]] = cache[names[0]]
        continue
      entries = [cache[n] for n in names]
      out[f"blocks.{block.index}"] = type(entries[0])(*(
          torch.cat([leaf.to(self.device) for leaf in leaves], dim=-1)
          for leaves in zip(*entries)))
    return out

  def init_cache(self, batch_size: int, dtype: torch.dtype | None = None
                 ) -> dict[str, Any]:
    """Empty caches, placed as :meth:`shard_cache` places them."""
    return self.shard_cache(
        griffin_lib.Griffin.init_cache(self, batch_size, dtype))


def check_shardable(model: griffin_lib.Griffin) -> None:
  """Raises for a model whose features tensor parallelism does not run."""
  if model.scan_sharding_spec is not None:
    raise NotImplementedError(
        "Tensor parallelism over a sequence-parallel model (scan_sharding_"
        f"spec) is not ported ({sharding.PROCESS_PER_CARD_ITEM}).")


def model_flags(model: griffin_lib.Griffin) -> dict[str, Any]:
  """The :class:`TensorParallelGriffin` arguments that carry ``model``'s
  flags over."""
  attention = [b.attention_block for b in model.blocks
               if b.temporal_block_type is common.TemporalBlockType.ATTENTION]
  return dict(
      dtype=model.final_norm.scale.dtype,
      use_flash_attention=(attention[0].use_flash_attention if attention
                           else None),
      fused_epilogue=model.blocks[0].fused_epilogue if model.blocks else False,
      quantized=model.quantized, act_quant=model.act_quant,
      lora_rank=model.lora_rank, lora_alpha=model.lora_alpha,
      lora_rows=model.lora_rows,
      gradient_checkpointing=model.gradient_checkpointing)


def tensor_parallel(model: griffin_lib.Griffin, mesh: sharding.Mesh,
                    model_axis: str = partitioning.MODEL_AXIS
                    ) -> TensorParallelGriffin:
  """``model``'s weights placed by ``griffin_param_shardings`` over
  ``mesh``'s ``model_axis`` (JAX's ``Sampler(mesh=)`` placement; stacked
  ``lora_rows`` adapters replicated, as JAX's batcher places them), and the
  sharded model over them. The model's flags carry over."""
  sharding.refuse_processes(mesh, "Tensor parallelism")
  check_shardable(model)
  _mesh_devices(mesh, model_axis)
  state = model.state_dict()
  shardings = partitioning.griffin_param_shardings(mesh, state, model_axis)
  if model.lora_rows:
    for name in shardings:
      if _is_adapter(name):
        shardings[name] = sharding.NamedSharding(mesh, sharding.PartitionSpec())
  placed = sharding.place_state_dict(state, shardings, model_axis)
  return TensorParallelGriffin(model.config, placed, mesh, model_axis,
                               **model_flags(model))


# -- the vision towers ---------------------------------------------------------


def _column(loader, devices, prefix: str, fan_in: int, fan_out: int,
            dense: dict) -> _Shards:
  """A column-parallel ``Dense``: each shard's output columns and bias
  piece (the whole layer on the first device where they do not divide)."""
  kernel = loader.placed[_leaf(loader.placed, f"{prefix}.kernel")][0]
  s = _Shards(devices, kernel.shape[0] < fan_out)
  for j in s.parts:
    layer = layers.Dense(fan_in, fan_out // len(s.parts), **dense)
    loader.fill(layer, prefix, j)
    s.shards.append(layer)
  return s


def _row(loader, devices, prefix: str, fan_in: int, fan_out: int,
         dense: dict) -> _Shards:
  """A row-parallel ``Dense``: each shard's input columns, the bias once
  after the ``psum``."""
  kernel = loader.placed[_leaf(loader.placed, f"{prefix}.kernel")][0]
  s = _Shards(devices, kernel.shape[-1] < fan_in)
  for j in s.parts:
    layer = layers.Dense(fan_in // len(s.parts), fan_out, use_bias=False,
                         **dense)
    loader.fill(layer, prefix, j)
    s.shards.append(layer)
  s.bias = loader.replicated(f"{prefix}.bias")
  return s


def _row_forward(s: _Shards, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
  absmax = s.row_absmax(s.shards[0], inputs)
  return s.reduce([layer(z, act_absmax=m)
                   for layer, z, m in zip(s.shards, inputs, absmax)])


class _TPViTBlock(nn.Module):
  """``vit.ViTBlock.forward`` over column ``attn_qkv`` / ``mlp_fc1`` and
  row ``attn_proj`` / ``mlp_fc2`` pieces; the norms, the layer scales and
  the residual run on the replicated activation on the first device."""

  def __init__(self, config: vit.ViTConfig, loader, devices, prefix: str,
               kw: dict):
    super().__init__()
    d, hidden = config.embed_dim, config.mlp_hidden_dim
    self.config = config
    self.use_flash_attention = kw["use_flash_attention"]
    self.softmax_bf16 = kw["softmax_bf16"]
    for name in ("norm1", "norm2"):
      norm = vit.LayerNorm(d, device="meta")
      norm.scale = loader.replicated(f"{prefix}.{name}.scale")
      norm.bias = loader.replicated(f"{prefix}.{name}.bias")
      setattr(self, name, norm)
    if config.use_layer_scale:
      self.ls1 = loader.replicated(f"{prefix}.ls1")
      self.ls2 = loader.replicated(f"{prefix}.ls2")
    dense = dict(device="meta", dtype=kw["param_dtype"],
                 quantized=kw["quantized"], act_quant=kw["act_quant"])
    self.attn_qkv = _column(loader, devices, f"{prefix}.attn_qkv", d, 3 * d,
                            dense)
    self.attn_proj = _row(loader, devices, f"{prefix}.attn_proj", d, d, dense)
    self.mlp_fc1 = _column(loader, devices, f"{prefix}.mlp_fc1", d, hidden,
                           dense)
    self.mlp_fc2 = _row(loader, devices, f"{prefix}.mlp_fc2", hidden, d,
                        dense)
    # Each attn_proj shard's input features are whole heads: it attends
    # over its own head group.
    self.head_groups = config.num_heads % len(self.attn_proj.parts) == 0

  _layer_scale = vit.ViTBlock._layer_scale  # pylint: disable=protected-access

  def _attention(self, x, key_bias) -> list[torch.Tensor]:
    """The attention's output features as ``attn_proj``'s shards take
    them."""
    cfg = self.config
    d = cfg.embed_dim
    head_dim = d // cfg.num_heads
    qkv_s, proj = self.attn_qkv, self.attn_proj
    parts = [layer(h) for layer, h in
             zip(qkv_s.shards, _broadcast(self.norm1(x), qkv_s.devices))]
    qkvs = sharding.all_gather_features(parts, proj.devices)
    local = d // len(proj.parts)
    attend = lambda q, k, v: vit.attend(  # noqa: E731
        q, k, v, None if key_bias is None else key_bias.to(q.device),
        self.use_flash_attention, self.softmax_bf16)
    if not self.head_groups:
      q, k, v = (z.unflatten(-1, (cfg.num_heads, head_dim))
                 for z in qkvs[0].split(d, dim=-1))
      whole = attend(q, k, v).flatten(-2)
      return [w[..., j * local:(j + 1) * local]
              for j, w in enumerate(_broadcast(whole, proj.devices))]
    outs = []
    for j, qkv in enumerate(qkvs):
      # Views of the gathered qkv: the kernel reads them in place.
      q, k, v = (qkv[..., i * d + j * local:i * d + (j + 1) * local]
                 .unflatten(-1, (-1, head_dim)) for i in range(3))
      outs.append(attend(q, k, v).flatten(-2))
    return outs

  def forward(self, x: torch.Tensor,
              key_bias: torch.Tensor | None = None) -> torch.Tensor:
    cfg = self.config
    out = _row_forward(self.attn_proj, self._attention(x, key_bias))
    x = x + self._layer_scale("ls1", out)
    fc1 = self.mlp_fc1
    hs = [F.gelu(layer(h), approximate="tanh" if cfg.gelu_approximate
                 else "none")
          for layer, h in zip(fc1.shards, _broadcast(self.norm2(x),
                                                     fc1.devices))]
    # fc1's output and fc2's input are one dimension: they split alike.
    out = _row_forward(self.mlp_fc2, hs)
    return x + self._layer_scale("ls2", out)


class _TPTower(nn.Module):
  """``vit.VisionTransformer`` over sharded blocks; the patch embedding,
  the position embedding and the prefix tokens replicate."""

  def __init__(self, config: vit.ViTConfig, loader, devices, prefix: str,
               kw: dict, dtype: torch.dtype, pad_tokens_to: int):
    super().__init__()
    self.config = config
    self.dtype = dtype
    self.use_flash_attention = kw["use_flash_attention"]
    self.pad_tokens_to = pad_tokens_to
    self.patch_embed = vit.PatchEmbed(config.patch_size, config.embed_dim,
                                      device="meta")
    loader.fill(self.patch_embed, f"{prefix}.patch_embed", 0)
    self.pos_embed = loader.replicated(f"{prefix}.pos_embed")
    if config.num_prefix_tokens:
      self.prefix_tokens = loader.replicated(f"{prefix}.prefix_tokens")
    self.blocks = []
    for i in range(config.last_block + 1):
      block = _TPViTBlock(config, loader, devices, f"{prefix}.block{i}", kw)
      self.add_module(f"block{i}", block)
      self.blocks.append(block)

  embed = vit.VisionTransformer.embed
  forward = vit.VisionTransformer.forward


class TensorParallelEncoder(nn.Module):
  """The ``DinoSigLIPEncoder`` forward with its towers split over a mesh's
  model axis (JAX's ``ModalSampler(mesh=)`` placement of the towers).

  Args:
    params: The placed state dict, ``{name: [piece per model-axis
      device]}``: :func:`sharding.place_state_dict` of an encoder's state
      dict by :func:`partitioning.param_shardings_or_replicated`.
    mesh: The mesh; its ``model_axis`` devices hold the shards (a device may
      repeat). A mesh without that axis replicates every leaf, and the
      towers run on its first device.
    model_axis: The mesh axis the weights split over.
    dino_config, siglip_config, dtype, param_dtype, use_flash_attention,
      pad_tokens_to, quantized, act_quant, softmax_bf16: As
      :class:`vit.DinoSigLIPEncoder`'s.
    kernel_copies: As :class:`TensorParallelGriffin`'s.

  :func:`tensor_parallel_encoder` builds one from an encoder. Pixels come
  in, and features go out, on the first model-axis device. float32 and
  bf16 pieces on the parameters' device are views; int8 pieces are
  contiguous copies, as the LM's are.
  """

  def __init__(self, params: Mapping[str, Sequence[torch.Tensor]],
               mesh: sharding.Mesh,
               model_axis: str = partitioning.MODEL_AXIS,
               dino_config: vit.ViTConfig = vit.DINOV2_LARGE_REG4_384,
               siglip_config: vit.ViTConfig = vit.SIGLIP_SO400M_384,
               dtype: torch.dtype = torch.bfloat16,
               param_dtype: torch.dtype = torch.float32,
               use_flash_attention: bool | None = None,
               pad_tokens_to: int = 128, quantized: bool = False,
               act_quant: bool = False, softmax_bf16: bool = False,
               kernel_copies: dict | None = None):
    super().__init__()
    if model_axis in mesh.axis_names:
      devices = _mesh_devices(mesh, model_axis)
    else:
      devices = [griffin_lib.resolve_device(mesh.devices.flat[0])]
    self.dino_config = dino_config
    self.siglip_config = siglip_config
    full_shapes = {name: tuple(t.shape) for name, t in vit.DinoSigLIPEncoder(
        dino_config, siglip_config, device="meta", param_dtype=param_dtype,
        quantized=quantized, act_quant=act_quant).state_dict().items()}
    loader = _Loader(params, full_shapes, kernel_copies)
    kw = dict(param_dtype=param_dtype, use_flash_attention=use_flash_attention,
              softmax_bf16=softmax_bf16, quantized=quantized,
              act_quant=act_quant)
    self.dino = _TPTower(dino_config, loader, devices, "dino", kw, dtype,
                         pad_tokens_to)
    self.siglip = _TPTower(siglip_config, loader, devices, "siglip", kw,
                           dtype, pad_tokens_to)

  feature_width = vit.DinoSigLIPEncoder.feature_width
  device = vit.DinoSigLIPEncoder.device
  forward = vit.DinoSigLIPEncoder.forward
  preprocess_path = vit.DinoSigLIPEncoder.preprocess_path


def tensor_parallel_encoder(encoder: vit.DinoSigLIPEncoder,
                            mesh: sharding.Mesh,
                            model_axis: str = partitioning.MODEL_AXIS
                            ) -> TensorParallelEncoder:
  """``encoder``'s weights placed by
  ``partitioning.param_shardings_or_replicated`` over ``mesh`` (JAX
  ``modal_sampler.py:67-85``), and the sharded towers over them; the
  encoder's flags carry over."""
  sharding.refuse_processes(mesh, "Tensor parallelism of the towers")
  state = encoder.state_dict()
  if model_axis in mesh.axis_names:
    _mesh_devices(mesh, model_axis)
    placed = sharding.place_state_dict(
        state, partitioning.param_shardings_or_replicated(mesh, state,
                                                          model_axis),
        model_axis)
  else:
    first = griffin_lib.resolve_device(mesh.devices.flat[0])
    placed = {name: [t.to(first)] for name, t in state.items()}
  tower, block = encoder.dino, encoder.dino.blocks[0]
  return TensorParallelEncoder(
      placed, mesh, model_axis, encoder.dino_config, encoder.siglip_config,
      dtype=tower.dtype, param_dtype=tower.pos_embed.dtype,
      use_flash_attention=tower.use_flash_attention,
      pad_tokens_to=tower.pad_tokens_to, quantized=encoder.quantized,
      act_quant=block.attn_qkv.act_quant, softmax_bf16=block.softmax_bf16)
