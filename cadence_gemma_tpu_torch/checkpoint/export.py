"""Serving export: the prefill and one decode step as ``torch.export``
programs, with the weights kept outside.

Counterpart of the JAX package's ``cadence_gemma_tpu/checkpoint/export.py``:
the two serving computations (the single-pass prefill and one decode step)
are traced once by ``torch.export`` over an explicit ``{name: tensor}``
parameter dict, saved as ``.pt2`` files, and loaded and called elsewhere
with no ``Griffin`` built:

  * **no model object**: the loader reads the programs, and the kernels
    they call are the ``torch.library`` operators that importing this module
    registers (:mod:`ops.library`);
  * **no retracing**: tracing happened at export time;
  * **weights outside**: both programs take the parameter dict as an
    argument, so an artifact is graph, not a copy of the checkpoint.
    Exporting reads only shapes and dtypes: ``params`` may be tensors of a
    ``FakeTensorMode``, and real tensors are swapped for fake ones first.

One artifact serves one bucket of fixed shapes (batch, prompt length), as
in JAX. A program runs on the device type it was exported for: its device
constants (RoPE frequencies, masks) are baked in, so export on the card for
the card; the loader refuses inputs of another device type.

Typical flow::

  exp = export_serving(model, params, batch_size=8, prompt_len=128)
  save_serving_export(exp, "/artifacts/2b-it")           # offline
  srv = load_serving_export("/artifacts/2b-it")           # serving host
  logits, cache = srv.prefill(params, tokens, positions)
  logits, cache = srv.decode_step(params, cache, tok, pos)

With ``mesh=`` (JAX's tensor-parallel export) the programs trace the
:class:`~cadence_gemma_tpu_torch.parallel.tensor_parallel.TensorParallelGriffin`
forward over the Megatron pieces: their weights argument is the placed tree
``{name: [piece per model-axis device]}`` that
``sharding.place_state_dict(params, partitioning.griffin_param_shardings(
mesh, params))`` gives, the kernels' operators appear at the shard shapes,
and the tokens, positions and cache stay replicated (the unsharded cache,
on the first model-axis device). The meta records ``num_devices`` and
``mesh_axes``, and the artifact loads only under a mesh of that shape::

  exp = export_serving(model, params, 2, 3000, mesh=mesh)
  srv = load_serving_export("/artifacts/2b-tp2", mesh=mesh)
  placed = sharding.place_state_dict(params, shardings)
  logits, cache = srv.prefill(placed, tokens, positions)

The mesh's devices are the program's: a mesh that repeats one card runs on
that card. A mesh of several distinct cards is refused, as the captured
decode over one is.
"""

from __future__ import annotations

import dataclasses
import io
import json
import pathlib
from typing import Any, Callable, Mapping

import torch
from torch.utils import _pytree as pytree

from cadence_gemma_tpu_torch.models import modules
# The operators the programs call: importing these modules registers them.
from cadence_gemma_tpu_torch.ops import fused_epilogue  # noqa: F401
from cadence_gemma_tpu_torch.ops import int8_matmul  # noqa: F401
from cadence_gemma_tpu_torch.ops import lru_scan  # noqa: F401
from cadence_gemma_tpu_torch.ops import window_attention  # noqa: F401
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel

FORMAT = "cadence_gemma_tpu_torch.serving_export.v1"
_META_NAME = "meta.json"
_PREFILL_NAME = "prefill.pt2"
_DECODE_NAME = "decode_step.pt2"


def _register_cache_pytrees() -> None:
  """Registers the cache NamedTuples for pytree serialization under stable
  names, so a program's output spec deserializes across refactors of the
  module layout (JAX ``_register_cache_pytrees``)."""
  for cls in (modules.RecurrentBlockCache, modules.AttentionBlockCache):
    try:
      pytree._register_namedtuple(  # pylint: disable=protected-access
          cls, serialized_type_name=f"cadence_gemma_tpu_torch.{cls.__name__}")
    except ValueError:
      pass  # already registered


_register_cache_pytrees()


def make_serving_functions(
    model,
) -> tuple[Callable[..., Any], Callable[..., Any]]:
  """Pure (prefill, decode_step) functions over an explicit parameter dict.

  ``prefill(params, tokens, positions) -> (last_logits, cache)`` runs the
  single-pass prefill (``return_cache=True, last_logits_only=True``);
  ``decode_step(params, cache, token, position) -> (logits, cache)``
  advances one token. Both run ``model`` through
  ``torch.func.functional_call`` with ``params`` in place of its own
  tensors, so nothing traced holds a weight.
  """

  def prefill(params, tokens, positions):
    return torch.func.functional_call(
        model, params, (tokens, positions),
        dict(return_cache=True, last_logits_only=True))

  def decode_step(params, cache, token, position):
    return torch.func.functional_call(model, params, (token, position),
                                      dict(cache=cache))

  return prefill, decode_step


@dataclasses.dataclass
class ServingExport:
  """Serialized serving programs (``.pt2`` bytes) + host-facing metadata."""

  prefill: bytes
  decode_step: bytes
  meta: dict


class _Program(torch.nn.Module):
  """The root ``torch.export`` traces: a function, with no submodule and so
  no parameter of its own."""

  def __init__(self, fn: Callable[..., Any]):
    super().__init__()
    self.fn = fn

  def forward(self, *args):
    return self.fn(*args)


def _fake_params(params: Mapping[str, torch.Tensor]):
  """``(fake_mode, {name: fake tensor})``: the mode of fake ``params``, or a
  new mode holding fake copies of real ones (no memory is read)."""
  from torch._subclasses import fake_tensor  # pylint: disable=import-outside-toplevel

  modes = {id(t.fake_mode): t.fake_mode for t in params.values()
           if isinstance(t, fake_tensor.FakeTensor)}
  if len(modes) > 1:
    raise ValueError("`params` mixes tensors of several FakeTensorModes.")
  if modes:
    mode = next(iter(modes.values()))
  else:
    mode = fake_tensor.FakeTensorMode()
  fakes = {name: t if isinstance(t, fake_tensor.FakeTensor)
           else mode.from_tensor(t) for name, t in params.items()}
  return mode, fakes


def _fake_placed(fakes: Mapping[str, torch.Tensor], mesh,
                 model_axis: str) -> dict[str, list[torch.Tensor]]:
  """The placed tree of fake ``params`` (call under their mode): each piece
  a fake tensor of its own, with the shape and strides that
  ``sharding.place_state_dict`` gives it (a view where it stays on the
  leaf's device), on its model-axis device. Distinct tensors, so the traced
  program takes one input a position even where a mesh repeats a device."""
  placed = sharding.place_state_dict(
      fakes, partitioning.griffin_param_shardings(mesh, fakes, model_axis),
      model_axis)
  return {name: [torch.empty_strided(p.shape, p.stride(), dtype=p.dtype,
                                     device=p.device) for p in pieces]
          for name, pieces in placed.items()}


def _export(fn, args) -> torch.export.ExportedProgram:
  """``torch.export`` of ``fn`` on ``args``, lean for serving: the
  training IR's metadata checks beside each ``.to()`` are erased (they
  launch nothing and cost host time at every call; the program's input
  spec checks what comes in), and so are the example inputs, which
  ``torch.export.load`` would unpickle."""
  with torch.no_grad():
    program = torch.export.export(_Program(fn), args, strict=False)
  graph = program.graph
  for node in list(graph.nodes):
    if node.target is torch.ops.aten._assert_tensor_metadata.default:
      graph.erase_node(node)
  program.graph_module.recompile()
  program.example_inputs = None
  return program


def _serialize(program: torch.export.ExportedProgram) -> bytes:
  buffer = io.BytesIO()
  torch.export.save(program, buffer)
  return buffer.getvalue()


def export_serving(
    model,
    params: Mapping[str, torch.Tensor],
    batch_size: int,
    prompt_len: int,
    *,
    cache_dtype: torch.dtype = torch.bfloat16,
    mesh=None,
    model_axis: str = "model",
) -> ServingExport:
  """Exports prefill + decode-step programs for fixed serving shapes.

  Args:
    model: A ``Griffin`` (its own tensors are never read; a model built on
      ``device="meta"`` will do).
    params: ``{name: tensor}`` as ``model.named_parameters()`` names them,
      real or of a ``FakeTensorMode``; only shapes, dtypes and the device
      are read. The programs are exported for that device's type.
    batch_size / prompt_len: The serving bucket to export for (one artifact
      per bucket).
    cache_dtype: KV/conv cache dtype (the RG-LRU state stays float32).
    mesh: A device mesh: the parameters take the Megatron layouts over its
      ``model_axis`` (``partitioning.griffin_param_shardings``) and the
      programs take them placed, ``{name: [piece per model-axis device]}``;
      the data stays replicated. The artifact must be loaded under a mesh of
      the same shape.
    model_axis: The mesh axis of the TP layouts (with ``mesh``).

  Returns:
    A :class:`ServingExport`; persist with :func:`save_serving_export`.
  """
  mode, fakes = _fake_params(params)
  device = next(iter(fakes.values())).device
  sharding.refuse_processes(mesh, "export_serving")
  if mesh is None:
    prefill, decode_step = make_serving_functions(model)
  elif len({str(d) for d in mesh.devices.flat if d.type == "cuda"}) > 1:
    raise NotImplementedError(
        f"export_serving over a mesh of several cards ({mesh}) needs "
        f"{sharding.PROCESS_PER_CARD_ITEM}; export over a mesh that repeats "
        "one card.")
  with mode:
    if mesh is not None:
      fakes = _fake_placed(fakes, mesh, model_axis)
      tp = tensor_parallel.TensorParallelGriffin(
          model.config, fakes, mesh, model_axis,
          **tensor_parallel.model_flags(model))
      prefill, decode_step = _tp_serving_functions(tp)
    ids = lambda length: torch.zeros(  # noqa: E731
        batch_size, length, dtype=torch.int32, device=device)
    cache = pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
        model.init_cache(batch_size, cache_dtype))
    prefill_program = _export(prefill, (fakes, ids(prompt_len),
                                        ids(prompt_len)))
    decode_program = _export(decode_step, (fakes, cache, ids(1), ids(1)))

  config = model.config
  meta = {
      "format": FORMAT,
      "batch_size": batch_size,
      "prompt_len": prompt_len,
      "cache_dtype": str(cache_dtype).removeprefix("torch."),
      "num_devices": 1 if mesh is None else int(mesh.devices.size),
      "mesh_axes": None if mesh is None else dict(mesh.shape),
      "config": {
          "vocab_size": config.vocab_size,
          "width": config.width,
          "num_layers": len(config.block_types),
          "attention_window_size": config.attention_window_size,
          "block_types": [bt.name for bt in config.block_types],
      },
      "torch_version": torch.__version__,
      "device_type": device.type,
  }
  return ServingExport(prefill=_serialize(prefill_program),
                       decode_step=_serialize(decode_program), meta=meta)


def _tp_serving_functions(tp) -> tuple[Callable[..., Any], Callable[..., Any]]:
  """:func:`make_serving_functions` of a tensor-parallel model, over the
  placed tree: the cache goes in and comes out unsharded, on the first
  model-axis device (JAX's replicated cache)."""

  def prefill(placed, tokens, positions):
    logits, cache = torch.func.functional_call(
        tp, tp.bind(placed), (tokens, positions),
        dict(return_cache=True, last_logits_only=True))
    return logits, tp.unshard_cache(cache)

  def decode_step(placed, cache, token, position):
    logits, cache = torch.func.functional_call(
        tp, tp.bind(placed), (token, position),
        dict(cache=tp.shard_cache(cache)))
    return logits, tp.unshard_cache(cache)

  return prefill, decode_step


def save_serving_export(exp: ServingExport, path: str) -> None:
  """Writes the artifact directory (two programs + meta.json)."""
  out = pathlib.Path(path)
  out.mkdir(parents=True, exist_ok=True)
  (out / _PREFILL_NAME).write_bytes(bytes(exp.prefill))
  (out / _DECODE_NAME).write_bytes(bytes(exp.decode_step))
  (out / _META_NAME).write_text(json.dumps(exp.meta, indent=2))


def _param_names(program: torch.export.ExportedProgram) -> list[str]:
  """The keys of the parameter dict, the first argument, in the order the
  program's input spec holds them."""
  spec = program.call_spec.in_spec
  args, _ = pytree.tree_unflatten(list(range(spec.num_leaves)), spec)
  return list(args[0])


class LoadedServing:
  """Deserialized serving programs; call without any model code.

  ``prefill(params, tokens, positions)`` and ``decode_step(params, cache,
  token, position)`` take the exported calling convention (int32 ids and
  positions of the bucket's shapes) under ``torch.no_grad()``; ``params``
  may hold its names in any order (a tensor-parallel artifact's are the
  placed pieces, ``{name: [piece per model-axis device]}``), and inputs on
  another device type than the artifact's are refused. ``mesh`` is the mesh
  a tensor-parallel artifact is loaded under; one of another shape than the
  artifact's is refused.
  """

  def __init__(self, prefill_bytes: bytes, decode_bytes: bytes, meta: dict,
               mesh=None):
    want = meta.get("mesh_axes")
    got = None if mesh is None else dict(mesh.shape)
    if (None if want is None else list(want.items())) != (
        None if got is None else list(got.items())):
      raise ValueError(
          f"This serving export was made for a mesh of shape {want}; it "
          f"cannot be loaded under {got}.")
    self.meta = meta
    self._prefill = torch.export.load(io.BytesIO(bytes(prefill_bytes)))
    self._decode = torch.export.load(io.BytesIO(bytes(decode_bytes)))
    self._names = _param_names(self._prefill)
    self._prefill_fn = self._prefill.module()
    self._decode_fn = self._decode.module()

  def _params(self, params: Mapping[str, Any], data: torch.Tensor):
    if data.device.type != self.meta["device_type"]:
      raise ValueError(
          f"This serving export runs on {self.meta['device_type']!r} "
          f"tensors (the device type it was exported for), got "
          f"{data.device.type!r}.")
    return {name: params[name] for name in self._names}

  def prefill(self, params, tokens, positions):
    with torch.no_grad():
      return self._prefill_fn(self._params(params, tokens), tokens,
                              positions)

  def decode_step(self, params, cache, token, position):
    with torch.no_grad():
      return self._decode_fn(self._params(params, token), cache, token,
                             position)


def load_serving_export(path: str, mesh=None) -> LoadedServing:
  """Loads an artifact directory written by :func:`save_serving_export`;
  refuses one of another format (a JAX artifact among them), and a mesh of
  another shape than the artifact's (``mesh`` is required for a
  tensor-parallel artifact, and refused for another)."""
  src = pathlib.Path(path)
  meta = json.loads((src / _META_NAME).read_text())
  if meta.get("format") != FORMAT:
    raise ValueError(f"not a serving export: {path} ({meta.get('format')})")
  return LoadedServing(
      (src / _PREFILL_NAME).read_bytes(),
      (src / _DECODE_NAME).read_bytes(),
      meta,
      mesh,
  )
