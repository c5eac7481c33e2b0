"""Shared configuration for the PyTorch port.

A copy of the JAX package's ``cadence_gemma_tpu/common.py`` (that module is
framework-free, but importing anything under ``cadence_gemma_tpu`` pulls in
JAX through the package ``__init__``). Same public surface:
``TemporalBlockType``, ``ScanType``, ``Preset``, ``GriffinConfig`` (including
config reconstruction from a flax parameter tree given as nested dicts of
numpy arrays) and ``apply_it_formatter``.

The vision fields stay in the config so checkpoints and fixtures that carry
them build the same config; the text-only model ignores them.
"""

from __future__ import annotations

import enum
import itertools
from typing import Any, Mapping, NamedTuple


@enum.unique
class TemporalBlockType(enum.Enum):
  """Which temporal-mixing sub-block a residual block uses."""

  ATTENTION = enum.auto()
  RECURRENT = enum.auto()


@enum.unique
class ScanType(enum.Enum):
  """Implementation choice for the RG-LRU linear recurrence.

  ``AUTO`` and ``LINEAR_PALLAS`` launch the hand-written CUDA scan on a CUDA
  tensor and take its plain PyTorch version on a CPU tensor
  (``ops/scan.py``). ``LINEAR_NATIVE`` and ``ASSOCIATIVE_NATIVE`` always run
  the plain sequential and log-depth PyTorch scans.
  """

  AUTO = enum.auto()
  LINEAR_NATIVE = enum.auto()
  ASSOCIATIVE_NATIVE = enum.auto()
  LINEAR_PALLAS = enum.auto()


# Geometry of the fused DINOv2-L + SigLIP-so400m vision pathway at 384x384
# with patch size 14: (384 // 14)^2 = 729 patches; 1024 + 1152 = 2176
# features.
DEFAULT_VISION_TOKENS = 729
DEFAULT_VISION_WIDTH = 2176
DEFAULT_VL_EXPANDED_WIDTH = 4000


def _griffin_pattern(num_layers: int) -> tuple[TemporalBlockType, ...]:
  pattern = itertools.cycle([
      TemporalBlockType.RECURRENT,
      TemporalBlockType.RECURRENT,
      TemporalBlockType.ATTENTION,
  ])
  return tuple(itertools.islice(pattern, num_layers))


@enum.unique
class Preset(enum.Enum):
  """Model presets (Griffin / Hawk papers and the RecurrentGemma releases)."""

  GRIFFIN_PAPER_7B = enum.auto()
  HAWK_PAPER_7B = enum.auto()
  RECURRENT_GEMMA_2B_V1 = enum.auto()
  RECURRENT_GEMMA_9B_V1 = enum.auto()

  @property
  def config_dict(self) -> dict[str, Any]:
    if self is Preset.GRIFFIN_PAPER_7B:
      return dict(
          width=4096,
          mlp_expanded_width=3 * 4096,
          num_heads=32,
          lru_width=5632,
          block_types=_griffin_pattern(32),
          embeddings_scale_by_sqrt_dim=False,
          attention_window_size=1024,
          logits_soft_cap=0.0,
          scan_type=ScanType.AUTO,
      )
    if self is Preset.HAWK_PAPER_7B:
      return dict(
          width=4096,
          mlp_expanded_width=3 * 4096,
          num_heads=32,
          lru_width=5632,
          block_types=(TemporalBlockType.RECURRENT,) * 32,
          embeddings_scale_by_sqrt_dim=False,
          attention_window_size=1024,
          logits_soft_cap=0.0,
          scan_type=ScanType.AUTO,
      )
    if self is Preset.RECURRENT_GEMMA_2B_V1:
      return dict(
          width=2560,
          mlp_expanded_width=3 * 2560,
          num_heads=10,
          lru_width=2560,
          block_types=_griffin_pattern(26),
          embeddings_scale_by_sqrt_dim=True,
          attention_window_size=2048,
          logits_soft_cap=30.0,
          scan_type=ScanType.AUTO,
      )
    if self is Preset.RECURRENT_GEMMA_9B_V1:
      return dict(
          width=4096,
          mlp_expanded_width=3 * 4096,
          num_heads=16,
          lru_width=4096,
          block_types=_griffin_pattern(38),
          embeddings_scale_by_sqrt_dim=True,
          attention_window_size=2048,
          logits_soft_cap=30.0,
          scan_type=ScanType.AUTO,
      )
    raise ValueError(f"Unknown preset {self}")


class GriffinConfig(NamedTuple):
  """Griffin model hyper-parameters (https://arxiv.org/abs/2402.19427).

  Attributes:
    vocab_size: Number of tokens in the vocabulary.
    width: Model (embedding / residual-stream) dimensionality.
    mlp_expanded_width: Hidden width of the gated MLP block.
    num_heads: Attention heads, and block count of the RG-LRU block-diagonal
      gate projections. Must divide both ``width`` and ``lru_width``.
    block_types: Per-layer temporal-mixing type, in order.
    embeddings_scale_by_sqrt_dim: Whether token embeddings are scaled by
      ``sqrt(width)`` (cast through bfloat16 to match Gemma training).
    attention_window_size: Local-attention window, and therefore the KV-cache
      length (``max_cache_length``).
    logits_soft_cap: tanh soft cap applied to final logits (0 disables it).
    lru_width: RG-LRU state width if different from ``width``.
    scan_type: RG-LRU scan implementation selector.
    vision_tokens: Number of visual tokens spliced into the sequence.
    vision_width: Feature width of the (fused) vision encoder output.
    vl_expanded_width: Hidden width of the vision-language connector MLP.
  """

  vocab_size: int
  width: int
  mlp_expanded_width: int
  num_heads: int
  block_types: tuple[TemporalBlockType, ...]
  embeddings_scale_by_sqrt_dim: bool
  attention_window_size: int
  logits_soft_cap: float
  lru_width: int | None = None
  scan_type: ScanType = ScanType.AUTO
  vision_tokens: int = DEFAULT_VISION_TOKENS
  vision_width: int = DEFAULT_VISION_WIDTH
  vl_expanded_width: int = DEFAULT_VL_EXPANDED_WIDTH

  @property
  def max_cache_length(self) -> int:
    """Maximum KV-cache length (== the local attention window)."""
    return self.attention_window_size

  @property
  def num_layers(self) -> int:
    return len(self.block_types)

  @classmethod
  def from_preset(
      cls,
      preset: Preset,
      vocab_size: int = 256_000,
      max_sequence_length: int | None = None,
  ) -> "GriffinConfig":
    """Builds the config for a preset, optionally shrinking the window."""
    kwargs = preset.config_dict
    if max_sequence_length is not None:
      kwargs["attention_window_size"] = min(
          kwargs["attention_window_size"], max_sequence_length
      )
    return cls(vocab_size=vocab_size, **kwargs)

  @classmethod
  def _from_parameter_kwargs(
      cls,
      kwargs: dict[str, Any],
      preset: Preset | None = None,
      embeddings_scale_by_sqrt_dim: bool | None = None,
      attention_window_size: int | None = None,
      logits_soft_cap: float | None = None,
      scan_type: ScanType | None = ScanType.AUTO,
      max_sequence_length: int | None = None,
  ) -> "GriffinConfig":
    """Merges shape-inferred kwargs with preset / explicit overrides."""
    if preset is not None:
      defaults = preset.config_dict
      for key, value in kwargs.items():
        if key != "vocab_size" and value != defaults[key]:
          raise ValueError(
              f"Parameters do not match preset {preset}: inferred {key}="
              f"{value} but the preset value is {defaults[key]}."
          )
    else:
      defaults = {}

    overrides = dict(
        embeddings_scale_by_sqrt_dim=embeddings_scale_by_sqrt_dim,
        attention_window_size=attention_window_size,
        logits_soft_cap=logits_soft_cap,
        scan_type=scan_type,
    )
    merged = dict(kwargs)
    for key, value in overrides.items():
      merged[key] = value if value is not None else defaults.get(key)

    if max_sequence_length is not None:
      merged["attention_window_size"] = min(
          merged["attention_window_size"], max_sequence_length
      )
    return cls(**merged)

  @classmethod
  def from_flax_params_or_variables(
      cls,
      flax_params_or_variables: Mapping[str, Any],
      preset: Preset | None = None,
      embeddings_scale_by_sqrt_dim: bool | None = None,
      attention_window_size: int | None = None,
      logits_soft_cap: float | None = None,
      scan_type: ScanType = ScanType.AUTO,
      max_sequence_length: int | None = None,
  ) -> "GriffinConfig":
    """Reconstructs a config by shape inspection of a flax parameter tree.

    The tree is nested dicts of arrays (numpy arrays work; only ``.shape`` is
    read). Layer count and types are read off the ``blocks.{i}`` sub-trees,
    widths off the embedder / MLP / gate parameter shapes. Hypers that shapes
    cannot recover (window, soft cap, embedding scaling) come from ``preset``
    or the explicit keyword overrides.
    """
    params = flax_params_or_variables.get("params", flax_params_or_variables)

    vocab_size, width = params["embedder"]["input_embedding"].shape
    mlp_expanded_width = (
        params["blocks.0"]["mlp_block"]["ffw_up"]["w"].shape[-1]
    )

    lru_width = None
    num_heads = None
    block_types = []
    i = 0
    while f"blocks.{i}" in params:
      block = params[f"blocks.{i}"]
      if "recurrent_block" in block:
        block_types.append(TemporalBlockType.RECURRENT)
        a_gate_w = block["recurrent_block"]["rg_lru"]["a_gate"]["w"]
        num_heads, head_dim = a_gate_w.shape[0], a_gate_w.shape[1]
        lru_width = num_heads * head_dim
      elif "attention_block" in block:
        block_types.append(TemporalBlockType.ATTENTION)
        head_dim = block["attention_block"]["proj_k"]["kernel"].shape[1]
        num_heads = width // head_dim
      else:
        raise ValueError(
            f"Cannot recognize the type of blocks.{i}; keys: "
            f"{list(block.keys())}."
        )
      i += 1

    return cls._from_parameter_kwargs(
        kwargs=dict(
            vocab_size=vocab_size,
            width=width,
            mlp_expanded_width=mlp_expanded_width,
            num_heads=num_heads,
            lru_width=lru_width,
            block_types=tuple(block_types),
        ),
        preset=preset,
        embeddings_scale_by_sqrt_dim=embeddings_scale_by_sqrt_dim,
        attention_window_size=attention_window_size,
        logits_soft_cap=logits_soft_cap,
        scan_type=scan_type,
        max_sequence_length=max_sequence_length,
    )


# Gemma IT chat-template fragments.
IT_USER_OPEN = "<start_of_turn>user\n"
IT_TURN_CLOSE = "<end_of_turn>\n"
IT_MODEL_OPEN = "<start_of_turn>model\n"


def apply_it_formatter(input_string: str) -> str:
  """Wraps a prompt in the Gemma instruction-tuned chat template."""
  return f"{IT_USER_OPEN}{input_string}{IT_TURN_CLOSE}{IT_MODEL_OPEN}"
