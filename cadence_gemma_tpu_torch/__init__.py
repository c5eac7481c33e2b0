"""PyTorch / CUDA port of CadenceGemma-TPU for NVIDIA Hopper (H100).

Text generation (chunked prefill, prefix caching and conversational state,
per-row sampling, the decode loop captured as a CUDA graph), speculative
decoding from prompt-lookup drafts (``SpeculativeSampler``, and
``ContinuousBatcher(draft_len=...)``, each verify step one captured CUDA
graph), grammar-constrained decoding (``TokenDFA``, ``json_mode_dfa``,
``schema_dfa``: ``constraint=`` on every sampler, grammar registries in the
batcher, JSON mode, JSON schemas and forced tool calls over HTTP),
image-conditioned generation (DINOv2-L || SigLIP-so400m towers, the
vision-language connector), fine-tuning (full SFT, image SFT and the
two-stage recipe of ``two_stage_sft``, LoRA adapters over a bf16 or an int8
base: ``Griffin(lora_rank=...)``, ``lora``) and the
sequence-parallel long-context prefill (``Griffin(scan_sharding_spec=...)``
over a ``make_mesh`` mesh) and tensor-parallel serving (``Sampler(mesh=...)``
and ``ModalSampler(mesh=...)`` with JAX's Megatron layouts, ``partitioning``,
through the batcher, multi-LoRA, speculation and the export) and pipeline
parallelism (``parallel.pipeline.GriffinPipeline``: GPipe, interleaved,
PP x DP, over ``parallel.multihost`` meshes) on the
Griffin / RecurrentGemma backbone. Plain
tensor code is PyTorch; the kernels -- the RG-LRU scan (with the running
product of ``a`` for sequence parallelism) and its cotangent scan, the
windowed multi-query flash attention (with a sequence shard's key halo) and
its dq and dk/dv backward, the towers' bidirectional multi-head attention,
the fused residual add + RMSNorm and the weight-only int8 product of int8
serving (``Griffin(quantized=True)``, ``quantize_params``,
``prefill_act_quant``) and its input gradient (QLoRA) -- are hand-written
CUDA C++ (``csrc/``), built by
``nvcc`` at first use. The scan also takes
complex-valued operands (``complex_lib.Complex`` pairs of real tensors, the
complex kernels of ``csrc/lru_scan_complex.cu``), and
``benchmarks.kernel_lab`` times the scan's two tuning variants. The text
path's kernels launch through ``torch.library`` operators
(``ops/library.py``: CUDA, CPU and fake implementations), so
``export_serving`` / ``save_serving_export`` / ``load_serving_export``
(``checkpoint/export.py``) export the prefill and one decode step with
``torch.export`` and run them elsewhere with the weights kept outside.
Entry points run on the card unless the caller passes ``device="cpu"``
(``devices=["cpu"] * n`` for a mesh).

This package imports torch, numpy and the standard library only; the JAX
package ``cadence_gemma_tpu`` is the reference it is tested against.
"""

from cadence_gemma_tpu_torch.common import GriffinConfig
from cadence_gemma_tpu_torch.common import Preset
from cadence_gemma_tpu_torch.common import ScanType
from cadence_gemma_tpu_torch.common import TemporalBlockType
from cadence_gemma_tpu_torch.checkpoint.export import export_serving
from cadence_gemma_tpu_torch.checkpoint.export import load_serving_export
from cadence_gemma_tpu_torch.checkpoint.export import save_serving_export
from cadence_gemma_tpu_torch.common import apply_it_formatter
from cadence_gemma_tpu_torch.convert import encoder_from_flax_params
from cadence_gemma_tpu_torch.convert import griffin_from_flax_params
from cadence_gemma_tpu_torch.convert import read_npz_params
from cadence_gemma_tpu_torch.inference.constrain import TokenDFA
from cadence_gemma_tpu_torch.inference.constrain import choice_regex
from cadence_gemma_tpu_torch.inference.constrain import json_mode_dfa
from cadence_gemma_tpu_torch.inference.constrain import json_regex
from cadence_gemma_tpu_torch.inference.constrain import schema_dfa
from cadence_gemma_tpu_torch.inference.constrain import schema_regex
from cadence_gemma_tpu_torch.inference.constrain import token_strings_from_vocab
from cadence_gemma_tpu_torch.inference.constrain import tool_call_schema
from cadence_gemma_tpu_torch.inference.modal_sampler import ModalSampler
from cadence_gemma_tpu_torch.inference.sampler import PrefixState
from cadence_gemma_tpu_torch.inference.sampler import Sampler
from cadence_gemma_tpu_torch.inference.sampler import SamplerOutput
from cadence_gemma_tpu_torch.inference.server import ServingFrontend
from cadence_gemma_tpu_torch.inference.server import ServingHTTPServer
from cadence_gemma_tpu_torch.inference.serving import ContinuousBatcher
from cadence_gemma_tpu_torch.inference.speculative import SpeculativeSampler
from cadence_gemma_tpu_torch.models.griffin import Griffin
from cadence_gemma_tpu_torch.models.vit import DINOV2_LARGE_REG4_384
from cadence_gemma_tpu_torch.models.vit import SIGLIP_SO400M_384
from cadence_gemma_tpu_torch.models.vit import DinoSigLIPEncoder
from cadence_gemma_tpu_torch.models.vit import ViTConfig
from cadence_gemma_tpu_torch.ops.quantization import quantize_params
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel.sharding import ShardingSpec
from cadence_gemma_tpu_torch.parallel.sharding import make_mesh
from cadence_gemma_tpu_torch.parallel.tensor_parallel import TensorParallelGriffin
from cadence_gemma_tpu_torch.parallel.tensor_parallel import tensor_parallel
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab
from cadence_gemma_tpu_torch.tokenizers import Vocabulary
from cadence_gemma_tpu_torch.tokenizers import load_sentencepiece
from cadence_gemma_tpu_torch.training import lora
from cadence_gemma_tpu_torch.training.train_loop import TrainingConfig
from cadence_gemma_tpu_torch.training.train_loop import train_loop
from cadence_gemma_tpu_torch.training.train_loop import two_stage_sft

__all__ = [
    "ContinuousBatcher",
    "DINOV2_LARGE_REG4_384",
    "DinoSigLIPEncoder",
    "Griffin",
    "GriffinConfig",
    "ModalSampler",
    "PrefixState",
    "Preset",
    "SIGLIP_SO400M_384",
    "Sampler",
    "SamplerOutput",
    "ScanType",
    "ServingFrontend",
    "ServingHTTPServer",
    "ShardingSpec",
    "SimpleVocab",
    "SpeculativeSampler",
    "TemporalBlockType",
    "TokenDFA",
    "TrainingConfig",
    "ViTConfig",
    "Vocabulary",
    "apply_it_formatter",
    "choice_regex",
    "encoder_from_flax_params",
    "export_serving",
    "griffin_from_flax_params",
    "json_mode_dfa",
    "json_regex",
    "load_sentencepiece",
    "load_serving_export",
    "lora",
    "make_mesh",
    "quantize_params",
    "read_npz_params",
    "save_serving_export",
    "schema_dfa",
    "schema_regex",
    "token_strings_from_vocab",
    "tool_call_schema",
    "train_loop",
    "two_stage_sft",
]
