"""PyTorch / CUDA port of CadenceGemma-TPU for NVIDIA Hopper (H100).

Text generation, image-conditioned generation (DINOv2-L || SigLIP-so400m
towers, the vision-language connector), full SFT fine-tuning and the
sequence-parallel long-context prefill (``Griffin(scan_sharding_spec=...)``
over a ``make_mesh`` mesh) on the Griffin / RecurrentGemma backbone. Plain
tensor code is PyTorch; the kernels -- the RG-LRU scan (with the running
product of ``a`` for sequence parallelism) and its cotangent scan, the
windowed multi-query flash attention (with a sequence shard's key halo) and
its dq and dk/dv backward, the towers' bidirectional multi-head attention
and the fused residual add + RMSNorm -- are hand-written CUDA C++
(``csrc/``), built by ``nvcc`` at first use. The scan also takes
complex-valued operands (``complex_lib.Complex`` pairs of real tensors, the
complex kernels of ``csrc/lru_scan_complex.cu``), and
``benchmarks.kernel_lab`` times the scan's two tuning variants. Entry
points run on the card unless the caller passes ``device="cpu"``
(``devices=["cpu"] * n`` for a mesh).

This package imports torch, numpy and the standard library only; the JAX
package ``cadence_gemma_tpu`` is the reference it is tested against.
"""

from cadence_gemma_tpu_torch.common import GriffinConfig
from cadence_gemma_tpu_torch.common import Preset
from cadence_gemma_tpu_torch.common import ScanType
from cadence_gemma_tpu_torch.common import TemporalBlockType
from cadence_gemma_tpu_torch.common import apply_it_formatter
from cadence_gemma_tpu_torch.convert import encoder_from_flax_params
from cadence_gemma_tpu_torch.convert import griffin_from_flax_params
from cadence_gemma_tpu_torch.convert import read_npz_params
from cadence_gemma_tpu_torch.inference.modal_sampler import ModalSampler
from cadence_gemma_tpu_torch.inference.sampler import Sampler
from cadence_gemma_tpu_torch.inference.sampler import SamplerOutput
from cadence_gemma_tpu_torch.models.griffin import Griffin
from cadence_gemma_tpu_torch.models.vit import DINOV2_LARGE_REG4_384
from cadence_gemma_tpu_torch.models.vit import SIGLIP_SO400M_384
from cadence_gemma_tpu_torch.models.vit import DinoSigLIPEncoder
from cadence_gemma_tpu_torch.models.vit import ViTConfig
from cadence_gemma_tpu_torch.parallel.sharding import ShardingSpec
from cadence_gemma_tpu_torch.parallel.sharding import make_mesh
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab
from cadence_gemma_tpu_torch.tokenizers import Vocabulary

__all__ = [
    "DINOV2_LARGE_REG4_384",
    "DinoSigLIPEncoder",
    "Griffin",
    "GriffinConfig",
    "ModalSampler",
    "Preset",
    "SIGLIP_SO400M_384",
    "Sampler",
    "SamplerOutput",
    "ScanType",
    "ShardingSpec",
    "SimpleVocab",
    "TemporalBlockType",
    "ViTConfig",
    "Vocabulary",
    "apply_it_formatter",
    "encoder_from_flax_params",
    "griffin_from_flax_params",
    "make_mesh",
    "read_npz_params",
]
