"""PyTorch / CUDA port of CadenceGemma-TPU for NVIDIA Hopper (H100).

Text generation and full SFT fine-tuning on the Griffin / RecurrentGemma
backbone. Plain tensor code is PyTorch; the kernels -- the RG-LRU scan and
its cotangent scan, the windowed multi-query flash attention and its dq and
dk/dv backward -- are hand-written CUDA C++ (``csrc/``), built by ``nvcc``
at first use. Entry points run on the card unless the caller passes
``device="cpu"``.

This package imports torch, numpy and the standard library only; the JAX
package ``cadence_gemma_tpu`` is the reference it is tested against.
"""

from cadence_gemma_tpu_torch.common import GriffinConfig
from cadence_gemma_tpu_torch.common import Preset
from cadence_gemma_tpu_torch.common import ScanType
from cadence_gemma_tpu_torch.common import TemporalBlockType
from cadence_gemma_tpu_torch.common import apply_it_formatter
from cadence_gemma_tpu_torch.convert import griffin_from_flax_params
from cadence_gemma_tpu_torch.convert import read_npz_params
from cadence_gemma_tpu_torch.inference.sampler import Sampler
from cadence_gemma_tpu_torch.inference.sampler import SamplerOutput
from cadence_gemma_tpu_torch.models.griffin import Griffin
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab
from cadence_gemma_tpu_torch.tokenizers import Vocabulary

__all__ = [
    "Griffin",
    "GriffinConfig",
    "Preset",
    "Sampler",
    "SamplerOutput",
    "ScanType",
    "SimpleVocab",
    "TemporalBlockType",
    "Vocabulary",
    "apply_it_formatter",
    "griffin_from_flax_params",
    "read_npz_params",
]
