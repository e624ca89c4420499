"""gkl_tpu_torch — the PyTorch and CUDA port of gkl_tpu.

The active-region kernels of GATK on an NVIDIA Hopper GPU, under the public
names of ``gkl_tpu``: the PairHMM forward likelihood, Smith-Waterman
realignment and the PDHMM forward likelihood, each backed by a hand-written
CUDA kernel (``csrc/*.cu``) with a plain PyTorch twin for CPU tensors, and
Smith-Waterman's CIGAR walk on the card beside its DP; the host f64
rescues, the walk on a mesh and the scalar aligner on the port's
byte-identical copy of the JAX package's native C++ (``native/``); the
DEFLATE codec and BAM
reading and writing (``compression/``, ``bam``); the BAM streaming and
region pipelines; the validation corpus (``validation``); and the
multi-device layer (``parallel``: a ``dp`` mesh of CUDA devices behind
the engines' ``mesh=``, and ``torch.distributed`` across processes).  Module
names mirror ``gkl_tpu``'s.  This package imports neither JAX nor
``gkl_tpu``.
"""

from .api import (
    HaplotypeData,
    PairHMM,
    PairHMMFpga,
    PairHMMNativeArguments,
    PairHMMOMP,
    PendingLikelihoods,
    ReadData,
)
from .api_pdhmm import (
    PDHMM,
    KernelLevel,
    ParallelSetting,
    PDHaplotypeData,
    PDHMMNativeArguments,
)
from .api_sw import OverhangStrategy, SmithWaterman, SWAlignerResult, SWParameters
from .context import MIN_ACCEPTED
from . import parallel

__version__ = "0.1.0"

__all__ = [
    "HaplotypeData",
    "KernelLevel",
    "OverhangStrategy",
    "PDHMM",
    "PDHMMNativeArguments",
    "PDHaplotypeData",
    "PairHMM",
    "PairHMMFpga",
    "PairHMMNativeArguments",
    "PairHMMOMP",
    "PendingLikelihoods",
    "ParallelSetting",
    "ReadData",
    "SWAlignerResult",
    "SWParameters",
    "SmithWaterman",
    "MIN_ACCEPTED",
    "parallel",
    "__version__",
]
