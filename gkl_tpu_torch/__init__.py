"""gkl_tpu_torch — the PyTorch and CUDA port of gkl_tpu.

The PairHMM forward likelihood on an NVIDIA Hopper GPU: the public names of
``gkl_tpu``'s PairHMM surface, backed by a hand-written CUDA kernel
(``csrc/pairhmm_scaled.cu``) with a plain PyTorch twin for CPU tensors, the
host f64 rescue on the JAX package's native oracle (compiled by path), and
the BAM streaming pipeline.  Module names mirror ``gkl_tpu``'s.  This
package imports neither JAX nor ``gkl_tpu``.
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
from .context import MIN_ACCEPTED

__version__ = "0.1.0"

__all__ = [
    "HaplotypeData",
    "PairHMM",
    "PairHMMFpga",
    "PairHMMNativeArguments",
    "PairHMMOMP",
    "PendingLikelihoods",
    "ReadData",
    "MIN_ACCEPTED",
    "__version__",
]
