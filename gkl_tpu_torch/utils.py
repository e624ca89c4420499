"""Device probe and host helpers — counterpart of ``gkl_tpu/utils.py``.

The reference probes CPUID for AVX/AVX-512 (``utils/utils.cc:42-113``) and
controls the FPU's flush-to-zero mode (``IntelGKLUtils.java:81-107``); the
port probes for the CUDA card its kernels are built for (Hopper, compute
capability 9.0), and reports the flush-to-zero mode its f32 kernels were
built with.  The JAX package's TPU-only probes (``is_tpu_available``,
``f64_scope``, ``x32_scope``, ``GKL_TPU_F64_ON_DEVICE``) have no
counterpart: the card and the host both run f64 at full range.
"""

from __future__ import annotations

import dataclasses
import os
import re

import torch

HOPPER_CAPABILITY = (9, 0)


@dataclasses.dataclass(frozen=True)
class CudaDevice:
    name: str
    capability: tuple[int, int]
    count: int

    @property
    def is_hopper(self) -> bool:
        return self.capability == HOPPER_CAPABILITY


def cuda_device(index: int = 0) -> CudaDevice | None:
    """The CUDA card at ``index``, or None when PyTorch sees no card."""
    if not torch.cuda.is_available():
        return None
    return CudaDevice(
        name=torch.cuda.get_device_name(index),
        capability=tuple(torch.cuda.get_device_capability(index)),
        count=torch.cuda.device_count(),
    )


def default_backend() -> str:
    """``"cuda"`` when PyTorch sees a card, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def cpu_devices() -> tuple:
    """The host CPU device (the plain twins' and a CPU mesh's device)."""
    return (torch.device("cpu"),)


def supports_native_float64() -> bool:
    """Whether f64 runs at full range where the port computes: true on
    the H100 and on the host alike (the JAX package asks this of a TPU,
    which demotes f64)."""
    return True


def get_flush_to_zero() -> bool:
    """The f32 kernels flush subnormals: they are built with ``-ftz=true``
    (``cuda_build.NVCC_FLAGS``) and their twins flush explicitly, as the
    reference sets FTZ for its float kernel (IntelPairHmm.cc:93-96)."""
    return True


def set_flush_to_zero(value: bool) -> bool:
    """A no-op: the mode is fixed when the kernels are built.  Returns the
    mode in effect."""
    return get_flush_to_zero()


def available_parallelism(device: str | torch.device = "cuda") -> int:
    """Device-level parallelism (the OpenMP thread-count analogue): the
    local devices of ``device``'s type, ``torch.cuda.device_count()`` for
    CUDA and 1 for the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def default_host_threads() -> int:
    """Worker count for the host-side native thread pools (codec, f64
    oracle).  ``GKL_TPU_THREADS`` overrides; otherwise every core, capped
    at 16."""
    env = os.environ.get("GKL_TPU_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return min(16, os.cpu_count() or 1)


def path_to_test_resource(filename: str, base_dir: str | None = None) -> str:
    """Resolve a test-resource path with filename sanitization, as
    ``IntelGKLUtils.pathToTestResource`` (IntelGKLUtils.java:64-79): the
    name must be plain (letters, digits, ``.-_``, not starting with a
    dot or dash), so no separator or traversal gets through.  The default
    directory is the repository's ``tests/data``."""
    if not re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]*", filename):
        raise ValueError(f"unsafe test resource name: {filename!r}")
    if base_dir is None:
        base_dir = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tests", "data")
    return os.path.join(base_dir, filename)
