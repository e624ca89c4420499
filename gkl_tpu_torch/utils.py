"""Device probe and host helpers — counterpart of ``gkl_tpu/utils.py``.

The reference probes CPUID for AVX/AVX-512 (``utils/utils.cc:42-113``); the
port probes for the CUDA card its kernels are built for (Hopper, compute
capability 9.0).
"""

from __future__ import annotations

import dataclasses
import os

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
