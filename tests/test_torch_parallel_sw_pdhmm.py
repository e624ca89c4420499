"""The port's sharded SW and PDHMM engines (``gkl_tpu_torch.parallel``) on
meshes of 1-8 CPU shards: bit for bit the port's unsharded call, and against
the JAX engine of the same name on as many virtual CPU devices, its Pallas
kernels in interpret mode (``torch_parallel_cases.check_sharded_engine``)."""

import pytest
import torch

from torch_parallel_cases import ENGINES, SHARDS, check_sharded_engine


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("engine", sorted(e for e in ENGINES if not e.startswith("pairhmm")))
def test_sharded_engine(engine, n):
    """The SW and PDHMM engines (kernel, relay or chunked, and plain)."""
    check_sharded_engine(engine, n)
