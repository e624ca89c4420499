"""Multi-device and multi-process runtime, the counterpart of ``gkl_tpu/parallel/``.

The reference's only multi-worker mechanism is OpenMP shared memory
(``pairhmm/IntelPairHmm.cc:151-153``).  Here batches of pairs shard
data-parallel over a ``dp`` mesh of CUDA devices, a shard per mesh entry
(an entry may repeat a card), and processes join through
``torch.distributed`` (gloo); per-lane results are gathered at the end,
since likelihood vectors are tiny next to the inputs.

Every name of the JAX package's ``parallel`` is here.  Its
sequence-parallel pair, ``mesh.sequence_parallel_mesh`` and
``mesh.pairhmm_raw_sp`` (a prototype that no API reaches: one batch's
haplotype axis split over an ``sp`` mesh), stays out of ``__all__`` as it
does there.
"""

from .distributed import (
    GlobalArray,
    global_mesh,
    host_local_slice,
    initialize,
    make_global_array,
    make_replicated_array,
    pairhmm_raw_global,
    pairhmm_scaled_global,
    pdhmm_chunked_global,
    pdhmm_raw_global,
    sw_forward_global,
    sw_relay_global,
)
from .mesh import (
    Mesh,
    data_parallel_mesh,
    is_multiprocess,
    pairhmm_raw_pallas_cols_relay_sharded,
    pairhmm_raw_pallas_cols_sharded,
    pairhmm_raw_pallas_scaled_sharded,
    pairhmm_raw_pallas_sharded,
    pairhmm_raw_sharded,
    pairhmm_scaled_indexed_sharded,
    pdhmm_raw_pallas_chunked_sharded,
    pdhmm_raw_pallas_sharded,
    pdhmm_raw_sharded,
    replicate_to_host,
    shard_pairs,
    sw_forward_pallas_relay_sharded,
    sw_forward_pallas_sharded,
    sw_forward_sharded,
)

__all__ = [
    "GlobalArray",
    "Mesh",
    "data_parallel_mesh",
    "global_mesh",
    "host_local_slice",
    "initialize",
    "is_multiprocess",
    "make_global_array",
    "make_replicated_array",
    "pairhmm_raw_global",
    "pairhmm_scaled_global",
    "pdhmm_chunked_global",
    "pdhmm_raw_global",
    "replicate_to_host",
    "sw_forward_global",
    "sw_relay_global",
    "pairhmm_raw_pallas_scaled_sharded",
    "pairhmm_scaled_indexed_sharded",
    "pairhmm_raw_pallas_sharded",
    "pairhmm_raw_pallas_cols_relay_sharded",
    "pairhmm_raw_pallas_cols_sharded",
    "pairhmm_raw_sharded",
    "pdhmm_raw_pallas_chunked_sharded",
    "pdhmm_raw_pallas_sharded",
    "pdhmm_raw_sharded",
    "shard_pairs",
    "sw_forward_pallas_relay_sharded",
    "sw_forward_pallas_sharded",
    "sw_forward_sharded",
]
