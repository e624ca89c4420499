"""Multi-process runtime: ``torch.distributed`` set-up and per-process feeding.

Counterpart of ``gkl_tpu/parallel/distributed.py``.  The reference has no
distributed layer (OpenMP shared memory only); here the pair axis shards
over every device of every process, each process feeds only its own lanes
(:func:`host_local_slice`) and runs them on its own devices, and results
that every process needs are gathered once at the end over a gloo group.
Likelihood vectors are tiny next to the inputs, so a host-side gather is
the JAX package's own design; gloo also takes two ranks on one card,
which NCCL refuses.  Nothing here uses NCCL.

Nothing on a machine tells a program of a cluster: :func:`initialize` takes
the coordinator's address, the process count and this process's rank.  In
one process every helper falls back to the local mesh, so the same calling
code runs from one card to several processes.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_mod
from .mesh import Mesh, data_parallel_mesh, process_count, process_index


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group: gloo over TCP at ``coordinator_address``
    (``host:port``).  A no-op for one process (``num_processes`` None or
    at most 1) and when the group already exists."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize needs coordinator_address and process_id "
                         "for more than one process")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=5))


def _default_local_devices() -> tuple:
    if not torch.cuda.is_available():
        raise RuntimeError("global_mesh: no CUDA device is visible; pass local_devices=")
    return tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))


@functools.lru_cache(maxsize=8)
def _global_mesh(local_devices: tuple, n_processes: int) -> Mesh:
    if n_processes == 1:
        return data_parallel_mesh(devices=local_devices)
    per_rank = [None] * n_processes
    dist.all_gather_object(per_rank, list(local_devices))
    me = process_index()
    devices, processes = [], []
    for rank, devs in enumerate(per_rank):
        # another process's device is a placeholder here: only its rank
        # (whose lanes it runs) matters to this process
        devices += [mesh_mod._indexed(d) if rank == me else torch.device(d) for d in devs]
        processes += [rank] * len(devs)
    return Mesh(tuple(devices), tuple(processes))


def global_mesh(local_devices=None) -> Mesh:
    """1-D dp mesh over every process's local devices, in rank order: this
    process's ``local_devices`` (default: every visible CUDA device).  The
    lists are exchanged once over the group (every process calls this at
    the same point), and the mesh is kept for later calls."""
    local = tuple(str(torch.device(d)) for d in (local_devices or _default_local_devices()))
    return _global_mesh(local, process_count())


def host_local_slice(n_total: int) -> slice:
    """The [start, stop) range of a ``n_total``-lane batch this process
    feeds: contiguous blocks in rank order.  ``n_total`` must be a
    multiple of the process count (the API's lane multiple, a multiple of
    the global mesh size, makes it one)."""
    p, i = process_count(), process_index()
    per = (n_total + p - 1) // p
    return slice(i * per, min(n_total, (i + 1) * per))


@dataclasses.dataclass
class GlobalArray:
    """A value laid over a mesh: this process's shards on its entries'
    devices, the value's global shape, and the lane axis the shards cut
    (None: every shard holds the whole value)."""

    shards: tuple[torch.Tensor, ...]
    global_shape: tuple[int, ...]
    axis: int | None

    @property
    def shape(self) -> tuple[int, ...]:
        return self.global_shape

    def local_lanes(self) -> np.ndarray:
        """This process's lanes in order (the whole value when replicated)."""
        if self.axis is None:
            return self.shards[0].cpu().numpy()
        return np.concatenate([s.cpu().numpy() for s in self.shards], axis=self.axis)


def make_global_array(host_shard: np.ndarray, mesh: Mesh, axis: int = -1) -> GlobalArray:
    """Lay this process's block ``host_shard`` over its entries of the mesh:
    cut along ``axis`` into one equal slab per local entry, each on its
    device.  The global shape counts every process's block."""
    host_shard = np.asarray(host_shard)
    axis = axis % host_shard.ndim
    local = mesh.local_entries()
    per = host_shard.shape[axis] // len(local)
    shards = tuple(torch.from_numpy(np.ascontiguousarray(
        np.take(host_shard, range(j * per, (j + 1) * per), axis=axis))).to(dev)
        for j, (_, dev) in enumerate(local))
    shape = list(host_shard.shape)
    shape[axis] *= process_count()
    return GlobalArray(shards, tuple(shape), axis)


def make_replicated_array(value: np.ndarray, mesh: Mesh) -> GlobalArray:
    """``value``, which every process holds alike, whole on each of this
    process's entries (the haplotype planes of an indexed batch: tiny next
    to the read planes)."""
    value = np.asarray(value)
    shards = tuple(torch.from_numpy(np.ascontiguousarray(value)).to(dev)
                   for _, dev in mesh.local_entries())
    return GlobalArray(shards, value.shape, None)


def _local_mesh(mesh: Mesh) -> Mesh:
    """This process's entries of ``mesh`` as a mesh of its own: a
    ``*_global`` entry runs its local block there and gathers nothing."""
    devs = tuple(dev for _, dev in mesh.local_entries())
    return Mesh(devs, (process_index(),) * len(devs))


def pairhmm_raw_global(mesh: Mesh, packed_local, dtype: str = "float32", *,
                       engine: str = "auto") -> np.ndarray:
    """PairHMM forward of this process's lane block ``packed_local`` (a
    dense ``batch.PackedPairs``) on its devices of ``mesh``; returns its
    own (P_local,) raw results.  ``engine="pallas"`` (the JAX package's
    name for its kernel engine) runs the CUDA rows kernel per shard,
    ``"jnp"`` the plain twin; ``"auto"`` takes the kernel for float32 and
    the twin for float64, the only f64 engine."""
    if engine == "auto":
        engine = "pallas" if dtype == "float32" else "jnp"
    if engine == "pallas" and dtype != "float32":
        raise ValueError("engine='pallas' runs the float32 kernel; request "
                         "dtype='float32' or engine='jnp' for float64")
    local = _local_mesh(mesh)
    if engine == "pallas":
        return mesh_mod.pairhmm_raw_pallas_sharded(local, packed_local)
    return mesh_mod.pairhmm_raw_sharded(local, packed_local, dtype=dtype)


def pairhmm_scaled_global(mesh: Mesh, packed_local):
    """Scaled-f32 PairHMM (mantissa, exp2, flag) of this process's lane
    block on its devices; returns its own lanes."""
    return mesh_mod.pairhmm_raw_pallas_scaled_sharded(_local_mesh(mesh), packed_local)


def pdhmm_raw_global(mesh: Mesh, packed_local, hap_pd_local, states_local=None) -> np.ndarray:
    """PDHMM forward of this process's lane block on its devices; returns
    its own raw results."""
    return mesh_mod.pdhmm_raw_pallas_sharded(_local_mesh(mesh), packed_local, hap_pd_local,
                                             states_local)


# the JAX package's chunked entry runs the same CUDA kernel's pass loop
pdhmm_chunked_global = pdhmm_raw_global


def sw_forward_global(mesh: Mesh, ref_local, alt_local, reflen_local, altlen_local, params, *,
                      indel_boundary: bool = False):
    """SW score and backtrack DP of this process's lane block on its
    devices.  Each process fetches only its own backtrack: the O(N*M)
    tensor never crosses processes, and the CIGAR walk runs on local
    lanes.  Returns (bt (P_local, N//2, M), lastrow (M, P_local), lastcol
    (P_local, N))."""
    return mesh_mod.sw_forward_pallas_sharded(_local_mesh(mesh), ref_local, alt_local,
                                              reflen_local, altlen_local, params,
                                              indel_boundary=indel_boundary)


# one launch of the CUDA kernel covers any N: the JAX relay entry is the same
sw_relay_global = sw_forward_global

