"""Device mesh construction and data-parallel sharding of pair batches.

Counterpart of ``gkl_tpu/parallel/mesh.py``, with its two axes:

* ``dp``: data parallel over the pair (lane) axis, the reference's OpenMP
  ``parallel for`` over independent pairs (IntelPairHmm.cc:151-153,
  pdhmm.h:1218-1248);
* ``sp``: sequence parallel over the haplotype axis of one batch
  (:func:`sequence_parallel_mesh`, :func:`pairhmm_raw_sp`), the JAX
  package's prototype for haplotypes too long for one device.

Every DP kernel is lane-local, so a sharded engine cuts the lanes into
``mesh.size`` contiguous slabs and runs the same CUDA kernel on each slab,
on the slab's device, with no collective: the counterpart of the JAX
package's ``shard_map`` over ``dp`` (:func:`launch_lanes`).  A mesh entry
may repeat a device, so two shards can share one card.  On a mesh that
spans processes every process packs the same full batch, feeds only the
slabs of its own entries, and the (small) results are gathered over the
``torch.distributed`` group (gloo) so that each process holds them all.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import context as ctx_mod
from ..ops import pairhmm as pairhmm_ops
from ..ops import pairhmm_cols, pairhmm_cuda, pdhmm_cuda, sw_cuda
from ..ops import pdhmm as pdhmm_ops
from ..ops import sw as sw_ops

_DENSE_FIELDS = ("hap", "read", "q", "iq", "dq", "gcp", "haplen", "rslen")

# When a list, every CUDA shard launch appends (kernel name, shard index,
# device, start event, stop event): the events bracket the kernel call on
# the shard's stream.  None (the default) records nothing.
TRACE: list | None = None


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The group's size, 1 without a group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` becomes ``cuda:<current>``, so
    that each card's tables are built once (the kernels cache them by
    device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh (axis ``dp`` or ``sp``): entry ``k`` runs shard ``k`` on
    ``devices[k]`` in the process of rank ``processes[k]``.  Entries may
    repeat a device.
    torch's ``DeviceMesh`` needs one rank per device, so it cannot describe
    one process that drives several cards; this type can."""

    devices: tuple[torch.device, ...]
    processes: tuple[int, ...]
    axis_names: tuple[str, ...] = ("dp",)

    def __post_init__(self):
        if not self.devices or len(self.devices) != len(self.processes):
            raise ValueError("a mesh needs one process per entry, and an entry")
        if list(self.processes) != sorted(self.processes):
            # a process's lanes must be one contiguous block, in rank order
            raise ValueError("a process's entries must be contiguous, in rank order")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    def local_entries(self) -> list[tuple[int, torch.device]]:
        """(shard index, device) of the entries this process runs."""
        me = process_index()
        return [(k, d) for k, (d, p) in enumerate(zip(self.devices, self.processes)) if p == me]


def engine_mesh(mesh: Mesh | None, device) -> Mesh:
    """The mesh an engine runs its batches on: its ``mesh``, or without one
    a one-entry ``dp`` mesh of its ``device`` in this process, made when
    the engine first dispatches (so an engine on a card needs no card
    until it runs)."""
    if mesh is not None:
        return mesh
    return _one_entry_mesh(_indexed(device), process_index())


@functools.lru_cache(maxsize=None)
def _one_entry_mesh(device: torch.device, rank: int) -> Mesh:
    return Mesh((device,), (rank,))


def _local_mesh(axis: str, n_devices: int | None, devices) -> Mesh:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{axis} mesh: no CUDA device is visible; "
                               "pass devices= for a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = tuple(_indexed(d) for d in devices)
    return Mesh(devices, (process_index(),) * len(devices), (axis,))


def data_parallel_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D ``dp`` mesh over every visible CUDA device (the first
    ``n_devices`` of them), or over ``devices``, one shard per entry: an
    entry may repeat (``["cuda:0"] * 2`` puts two shards on one card,
    ``["cpu"] * 8`` runs the plain twins in eight shards).  Without a CUDA
    device and without ``devices`` it raises: it never builds a CPU mesh
    on its own."""
    return _local_mesh("dp", n_devices, devices)


def sequence_parallel_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D ``sp`` mesh: the haplotype axis of one batch split over its
    entries (:func:`pairhmm_raw_sp`).  The devices as for
    :func:`data_parallel_mesh`: every visible card, the first
    ``n_devices`` of them, or ``devices`` (entries may repeat a card);
    without a card and without ``devices`` it raises."""
    return _local_mesh("sp", n_devices, devices)


def is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh holds entries of other processes: each process
    then feeds only its own slabs, and results are gathered over the
    process group."""
    me = process_index()
    return any(p != me for p in mesh.processes)


def lane_slices(n_lanes: int, size: int) -> list[slice]:
    """The ``size`` contiguous, equal lane slabs of ``n_lanes`` lanes (the
    API's lane multiple, ``8 * mesh.size``, makes them even)."""
    if n_lanes % size:
        raise ValueError(f"{n_lanes} lanes do not split evenly over {size} shards")
    per = n_lanes // size
    return [slice(k * per, (k + 1) * per) for k in range(size)]


def _all_gather_lanes(local: np.ndarray) -> np.ndarray:
    """Every process's lane-major block, concatenated in rank order, over
    the gloo group (blocks may differ in length)."""
    n = torch.tensor([local.shape[0]], dtype=torch.int64)
    counts = [torch.zeros_like(n) for _ in range(process_count())]
    dist.all_gather(counts, n)
    counts = [int(c) for c in counts]
    buf = torch.zeros((max(counts),) + local.shape[1:], dtype=torch.from_numpy(local[:0]).dtype)
    buf[:local.shape[0]] = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(buf) for _ in counts]
    dist.all_gather(parts, buf)
    return np.concatenate([p[:c].numpy() for p, c in zip(parts, counts)])


def replicate_to_host(local, mesh: Mesh, axis: int = -1) -> np.ndarray:
    """The full value of a dp-sharded result on every process: this
    process's lanes ``local`` (a host array with its lanes along ``axis``,
    or a ``distributed.GlobalArray``) gathered with every other process's
    over the gloo group.  Likelihood vectors are tiny next to the inputs,
    so the gather at the end is cheap (``gkl_tpu/parallel/__init__.py``).
    On a one-process mesh it returns ``local`` as it is."""
    if hasattr(local, "local_lanes"):
        local, axis = local.local_lanes(), local.axis
    local = np.asarray(local)
    if axis is None or not is_multiprocess(mesh):
        return local
    return np.moveaxis(_all_gather_lanes(np.moveaxis(local, axis, 0)), 0, axis)


@functools.lru_cache(maxsize=None)
def _shard_stream(device: torch.device, shard: int) -> torch.cuda.Stream:
    """The stream of shard ``shard`` on ``device``: its own, so that two
    shards on one card overlap and no shard's copy waits on another's."""
    return torch.cuda.Stream(device=device)


class Launch:
    """A dispatched batch: each output in one host buffer, lane-major,
    written by every shard's copy (pinned memory for CUDA shards), with
    one CUDA event per shard marking its copy's end.  ``wait()`` waits for
    them all and returns the outputs with their lane axes restored, with
    ``gather`` every process's lanes (over the process group)."""

    def __init__(self, outs, out_axes, events=(), keep=(), gather: bool = False):
        self.outs = outs
        self.out_axes = out_axes
        self.events = list(events)
        self.keep = keep
        self.gather = gather

    def wait(self):
        for ev in self.events:
            ev.synchronize()
        self.keep = ()
        res = []
        for out, axis in zip(self.outs, self.out_axes):
            host = out.numpy()
            if self.gather:
                host = _all_gather_lanes(host)
            res.append(np.moveaxis(host, 0, axis))
        return res[0] if len(res) == 1 else tuple(res)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def launch_lanes(mesh: Mesh, n_lanes: int, inputs, kernel, *, out_axes=(-1,),
                 **kernel_kw) -> Launch:
    """Run ``kernel`` on each of this process's lane slabs, without waiting.

    ``inputs(k, sl)`` gives shard ``k``'s host arrays for the lanes ``sl``
    of the ``n_lanes``, keyed as ``kernel``'s arguments;
    ``kernel(**tensors, **kernel_kw)`` returns one tensor or a tuple, whose
    lane axis is ``out_axes[i]``.  A CUDA shard runs under
    ``torch.cuda.device(dev)`` (the ctypes launchers take a stream but no
    device, and launch on the current one) on a stream of its own: its
    planes go up by non-blocking copies from the host arrays as they are
    (CUDA stages pageable memory before the copy returns, and
    pinning each plane first cost more host time than it saved), its
    outputs come down into its rows of the pinned host buffers, and an
    event on its stream marks their arrival.  A CPU shard runs at once.
    On a multi-process mesh the returned handle gathers every process's
    lanes when waited on."""
    cuts = lane_slices(n_lanes, mesh.size)
    local = mesh.local_entries()
    if not local:
        raise ValueError("this process owns no entry of the mesh")
    # this process's lanes: one contiguous block, since its entries are
    mine = slice(cuts[local[0][0]].start, cuts[local[-1][0]].stop)
    pin = any(dev.type == "cuda" for _, dev in local)
    name = getattr(kernel, "__name__", "kernel")
    host, events, keep = None, [], []
    for k, dev in local:
        sl = cuts[k]
        arrays = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in inputs(k, sl).items()}
        rows = slice(sl.start - mine.start, sl.stop - mine.start)
        if dev.type != "cuda":
            outs = _as_tuple(kernel(**{n: t.to(dev) for n, t in arrays.items()}, **kernel_kw))
            outs = [o.movedim(ax, 0).cpu() for o, ax in zip(outs, out_axes)]
            if host is None:
                host = _host_buffers(outs, mine.stop - mine.start, pin)
            for h, o in zip(host, outs):
                h[rows] = o
            continue
        with torch.cuda.device(dev):
            stream = _shard_stream(dev, k)
            with torch.cuda.stream(stream):
                planes = {n: t.to(dev, non_blocking=True) for n, t in arrays.items()}
                if TRACE is not None:
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                outs = _as_tuple(kernel(**planes, **kernel_kw))
                if TRACE is not None:
                    stop.record(stream)
                    TRACE.append((name, k, dev, start, stop))
                outs = [o.movedim(ax, 0).contiguous() for o, ax in zip(outs, out_axes)]
                if host is None:
                    host = _host_buffers(outs, mine.stop - mine.start, pin)
                for h, o in zip(host, outs):
                    h[rows].copy_(o, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
        events.append(event)
        keep.append((planes, outs))
    return Launch(host, out_axes, events, keep, gather=is_multiprocess(mesh))


def _host_buffers(outs, n_local: int, pin: bool):
    """One lane-major host buffer per output, for this process's lanes."""
    return [torch.empty((n_local,) + tuple(o.shape[1:]), dtype=o.dtype, pin_memory=pin)
            for o in outs]


def shard_pairs(mesh: Mesh, packed) -> list:
    """A dense ``batch.PackedPairs``, lane-sharded: this process's slabs,
    one ``PackedPairs`` of tensors on its entry's device each."""
    cuts = lane_slices(packed.hap.shape[1], mesh.size)
    out = []
    for k, dev in mesh.local_entries():
        sl = cuts[k]
        fields = [torch.from_numpy(np.ascontiguousarray(getattr(packed, f)[..., sl])).to(dev)
                  for f in _DENSE_FIELDS]
        out.append(type(packed)(*fields, n_real=max(0, min(packed.n_real, sl.stop) - sl.start)))
    return out


# ---------------------------------------------------------------------------
# Shard inputs.  Each returns ``inputs(k, sl)`` for launch_lanes.


def _dense_pairhmm_inputs(packed):
    """Dense planes as the PairHMM kernels' indexed batch: each slab's own
    columns, ``ridx = hidx = 0..n-1`` and the gap quals as planes."""
    def inputs(k, sl):
        lanes = np.arange(sl.stop - sl.start, dtype=np.int32)
        return dict(hap_u=packed.hap[:, sl],
                    readq_u=np.stack([packed.read[:, sl], packed.q[:, sl]]),
                    quals_u=np.stack([packed.iq[:, sl], packed.dq[:, sl], packed.gcp[:, sl]]),
                    ridx=lanes, hidx=lanes, haplen=packed.haplen[sl], rslen=packed.rslen[sl])
    return inputs


def _compacted(cols, idx):
    """The unique columns ``idx`` takes from each plane of ``cols`` (the
    unique axis last), and ``idx`` renumbered onto them."""
    used, inv = np.unique(idx, return_inverse=True)
    return [c[..., used] for c in cols], inv.astype(np.int32)


def _whole(pk, names):
    """The packed planes as they are, when one slab covers every lane: no
    unique pass (an engine without a mesh launches this way)."""
    planes = {n: getattr(pk, n) for n in names}
    return lambda k, sl: planes


def _indexed_pairhmm_inputs(pk, size: int):
    """An indexed PairHMM batch's slabs.  One slab takes the batch whole.
    In the full-pattern layout each shard takes the read columns cut where
    its lanes are cut and rebases ``ridx`` onto them
    (``gkl_tpu/parallel/mesh.py:226-236``); the haplotype planes go whole
    to every shard.  Otherwise each shard takes the unique columns its
    lanes use."""
    quals = () if pk.quals_u is None else (pk.quals_u,)
    if size == 1:
        return _whole(pk, ("hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen")
                      + (("quals_u",) if quals else ()))
    if pk.pattern_nh is not None:
        nu = pk.readq_u.shape[2] // size

        def inputs(k, sl):
            c = slice(k * nu, (k + 1) * nu)
            d = dict(hap_u=pk.hap_u, readq_u=pk.readq_u[:, :, c], ridx=pk.ridx[sl] - k * nu,
                     hidx=pk.hidx[sl], haplen=pk.haplen[sl], rslen=pk.rslen[sl])
            if quals:
                d["quals_u"] = pk.quals_u[:, :, c]
            return d
        return inputs

    def inputs(k, sl):
        reads, ridx = _compacted((pk.readq_u,) + quals, pk.ridx[sl])
        (hap_u,), hidx = _compacted((pk.hap_u,), pk.hidx[sl])
        d = dict(hap_u=hap_u, readq_u=reads[0], ridx=ridx, hidx=hidx,
                 haplen=pk.haplen[sl], rslen=pk.rslen[sl])
        if quals:
            d["quals_u"] = reads[1]
        return d
    return inputs


def _indexed_pdhmm_inputs(pk, size: int):
    """A ``batch.PackedPDHMMIndexed``'s slabs: one slab takes the batch
    whole; otherwise each shard takes the unique read and haplotype columns
    its lanes use."""
    if size == 1:
        return _whole(pk, ("hap_u", "happd_u", "readq_u", "ridx", "hidx", "haplen", "rslen"))

    def inputs(k, sl):
        (readq_u,), ridx = _compacted((pk.readq_u,), pk.ridx[sl])
        (hap_u, happd_u), hidx = _compacted((pk.hap_u, pk.happd_u), pk.hidx[sl])
        return dict(hap_u=hap_u, happd_u=happd_u, readq_u=readq_u, ridx=ridx, hidx=hidx,
                    haplen=pk.haplen[sl], rslen=pk.rslen[sl])
    return inputs


def _dense_pdhmm_inputs(packed, hap_pd):
    def inputs(k, sl):
        lanes = np.arange(sl.stop - sl.start, dtype=np.int32)
        return dict(hap_u=packed.hap[:, sl], happd_u=np.asarray(hap_pd)[:, sl],
                    readq_u=np.stack([getattr(packed, f)[:, sl]
                                      for f in ("read", "q", "iq", "dq", "gcp")]),
                    ridx=lanes, hidx=lanes, haplen=packed.haplen[sl], rslen=packed.rslen[sl])
    return inputs


def _dense_inputs(arrays: dict):
    """Planes cut along their last (lane) axis."""
    def inputs(k, sl):
        return {n: np.asarray(a)[..., sl] for n, a in arrays.items()}
    return inputs


def _sw_scores(params) -> dict:
    return dict(match=int(params.match_value), mismatch=int(params.mismatch_penalty),
                gap_open=int(params.gap_open_penalty), gap_extend=int(params.gap_extend_penalty))


# ---------------------------------------------------------------------------
# The kernels under the dp mesh.  Each dispatch_* returns a Launch; each
# engine under the JAX package's name waits for it.


def dispatch_pairhmm(mesh: Mesh, pk, kernel) -> Launch:
    """``kernel`` (``pairhmm_cuda.pairhmm_scaled``, ``pairhmm_rows`` or
    ``pairhmm_cols.pairhmm_cols``) on an indexed PairHMM batch, sharded."""
    return launch_lanes(mesh, pk.ridx.shape[0], _indexed_pairhmm_inputs(pk, mesh.size),
                        kernel, const_quals=pk.const_quals)


def dispatch_pdhmm(mesh: Mesh, pk, kernel) -> Launch:
    """``kernel`` (``pdhmm_cuda.pdhmm``, or ``pdhmm_f64`` for the rescue) on
    a ``batch.PackedPDHMMIndexed``, sharded."""
    return launch_lanes(mesh, pk.ridx.shape[0], _indexed_pdhmm_inputs(pk, mesh.size), kernel)


def _dense_pairhmm(mesh, packed, kernel):
    return launch_lanes(mesh, packed.hap.shape[1], _dense_pairhmm_inputs(packed), kernel,
                        const_quals=None)


def pairhmm_raw_pallas_sharded(mesh: Mesh, packed) -> np.ndarray:
    """Plain-f32 PairHMM forward of a dense ``batch.PackedPairs``, lane-
    sharded: the rows kernel (``pairhmm_cuda.pairhmm_rows``) on each slab.
    Returns the (P,) float32 raw results."""
    return _dense_pairhmm(mesh, packed, pairhmm_cuda.pairhmm_rows).wait()


def pairhmm_raw_pallas_scaled_sharded(mesh: Mesh, packed):
    """Scaled-f32 PairHMM (mantissa f32, exp2 i32, flag i32) of a dense
    batch, lane-sharded: the scaled kernel on each slab."""
    out = _dense_pairhmm(mesh, packed, pairhmm_cuda.pairhmm_scaled).wait()
    return out[0].view(np.float32), out[1], out[2]


def pairhmm_scaled_indexed_sharded(mesh: Mesh, pk) -> np.ndarray:
    """The scaled kernel on a full-pattern ``batch.PackedPairsIndexed``
    (``pattern_nh`` set, read columns divisible by the mesh), lane-sharded:
    each shard gets its own read slab and the haplotype planes.  Returns
    the kernel's (3, P) int32 layout (mantissa bits, exp2, flag), where the
    JAX package returns the three as float32 rows."""
    if pk.pattern_nh is None:
        raise ValueError("indexed sharding needs full_pattern packing")
    if pk.readq_u.shape[2] % mesh.size:
        raise ValueError(f"{pk.readq_u.shape[2]} read columns do not split over "
                         f"{mesh.size} shards")
    return dispatch_pairhmm(mesh, pk, pairhmm_cuda.pairhmm_scaled).wait()


def pairhmm_raw_pallas_cols_sharded(mesh: Mesh, packed) -> np.ndarray:
    """Plain-f32 column-sweep PairHMM (long haplotypes) of a dense batch,
    lane-sharded: ``pairhmm_cols.pairhmm_cols`` on each slab."""
    return _dense_pairhmm(mesh, packed, pairhmm_cols.pairhmm_cols).wait()


# the JAX package's read-relayed cols kernel is this CUDA kernel's pass loop
pairhmm_raw_pallas_cols_relay_sharded = pairhmm_raw_pallas_cols_sharded


def pdhmm_raw_pallas_sharded(mesh: Mesh, packed, hap_pd, states=None) -> np.ndarray:
    """f32 PDHMM forward of a dense batch and its (H, P) PD bytes,
    lane-sharded: ``pdhmm_cuda.pdhmm`` on each slab.  ``states`` (the JAX
    kernel's column states) is accepted for the JAX signature; the CUDA
    kernel derives them from ``hap_pd``."""
    return launch_lanes(mesh, packed.hap.shape[1], _dense_pdhmm_inputs(packed, hap_pd),
                        pdhmm_cuda.pdhmm).wait()


# the JAX package's read-chunked PDHMM kernel is this CUDA kernel's pass loop
pdhmm_raw_pallas_chunked_sharded = pdhmm_raw_pallas_sharded


def sw_forward_pallas_sharded(mesh: Mesh, ref, alt, reflen, altlen, params, *,
                              indel_boundary: bool = False):
    """SW score and backtrack DP of (N, P) ``ref`` and (M, P) ``alt``,
    lane-sharded: the CUDA kernel on each slab, which sees the batch's N
    and M, so the kernel's M % 8 rule holds on every shard.  Returns (bt
    (P, N//2, M) uint8, lastrow (M, P), lastcol (P, N)), the kernel's
    layout."""
    inputs = _dense_inputs(dict(ref=ref, alt=alt, reflen=np.asarray(reflen, np.int32),
                                altlen=np.asarray(altlen, np.int32)))
    return launch_lanes(mesh, np.asarray(ref).shape[1], inputs, sw_cuda.sw_forward,
                        out_axes=(0, 1, 0), indel_boundary=indel_boundary,
                        **_sw_scores(params)).wait()


# one launch of the CUDA kernel covers any N: the JAX relay is the same call
sw_forward_pallas_relay_sharded = sw_forward_pallas_sharded


# ---------------------------------------------------------------------------
# The plain twins per shard: the JAX package's engines off the TPU.  In the
# port they serve CPU meshes and the tests; no API routes a CUDA mesh here.


def pairhmm_raw_sharded(mesh: Mesh, packed, dtype: str = "float32") -> np.ndarray:
    """``ops.pairhmm.pairhmm_raw`` on each lane slab of a dense batch."""
    arrays = {f: getattr(packed, f) for f in _DENSE_FIELDS}
    return launch_lanes(mesh, packed.hap.shape[1], _dense_inputs(arrays),
                        pairhmm_ops.pairhmm_raw, dtype=dtype).wait()


def pdhmm_raw_sharded(mesh: Mesh, packed, hap_pd, states, dtype: str = "float32") -> np.ndarray:
    """``ops.pdhmm.pdhmm_raw`` on each lane slab of a dense batch."""
    arrays = {f: getattr(packed, f) for f in _DENSE_FIELDS}
    arrays.update(hap_pd=hap_pd, states=states)
    return launch_lanes(mesh, packed.hap.shape[1], _dense_inputs(arrays),
                        pdhmm_ops.pdhmm_raw, dtype=dtype).wait()


def sw_forward_sharded(mesh: Mesh, ref, alt, reflen, altlen, params,
                       indel_boundary: bool = False):
    """``ops.sw.sw_forward`` on each lane slab: (bt (P, N, M) unpacked
    codes, lastrow (M, P), lastcol (P, N))."""
    inputs = _dense_inputs(dict(ref=ref, alt=alt, reflen=np.asarray(reflen, np.int32),
                                altlen=np.asarray(altlen, np.int32)))
    return launch_lanes(mesh, np.asarray(ref).shape[1], inputs, sw_ops.sw_forward,
                        out_axes=(0, 1, 0), indel_boundary=indel_boundary,
                        **_sw_scores(params)).wait()


# ---------------------------------------------------------------------------
# The sequence-parallel axis: one batch's haplotype columns split over an
# ``sp`` mesh.


def pairhmm_raw_sp(mesh: Mesh, hap, read, q, iq, dq, gcp, haplen, rslen, *,
                   dtype: str = "float32") -> torch.Tensor:
    """Sequence-parallel PairHMM forward (``gkl_tpu/parallel/mesh.py:585-712``):
    the HAPLOTYPE axis split over the mesh's entries, with the DP carry
    relayed between neighbouring entries each read row, for haplotypes too
    long for one device.

    Shard ``k`` holds haplotype columns ``[k*H/n, (k+1)*H/n)`` on
    ``mesh.devices[k]`` (``H % n`` must be 0), and every shard computes its
    column slab as ``ops.pairhmm.pairhmm_raw`` does.  Each read row takes
    from the left neighbour (a) its previous-row edge M/X/Y (shard 0 the
    column-0 boundary: M = X = 0, Y = init_y on row 1 only) and (b) its
    current-row edge M as the Y scan's input; (c) the Y scan runs locally
    (``ops.pairhmm.affine_scan``), then composes the slab totals of
    the shards to its left in an exclusive left fold.  The JAX package's
    ``ppermute`` and ``all_gather`` are copies between the entries'
    devices, in one process: a mesh with another process's entry raises
    ``NotImplementedError``.  The result is the sum of the shards'
    accumulators, a (P,) tensor in ``dtype`` on ``mesh.devices[0]``.

    The JAX original is jnp-only and no API reaches it; this is plain
    PyTorch on each entry's device.  The Y scan is block-reassociated
    against the one-device scan, so results agree to rounding (f64 ~1e-12
    relative), not bit for bit.
    """
    if is_multiprocess(mesh):
        raise NotImplementedError("pairhmm_raw_sp runs the entries of one process only")
    nsp = mesh.size
    ctx = ctx_mod.pairhmm_context(dtype)
    f = getattr(torch, dtype)
    hap = torch.as_tensor(hap)
    H, P = hap.shape
    if H % nsp:
        raise ValueError(f"{H} haplotype rows do not split over {nsp} sp shards")
    H_loc = H // nsp
    R = torch.as_tensor(read).shape[0]

    def on(dev):
        """The replicated inputs and per-row transitions on ``dev``."""
        rd, qq, ii, dd, gg, hl, rl = (torch.as_tensor(a).to(dev)
                                      for a in (read, q, iq, dq, gcp, haplen, rslen))
        rows = pairhmm_ops.transition_rows(qq, ii, dd, gg, ctx, f, dev)
        init_y = torch.tensor(ctx.INITIAL_CONSTANT, dtype=f, device=dev) / hl.to(f)
        return dict(read=rd, rows=rows, init_y=init_y, haplen=hl, rslen=rl)

    per_device = {}
    shards = []
    for k, dev in enumerate(mesh.devices):
        if dev not in per_device:
            per_device[dev] = on(dev)
        rep = per_device[dev]
        hap_l = hap[k * H_loc:(k + 1) * H_loc].to(dev)
        cols = torch.arange(k * H_loc + 1, (k + 1) * H_loc + 1, device=dev)
        shards.append(dict(
            rep, dev=dev, hap=hap_l, hap_is_n=hap_l == pairhmm_ops.N_CODE,
            col_valid=(cols[:, None] <= rep["haplen"][None, :]).to(f),
            zero=torch.zeros((1, P), dtype=f, device=dev),
            m=torch.zeros((H_loc, P), dtype=f, device=dev),
            x=torch.zeros((H_loc, P), dtype=f, device=dev),
            y=rep["init_y"][None, :].expand(H_loc, P).clone(),
            acc=torch.zeros(P, dtype=f, device=dev)))

    def from_left(k, plane):
        """The last row of shard k-1's ``plane`` on shard k's device."""
        return shards[k - 1][plane][-1:].to(shards[k]["dev"])

    shift = pairhmm_ops._shift_down
    for r in range(R):
        # M and X of row r on every slab, from the row above and its left edge
        new = []
        for k, s in enumerate(shards):
            p_mm, p_gapm, p_mx, p_xx = (t[r] for t in s["rows"][:4])
            dmatch, dmis = s["rows"][6][r], s["rows"][7][r]
            rc = s["read"][r]
            if k == 0:
                m_first = x_first = s["zero"]
                y_first = s["init_y"][None, :] if r == 0 else s["zero"]
            else:
                m_first, x_first, y_first = (from_left(k, p) for p in ("m", "x", "y"))
            match = (s["hap"] == rc[None, :]) | s["hap_is_n"] | (rc == pairhmm_ops.N_CODE)[None, :]
            prior = torch.where(match, dmatch[None, :], dmis[None, :])
            m_new = prior * (p_mm * shift(s["m"], 1, m_first)
                             + p_gapm * (shift(s["x"], 1, x_first) + shift(s["y"], 1, y_first)))
            new.append((m_new, p_mx * s["m"] + p_xx * s["x"]))
        for s, (m_new, x_new) in zip(shards, new):
            s["m"], s["x"] = m_new, x_new
        # Y: each slab's local scan from its left neighbour's current-row
        # edge M, then the composed totals of the slabs to its left
        scans = []
        for k, s in enumerate(shards):
            p_my, p_yy = s["rows"][4][r], s["rows"][5][r]
            b_first = s["zero"] if k == 0 else from_left(k, "m")
            b = p_my * shift(s["m"], 1, b_first)
            am, ae = pairhmm_ops._mant_exp(p_yy[None, :].expand(H_loc, P))
            scans.append(pairhmm_ops.affine_scan(am, ae, b))
        for k, s in enumerate(shards):
            dev = s["dev"]
            carry = (torch.ones((1, P), dtype=f, device=dev),
                     torch.zeros((1, P), dtype=torch.int32, device=dev),
                     torch.zeros((1, P), dtype=f, device=dev))  # the identity map
            for j in range(k):
                total = tuple(t[-1:].to(dev) for t in scans[j])
                carry = pairhmm_ops._affine_combine(carry, total)
            s["y"] = pairhmm_ops._affine_combine(carry, scans[k])[2]
            row_sum = pairhmm_ops.lane_sum((s["m"] + s["x"]) * s["col_valid"])
            s["acc"] = s["acc"] + torch.where(s["rslen"] == r + 1, row_sum,
                                              torch.zeros_like(row_sum))
    out = shards[0]["acc"]
    for s in shards[1:]:
        out = out + s["acc"].to(out.device)
    return out
