"""PairHMM public API — counterpart of the PairHMM part of ``gkl_tpu/api.py``.

Mirrors the reference's ``IntelPairHmm`` (``pairhmm/IntelPairHmm.java:41-167``):
the likelihood batch is the read x haplotype cross product in read-major
order (``pairhmm/JavaData.h:84-106``), computed in float32 with the lanes
whose result is deep or untrustworthy recomputed in exact float64
(``pairhmm/IntelPairHmm.cc:125-181``).

Every float32 shape bucket goes to one kernel launch on each lane slab of
the engine's mesh through ``parallel.mesh.launch_lanes``: the caller's
``mesh``, or without one a one-entry mesh of ``PairHMM.device`` (CUDA by
default, the plain PyTorch twins when the caller asks for
``device="cpu"``).  A bucket is routed as the JAX package routes it:
haplotype buckets up to ``PALLAS_MAX_HAP`` to the scaled kernel
(``ops/pairhmm_cuda.py``), longer ones to the plain-f32 column kernel
(``ops/pairhmm_cols.py``) with every lane below ``MIN_ACCEPTED`` rescued.
The f64 rescue and the double-precision mode run on the host's native
oracle.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from . import batch as batch_mod
from . import debug, profiling, utils
from .context import MIN_ACCEPTED
from .ops import pairhmm as pairhmm_ops
from .ops import pairhmm_cols, pairhmm_cuda, pairhmm_ref
from .parallel import mesh as mesh_mod


def _as_u8(x) -> np.ndarray:
    if isinstance(x, (bytes, bytearray, str)):
        if isinstance(x, str):
            x = x.encode("ascii")
        return np.frombuffer(bytes(x), dtype=np.uint8)
    # no copy when already uint8 (the pipeline shares constant GOP rows)
    return np.asarray(x).astype(np.uint8, copy=False)


@dataclasses.dataclass
class ReadData:
    """Equivalent of GATK's ReadDataHolder (pairhmm/JavaData.h:55-60)."""

    read_bases: np.ndarray
    read_quals: np.ndarray
    insertion_gop: np.ndarray
    deletion_gop: np.ndarray
    overall_gcp: np.ndarray

    def __post_init__(self):
        self.read_bases = _as_u8(self.read_bases)
        self.read_quals = _as_u8(self.read_quals)
        self.insertion_gop = _as_u8(self.insertion_gop)
        self.deletion_gop = _as_u8(self.deletion_gop)
        self.overall_gcp = _as_u8(self.overall_gcp)


@dataclasses.dataclass
class HaplotypeData:
    """Equivalent of HaplotypeDataHolder (pairhmm/JavaData.h:61-62)."""

    haplotype_bases: np.ndarray

    def __post_init__(self):
        self.haplotype_bases = _as_u8(self.haplotype_bases)


@dataclasses.dataclass
class PairHMMNativeArguments:
    """Mirror of PairHMMNativeArguments (pairhmm/IntelPairHmm.java:85-119).

    ``max_number_of_threads`` is the reference's OpenMP worker clamp, mapped
    onto the local devices of the engine's device type as the JAX package
    does (gkl_tpu/api.py:273-296): 0 means all of them, N at most N.  A span
    of one device needs no mesh; a span of several CUDA devices builds a
    ``dp`` mesh over them.
    """

    use_double_precision: bool = False
    max_number_of_threads: int = 1


def _const_quals_of(reads: Sequence[ReadData]):
    """(iq, dq, gcp) constants when every read's planes are uniform (the
    GATK default-GOP flow), else None.  Planes are deduplicated by object
    identity first — the pipeline shares one plane per length — so the scan
    is O(unique planes), not O(reads)."""
    first = reads[0]
    c = (int(first.insertion_gop[0]), int(first.deletion_gop[0]),
         int(first.overall_gcp[0]))
    seen: set = set()
    for rd in reads:
        for plane, cv in ((rd.insertion_gop, c[0]), (rd.deletion_gop, c[1]),
                          (rd.overall_gcp, c[2])):
            key = (id(plane), cv)  # an object may serve several roles
            if key in seen:
                continue
            seen.add(key)
            if plane[0] != cv or not (plane == cv).all():
                return None
    return c


def _extract_lanes(pk, lanes):
    """Per-lane variable-length (haps, reads, quals) of a lane subset of an
    indexed batch — the compaction step of the lane-granular rescue (the
    reference recomputes only the underflowed pair,
    IntelPairHmm.cc:157-165)."""
    haps, reads, quals = [], [], []
    for k in lanes:
        k = int(k)
        hl, rl = int(pk.haplen[k]), int(pk.rslen[k])
        ri, hi = int(pk.ridx[k]), int(pk.hidx[k])
        haps.append(pk.hap_u[:hl, hi])
        reads.append(pk.readq_u[0][:rl, ri])
        if pk.const_quals is not None:
            iq, dq, gcp = (np.full(rl, v, np.uint8) for v in pk.const_quals)
        else:
            iq, dq, gcp = (pk.quals_u[i][:rl, ri] for i in range(3))
        quals.append((pk.readq_u[1][:rl, ri], iq, dq, gcp))
    return haps, reads, quals


class PairHMM:
    """PairHMM forward-likelihood engine (float-first with double rescue).

    ``compute_likelihoods`` follows ``pairhmm/IntelPairHmm.cc:125-181``:
    every (read, hap) pair is computed in float32, by the scaled kernel or,
    for haplotype buckets past ``PALLAS_MAX_HAP``, by the plain column
    kernel, and the lanes the rescue policy selects are recomputed in
    float64.  With ``use_double_precision=True`` everything runs in float64.
    """

    # The routing threshold under the JAX package's name (gkl_tpu/api.py),
    # where it is the scaled kernel's VMEM cap.  On this card it is kept for
    # parity, not as a memory cap: a group whose haplotype bucket is longer
    # leaves the scaled kernel for a plain-f32 "f32" work item on the column
    # kernel, and gets the JAX package's rescue rule (every lane below
    # MIN_ACCEPTED); _raw_batch sends a dense batch with a bucket up to it
    # to the rows kernel.  The JAX package's second threshold,
    # COLS_MAX_READ, picks between its cols and relay kernels, which are
    # one kernel here.
    PALLAS_MAX_HAP = 2048

    # compute_likelihoods_async keeps at most this many device bytes in
    # flight (PackedPairsIndexed.device_bytes); later groups stay "lazy"
    # and result() dispatches them one group ahead of the fetch, as
    # gkl_tpu/api.py does
    _ASYNC_INFLIGHT_BYTES = 256 << 20

    def __init__(self, args: PairHMMNativeArguments | None = None, *,
                 lane_multiple: int | None = None, device: str | torch.device = "cuda",
                 mesh: mesh_mod.Mesh | None = None):
        """``lane_multiple``: every packed group's lanes pad to a multiple
        of it; None means ``batch.LANE_MULTIPLE * mesh.size`` (8 without a
        mesh).  A value below 1, or one that does not split evenly over the
        mesh, raises ``ValueError``.  ``mesh``: an optional
        ``parallel.Mesh``; every batch then shards lane-wise over it, one
        launch per lane slab on the slab's device (the OpenMP-over-pairs
        analogue).  Without one, ``max_number_of_threads`` may build a
        mesh of local CUDA devices (:meth:`initialize`)."""
        self.device = torch.device(device)
        self._user_mesh = mesh is not None
        self._user_lane_multiple = lane_multiple
        self.mesh = mesh
        self.initialize(args or PairHMMNativeArguments())

    def _mesh_from_thread_cap(self, args: PairHMMNativeArguments) -> mesh_mod.Mesh | None:
        """The thread clamp as a dp-mesh width over the local devices of
        ``self.device``'s type (IntelPairHmm.cc:88-91 mapped to devices, as
        ``gkl_tpu/api.py:273-296``): 0 = all, N = at most N; a span of one
        device needs no mesh.  Local devices only, each once: an auto-mesh
        never spans processes, since each process feeds its own batches."""
        cap = args.max_number_of_threads
        if cap < 0:
            raise ValueError("maxNumberOfThreads must be >= 0")
        if cap == 1:
            return None
        count = utils.available_parallelism(self.device)
        n = count if cap == 0 else min(cap, count)
        if n <= 1:
            return None
        return mesh_mod.data_parallel_mesh(devices=[torch.device("cuda", i) for i in range(n)])

    def initialize(self, args: PairHMMNativeArguments) -> None:
        """Takes new arguments, as the reference's initializeNative does on
        every call (IntelPairHmm.cc:88-91): an auto-built mesh is rebuilt
        (or dropped) to match the new thread clamp; a mesh the caller
        passed is never touched.  The caller's ``lane_multiple`` is kept
        and checked against the mesh (``ValueError`` before anything
        changes); only the default follows the mesh's size."""
        mesh = self._mesh_from_thread_cap(args)
        if self._user_mesh:
            mesh = self.mesh
        lane_multiple = batch_mod.resolve_lane_multiple(self._user_lane_multiple,
                                                        mesh.size if mesh else 1)
        self.mesh, self.args, self._lane_multiple = mesh, args, lane_multiple

    def done(self) -> None:  # parity with IntelPairHmm.done()
        pass

    def _f64_lanes(self, pk, lanes, on: bool) -> np.ndarray:
        """Exact f64 log10 results for a lane subset, on the threaded native
        oracle over the compacted lanes: rescue work scales with
        ``len(lanes)``, not the packed group.  Recorded as the
        ``pairhmm_rescue`` METRICS span (items = lanes recomputed)."""
        lanes = np.asarray(lanes, np.int64)
        with profiling.span("pairhmm_rescue", on, items=len(lanes)) as s:
            haps, reads, quals = _extract_lanes(pk, lanes)
            res = pairhmm_ref.pairhmm_scalar_batch(haps, reads, quals,
                                                   threads=utils.default_host_threads())
            if on:
                s.cells = int(np.sum(pk.haplen[lanes].astype(np.int64)
                                     * pk.rslen[lanes].astype(np.int64)))
        return res

    @property
    def _shards(self) -> mesh_mod.Mesh:
        """The mesh batches run on: ``mesh``, or one entry of ``device``."""
        return mesh_mod.engine_mesh(self.mesh, self.device)

    def _dispatch_group(self, idxs, pk: batch_mod.PackedPairsIndexed):
        """Launch one read-group x hap-group batch without waiting, one
        launch per lane slab (``parallel.mesh.dispatch_pairhmm``): a
        ``"scaled"`` work item on the scaled kernel, or past
        ``PALLAS_MAX_HAP`` the JAX package's plain-f32 route
        (gkl_tpu/api.py:703-712), an ``"f32"`` item on the column kernel."""
        if pk.hap_u.shape[0] <= self.PALLAS_MAX_HAP:
            kind, kernel = "scaled", pairhmm_cuda.pairhmm_scaled
        else:
            kind, kernel = "f32", pairhmm_cols.pairhmm_cols
        return (kind, idxs, pk, mesh_mod.dispatch_pairhmm(self._shards, pk, kernel))

    def _raw_batch(self, packed: batch_mod.PackedPairs, dtype: str = "float32") -> np.ndarray:
        """Forward probabilities of a dense batch's real lanes: the
        counterpart of ``gkl_tpu/api.py:372-498``.

        ``"float32"``: the plain-f32 rows kernel for haplotype buckets up
        to PALLAS_MAX_HAP and the column kernel past it, lane-sharded on
        the engine's mesh as ``gkl_tpu/api.py:404-431``; each slab goes in
        as an indexed batch with ``ridx = hidx = 0..n-1``.

        ``"float64"``: the plain engine ``ops.pairhmm.pairhmm_raw`` in f64
        (the JAX package's jnp f64 engine, ``gkl_tpu/api.py:485-498``),
        unsharded on the first entry of this process (the engine's device
        without a mesh), as the JAX package shards only float32
        (``gkl_tpu/api.py:404``); the H100 runs f64 at full range, so
        nothing moves to the host.  The rescue (``_f64_lanes``) stays on
        the native oracle, as in the JAX package."""
        if dtype == "float64":
            local = self._shards.local_entries()
            if not local:
                raise ValueError("this process owns no entry of the mesh")
            dev = local[0][1]
            planes = [torch.from_numpy(np.ascontiguousarray(getattr(packed, f))).to(dev)
                      for f in ("hap", "read", "q", "iq", "dq", "gcp", "haplen", "rslen")]
            raw = pairhmm_ops.pairhmm_raw(*planes, dtype="float64")
            return raw.cpu().numpy()[: packed.n_real]
        if dtype != "float32":
            raise ValueError(f"_raw_batch runs float32 or float64, got {dtype!r}")
        rows = packed.hap.shape[0] <= self.PALLAS_MAX_HAP
        engine = debug.engine_name(*(("pairhmm_rows kernel", "pairhmm_raw twin") if rows else
                                     ("pairhmm_cols kernel", "pairhmm_raw_cols twin")),
                                   self._shards.devices)
        sharded = (mesh_mod.pairhmm_raw_pallas_sharded if rows
                   else mesh_mod.pairhmm_raw_pallas_cols_sharded)
        raw = sharded(self._shards, packed)[: packed.n_real]
        debug.check_nan(raw, packed.n_real, engine)
        return raw

    def _forward_raw_finalize(self, packed: batch_mod.PackedPairsIndexed, raw: np.ndarray):
        """log10 results of a plain-f32 batch and the lanes to rescue: every
        lane below MIN_ACCEPTED, as ``gkl_tpu/api.py:820-831``."""
        raw32 = np.asarray(raw, np.float32)[: packed.n_real]
        debug.check_nan(raw32, packed.n_real, debug.engine_name(
            "pairhmm_cols kernel", "pairhmm_raw_cols twin", self._shards.devices))
        return pairhmm_ops.pairhmm_log10_from_raw_f32(raw32), raw32 < MIN_ACCEPTED

    def _forward_scaled_finalize(self, pk, stacked: np.ndarray):
        """Reconstruct the f32 result of a scaled-kernel batch and classify
        its lanes for the host-f64 rescue.  Returns (log10 results, lanes
        to rescue)."""
        n = pk.n_real
        debug.check_nan(stacked[0].view(np.float32), n, debug.engine_name(
            "pairhmm_scaled kernel", "pairhmm_raw_scaled_reference twin", self._shards.devices))
        mant = stacked[0].view(np.float32)[:n].astype(np.float64)
        ex = stacked[1][:n].astype(np.float64)
        flag = stacked[2][:n]
        raw32 = np.ldexp(mant, ex.astype(np.int64)).astype(np.float32)
        in_range = raw32 >= MIN_ACCEPTED
        with np.errstate(divide="ignore", invalid="ignore"):
            res_in = pairhmm_ops.pairhmm_log10_from_raw_f32(raw32)
        res_deep = pairhmm_cuda.log10_of(mant, ex)
        res = np.where(in_range, res_in, res_deep)
        # host-f64 rescue policy (GKL_TPU_RESCUE):
        #   flagged (default) — rescue deep lanes whose column spread
        #     exceeded the kernel's f32 window, plus lanes past the f64
        #     subnormal parity zone or without a finite result;
        #   device  — trust the scaled kernel wherever its result is finite;
        #   host    — rescue every deep lane (reference-exact).
        # GKL_TPU_EXACT_RESCUE=1 means host whatever GKL_TPU_RESCUE says.
        deep = ~in_range & (~np.isfinite(res_deep) | (res_deep < -600.0))
        mode = os.environ.get("GKL_TPU_RESCUE", "flagged")
        if os.environ.get("GKL_TPU_EXACT_RESCUE") == "1" or mode == "host":
            deep = ~in_range
        elif mode != "device":
            deep = deep | (~in_range & (flag != 0))
        return res, deep

    def compute_likelihoods_async(
        self,
        reads: Sequence[ReadData],
        haplotypes: Sequence[HaplotypeData],
    ) -> "PendingLikelihoods":
        """Dispatch the cross-product batch without waiting for the device.

        Reads and haplotypes are grouped by their own length buckets; each
        read-group x hap-group pair is one deduplicated batch and one kernel
        launch: the scaled kernel, or past ``PALLAS_MAX_HAP`` the column
        kernel.  Groups launch here while their device bytes fit
        ``_ASYNC_INFLIGHT_BYTES`` (the first always does); the rest wait as
        ``"lazy"`` work items.  The returned handle materialises the
        results, including the float-to-double rescue, on ``.result()``:
        the streaming pipeline's building block, so that chunk N+1's host
        work overlaps chunk N's device time.
        """
        on = profiling.metrics_enabled()
        with profiling.span("pairhmm_pack", on):
            if reads is None or haplotypes is None:
                raise TypeError("readDataArray/haplotypeDataArray is null")
            if len(reads) == 0 or len(haplotypes) == 0:
                raise ValueError("readDataArray/haplotypeDataArray is empty")
            for rd in reads:
                if rd.read_bases is None or len(rd.read_bases) == 0:
                    raise ValueError("read bases are null or empty")
                if not (
                    len(rd.read_bases) == len(rd.read_quals) == len(rd.insertion_gop)
                    == len(rd.deletion_gop) == len(rd.overall_gcp)
                ):
                    raise ValueError("read arrays must all have the read's length")
            for hp in haplotypes:
                if hp.haplotype_bases is None or len(hp.haplotype_bases) == 0:
                    raise ValueError("haplotype bases are null or empty")
            nr, nh = len(reads), len(haplotypes)
            t0 = time.perf_counter()  # the ``pairhmm`` counter's start
            rlens = [len(rd.read_bases) for rd in reads]
            hlens = [len(hp.haplotype_bases) for hp in haplotypes]
            # sum over pairs of len_r * len_h over the full cross product
            cells = sum(rlens) * sum(hlens)

            if self.args.use_double_precision:
                # the native oracle is the engine: exact f64 with gradual
                # underflow, like the reference's double kernel
                pairs = [(hp.haplotype_bases, rd.read_bases,
                          (rd.read_quals, rd.insertion_gop, rd.deletion_gop, rd.overall_gcp))
                         for rd in reads for hp in haplotypes]
                return PendingLikelihoods(self, nr * nh, [("f64", None, pairs, None)], t0,
                                          cells, on)

            const_quals = _const_quals_of(reads)
            rgroups: dict = {}
            for i, ln in enumerate(rlens):
                rgroups.setdefault(batch_mod.bucket_length(ln), []).append(i)
            hgroups: dict = {}
            for j, ln in enumerate(hlens):
                hgroups.setdefault(batch_mod.bucket_length(ln), []).append(j)
            rsets = [(rids, [reads[i].read_bases for i in rids],
                      [(reads[i].read_quals, reads[i].insertion_gop,
                        reads[i].deletion_gop, reads[i].overall_gcp) for i in rids])
                     for rids in rgroups.values()]
        lm = self._lane_multiple
        work = []
        inflight = 0
        for rids, rbases, rq in rsets:
            for hids in hgroups.values():
                with profiling.span("pairhmm_pack", on) as s:
                    # on a mesh, the full-pattern layout cuts unique reads
                    # where the pair lanes are cut, when the group's nh
                    # divides the padded lanes (gkl_tpu/api.py:674-684)
                    nh_g = len(hids)
                    Pg = batch_mod.bucket_lanes(len(rids) * nh_g, lm)
                    full_pattern = (self.mesh is not None and Pg % nh_g == 0
                                    and (Pg // nh_g) % self.mesh.size == 0)
                    pk = batch_mod.pack_pairs_indexed(
                        [haplotypes[j].haplotype_bases for j in hids], rbases, rq,
                        lane_multiple=lm, const_quals=const_quals, full_pattern=full_pattern)
                    s.items = pk.n_real
                    idxs = (np.asarray(rids, np.int64)[:, None] * nh
                            + np.asarray(hids, np.int64)[None, :]).ravel()
                    est = pk.device_bytes()
                    if work and inflight + est > self._ASYNC_INFLIGHT_BYTES:
                        work.append(("lazy", idxs, pk, None))
                        continue
                    inflight += est
                with profiling.span("pairhmm_dispatch", on, items=pk.n_real):
                    work.append(self._dispatch_group(idxs, pk))
        return PendingLikelihoods(self, nr * nh, work, t0, cells, on)

    def compute_likelihoods(
        self,
        reads: Sequence[ReadData],
        haplotypes: Sequence[HaplotypeData],
        likelihoods: np.ndarray | None = None,
    ) -> np.ndarray:
        """Cross-product likelihoods, read-major (JavaData.h:84-106)."""
        out = self.compute_likelihoods_async(reads, haplotypes).result()
        if likelihoods is not None:
            likelihoods[: len(out)] = out
            return likelihoods
        return out


class PendingLikelihoods:
    """Handle for a dispatched likelihood batch (compute_likelihoods_async).

    ``result()`` waits for each bucket's kernel, applies the float-to-double
    rescue policy and returns the (n,) float64 log10 likelihoods in pair
    order.  A ``"lazy"`` group (past the in-flight budget) is launched when
    it is reached, and the next lazy group one ahead of each fetch.
    Resolving twice returns the same array.
    """

    def __init__(self, hmm: PairHMM, n: int, work, t0: float, cells: int, on: bool):
        self._hmm = hmm
        self._n = n
        self._work = work
        self._t0 = t0
        self._cells = cells
        self._on = on  # the dispatching call's metrics switch
        self._out: np.ndarray | None = None

    def result(self) -> np.ndarray:
        if self._out is not None:
            return self._out
        hmm, on = self._hmm, self._on
        out = np.zeros(self._n, np.float64)
        work = list(self._work)
        for k in range(len(work)):
            # keep the next lazy group dispatched one ahead of this fetch, so
            # that its upload and kernel overlap the wait and rescue below
            for i in (k, k + 1):
                if i < len(work) and work[i][0] == "lazy":
                    with profiling.span("pairhmm_dispatch", on, items=work[i][2].n_real):
                        work[i] = hmm._dispatch_group(*work[i][1:3])
            kind, idxs, packed, launch = work[k]
            if kind == "f64":
                haps, rds, quals = zip(*packed)
                out[:] = pairhmm_ref.pairhmm_scalar_batch(
                    haps, rds, quals, threads=utils.default_host_threads())
                continue
            with profiling.span("pairhmm_wait", on, items=packed.n_real):
                raw = launch.wait()
            with profiling.span("pairhmm_finalize", on, items=packed.n_real):
                if kind == "scaled":
                    res, needs_rescue = hmm._forward_scaled_finalize(packed, raw)
                else:
                    res, needs_rescue = hmm._forward_raw_finalize(packed, raw)
                if np.any(needs_rescue):
                    # lane-granular rescue: only the selected lanes are
                    # compacted and recomputed in exact f64
                    lanes = np.nonzero(needs_rescue)[0]
                    res[lanes] = hmm._f64_lanes(packed, lanes, on)
                out[idxs] = res
        self._work = ()
        self._out = out
        if on:
            profiling.METRICS.record(
                "pairhmm", items=self._n, cells=self._cells,
                seconds=time.perf_counter() - self._t0,
            )
        return out


class PairHMMOMP(PairHMM):
    """Parity alias for IntelPairHmmOMP (pairhmm/IntelPairHmmOMP.java:29-35):
    the same engine under the reference's other name."""


class PairHMMFpga(PairHMM):
    """Parity alias for IntelPairHmmFpga (pairhmm/IntelPairHmmFpga.java:36-39):
    the same engine; the accelerator here is the GPU."""
