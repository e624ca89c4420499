"""PDHMM public API — counterpart of ``gkl_tpu/api_pdhmm.py``.

Parity with IntelPDHMM (``pdhmm/IntelPDHMM.java:46-220``):

* :meth:`PDHMM.compute_pdhmm` — flat batch arrays plus per-pair lengths,
  mirroring ``computePDHMM`` (IntelPDHMM.java:163-204) and its size checks;
* :meth:`PDHMM.compute_likelihoods` — the object path over reads x
  haplotypes (read-major cross product, pdhmm/JavaData.h:186-236).

Engines: on ``PDHMM.device`` (CUDA by default) the float32 CUDA kernel
``csrc/pdhmm.cu`` over deduplicated, memory-budgeted lane slices, each
launched through ``parallel.mesh.launch_lanes`` (lane-sharded when the
engine has a ``mesh``, one slab otherwise), with every lane below
``MIN_ACCEPTED`` recomputed on the card by the same kernel's float64
instance, one launch a slice by the same path — the reference's
float-then-double pattern (pairhmm/IntelPairHmm.cc:157-165).  With
``device="cpu"`` the kernel's plain twins take their place.  The
double-precision mode and ``KernelLevel.SCALAR`` run the host's exact f64
oracle alone (``gkl_tpu_torch/native/pdhmm_oracle.cc``, a byte-identical
copy of ``gkl_tpu/native/pdhmm_oracle.cc``).
"""

from __future__ import annotations

import dataclasses
import operator
import os
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import batch as batch_mod
from . import debug, native_lib, profiling
from .api import HaplotypeData, ReadData
from .context import MIN_ACCEPTED, pdhmm_context
from .ops import pdhmm as pdhmm_ops
from .ops import pdhmm_cuda, pdhmm_ref
from .parallel import mesh as mesh_mod


@dataclasses.dataclass
class PDHaplotypeData(HaplotypeData):
    """Haplotype with partially-determined flag bytes."""

    haplotype_pdbases: np.ndarray = None

    def __post_init__(self):
        super().__post_init__()
        if self.haplotype_pdbases is None:
            raise ValueError(
                "haplotype_pdbases is required (the PD flag bytes; pass an "
                "all-zero array for a fully determined haplotype)")
        self.haplotype_pdbases = np.asarray(self.haplotype_pdbases).astype(np.uint8)


class KernelLevel(int):
    """AVXLevel analogue (pdhmm-implementation.h:45-58): which engine.

    FASTEST_AVAILABLE and PALLAS run the CUDA kernel on a CUDA device or
    mesh (the plain twin on ``device="cpu"``); PALLAS raises where no
    kernel can run.  SCALAR runs the native serial f64 oracle, the reference's scalar
    implementation.
    """


KernelLevel.FASTEST_AVAILABLE = KernelLevel(0)
KernelLevel.SCALAR = KernelLevel(1)
KernelLevel.PALLAS = KernelLevel(2)


class ParallelSetting(int):
    """OpenMPSetting analogue (pdhmm-implementation.h:45-50)."""


ParallelSetting.FASTEST_AVAILABLE = ParallelSetting(0)
ParallelSetting.ENABLE = ParallelSetting(1)
ParallelSetting.DISABLE = ParallelSetting(2)


@dataclasses.dataclass
class PDHMMNativeArguments:
    """Mirror of PDHMMNativeArguments (IntelPDHMM.java:79-89).

    The reference kernel is double-only; the default here is float first
    with the double rescue, and ``use_double_precision=True`` runs the
    reference-exact f64 oracle for every pair."""

    max_number_of_threads: int = 0  # host threads of the f64 oracle; 0 = all cores
    max_memory_in_mb: int = 512
    kernel_level: int = KernelLevel.FASTEST_AVAILABLE  # avxLevel analogue
    parallel_setting: int = ParallelSetting.FASTEST_AVAILABLE
    use_double_precision: bool = False


class _Planes(NamedTuple):
    """A call's unique planes, which its lanes index: haplotype bases and
    PD bytes, read bases and (q, iq, dq, gcp)."""

    haps: Sequence[np.ndarray]
    hap_pds: Sequence[np.ndarray]
    reads: Sequence[np.ndarray]
    quals: Sequence[tuple]

    def lengths(self) -> tuple[np.ndarray, np.ndarray]:
        """Each unique read's and haplotype's length."""
        return (np.fromiter(map(len, self.reads), np.int64, count=len(self.reads)),
                np.fromiter(map(len, self.haps), np.int64, count=len(self.haps)))

    def pairs(self, ridx, hidx) -> tuple[list, list, list, list]:
        """Per-pair lists of the lanes ``ridx``/``hidx``, as the oracle
        takes them."""
        return ([self.haps[k] for k in hidx], [self.hap_pds[k] for k in hidx],
                [self.reads[k] for k in ridx], [self.quals[k] for k in ridx])

    def cells(self, ridx, hidx) -> int:
        """DP cells of the lanes ``ridx``/``hidx``."""
        rlen, hlen = self.lengths()
        return int(np.dot(rlen[ridx], hlen[hidx]))


def _by_identity(objs: Sequence[tuple]) -> tuple[Sequence[tuple], np.ndarray]:
    """Objects told apart by the identity of their arrays (a tuple each):
    the distinct ones in the order of their first appearance, and each
    object's column among them."""
    if len(set(map(id, next(zip(*objs))))) == len(objs):
        # every first array is its own, so every object is distinct
        return objs, np.arange(len(objs))
    cols: dict = {}
    distinct, sel = [], np.empty(len(objs), np.int64)
    for i, arrays in enumerate(objs):
        c = sel[i] = cols.setdefault(tuple(map(id, arrays)), len(cols))
        if c == len(distinct):
            distinct.append(arrays)
    return distinct, sel


_READ_PLANES = operator.attrgetter("read_bases", "read_quals", "insertion_gop",
                                   "deletion_gop", "overall_gcp")
_HAP_PLANES = operator.attrgetter("haplotype_bases", "haplotype_pdbases")


class PDHMM:
    """PDHMM forward-likelihood engine (IntelPDHMM).

    ``lane_multiple``: each lane slice pads to a multiple of it, and the
    memory budget slices in its units; None means ``batch.LANE_MULTIPLE *
    mesh.size`` (8 without a mesh), and a value below 1 or one that does not
    split evenly over the mesh raises ``ValueError``.  ``mesh``: an
    optional ``parallel.Mesh``; the lane slices and their rescues then
    shard lane-wise over it.  ``max_number_of_threads`` stays the f64
    oracle's host threads (the double-precision mode and
    ``KernelLevel.SCALAR``), as in the JAX package's PDHMM."""

    def __init__(self, args: PDHMMNativeArguments | None = None, *,
                 lane_multiple: int | None = None, device: str | torch.device = "cuda",
                 mesh: mesh_mod.Mesh | None = None):
        self._lane_multiple = batch_mod.resolve_lane_multiple(lane_multiple,
                                                              mesh.size if mesh else 1)
        self.device = torch.device(device)
        self.mesh = mesh
        self.initialize(args or PDHMMNativeArguments())

    def initialize(self, args: PDHMMNativeArguments) -> None:
        self.args = args
        self._effective_threads()  # validate eagerly, like initializeNative

    def done(self) -> None:
        pass

    def _effective_threads(self) -> int:
        """ComputeConfig's OpenMP resolution (pdhmm-implementation.h:96-133)
        mapped to the oracle's thread pool: DISABLE -> 1 worker; ENABLE
        needs the native pool, whose build raises when it fails; otherwise
        the requested count clamps to the host's cores (0 = all)."""
        setting = self.args.parallel_setting
        if setting == ParallelSetting.ENABLE:
            native_lib.load("gkl_pdhmm_oracle")
        if setting == ParallelSetting.DISABLE:
            return 1
        cores = os.cpu_count() or 1
        req = self.args.max_number_of_threads
        return cores if req <= 0 else min(req, cores)

    @property
    def _shards(self) -> mesh_mod.Mesh:
        """The mesh slices run on: ``mesh``, or one entry of ``device``."""
        return mesh_mod.engine_mesh(self.mesh, self.device)

    def _slices(self, ridx, hidx, planes: _Planes, dtype: str) -> list[slice]:
        """Memory-budgeted lane slicing (pdhmm/JavaData.h:83-97) of the lanes
        ``ridx``/``hidx`` for the kernel's ``dtype`` instance.  Per lane the
        kernel takes at most one unique read (5 planes) and haplotype (bases
        and PD bytes), four i32 indices, and, when the read bucket needs
        more than one pass, its pass boundary (six planes along the
        haplotype axis, 24 bytes a column in f32 and 48 in f64); the JAX
        package's formula counts the TPU's state on the read axis instead."""
        n = len(ridx)
        rlen, hlen = planes.lengths()
        max_r = batch_mod.bucket_length(int(rlen[ridx].max()))
        max_h = batch_mod.bucket_length(int(hlen[hidx].max()))
        bytes_per_lane = (pdhmm_cuda.boundary_bytes_per_lane(max_r, max_h, dtype)
                          + 5 * max_r + 2 * max_h + 16)
        lm = self._lane_multiple
        # the budget holds on each device: a slice puts 1/size of its lanes
        # on each shard, and shards that share a device add up there
        devices = self._shards.devices
        per_device = max(map(devices.count, devices))
        budget_lanes = self.args.max_memory_in_mb * 1024 * 1024 // bytes_per_lane
        # whole lane-padding units, so a padded slice stays within the budget
        max_lanes = max(lm, budget_lanes * len(devices) // per_device // lm * lm)
        return [slice(s, min(n, s + max_lanes)) for s in range(0, n, max_lanes)]

    def _run_indexed(self, ridx, hidx, planes: _Planes, on: bool = False):
        """One lane slice through the f32 engine: ``ridx``/``hidx`` index
        the call's unique planes; the slice packs each plane its lanes use
        once (the object path shares one array per read and per
        haplotype, pdhmm/JavaData.h:186-236), runs the kernel (or its
        twin) and returns the raw (n,) f32 results."""
        with profiling.span("pdhmm_pack", on, items=len(ridx)):
            pk, unique = batch_mod.pack_pdhmm_lanes(*planes, ridx, hidx,
                                                    lane_multiple=self._lane_multiple)
            if on:
                profiling.METRICS.record("pdhmm_unique", items=unique)
        # from the upload's start until the results are on the host
        with profiling.span("pdhmm_wait", on, items=len(ridx)):
            raw = mesh_mod.dispatch_pdhmm(self._shards, pk, pdhmm_cuda.pdhmm).wait()[:pk.n_real]
        debug.check_nan(raw, pk.n_real, debug.engine_name(
            "pdhmm kernel", "pdhmm_indexed_reference twin", self._shards.devices))
        return raw

    def _rescue(self, ridx, hidx, planes: _Planes) -> np.ndarray:
        """The log10 likelihoods of the lanes ``ridx``/``hidx`` from the
        kernel's f64 instance (its plain twin on the CPU), with gradual
        underflow: one launch, or as many as the memory budget needs at
        48 bytes a boundary column."""
        ctx = pdhmm_context("float64")
        out = np.empty(len(ridx), np.float64)
        for sl in self._slices(ridx, hidx, planes, "float64"):
            pk, _ = batch_mod.pack_pdhmm_lanes(*planes, ridx[sl], hidx[sl],
                                               lane_multiple=self._lane_multiple)
            raw = mesh_mod.dispatch_pdhmm(self._shards, pk, pdhmm_cuda.pdhmm_f64).wait()
            with np.errstate(divide="ignore"):
                out[sl] = np.log10(raw[:pk.n_real]) - ctx.INITIAL_CONDITION_LOG10
        return out

    def _oracle(self, haps, hap_pds, reads, quals) -> np.ndarray:
        return pdhmm_ref.pdhmm_scalar_batch(haps, hap_pds, reads, quals,
                                            threads=self._effective_threads())

    def _compute_pairs(self, haps: Sequence[np.ndarray], hap_pds: Sequence[np.ndarray],
                       reads: Sequence[np.ndarray], quals: Sequence[tuple],
                       on: bool = False, ridx: np.ndarray | None = None,
                       hidx: np.ndarray | None = None) -> np.ndarray:
        """The pairs' log10 likelihoods; ``on`` is the public call's metrics
        switch.  Pair k is read ``ridx[k]`` (``reads``, ``quals``) against
        haplotype ``hidx[k]`` (``haps``, ``hap_pds``); without indices the
        lists hold one entry per pair.  The ``pdhmm`` counter runs from here
        until just before the validity check."""
        t0 = time.perf_counter()
        planes = _Planes(haps, hap_pds, reads, quals)
        if ridx is None:
            ridx = hidx = np.arange(len(haps))
        level = self.args.kernel_level
        inv = None
        if self.args.use_double_precision or level == KernelLevel.SCALAR:
            out = self._oracle(*planes.pairs(ridx, hidx))
        else:
            devices = self._shards.devices
            if level == KernelLevel.PALLAS and any(d.type != "cuda" for d in devices):
                # an explicit engine that cannot run raises, as the
                # reference does for an unavailable AVX level
                # (pdhmm-implementation.h:96-133)
                raise RuntimeError(
                    f"KernelLevel.PALLAS requested but no PDHMM kernel runs on "
                    f"devices {[str(d) for d in devices]}")
            out, inv = self._compute_f32(planes, ridx, hidx, on)
        with profiling.span("pdhmm_finalize", on):
            if inv is not None:
                out = out[inv]
            if on:
                profiling.METRICS.record(
                    "pdhmm", items=len(ridx), cells=planes.cells(ridx, hidx),
                    seconds=time.perf_counter() - t0)
            # validity (pdhmm-serial.cc:432-442): log10 probabilities are <= 0
            bad = ~np.isfinite(out) & ~np.isneginf(out) | (out > 0.0)
            if np.any(bad):
                raise RuntimeError(
                    f"PDHMM produced invalid log10 probabilities at indices "
                    f"{np.nonzero(bad)[0][:10]}")
        return out

    def _compute_f32(self, planes: _Planes, ridx: np.ndarray, hidx: np.ndarray, on: bool):
        """The f32 engine's log10 likelihoods in its lane order, and the
        permutation back to the pairs' order."""
        n = len(ridx)
        with profiling.span("pdhmm_plan", on, items=n):
            # lanes grouped by their haplotype's first PD-event column, then
            # by its bytes, as the JAX package plans them: the key is taken
            # once a unique haplotype, and a stable sort of the lanes by its
            # rank keeps the pairs' order within a group; results go back
            # through the permutation
            keys = [(pdhmm_ops.lane_event_key(pd), h.tobytes(), pd.tobytes())
                    for h, pd in zip(planes.haps, planes.hap_pds)]
            ranks = {k: r for r, k in enumerate(sorted(set(keys)))}
            rank = np.fromiter(map(ranks.__getitem__, keys), np.int64, count=len(keys))
            order = np.argsort(rank[hidx], kind="stable")
            ridx, hidx = ridx[order], hidx[order]
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
            parts = self._slices(ridx, hidx, planes, "float32")
        ctx = pdhmm_context("float32")
        out = np.zeros(n, np.float64)
        for sl in parts:
            raw = self._run_indexed(ridx[sl], hidx[sl], planes, on)
            with profiling.span("pdhmm_finalize", on, items=len(raw)):
                with np.errstate(divide="ignore", invalid="ignore"):
                    res = (np.log10(raw) - ctx.INITIAL_CONDITION_LOG10).astype(np.float64)
                # every lane below MIN_ACCEPTED reruns on the kernel's f64
                # instance, with gradual underflow (the f32 instance flushes
                # subnormals); a NaN (a malformed lane) is not below it and
                # fails the validity check
                ks = np.nonzero(raw < MIN_ACCEPTED)[0]
                if len(ks):
                    ids = ks + sl.start
                    with profiling.span("pdhmm_rescue", on, items=len(ks)) as s:
                        res[ks] = self._rescue(ridx[ids], hidx[ids], planes)
                        if on:
                            s.cells = planes.cells(ridx[ids], hidx[ids])
                            profiling.METRICS.record("pdhmm_card_rescue", items=len(ks))
                out[sl] = res
        return out, inv

    def compute_pdhmm(self, hap_bases, hap_pdbases, read_bases, read_qual, read_ins_qual,
                      read_del_qual, gcp, hap_lengths, read_lengths,
                      batch_size: int | None = None, max_hap_length: int | None = None,
                      max_read_length: int | None = None) -> np.ndarray:
        """Flat-array path (IntelPDHMM.java:163-204): flat 1-D arrays of
        length batch*maxLen (the Java layout) or 2-D (batch, maxLen)."""
        hap_lengths = np.asarray(hap_lengths, np.int64)
        read_lengths = np.asarray(read_lengths, np.int64)
        t = batch_size if batch_size is not None else len(hap_lengths)
        if t <= 0:
            raise ValueError("batchSize must be positive")

        def to2d(x, maxlen, name):
            x = np.asarray(x)
            if x.ndim == 2:
                if x.shape[0] != t:
                    raise ValueError(f"{name} has {x.shape[0]} rows, expected batchSize = {t}")
                if maxlen is not None and x.shape[1] != maxlen:
                    raise ValueError(
                        f"{name} has width {x.shape[1]}, expected maxLength = {maxlen}")
                return x.astype(np.uint8)
            if maxlen is None:
                if x.size % t:
                    raise ValueError(f"{name} length {x.size} is not a multiple of batchSize {t}")
                maxlen = x.size // t
            if x.size != t * maxlen:
                raise ValueError(
                    f"{name} has {x.size} elements, expected batchSize*maxLength = {t * maxlen}")
            return x.reshape(t, maxlen).astype(np.uint8)

        hap2 = to2d(hap_bases, max_hap_length, "hap_bases")
        pd2 = to2d(hap_pdbases, hap2.shape[1], "hap_pdbases")
        read2 = to2d(read_bases, max_read_length, "read_bases")
        q2 = to2d(read_qual, read2.shape[1], "read_qual")
        iq2 = to2d(read_ins_qual, read2.shape[1], "read_ins_qual")
        dq2 = to2d(read_del_qual, read2.shape[1], "read_del_qual")
        g2 = to2d(gcp, read2.shape[1], "gcp")
        if len(hap_lengths) != t or len(read_lengths) != t:
            raise ValueError("hap_lengths/read_lengths must have batchSize elements")
        if np.any(hap_lengths <= 0) or np.any(read_lengths <= 0):
            raise ValueError("sequence lengths must be positive")
        if np.any(hap_lengths > hap2.shape[1]) or np.any(read_lengths > read2.shape[1]):
            raise ValueError("per-pair length exceeds the padded max length")

        haps = [hap2[i, :hap_lengths[i]] for i in range(t)]
        pds = [pd2[i, :hap_lengths[i]] for i in range(t)]
        reads = [read2[i, :read_lengths[i]] for i in range(t)]
        quals = [(q2[i, :read_lengths[i]], iq2[i, :read_lengths[i]],
                  dq2[i, :read_lengths[i]], g2[i, :read_lengths[i]]) for i in range(t)]
        return self._compute_pairs(haps, pds, reads, quals, profiling.metrics_enabled())

    def compute_likelihoods(self, reads: Sequence[ReadData],
                            haplotypes: Sequence[PDHaplotypeData],
                            likelihoods: np.ndarray | None = None) -> np.ndarray:
        """Object path: read-major cross product (pdhmm/JavaData.h:186-236)."""
        if not reads or not haplotypes:
            raise ValueError("Input arrays are empty.")
        on = profiling.metrics_enabled()
        with profiling.span("pdhmm_plan", on, items=len(reads) * len(haplotypes)):
            # the cross product as indices into the unique planes: objects
            # that share their arrays share a column
            ru, rsel = _by_identity(list(map(_READ_PLANES, reads)))
            hu, hsel = _by_identity(list(map(_HAP_PLANES, haplotypes)))
            ridx = np.repeat(rsel, len(haplotypes))
            hidx = np.tile(hsel, len(reads))
            haps, pds = zip(*hu)
            rds = [p[0] for p in ru]
            quals = [p[1:] for p in ru]
        out = self._compute_pairs(haps, pds, rds, quals, on, ridx, hidx)
        if likelihoods is not None:
            likelihoods[:len(out)] = out
            return likelihoods
        return out
