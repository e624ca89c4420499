"""PDHMM public API — counterpart of ``gkl_tpu/api_pdhmm.py``.

Parity with IntelPDHMM (``pdhmm/IntelPDHMM.java:46-220``):

* :meth:`PDHMM.compute_pdhmm` — flat batch arrays plus per-pair lengths,
  mirroring ``computePDHMM`` (IntelPDHMM.java:163-204) and its size checks;
* :meth:`PDHMM.compute_likelihoods` — the object path over reads x
  haplotypes (read-major cross product, pdhmm/JavaData.h:186-236).

Engines: on ``PDHMM.device`` (CUDA by default) the float32 CUDA kernel
``csrc/pdhmm.cu`` over deduplicated, memory-budgeted lane slices, with
every lane below ``MIN_ACCEPTED`` recomputed on the host's exact f64 oracle
(``gkl_tpu_torch/native/pdhmm_oracle.cc``, a byte-identical copy of
``gkl_tpu/native/pdhmm_oracle.cc``) — the reference's
float-then-double pattern (pairhmm/IntelPairHmm.cc:157-165).  With
``device="cpu"`` the kernel's plain twin takes its place.  The
double-precision mode and ``KernelLevel.SCALAR`` run the oracle alone.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from . import batch as batch_mod
from . import native_lib, profiling
from .api import HaplotypeData, ReadData
from .context import MIN_ACCEPTED, pdhmm_context
from .ops import pdhmm as pdhmm_ops
from .ops import pdhmm_cuda, pdhmm_ref


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

    FASTEST_AVAILABLE and PALLAS run the CUDA kernel on a CUDA device
    (the plain twin on ``device="cpu"``); PALLAS raises where no kernel can
    run.  SCALAR runs the native serial f64 oracle, the reference's scalar
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


class PDHMM:
    """PDHMM forward-likelihood engine (IntelPDHMM)."""

    def __init__(self, args: PDHMMNativeArguments | None = None, *,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
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

    def _run_indexed(self, haps, hap_pds, reads, quals):
        """One lane slice through the f32 engine: deduplicate the planes by
        object identity (the object path shares one array per read and per
        haplotype, pdhmm/JavaData.h:186-236), pack, run the kernel (or its
        twin) and return the raw (n,) f32 results."""
        hmap: dict = {}
        rmap: dict = {}
        uh, uhpd, ur, urq, hidx, ridx = [], [], [], [], [], []
        for h, pd, r, qs in zip(haps, hap_pds, reads, quals):
            hk = (id(h), id(pd))
            rk = (id(r),) + tuple(id(a) for a in qs)
            if hk not in hmap:
                hmap[hk] = len(uh)
                uh.append(h)
                uhpd.append(pd)
            if rk not in rmap:
                rmap[rk] = len(ur)
                ur.append(r)
                urq.append(qs)
            hidx.append(hmap[hk])
            ridx.append(rmap[rk])
        pk = batch_mod.pack_pdhmm_indexed(uh, uhpd, ur, urq, ridx, hidx)
        names = ("hap_u", "happd_u", "readq_u", "ridx", "hidx", "haplen", "rslen")
        dev = {k: torch.from_numpy(np.ascontiguousarray(getattr(pk, k))).to(self.device)
               for k in names}
        return pdhmm_cuda.pdhmm(**dev).cpu().numpy()[:pk.n_real]

    def _oracle(self, haps, hap_pds, reads, quals) -> np.ndarray:
        return pdhmm_ref.pdhmm_scalar_batch(haps, hap_pds, reads, quals,
                                            threads=self._effective_threads())

    def _compute_pairs(self, haps: Sequence[np.ndarray], hap_pds: Sequence[np.ndarray],
                       reads: Sequence[np.ndarray], quals: Sequence[tuple]) -> np.ndarray:
        metrics_on = profiling.metrics_enabled()
        t0 = time.perf_counter()
        n = len(haps)
        level = self.args.kernel_level
        if self.args.use_double_precision or level == KernelLevel.SCALAR:
            out = self._oracle(haps, hap_pds, reads, quals)
        else:
            if level == KernelLevel.PALLAS and self.device.type != "cuda":
                # an explicit engine that cannot run raises, as the
                # reference does for an unavailable AVX level
                # (pdhmm-implementation.h:96-133)
                raise RuntimeError(
                    f"KernelLevel.PALLAS requested but no PDHMM kernel runs on "
                    f"device {self.device}")
            out = self._compute_f32(haps, hap_pds, reads, quals, metrics_on)
        if metrics_on:
            profiling.METRICS.record(
                "pdhmm", items=n, cells=sum(len(r) * len(h) for r, h in zip(reads, haps)),
                seconds=time.perf_counter() - t0)
        # validity (pdhmm-serial.cc:432-442): log10 probabilities are <= 0
        bad = ~np.isfinite(out) & ~np.isneginf(out) | (out > 0.0)
        if np.any(bad):
            raise RuntimeError(
                f"PDHMM produced invalid log10 probabilities at indices {np.nonzero(bad)[0][:10]}")
        return out

    def _compute_f32(self, haps, hap_pds, reads, quals, metrics_on) -> np.ndarray:
        n = len(haps)
        # lanes grouped by their first PD-event column, then by haplotype,
        # as the JAX package plans them; results go back through the
        # permutation
        order = sorted(range(n), key=lambda i: (
            pdhmm_ops.lane_event_key(hap_pds[i]), haps[i].tobytes(), hap_pds[i].tobytes()))
        haps = [haps[i] for i in order]
        hap_pds = [hap_pds[i] for i in order]
        reads = [reads[i] for i in order]
        quals = [quals[i] for i in order]
        inv = np.empty(n, np.int64)
        inv[np.asarray(order)] = np.arange(n)
        # memory-budgeted lane slicing (pdhmm/JavaData.h:83-97), taken in
        # permuted order.  Per lane the kernel takes at most one unique read
        # (5 planes) and haplotype (bases and PD bytes), four i32 indices,
        # and, when the read bucket needs more than one pass, its pass
        # boundary (six f32 planes along the haplotype axis); the JAX
        # package's formula counts the TPU's state on the read axis instead
        max_r = batch_mod.bucket_length(max(len(r) for r in reads))
        max_h = batch_mod.bucket_length(max(len(h) for h in haps))
        bytes_per_lane = (pdhmm_cuda.boundary_bytes_per_lane(max_r, max_h)
                          + 5 * max_r + 2 * max_h + 16)
        lm = batch_mod.LANE_MULTIPLE
        # whole lane-padding units, so a padded slice stays within the budget
        max_lanes = max(lm, self.args.max_memory_in_mb * 1024 * 1024 // bytes_per_lane // lm * lm)
        ctx = pdhmm_context("float32")
        out = np.zeros(n, np.float64)
        for start in range(0, n, max_lanes):
            sl = slice(start, min(n, start + max_lanes))
            raw = self._run_indexed(haps[sl], hap_pds[sl], reads[sl], quals[sl])
            with np.errstate(divide="ignore", invalid="ignore"):
                res = (np.log10(raw) - ctx.INITIAL_CONDITION_LOG10).astype(np.float64)
            # every lane below MIN_ACCEPTED reruns on the exact f64 oracle,
            # with gradual underflow (the device flushes subnormals); a NaN
            # (a malformed lane) is not below it and fails the validity check
            ks = np.nonzero(raw < MIN_ACCEPTED)[0]
            if len(ks):
                t0 = time.perf_counter()
                ids = ks + start
                res[ks] = self._oracle([haps[i] for i in ids], [hap_pds[i] for i in ids],
                                       [reads[i] for i in ids], [quals[i] for i in ids])
                if metrics_on:
                    profiling.METRICS.record(
                        "pdhmm_rescue", items=len(ks),
                        cells=sum(len(reads[i]) * len(haps[i]) for i in ids),
                        seconds=time.perf_counter() - t0)
            out[sl] = res
        return out[inv]

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
        return self._compute_pairs(haps, pds, reads, quals)

    def compute_likelihoods(self, reads: Sequence[ReadData],
                            haplotypes: Sequence[PDHaplotypeData],
                            likelihoods: np.ndarray | None = None) -> np.ndarray:
        """Object path: read-major cross product (pdhmm/JavaData.h:186-236)."""
        if not reads or not haplotypes:
            raise ValueError("Input arrays are empty.")
        haps, pds, rds, quals = [], [], [], []
        for rd in reads:
            for hp in haplotypes:
                haps.append(hp.haplotype_bases)
                pds.append(hp.haplotype_pdbases)
                rds.append(rd.read_bases)
                quals.append((rd.read_quals, rd.insertion_gop, rd.deletion_gop,
                              rd.overall_gcp))
        out = self._compute_pairs(haps, pds, rds, quals)
        if likelihoods is not None:
            likelihoods[:len(out)] = out
            return likelihoods
        return out
