"""Streaming PairHMM pipeline: BAM blocks -> host codec -> batch planner -> GPU.

Counterpart of the PairHMM part of ``gkl_tpu/pipeline.py``:

1. a producer thread inflates BGZF blocks on the native codec and decodes
   and filters records (``bam.read_bam_streaming``) into chunks on a
   bounded queue;
2. the main thread turns each chunk into ``ReadData`` (GATK's input
   normalisation: base quals clamped >= 6, constant GOPs) and dispatches it
   with ``PairHMM.compute_likelihoods_async``;
3. results resolve two chunks behind the dispatch, so chunk N's kernels
   run while chunk N+1 decodes and packs.

Stage times land in ``profiling.METRICS`` (pipeline_wait,
pipeline_dispatch, pipeline_resolve) when metrics are on.
"""

from __future__ import annotations

import collections
import dataclasses
import queue as queue_mod
import threading
import time
from typing import Iterable, Iterator, Sequence

import numpy as np

from . import bam as bam_mod
from . import profiling
from .api import HaplotypeData, PairHMM, ReadData

MIN_BASE_QUAL = 6  # GATK clamps read quals below 6 (PairHmmUnitTest.java:317)


@dataclasses.dataclass
class ChunkResult:
    read_names: list[str]
    likelihoods: np.ndarray  # (n_reads, n_haplotypes) log10


def reads_from_records(records: Iterable[bam_mod.BamRecord],
                       default_gcp: int = 10) -> list[ReadData]:
    """BamRecords -> ReadData with GATK-style qual normalisation.

    BAM has no per-base indel GOPs; like GATK's default PairHMM inputs the
    insertion/deletion GOPs are 45 and the gap continuation penalty is
    ``default_gcp``.  The constant planes are shared by reads of one length
    (read-only downstream).
    """
    gop_cache: dict[int, np.ndarray] = {}
    gcp_cache: dict[int, np.ndarray] = {}
    out = []
    for rec in records:
        q = np.maximum(rec.qual, MIN_BASE_QUAL).astype(np.uint8)
        n = len(rec.seq)
        gop = gop_cache.get(n)
        if gop is None:
            gop = gop_cache[n] = np.full(n, 45, np.uint8)
            gcp_cache[n] = np.full(n, default_gcp, np.uint8)
        out.append(ReadData(read_bases=rec.seq, read_quals=q, insertion_gop=gop,
                            deletion_gop=gop, overall_gcp=gcp_cache[n]))
    return out


def _chunk_producer(bam_path: str, *, chunk_reads: int, limit: int | None,
                    include_filtered: bool, threads: int | None,
                    prefetch: int):
    """Start the producer thread: decodes and filters records into
    ``chunk_reads``-sized batches on a bounded queue.  Returns (queue,
    stop_event); the consumer sets the event when it stops reading, so the
    thread cannot stay blocked on a full queue."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            _, record_iter = bam_mod.read_bam_streaming(
                bam_path, limit=limit, threads=threads)
            batch: list[bam_mod.BamRecord] = []
            for rec in record_iter:
                if not include_filtered and rec.flag & (
                    bam_mod.FLAG_UNMAPPED
                    | bam_mod.FLAG_SECONDARY
                    | bam_mod.FLAG_SUPPLEMENTARY
                ):
                    continue
                if len(rec.seq) == 0:
                    # '*'-sequence records can never go through PairHMM
                    continue
                batch.append(rec)
                if len(batch) >= chunk_reads:
                    if not _put(("chunk", batch)):
                        return
                    batch = []
            if batch and not _put(("chunk", batch)):
                return
            _put(("done", None))
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            _put(("error", e))

    threading.Thread(target=producer, daemon=True).start()
    return q, stop


def pairhmm_stream(
    bam_path: str,
    haplotypes: Sequence[HaplotypeData],
    *,
    chunk_reads: int = 1024,
    limit: int | None = None,
    include_filtered: bool = False,
    hmm: PairHMM | None = None,
    threads: int | None = None,
    prefetch: int = 3,
) -> Iterator[ChunkResult]:
    """Stream a BAM through the PairHMM engine against ``haplotypes``.

    Yields one ChunkResult per ``chunk_reads`` reads.  Secondary,
    supplementary and unmapped reads are skipped unless
    ``include_filtered`` (GATK's HaplotypeCaller read filters,
    approximated).  ``hmm`` defaults to ``PairHMM()`` on CUDA.
    """
    hmm = hmm or PairHMM()
    haplotypes = list(haplotypes)
    q, stop = _chunk_producer(bam_path, chunk_reads=chunk_reads, limit=limit,
                              include_filtered=include_filtered,
                              threads=threads, prefetch=prefetch)
    metrics_on = profiling.metrics_enabled()
    nh = len(haplotypes)
    pending: collections.deque = collections.deque()

    def resolve(entry) -> ChunkResult:
        names, nr, handle = entry
        t0 = time.perf_counter()
        res = ChunkResult(names, np.asarray(handle.result()).reshape(nr, nh))
        if metrics_on:
            profiling.METRICS.record("pipeline_resolve", items=nr,
                                     seconds=time.perf_counter() - t0)
        return res

    try:
        while True:
            t0 = time.perf_counter()
            kind, payload = q.get()
            if metrics_on:
                profiling.METRICS.record("pipeline_wait", items=1,
                                         seconds=time.perf_counter() - t0)
            if kind == "error":
                raise payload
            if kind == "done":
                break
            records = payload
            t0 = time.perf_counter()
            reads = reads_from_records(records)
            handle = hmm.compute_likelihoods_async(reads, haplotypes)
            if metrics_on:
                profiling.METRICS.record("pipeline_dispatch", items=len(reads),
                                         seconds=time.perf_counter() - t0)
            pending.append(([r.name for r in records], len(reads), handle))
            # resolve two chunks behind: chunk N dispatches while N-1
            # computes and N-2's results come back
            while len(pending) > 2:
                yield resolve(pending.popleft())
        while pending:
            yield resolve(pending.popleft())
    finally:
        stop.set()


def pairhmm_bam(bam_path: str, haplotypes: Sequence[HaplotypeData],
                **kw) -> ChunkResult:
    """Non-streaming convenience: whole BAM -> one concatenated result."""
    names: list[str] = []
    liks: list[np.ndarray] = []
    for chunk in pairhmm_stream(bam_path, haplotypes, **kw):
        names.extend(chunk.read_names)
        liks.append(chunk.likelihoods)
    return ChunkResult(names, np.concatenate(liks, axis=0) if liks
                       else np.zeros((0, len(haplotypes))))
