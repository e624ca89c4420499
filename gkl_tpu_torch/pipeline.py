"""Streaming pipelines: BAM blocks -> host codec -> batch planner -> GPU.

Counterpart of ``gkl_tpu/pipeline.py``:

1. a producer thread inflates BGZF blocks on the native codec and decodes
   and filters records (``bgzf.iter_decompressed``, ``bam.RecordDecoder``)
   into chunks on a bounded queue;
2. the main thread turns each chunk into ``ReadData`` (GATK's input
   normalisation: base quals clamped >= 6, constant GOPs) and dispatches it
   with ``PairHMM.compute_likelihoods_async``;
3. results resolve two chunks behind the dispatch, so chunk N's kernels
   run while chunk N+1 decodes and packs.

:func:`region_stream` composes the three kernels of GATK's active-region
flow on that stream: PairHMM, then Smith-Waterman realignment of each read
against its best haplotype, then optionally PDHMM against partially
determined haplotypes; :func:`sw_align_stream` realigns a BAM's reads
against one reference window; :func:`bam_recompress` streams a BAM through
decode, re-encode and the parallel BGZF deflate.

Stage times land in ``profiling.METRICS`` when metrics are on:
``pipeline_wait`` (the wait for the producer's next chunk) and
``pipeline_dispatch`` (``ReadData`` and the PairHMM dispatch) on the
caller's thread; ``pipeline_inflate`` (each batch of BGZF members) and
``pipeline_decode`` (record parsing, filtering and chunking) on the
producer's.  The engines record their own calls and stages.
"""

from __future__ import annotations

import collections
import dataclasses
import queue as queue_mod
import threading
from typing import Iterable, Iterator, Sequence

import numpy as np

from . import bam as bam_mod
from . import profiling
from .compression import bgzf
from .api import HaplotypeData, PairHMM, ReadData
from .api_pdhmm import PDHMM
from .api_sw import OverhangStrategy, SmithWaterman, SWParameters

MIN_BASE_QUAL = 6  # GATK clamps read quals below 6 (PairHmmUnitTest.java:317)


@dataclasses.dataclass
class ChunkResult:
    read_names: list[str]
    likelihoods: np.ndarray  # (n_reads, n_haplotypes) log10


@dataclasses.dataclass
class RegionChunkResult:
    """One chunk of the composed active-region pipeline."""

    read_names: list[str]
    likelihoods: np.ndarray        # (n_reads, n_haps) PairHMM log10
    best_haplotype: np.ndarray     # (n_reads,) argmax over haplotypes
    cigars: list[str]              # SW realignment of read vs its best hap
    offsets: np.ndarray            # (n_reads,) SW alignment offsets
    pd_likelihoods: np.ndarray | None  # (n_reads, n_pd_haps) PDHMM log10


# GATK's haplotype-to-reference scores (SmithWatermanAlignmentConstants
# NEW_SW_PARAMETERS: match 200, mismatch -150, open -260, extend -11), as
# the JAX package's region_stream uses them; HaplotypeCaller realigns reads
# to haplotypes with 10, -15, -30, -5
DEFAULT_SW_PARAMETERS = SWParameters(200, -150, -260, -11)


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


def _is_filtered(rec: bam_mod.BamRecord) -> bool:
    """Secondary, supplementary and unmapped records (GATK's
    HaplotypeCaller read filters, approximated)."""
    return bool(rec.flag & (bam_mod.FLAG_UNMAPPED | bam_mod.FLAG_SECONDARY
                            | bam_mod.FLAG_SUPPLEMENTARY))


def _chunk_producer(bam_path: str, *, chunk_reads: int, limit: int | None,
                    include_filtered: bool, threads: int | None,
                    prefetch: int, on: bool):
    """Start the producer thread: decodes and filters records into
    ``chunk_reads``-sized batches on a bounded queue.  Returns (queue,
    stop_event); the consumer sets the event when it stops reading, so the
    thread cannot stay blocked on a full queue.  ``on``: the caller's
    metrics switch."""
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
            chunks = bgzf.iter_decompressed(bam_path, threads=threads)
            dec = bam_mod.RecordDecoder(limit)
            batch: list[bam_mod.BamRecord] = []
            while not dec.done:
                with profiling.span("pipeline_inflate", on) as s:
                    chunk = next(chunks, None)
                    s.items = len(chunk) if chunk is not None else 0
                if chunk is None:
                    dec.finish()
                    break
                full = []
                with profiling.span("pipeline_decode", on) as s:
                    recs = dec.feed(chunk)
                    s.items = len(recs)
                    for rec in recs:
                        if not include_filtered and _is_filtered(rec):
                            continue
                        if len(rec.seq) == 0:
                            # '*'-sequence records can never go through PairHMM
                            continue
                        batch.append(rec)
                        if len(batch) >= chunk_reads:
                            full.append(batch)
                            batch = []
                for b in full:
                    if not _put(("chunk", b)):
                        return
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
    on = profiling.metrics_enabled()
    q, stop = _chunk_producer(bam_path, chunk_reads=chunk_reads, limit=limit,
                              include_filtered=include_filtered,
                              threads=threads, prefetch=prefetch, on=on)
    nh = len(haplotypes)
    pending: collections.deque = collections.deque()

    def resolve(entry) -> ChunkResult:
        names, nr, handle = entry
        return ChunkResult(names, np.asarray(handle.result()).reshape(nr, nh))

    try:
        while True:
            with profiling.span("pipeline_wait", on, items=1):
                kind, payload = q.get()
            if kind == "error":
                raise payload
            if kind == "done":
                break
            records = payload
            with profiling.span("pipeline_dispatch", on, items=len(records)):
                reads = reads_from_records(records)
                handle = hmm.compute_likelihoods_async(reads, haplotypes)
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



def sw_align_stream(bam_path: str, reference, parameters: SWParameters | None = None,
                    strategy=None, *, chunk_reads: int = 512, limit: int | None = None,
                    threads: int | None = None, sw: SmithWaterman | None = None):
    """Stream a BAM's reads through the Smith-Waterman engine against one
    reference window, yielding (read_names, [SWAlignerResult]) per chunk —
    the assembly-region realignment pattern (reads re-aligned to an
    assembled haplotype or reference with IntelSmithWaterman).  ``sw``
    defaults to ``SmithWaterman()`` on CUDA."""
    parameters = parameters or DEFAULT_SW_PARAMETERS
    strategy = OverhangStrategy.SOFTCLIP if strategy is None else strategy
    if isinstance(reference, (bytes, bytearray)):
        reference = np.frombuffer(bytes(reference), np.uint8)
    sw = sw or SmithWaterman()
    _, record_iter = bam_mod.read_bam_streaming(bam_path, limit=limit, threads=threads)

    def align(batch):
        res = sw.align_batch([reference] * len(batch), [r.seq for r in batch],
                             parameters, strategy)
        return [r.name for r in batch], res

    batch: list[bam_mod.BamRecord] = []
    for rec in record_iter:
        if _is_filtered(rec) or len(rec.seq) == 0:
            continue
        batch.append(rec)
        if len(batch) >= chunk_reads:
            yield align(batch)
            batch = []
    if batch:
        yield align(batch)


def region_stream(
    bam_path: str,
    haplotypes: Sequence[HaplotypeData],
    *,
    pd_haplotypes: Sequence | None = None,
    sw_parameters: SWParameters | None = None,
    sw_strategy=None,
    chunk_reads: int = 1024,
    limit: int | None = None,
    include_filtered: bool = False,
    hmm: PairHMM | None = None,
    sw: SmithWaterman | None = None,
    pdhmm: PDHMM | None = None,
    threads: int | None = None,
    prefetch: int = 3,
) -> Iterator[RegionChunkResult]:
    """The composed active-region pipeline: one BAM stream drives the three
    kernels in the order of GATK's active-region flow:

    1. PairHMM scores every read against every haplotype (dispatched
       without waiting, resolved two chunks behind);
    2. each read is Smith-Waterman realigned against its best-scoring
       haplotype, giving CIGAR and offset;
    3. with ``pd_haplotypes``, PDHMM scores the reads against the
       partially determined haplotypes (DRAGEN-GATK's PDHMM mode).

    Yields one RegionChunkResult per chunk.  The engines default to
    ``PairHMM()``, ``SmithWaterman()`` and ``PDHMM()`` on CUDA.
    """
    hmm = hmm or PairHMM()
    sw = sw or SmithWaterman()
    haplotypes = list(haplotypes)
    hap_seqs = [np.asarray(h.haplotype_bases, np.uint8) for h in haplotypes]
    sw_parameters = sw_parameters or DEFAULT_SW_PARAMETERS
    sw_strategy = OverhangStrategy.SOFTCLIP if sw_strategy is None else sw_strategy
    if pd_haplotypes is not None:
        pd_haplotypes = list(pd_haplotypes)
        pdhmm = pdhmm or PDHMM()
    on = profiling.metrics_enabled()
    q, stop = _chunk_producer(bam_path, chunk_reads=chunk_reads, limit=limit,
                              include_filtered=include_filtered,
                              threads=threads, prefetch=prefetch, on=on)
    nh = len(haplotypes)
    pending: collections.deque = collections.deque()

    def resolve(entry) -> RegionChunkResult:
        records, reads, handle = entry
        lik = np.asarray(handle.result()).reshape(len(reads), nh)
        best = np.argmax(lik, axis=1)
        aligned = sw.align_batch([hap_seqs[b] for b in best], [r.read_bases for r in reads],
                                 sw_parameters, sw_strategy)
        pd_lik = None
        if pd_haplotypes is not None:
            pd_lik = np.asarray(pdhmm.compute_likelihoods(reads, pd_haplotypes)).reshape(
                len(reads), len(pd_haplotypes))
        return RegionChunkResult(
            read_names=[r.name for r in records], likelihoods=lik, best_haplotype=best,
            cigars=[a.cigar for a in aligned],
            offsets=np.asarray([a.alignment_offset for a in aligned]),
            pd_likelihoods=pd_lik)

    try:
        while True:
            with profiling.span("pipeline_wait", on, items=1):
                kind, payload = q.get()
            if kind == "error":
                raise payload
            if kind == "done":
                break
            records = payload
            with profiling.span("pipeline_dispatch", on, items=len(records)):
                reads = reads_from_records(records)
                handle = hmm.compute_likelihoods_async(reads, haplotypes)
            pending.append((records, reads, handle))
            while len(pending) > 2:
                yield resolve(pending.popleft())
        while pending:
            yield resolve(pending.popleft())
    finally:
        stop.set()


def region_bam(bam_path: str, haplotypes: Sequence[HaplotypeData],
               **kw) -> RegionChunkResult:
    """Non-streaming convenience: whole BAM -> one concatenated region result."""
    chunks = list(region_stream(bam_path, haplotypes, **kw))
    pd = [c.pd_likelihoods for c in chunks if c.pd_likelihoods is not None]
    return RegionChunkResult(
        read_names=[n for c in chunks for n in c.read_names],
        likelihoods=(np.concatenate([c.likelihoods for c in chunks])
                     if chunks else np.zeros((0, len(haplotypes)))),
        best_haplotype=(np.concatenate([c.best_haplotype for c in chunks])
                        if chunks else np.zeros((0,), np.int64)),
        cigars=[g for c in chunks for g in c.cigars],
        offsets=(np.concatenate([c.offsets for c in chunks])
                 if chunks else np.zeros((0,), np.int64)),
        pd_likelihoods=np.concatenate(pd) if pd else None)


def bam_recompress(src_path: str, dst_path: str, *, level: int = 6,
                   threads: int | None = None, limit: int | None = None,
                   window_blocks: int = 64) -> int:
    """Stream a BAM through decode -> re-encode -> parallel BGZF deflate in
    bounded memory: the read side inflates incrementally
    (``read_bam_streaming``) while the write side batches the records into
    maximal BGZF blocks for the native deflate pool
    (``write_bam_streaming``), the DeflaterIntegrationTest loop
    (DeflaterIntegrationTest.java:27-99) as a pipeline stage.  Records are
    read with ``keep_raw=True`` and re-emitted byte for byte, so tags, mate
    fields and bin survive.  Returns the record count."""
    header, records = bam_mod.read_bam_streaming(src_path, limit=limit, threads=threads,
                                                 keep_raw=True)
    return bam_mod.write_bam_streaming(dst_path, header, records, level=level,
                                       threads=threads, window_blocks=window_blocks)
