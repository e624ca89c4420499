"""Driving the port: its engines, the pool's regions as its calls take them,
the two entries (the three calls GATK makes for an active region, and
``pipeline.region_stream`` over the region written as a BAM), the spans the
benchmark records around every call into the port, and the closed loop.

Only this module and ``session`` import the program, and only inside
functions, so that the rest of the benchmark imports without it."""

from __future__ import annotations

import contextlib
import dataclasses
import time
import traceback

import numpy as np
import torch

from . import roofline

CALLS = ("pairhmm", "sw", "pdhmm")


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    reads: int
    least_s: float = 0.0


class Spans:
    """Host-clock spans around calls into the port.  With ``annotate`` each
    span is also a ``torch.profiler.record_function`` of the same name and
    carries the least time of its call's work (``roofline``)."""

    def __init__(self, annotate: bool = False):
        self.items: list[Span] = []
        self.annotate = annotate

    @contextlib.contextmanager
    def span(self, name: str, reads: int):
        s = Span(name, 0.0, 0.0, reads)
        mark = (torch.profiler.record_function(name) if self.annotate
                else contextlib.nullcontext())
        with mark:
            s.t0 = time.perf_counter()
            try:
                yield s
            finally:
                s.t1 = time.perf_counter()
        self.items.append(s)


def _lengths(reads):
    return [len(r.read_bases) for r in reads]


class PairHMMCalls:
    """``PairHMM`` behind spans: the synchronous call, and the asynchronous
    one whose dispatch and ``result()`` are each a span (``region_stream``).
    ``double``: the deployment runs it in float64, so its least time is
    read at the FP64 peak."""

    def __init__(self, hmm, spans: Spans, double: bool = False):
        self.hmm, self.spans, self.double = hmm, spans, double

    def _least(self, s, reads, haps):
        if self.spans.annotate:
            s.least_s = roofline.pairhmm_s(_lengths(reads), [len(h.haplotype_bases) for h in haps],
                                           double=self.double)

    def compute_likelihoods(self, reads, haps):
        with self.spans.span("pairhmm", len(reads)) as s:
            out = self.hmm.compute_likelihoods(reads, haps)
            self._least(s, reads, haps)
        return out

    def compute_likelihoods_async(self, reads, haps):
        with self.spans.span("pairhmm", len(reads)) as s:
            pending = self.hmm.compute_likelihoods_async(reads, haps)
            self._least(s, reads, haps)
        return _PendingCall(pending, self.spans)


class _PendingCall:
    def __init__(self, pending, spans: Spans):
        self.pending, self.spans = pending, spans

    def result(self):
        with self.spans.span("pairhmm", 0):
            return self.pending.result()


class SWCalls:
    def __init__(self, sw, spans: Spans):
        self.sw, self.spans = sw, spans

    def align_batch(self, refs, alts, parameters, strategy):
        with self.spans.span("sw", len(alts)) as s:
            out = self.sw.align_batch(refs, alts, parameters, strategy)
            if self.spans.annotate:
                s.least_s = roofline.sw_s([len(r) for r in refs], [len(a) for a in alts],
                                          [len(a.cigar) for a in out])
        return out


class PDHMMCalls:
    """``PDHMM`` behind a span; ``double`` as in ``PairHMMCalls``."""

    def __init__(self, pdhmm, spans: Spans, double: bool = False):
        self.pdhmm, self.spans, self.double = pdhmm, spans, double

    def compute_likelihoods(self, reads, pd_haps):
        with self.spans.span("pdhmm", len(reads)) as s:
            out = self.pdhmm.compute_likelihoods(reads, pd_haps)
            if self.spans.annotate:
                s.least_s = roofline.pdhmm_s(_lengths(reads),
                                             [len(h.haplotype_bases) for h in pd_haps],
                                             double=self.double)
        return out


@dataclasses.dataclass
class Output:
    """What one region's calls returned."""
    lik: np.ndarray          # (reads, haplotypes) PairHMM log10
    best: np.ndarray         # (reads,) the haplotype SW realigned each read to
    cigars: list
    offsets: np.ndarray
    pd: np.ndarray           # (reads, PD haplotypes) PDHMM log10
    names: list | None = None  # read names as decoded (region_stream)

    def take(self, idx) -> "Output":
        return Output(self.lik[idx], self.best[idx], [self.cigars[i] for i in idx],
                      self.offsets[idx], self.pd[idx])


@dataclasses.dataclass
class Region:
    """A pool region as the port's calls take it."""
    reads: list
    haps: list
    pd_haps: list
    n_reads: int
    bam: str | None = None


def read_planes(seq, qual, config: dict) -> tuple:
    """GATK's PairHMM inputs of a read: bases, base qualities with every
    one below ``base_quality_score_threshold`` set to
    ``min_usable_base_quality``, and constant insertion, deletion and
    continuation penalties, each an array of the read's own."""
    n = len(seq)
    gop, gcp = config["gap_open_penalty"], config["gap_continuation_penalty"]
    q = np.where(qual < config["base_quality_score_threshold"],
                 config["min_usable_base_quality"], qual).astype(np.uint8)
    return (seq, q, np.full(n, gop, np.uint8), np.full(n, gop, np.uint8),
            np.full(n, gcp, np.uint8))


def port_region(raw: dict, config: dict) -> Region:
    """The generator's region as ``ReadData``, ``HaplotypeData`` and
    ``PDHaplotypeData``."""
    from gkl_tpu_torch import HaplotypeData, PDHaplotypeData, ReadData

    reads = [ReadData(*read_planes(seq, qual, config)) for seq, qual, _ in raw["reads"]]
    return Region(reads=reads, haps=[HaplotypeData(h) for h in raw["haps"]],
                  pd_haps=[PDHaplotypeData(h, haplotype_pdbases=p) for h, p in raw["pd_haps"]],
                  n_reads=len(reads))


def sw_setting(config: dict):
    from gkl_tpu_torch import OverhangStrategy, SWParameters

    return SWParameters(*config["sw_parameters"]), OverhangStrategy[config["sw_strategy"]]


def three_calls(engines, region: Region, config: dict, mix: dict) -> Output:
    """PairHMM over reads x haplotypes, SW of each read against its best
    haplotype, PDHMM over reads x PD haplotypes: one call each."""
    hmm, sw, pdhmm = engines
    nr = region.n_reads
    lik = np.asarray(hmm.compute_likelihoods(region.reads, region.haps)).reshape(nr, -1)
    best = np.argmax(lik, axis=1)
    aligned = sw.align_batch([region.haps[b].haplotype_bases for b in best],
                             [r.read_bases for r in region.reads], *sw_setting(config))
    pd = np.asarray(pdhmm.compute_likelihoods(region.reads, region.pd_haps)).reshape(nr, -1)
    return Output(lik, best, [a.cigar for a in aligned],
                  np.asarray([a.alignment_offset for a in aligned]), pd)


def region_stream(engines, region: Region, config: dict, mix: dict) -> Output:
    """``pipeline.region_stream`` over the region's BAM, chunk by chunk."""
    from gkl_tpu_torch import pipeline

    hmm, sw, pdhmm = engines
    params, strategy = sw_setting(config)
    chunks = list(pipeline.region_stream(
        region.bam, region.haps, pd_haplotypes=region.pd_haps, sw_parameters=params,
        sw_strategy=strategy, chunk_reads=mix["chunk_reads"], hmm=hmm, sw=sw, pdhmm=pdhmm))
    return Output(np.concatenate([c.likelihoods for c in chunks]),
                  np.concatenate([c.best_haplotype for c in chunks]),
                  [g for c in chunks for g in c.cigars],
                  np.concatenate([c.offsets for c in chunks]),
                  np.concatenate([c.pd_likelihoods for c in chunks]),
                  [n for c in chunks for n in c.read_names])


ENTRIES = {"three_calls": three_calls, "region_stream": region_stream}


@dataclasses.dataclass
class Done:
    region: int
    t0: float
    t1: float
    reads: int
    output: Output


@dataclasses.dataclass
class Loop:
    t_start: float
    t_end: float
    done: list
    next: int
    error: str | None

    def completed(self) -> list:
        """The regions whose calls all completed inside the window."""
        return [d for d in self.done if d.t1 <= self.t_end]


def closed_loop(call, reads_of: list, start: int, seconds: float, *, min_regions: int = 0,
                on_done=None) -> Loop:
    """One caller issues region after region (``reads_of[g]`` reads in
    region g) in the pool's cyclic order from ``start`` until ``seconds``
    have passed and at least ``min_regions`` are done; a region started
    before the end runs to its end.  A call that raises ends the loop, its
    traceback kept."""
    t_start = time.perf_counter()
    t_end = t_start + seconds
    done: list[Done] = []
    k, error = start, None
    while time.perf_counter() < t_end or len(done) < min_regions:
        g = k % len(reads_of)
        k += 1
        t0 = time.perf_counter()
        try:
            out = call(g)
        except Exception:  # noqa: BLE001 — a failed call is counted and reported
            error = traceback.format_exc()
            break
        d = Done(g, t0, time.perf_counter(), reads_of[g], out)
        done.append(d)
        if on_done is not None:
            on_done(d, t_end)
    return Loop(t_start, t_end, done, k, error)
