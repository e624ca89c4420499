"""One cell at one seed: the pool, the port's engines and regions, the
warm-up, the measured window, the profiled slice and the check."""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from bench_port.reference import bam as ref_bam

from . import check, drive, spec, trace
from .spec import Cell

# the port's host libraries, built (on a checkout's first run) or loaded
# in set-up, never inside the window
NATIVE_LIBRARIES = ("gkl_codec", "gkl_bam", "gkl_pairhmm_oracle", "gkl_sw_runtime",
                    "gkl_pdhmm_oracle")


def _build_files() -> set:
    root = os.environ.get("GKL_TPU_CACHE_DIR", "")
    return {os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs} if root else set()


def build_port(device) -> bool:
    """Build or load every library the port can call on ``device``; True
    where this built one (no library of this checkout was there yet)."""
    from gkl_tpu_torch import cuda_build, native_lib

    before = _build_files()
    for name in NATIVE_LIBRARIES:
        native_lib.load(name)
    if torch.device(device).type == "cuda":
        cuda_build.load()
    return _build_files() != before


def pin_threads(config: dict) -> None:
    """The host threads the deployment gives the port: its native pools
    (f64 rescues, SW walk, codec) and torch's own."""
    os.environ["GKL_TPU_THREADS"] = str(config["native_threads"])
    torch.set_num_threads(config["native_threads"])


def engines(device, config: dict):
    """PairHMM, SmithWaterman and PDHMM as the deployment sets them up; with
    ``native_pair_hmm_use_double_precision`` PairHMM and PDHMM run in
    float64 (GKL's PDHMM computes in double only)."""
    from gkl_tpu_torch import (PDHMM, PairHMM, PairHMMNativeArguments, PDHMMNativeArguments,
                               SmithWaterman)

    double = spec.double_precision(config)
    hmm_args = PairHMMNativeArguments(use_double_precision=double)
    args = PDHMMNativeArguments(max_number_of_threads=config["native_threads"],
                                use_double_precision=double)
    return (PairHMM(hmm_args, device=device), SmithWaterman(device=device),
            PDHMM(args, device=device))


class Session:
    def __init__(self, cell: Cell, seed: int, device, port_engines=None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.mix = cell.config, cell.mix
        self.double = spec.double_precision(self.config)
        self.pool = cell.generator().pool(self.config, self.mix, seed)
        self.regions = [drive.port_region(raw, self.config) for raw in self.pool]
        self.reads_of = [r.n_reads for r in self.regions]
        self.tmpdir = tempfile.mkdtemp(prefix="bench_port_")
        self.bam = self.mix["entry"] == "region_stream"
        if self.bam:
            self._write_bams()
        self.engines = port_engines or engines(self.device, self.config)
        self.entry = drive.ENTRIES[self.mix["entry"]]
        self.spans = drive.Spans()
        self.next = 0

    def _write_bams(self) -> None:
        for g, (raw, region) in enumerate(zip(self.pool, self.regions)):
            length = max(len(h) for h in raw["haps"])
            header = ref_bam.encode_header(f"@HD\tVN:1.6\n@SQ\tSN:region\tLN:{length}\n",
                                           [("region", length)])
            # region_stream floors qualities at 6 and applies no threshold,
            # so the BAM holds them as the caller hands them to PairHMM
            records = [ref_bam.encode_record(check.read_name(i), pos, seq,
                                             drive.read_planes(seq, qual, self.config)[1])
                       for i, (seq, qual, pos) in enumerate(raw["reads"])]
            region.bam = os.path.join(self.tmpdir, f"region{g}.bam")
            ref_bam.write_bam(region.bam, header, records, level=self.mix["bgzf_level"])

    def call(self, g: int) -> drive.Output:
        hmm, sw, pdhmm = self.engines
        spanned = (drive.PairHMMCalls(hmm, self.spans, self.double),
                   drive.SWCalls(sw, self.spans), drive.PDHMMCalls(pdhmm, self.spans, self.double))
        return self.entry(spanned, self.regions[g], self.config, self.mix)

    def warm_up(self) -> None:
        """The ``warmup_regions`` regions with the most lanes, once each."""
        lanes = [r.n_reads * (len(r.haps) + len(r.pd_haps)) for r in self.regions]
        for g in np.argsort(lanes, kind="stable")[::-1][:self.mix["warmup_regions"]]:
            self.call(int(g))
        self._sync()
        self.spans.items.clear()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, on_done=None) -> drive.Loop:
        loop = drive.closed_loop(self.call, self.reads_of, self.next, seconds, on_done=on_done)
        self.next = loop.next
        return loop

    def profiled_slice(self, seconds: float):
        """(loop, trace Summary) of regions run on from the window under the
        profiler for about ``seconds``, at least one region."""
        spans, self.spans = self.spans, drive.Spans(annotate=True)
        try:
            loop, summary = trace.profile(
                lambda: drive.closed_loop(self.call, self.reads_of, self.next, seconds,
                                          min_regions=1), self.spans, self.tmpdir)
        finally:
            self.spans = spans
        self.next = loop.next
        return loop, summary

    def check(self, done: list) -> tuple[dict, dict]:
        plan = check.plan([d.region for d in done], self.pool, self.mix, self.seed)
        return check.compare(check.program_calls(done, plan, self.pool), self.pool, plan,
                             self.config, device=self.device, bam=self.bam)

    def control(self) -> tuple[dict, dict]:
        plan = check.plan(range(len(self.pool)), self.pool, self.mix, self.seed)
        calls = check.control_calls(self.pool, plan, self.config, device=self.device)
        return check.compare(calls, self.pool, plan, self.config, device=self.device)

    def close(self) -> None:
        shutil.rmtree(self.tmpdir, ignore_errors=True)
