"""The long-region cell (``hc_long_region.region``) on the CPU: a small
hybrid region (short and long reads of one sample) through the port's three
calls as the benchmark drives them, held to the benchmark's plain reference;
the column route's rescue rule; the cell's generator, files and readers.

The region's haplotypes run 60-120 bases, so ``PairHMM.PALLAS_MAX_HAP`` is
shrunk to 16 to send every group down the column route (its plain twin on
the CPU), where every lane below ``MIN_ACCEPTED`` is rescued in float64.
Imports neither JAX nor the JAX package."""

from __future__ import annotations

import numpy as np
import pytest

from bench_port.gen import active_region, draws, long_region
from bench_port.harness import check, drive, readers, session, spec
from gkl_tpu_torch import PairHMM, api, batch, profiling
from gkl_tpu_torch.context import MIN_ACCEPTED
from gkl_tpu_torch.ops import pairhmm_cuda

CELL = "hc_long_region.region"
SEED = 2 ** 31 + 4099


def small_region(seed: int = SEED) -> dict:
    """Four haplotypes of 60-120 bases over one window (10% of their bases
    redrawn, so that a long read scores far below MIN_ACCEPTED against a
    haplotype it did not come from), 20 short reads of 30-50 bases at the
    configuration's Illumina qualities and 3 long reads at its HiFi ones,
    each spanning its source haplotype."""
    config = spec.load_cell(CELL).config
    rng = np.random.default_rng(seed)
    window = draws.BASES[rng.integers(0, 4, 90)]
    haps = [active_region._haplotype(rng, window, dict(config, haplotype_substitution=0.1))
            for _ in range(4)]
    short = draws.reads(rng, haps[:2], 60, 50, 30, config["read_quality_bins"])[:20]
    long = draws.reads(rng, haps[:2], 3, 10_000, 30, config["long_reads"]["read_quality_bins"])
    return {"haps": haps, "pd_haps": [(h, draws.pd_bytes(rng, h, 2)) for h in haps],
            "reads": short + long}


@pytest.fixture
def column_route(monkeypatch):
    """Every PairHMM group on the column route, metrics on, counters clear."""
    def no_scaled(**kw):
        raise AssertionError("a group took the scaled kernel")

    monkeypatch.setattr(PairHMM, "PALLAS_MAX_HAP", 16)
    monkeypatch.setattr(pairhmm_cuda, "pairhmm_scaled", no_scaled)
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    profiling.METRICS.reset()
    yield
    profiling.METRICS.reset()


def test_small_region_has_the_shape_it_states():
    raw = small_region()
    assert all(60 <= len(h) <= 120 for h in raw["haps"])
    short, long = raw["reads"][:20], raw["reads"][20:]
    assert len(short) == 20 and all(30 <= len(s) <= 50 for s, _, _ in short)
    assert len(long) == 3
    for s, _, pos in long:
        assert pos == 0 and len(s) in {len(h) for h in raw["haps"][:2]}


def _three_calls(raw):
    cell = spec.load_cell(CELL)
    region = drive.port_region(raw, cell.config)
    out = drive.three_calls(session.engines("cpu", cell.config), region, cell.config,
                            cell.mix)
    return cell, out


def test_three_calls_match_the_reference(column_route):
    """PairHMM, SW and PDHMM of every read through ``drive.three_calls``
    against the f64 and int32 reference, within the cell's own limits."""
    raw = small_region()
    cell, out = _three_calls(raw)
    plan = {0: np.arange(len(raw["reads"]))}
    numbers, counts = check.compare([(0, out, out)], [raw], plan, cell.config)
    assert counts["reads"] == 23 and counts["lanes"] == 23 * 8
    assert numbers["sw_mismatches"] == 0
    assert check.verdict(numbers, cell.limits), numbers
    snap = profiling.METRICS.snapshot()
    assert snap["pairhmm_rescue"]["items"] > 0
    # the long reads' lanes against a haplotype they did not come from
    assert snap["pdhmm_rescue"]["items"] > 0


def _pair_key(read, hap) -> tuple:
    return bytes(np.asarray(read, np.uint8)), bytes(np.asarray(hap, np.uint8))


def test_rescued_lanes_are_those_below_min_accepted(column_route, monkeypatch):
    """The column route rescues exactly the lanes whose plain-f32 result
    lies below MIN_ACCEPTED: some of them, not all, and the counter's items
    are those lanes."""
    raw = small_region()
    rescued = []
    real = PairHMM._f64_lanes

    def spy(self, pk, lanes, on):
        haps, reads, _ = api._extract_lanes(pk, lanes)
        rescued.extend(_pair_key(r, h) for r, h in zip(reads, haps))
        return real(self, pk, lanes, on)

    monkeypatch.setattr(PairHMM, "_f64_lanes", spy)
    _three_calls(raw)

    cell = spec.load_cell(CELL)
    planes = [drive.read_planes(s, q, cell.config) for s, q, _ in raw["reads"]]
    pairs = [(p, h) for p in planes for h in raw["haps"]]
    packed = batch.pack_pairs([h for _, h in pairs], [p[0] for p, _ in pairs],
                              [p[1:] for p, _ in pairs])
    f32 = PairHMM(device="cpu")._raw_batch(packed, "float32")
    below = {_pair_key(p[0], h) for (p, h), v in zip(pairs, f32) if v < MIN_ACCEPTED}
    assert 0 < len(below) < len(pairs)
    assert sorted(rescued) == sorted(below)
    assert profiling.METRICS.snapshot()["pairhmm_rescue"]["items"] == len(below)


def test_pool_repeats_per_seed_and_holds_long_work():
    """At full size: the same pool for the same seed, every haplotype past
    the scaled kernel's cap, and long reads in every region."""
    cell = spec.load_cell(CELL)
    gen = cell.generator()
    one = gen.pool(cell.config, cell.mix, SEED)
    two = gen.pool(cell.config, cell.mix, SEED)
    assert len(one) == cell.mix["pool_regions"]
    for a, b in zip(one, two):
        assert all(np.array_equal(x, y) for x, y in zip(a["haps"], b["haps"]))
        assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) and x[2] == y[2]
                   for x, y in zip(a["reads"], b["reads"]))
    other = gen.pool(cell.config, cell.mix, SEED + 1)
    assert not np.array_equal(one[0]["haps"][0], other[0]["haps"][0])
    L = cell.config["read_length"]
    for r in one:
        assert all(len(h) > PairHMM.PALLAS_MAX_HAP for h in r["haps"])
        assert len(r["haps"]) == cell.mix["n_haplotypes"]
        assert any(len(s) > L for s, _, _ in r["reads"])
    # the windows are the stratified quantiles of the mix's range, padded
    pad = 2 * cell.config["assembly_region_padding"]
    lo, hi = cell.mix["region_sizes"]
    assert all(lo + pad - 20 <= len(h) <= hi + pad + 20 for r in one for h in r["haps"])


def test_long_reads_follow_the_configuration():
    """Each region's reads past the short-read length carry only the HiFi
    qualities, and the long reads number about the configuration's depth."""
    cell = spec.load_cell(CELL)
    long = cell.config["long_reads"]
    bins = {q for q, _ in long["read_quality_bins"]}
    for r in cell.generator().pool(cell.config, cell.mix, SEED):
        tall = [(s, q) for s, q, _ in r["reads"] if len(s) > cell.config["read_length"]]
        assert all(set(np.unique(q).tolist()) <= bins for _, q in tall)
        width = len(r["haps"][0])
        drawn = round(long["coverage"] * (width + long["read_length"]) / long["read_length"])
        assert drawn - 4 <= len(tall) <= drawn


def test_every_seed_asks_the_same_long_read_work():
    """The long reads are stratified: over the pool, the sum of their
    lengths and their count agree across seeds to within 1%."""
    cell = spec.load_cell(CELL)
    work = []
    for seed in (SEED, SEED + 1, 17, 2 ** 33 + 5):
        pool = cell.generator().pool(cell.config, cell.mix, seed)
        tall = [len(s) for r in pool for s, _, _ in r["reads"] if len(s) > cell.config["read_length"]]
        work.append((len(tall), sum(tall)))
    assert len({n for n, _ in work}) == 1
    assert max(b for _, b in work) <= 1.01 * min(b for _, b in work)


@pytest.mark.parametrize("n", [1, 4, 9])
def test_long_reads_start_at_the_quantiles(n):
    """On two haplotypes of one length, read k of any seed is the clip of
    the start at quantile (k + 0.5) / n, and the sources split evenly."""
    hap = draws.BASES[np.arange(300) % 4]
    L, want = 1000, []
    for k in range(n):
        start = -(L - 1) + int((k + 0.5) / n * (len(hap) + L - 1))
        lo, hi = max(start, 0), min(start + L, len(hap))
        if hi - lo >= 30:
            want.append((lo, hi - lo))
    other = np.roll(hap, 1)
    for seed in (1, SEED):
        got = long_region.long_reads(np.random.default_rng(seed), [hap, other], n, L, 30,
                                     [[40, 1.0]])
        assert sorted((pos, len(s)) for s, _, pos in got) == sorted(want)
        assert all(set(q.tolist()) == {40} for _, q, _ in got)
        first = sum(np.mean(s == hap[pos:pos + len(s)]) > 0.9 for s, _, pos in got)
        assert sorted([first, len(got) - first]) == sorted([n // 2, n - n // 2])


def test_cell_loads():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.mix["entry"] == "three_calls"
    assert cell.mix["check_reads"] is None
    assert set(cell.limits) == {"pairhmm_err", "best_gap", "sw_mismatches", "pdhmm_err"}
    assert cell.limits["sw_mismatches"] == 0
    names = {m["name"] for m in cell.per_layer}
    assert {"pairhmm.rescued_cells_pct", "pdhmm.rescued_cells_pct"} <= names
    for other in ("hc_wgs30x.region", "hc_deep_panel.region"):
        assert "pairhmm.rescued_cells_pct" not in {m["name"] for m in
                                                   spec.load_cell(other).per_layer}


@pytest.mark.parametrize("call", ["pairhmm", "pdhmm"])
@pytest.mark.parametrize("rescue_cells, want", [(250, 25.0), (0, 0.0), (None, 0.0)])
def test_rescued_cells_reader(call, rescue_cells, want):
    counters = {call: {"calls": 2, "items": 40, "cells": 1000, "seconds": 0.5}}
    if rescue_cells is not None:
        counters[f"{call}_rescue"] = {"calls": 1, "items": 3, "cells": rescue_cells,
                                      "seconds": 0.1}
    run = readers.Run(reads=10, spans=[], counters=counters, trace=None)
    assert spec.metric_reader(f"{call}.rescued_cells_pct").read(run) == want


@pytest.mark.parametrize("call", ["pairhmm", "pdhmm"])
def test_rescued_cells_reader_reads_nothing_without_counters(call):
    reader = spec.metric_reader(f"{call}.rescued_cells_pct")
    assert reader.read(readers.Run(reads=10, spans=[], counters={}, trace=None)) is None
    other = {"sw_pack": {"calls": 1, "items": 1, "cells": 0, "seconds": 0.1}}
    assert reader.read(readers.Run(reads=10, spans=[], counters=other, trace=None)) is None
