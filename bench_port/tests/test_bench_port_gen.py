"""The region generators: the same pool for the same seed, and the sizes
their configurations state."""

from __future__ import annotations

import numpy as np
import pytest

from bench_port.harness import spec

from .conftest import CELLS, tiny_cell

BIG_SEED = 2 ** 31 + 977


def same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("name", CELLS)
def test_pool_repeats_per_seed(name):
    cell = tiny_cell(name)
    gen = cell.generator()
    one = gen.pool(cell.config, cell.mix, BIG_SEED)
    assert same(one, gen.pool(cell.config, cell.mix, BIG_SEED))
    assert not same(one, gen.pool(cell.config, cell.mix, BIG_SEED + 1))


def _check_regions(cell, pool):
    cfg, mix = cell.config, cell.mix
    pad = 2 * cfg["assembly_region_padding"]
    lo, hi = cfg["min_assembly_region_size"] + pad, cfg["max_assembly_region_size"] + pad
    bins = {q for q, _ in cfg["read_quality_bins"]}
    L = cfg["read_length"]
    for r in pool:
        # every haplotype spans the padded window, give or take its indels
        slack = cfg["haplotype_indels"][1] * cfg["indel_length"][1]
        assert all(lo - slack <= len(h) <= hi + slack for h in r["haps"])
        assert len(r["pd_haps"]) == min(len(r["haps"]), cfg["n_pd_haplotypes"])
        lengths = [len(s) for s, q, _ in r["reads"]]
        assert min(lengths) >= cfg["min_read_length"] and max(lengths) <= L
        assert all(len(s) == len(q) for s, q, _ in r["reads"])
        # reads are clipped to the window: none runs past a source haplotype
        assert all(pos + len(s) <= max(len(h) for h in r["haps"][:2])
                   for s, _, pos in r["reads"])
        width = len(r["haps"][0])
        assert len(r["reads"]) <= round(cfg["coverage"] * (width + slack + L) / L)
        assert set(np.concatenate([q for _, q, _ in r["reads"]]).tolist()) <= bins


def test_wgs_regions_match_their_config():
    cell = spec.load_cell("hc_wgs30x.region")
    cfg, mix = cell.config, cell.mix
    pool = cell.generator().pool(cfg, mix, BIG_SEED)
    assert len(pool) == mix["pool_regions"]
    counts = [len(r["haps"]) for r in pool]
    assert min(counts) == 2 and max(counts) == cfg["max_haplotypes"]
    # every block of `strata` regions asks the same haplotype counts
    blocks = [sorted(counts[i:i + mix["strata"]]) for i in range(0, len(pool), mix["strata"])]
    assert all(b == blocks[0] for b in blocks)
    _check_regions(cell, pool)


@pytest.mark.parametrize("name", ["hc_deep_panel.region", "hc_deep_panel.bam_stream"])
def test_deep_regions_match_their_config(name):
    cell = spec.load_cell(name)
    pool = cell.generator().pool(cell.config, cell.mix, BIG_SEED)
    assert len(pool) == cell.mix["pool_regions"]
    assert all(len(r["haps"]) == cell.mix["n_haplotypes"] for r in pool)
    _check_regions(cell, pool)
    # the depth the configuration states, about, over each region's window
    for r in pool:
        depth = sum(len(s) for s, _, _ in r["reads"]) / len(r["haps"][0])
        assert 0.8 * cell.config["coverage"] <= depth <= 1.2 * cell.config["coverage"]


def test_reads_are_miscalled_at_their_qualities():
    cell = spec.load_cell("hc_deep_panel.region")
    (r, *_) = cell.generator().pool(cell.config, cell.mix, BIG_SEED)
    errors = bases = expected = 0
    for s, q, pos in r["reads"]:
        errors += min(int(np.sum(h[pos:pos + len(s)] != s)) if pos + len(s) <= len(h)
                      else len(s) for h in r["haps"][:2])
        bases += len(s)
        expected += float(np.sum(10.0 ** (-q.astype(np.float64) / 10)))
    # a read's source haplotype is the closer one; the other can only add
    assert 0.9 * expected <= errors <= 1.1 * expected
    assert errors / bases < 0.006
