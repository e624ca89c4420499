"""The plain reference against GKL's golden vectors and, at small sizes,
the port's own CPU oracles and twins; the BAM writer against the port's
reader.  (The reference itself imports nothing of the port.)"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from bench_port.reference import bam as ref_bam
from bench_port.reference import pairhmm, pdhmm, sw
from bench_port.tests.conftest import REPO_DIR

sys.path.insert(0, os.path.join(REPO_DIR, "tests"))
import golden  # noqa: E402

BASES = np.frombuffer(b"ACGT", np.uint8)


def random_reads(rng, n, lo, hi):
    out = []
    for _ in range(n):
        L = int(rng.integers(lo, hi))
        out.append((BASES[rng.integers(0, 4, L)], rng.integers(6, 46, L).astype(np.uint8),
                    rng.integers(20, 46, L).astype(np.uint8),
                    rng.integers(20, 46, L).astype(np.uint8), np.full(L, 10, np.uint8)))
    return out


def test_pairhmm_golden_file():
    cases = golden.load_pairhmm_cases()
    got = pairhmm.log10_likelihoods([(c.read, c.q, c.iq, c.dq, c.gcp) for c in cases],
                                    [c.hap for c in cases],
                                    [(k, k) for k in range(len(cases))], block=32)
    assert np.abs(got - np.array([c.expected for c in cases])).max() < 1e-5


@pytest.mark.parametrize("name", ["pdhmm_syn_990_1_2.txt", "pdhmm_syn_199_68_51.txt"])
def test_pdhmm_golden_file(name):
    cases = golden.load_pdhmm_cases(name)[:60]
    got = pdhmm.log10_likelihoods([(c.read, c.q, c.iq, c.dq, c.gcp) for c in cases],
                                  [(c.hap, c.hap_pd) for c in cases],
                                  [(k, k) for k in range(len(cases))], block=16)
    assert np.abs(got - np.array([c.expected for c in cases])).max() < 1e-4


def test_pairhmm_equals_the_ports_f64_dp():
    from gkl_tpu_torch.ops import pairhmm_ref

    rng = np.random.default_rng(5)
    reads = random_reads(rng, 5, 4, 40)
    haps = [BASES[rng.integers(0, 4, int(rng.integers(8, 60)))] for _ in range(4)]
    reads[1][0][2] = ord("N")
    lanes = [(r, h) for r in range(5) for h in range(4)]
    got = pairhmm.log10_likelihoods(reads, haps, lanes, block=7)
    want = pairhmm_ref.pairhmm_scalar_batch([haps[h] for _, h in lanes],
                                            [reads[r][0] for r, _ in lanes],
                                            [reads[r][1:] for r, _ in lanes])
    assert np.array_equal(got, want)


def test_pdhmm_equals_the_ports_f64_dp():
    from gkl_tpu_torch.ops import pdhmm_ref

    rng = np.random.default_rng(6)
    reads = random_reads(rng, 4, 6, 40)
    haps = []
    for _ in range(3):
        h = BASES[rng.integers(0, 4, int(rng.integers(20, 60)))]
        pd = np.zeros(len(h), np.uint8)
        pd[5], pd[9], pd[14] = 2, 4, 1 | 8 | 32
        haps.append((h, pd))
    lanes = [(r, h) for r in range(4) for h in range(3)]
    got = pdhmm.log10_likelihoods(reads, haps, lanes, block=5)
    want = pdhmm_ref.pdhmm_scalar_batch([haps[h][0] for _, h in lanes],
                                        [haps[h][1] for _, h in lanes],
                                        [reads[r][0] for r, _ in lanes],
                                        [reads[r][1:] for r, _ in lanes])
    assert np.abs(got - want).max() < 1e-12


@pytest.mark.parametrize("strategy", [sw.SOFTCLIP, sw.INDEL, sw.LEADING_INDEL, sw.IGNORE])
def test_sw_equals_the_ports_aligner(strategy):
    from gkl_tpu_torch.ops import sw_ref

    rng = np.random.default_rng(strategy)
    refs, alts = [], []
    for k in range(24):
        ref = BASES[rng.integers(0, 4, int(rng.integers(1, 60)))]
        if k % 2 and len(ref) > 4:
            s = int(rng.integers(0, len(ref) - 2))
            alt = ref[s:s + int(rng.integers(1, 40))].copy()
            alt[rng.random(len(alt)) < 0.1] = ord("A")
        else:
            alt = BASES[rng.integers(0, 4, int(rng.integers(1, 40)))]
        refs.append(ref)
        alts.append(alt)
    for params in ((10, -15, -30, -5), (200, -150, -260, -11), (3, -1, -2, -1)):
        got = sw.align(refs, alts, *params, strategy, block=9)
        want = [sw_ref.sw_align(r, a, *params, strategy) for r, a in zip(refs, alts)]
        assert got == [(w.cigar, w.offset) for w in want]


def test_controls_differ_from_the_reference():
    rng = np.random.default_rng(7)
    reads = random_reads(rng, 3, 100, 150)
    haps = [r[0].copy() for r in reads]
    lanes = [(r, h) for r in range(3) for h in range(3)]
    f64 = pairhmm.log10_likelihoods(reads, haps, lanes)
    low = pairhmm.log10_likelihoods(reads, haps, lanes, dtype=torch.bfloat16)
    assert np.abs(low - f64).max() > 1e-3
    long_ref = BASES[rng.integers(0, 4, 240)]
    args = ([long_ref] * 2, [long_ref[:200], long_ref[20:220]], 200, -150, -260, -11,
            sw.SOFTCLIP)
    assert sw.align(*args, dtype=torch.int16) != sw.align(*args)


@pytest.mark.parametrize("ref", [pairhmm, pdhmm])
def test_narrow_lanes_below_the_rescue_line_take_float64(ref):
    """The control's rescue: a lane whose bfloat16 sum falls below
    ``rescue_below`` is the float64 one; the others keep bfloat16's."""
    rng = np.random.default_rng(9)
    reads = random_reads(rng, 4, 100, 150)
    haps = [reads[0][0].copy(), BASES[rng.integers(0, 4, 140)]]
    if ref is pdhmm:
        haps = [(h, np.zeros(len(h), np.uint8)) for h in haps]
    lanes = [(r, h) for r in range(4) for h in range(2)]
    f64 = ref.log10_likelihoods(reads, haps, lanes)
    low = ref.log10_likelihoods(reads, haps, lanes, dtype=torch.bfloat16)
    saved = ref.log10_likelihoods(reads, haps, lanes, dtype=torch.bfloat16, rescue_below=1e-28)
    under = ~np.isfinite(low)
    assert under.any() and np.isfinite(saved).all()
    assert np.array_equal(saved[under], f64[under])
    kept = ~under & (low > -28 - np.log10(2.0 ** 120))
    assert kept.any() and np.array_equal(saved[kept], low[kept])


def test_bam_writer_reads_back_through_the_port(tmp_path):
    from gkl_tpu_torch import bam

    rng = np.random.default_rng(8)
    recs = [(f"r{k:06d}", int(rng.integers(0, 400)),
             BASES[rng.integers(0, 4, int(rng.integers(1, 251)))]) for k in range(900)]
    records = [ref_bam.encode_record(n, p, s, np.full(len(s), 30, np.uint8)) for n, p, s in recs]
    path = str(tmp_path / "x.bam")
    ref_bam.write_bam(path, ref_bam.encode_header("@HD\tVN:1.6\n", [("region", 420)]), records)
    header, got = bam.read_bam(path)
    assert header.ref_names == ["region"] and len(got) == len(recs)
    for g, (name, pos, seq) in zip(got, recs):
        assert (g.name, g.pos, g.cigar_string()) == (name, pos, f"{len(seq)}M")
        assert np.array_equal(g.seq, seq)
