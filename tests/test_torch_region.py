"""The port's composed active-region pipeline (PairHMM, then Smith-Waterman
realignment, then PDHMM) and its SW stream on the CPU, against the
committed region snapshot and against ``gkl_tpu.pipeline``."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from gkl_tpu import pipeline as jpipe
from gkl_tpu_torch import PDHMM, PairHMM, SmithWaterman, bam, pipeline

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BAM = os.path.join(DATA, "HiSeq.1mb.1RG.2k_lines.bam")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines():
    return dict(hmm=PairHMM(device="cpu"), sw=SmithWaterman(device="cpu"),
                pdhmm=PDHMM(device="cpu"))


def _region_haplotypes():
    """The snapshot's haplotypes (the first four reads' sequences) and PD
    haplotypes (two of them, one with a deletion event), as chip_smoke
    builds them."""
    _, records = bam.read_bam(BAM, limit=8)
    return chip_smoke.region_haplotypes(records)


def test_region_golden_snapshot():
    """region_bam (limit 24, chunk 8) reproduces every column of
    region_golden.txt: names, best haplotype, offset and CIGAR exact;
    PairHMM likelihoods at 1e-5; PDHMM likelihoods at 1e-4."""
    haps, pd_haps = _region_haplotypes()
    res = pipeline.region_bam(BAM, haps, pd_haplotypes=pd_haps, limit=24, chunk_reads=8,
                              **_engines())
    names, bests, offs, cigars, liks, pdliks = chip_smoke.region_golden()
    assert res.read_names == names
    assert list(res.best_haplotype) == bests
    assert list(res.offsets) == offs
    assert res.cigars == cigars
    np.testing.assert_allclose(res.likelihoods, liks, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.pd_likelihoods, pdliks, rtol=0, atol=1e-4)


def test_sw_align_stream_matches_jax():
    """Reads realigned against one read's sequence: the same chunks, names,
    CIGARs and offsets as the JAX stream."""
    _, records = bam.read_bam(BAM, limit=16)
    ref = records[0].seq
    want = list(jpipe.sw_align_stream(BAM, ref, chunk_reads=6, limit=40))
    got = list(pipeline.sw_align_stream(BAM, ref, chunk_reads=6, limit=40,
                                        sw=SmithWaterman(device="cpu")))
    assert len(got) == len(want) >= 2
    for (gn, gr), (wn, wr) in zip(got, want):
        assert gn == wn
        assert [(r.cigar, r.alignment_offset) for r in gr] == \
            [(r.cigar, r.alignment_offset) for r in wr]
    assert got[0][1][0].cigar == f"{len(ref)}M"


def test_region_stream_without_pd_haplotypes():
    """Without PD haplotypes no PDHMM runs and pd_likelihoods is None; the
    PairHMM block and realignment are those of the full run."""
    haps, pd_haps = _region_haplotypes()
    engines = _engines()
    chunks = list(pipeline.region_stream(BAM, haps, limit=16, chunk_reads=8, **engines))
    assert len(chunks) == 2 and all(c.pd_likelihoods is None for c in chunks)
    full = pipeline.region_bam(BAM, haps, pd_haplotypes=pd_haps, limit=16, chunk_reads=8,
                               **engines)
    np.testing.assert_array_equal(np.concatenate([c.likelihoods for c in chunks]),
                                  full.likelihoods)
    assert [g for c in chunks for g in c.cigars] == full.cigars
    assert full.pd_likelihoods.shape == (16, 2)
