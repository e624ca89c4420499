"""The port's BAM -> codec -> batch -> PairHMM stream on the CPU against the
committed pipeline snapshot and against ``gkl_tpu.pipeline``."""

import os
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from gkl_tpu import pipeline as jpipe
from gkl_tpu import validation
from gkl_tpu_torch import HaplotypeData, PairHMM, bam, pipeline

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BAM = os.path.join(DATA, "HiSeq.1mb.1RG.2k_lines.bam")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pipeline_golden_snapshot():
    """pairhmm_bam on the bundled BAM reproduces the committed snapshot
    (pipeline_golden.txt) at 1e-5."""
    _, records = bam.read_bam(BAM, limit=8)
    haps = [HaplotypeData(records[i].seq) for i in (0, 1, 2, 3)]
    res = pipeline.pairhmm_bam(BAM, haps, limit=24, chunk_reads=8, hmm=PairHMM(device="cpu"))
    names, rows = [], []
    with open(os.path.join(DATA, "pipeline_golden.txt")) as fh:
        for line in fh:
            if not line.startswith("#"):
                parts = line.split()
                names.append(parts[0])
                rows.append([float(v) for v in parts[1:]])
    assert res.read_names == names
    np.testing.assert_allclose(res.likelihoods, np.array(rows), atol=1e-5)


def test_stream_matches_jax_pipeline(tmp_path):
    """A 256-read synthetic active region (validation.build_corpus, deep
    lanes included) streamed through both packages: same reads in order,
    likelihoods within the corpus bound of 1e-4 (the JAX package rescues
    every deep lane in f64, the port only the flagged ones; in-range lanes
    agree far closer).  Two haplotypes keep the JAX engine's per-shape
    compiles few."""
    corpus = validation.build_corpus(str(tmp_path / "c.bam"), n_reads=256, n_haplotypes=2,
                                     n_pd_haplotypes=2)
    j_haps = corpus.haplotypes
    t_haps = [HaplotypeData(h.haplotype_bases) for h in j_haps]
    want = list(jpipe.pairhmm_stream(corpus.bam_path, j_haps, chunk_reads=256))
    got = list(pipeline.pairhmm_stream(corpus.bam_path, t_haps, chunk_reads=256,
                                       hmm=PairHMM(device="cpu")))
    assert len(got) == len(want) == 1
    assert got[0].read_names == want[0].read_names
    lik = got[0].likelihoods
    assert lik.shape == (256, 2) and np.isfinite(lik).all()
    np.testing.assert_allclose(lik, want[0].likelihoods, rtol=0, atol=1e-4)
    assert lik[corpus.deep_lanes].min() < -60


def test_reads_from_records_share_const_planes():
    _, records = bam.read_bam(BAM, limit=40)
    reads = pipeline.reads_from_records(records)
    by_len = {}
    for rd, rec in zip(reads, records):
        assert (rd.read_quals >= pipeline.MIN_BASE_QUAL).all()
        assert rd.insertion_gop is rd.deletion_gop
        assert (rd.insertion_gop == 45).all() and (rd.overall_gcp == 10).all()
        first = by_len.setdefault(len(rec.seq), rd)
        assert rd.overall_gcp is first.overall_gcp


def test_stream_abandoned_producer_terminates():
    """Stopping early must not leave the producer thread blocked on a full
    queue."""
    _, records = bam.read_bam(BAM, limit=2)
    haps = [HaplotypeData(records[0].seq)]
    before = threading.active_count()
    stream = pipeline.pairhmm_stream(BAM, haps, chunk_reads=4, prefetch=1,
                                     hmm=PairHMM(device="cpu"))
    first = next(stream)
    assert first.likelihoods.shape == (4, 1)
    stream.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_chip_smoke_region_is_the_validation_corpus(tmp_path):
    """chip_smoke's active region (numpy only, no JAX) draws the same reads,
    haplotypes and PD haplotypes as validation.build_corpus."""
    corpus = validation.build_corpus(str(tmp_path / "c.bam"), n_reads=130)
    haps, reads, deep, pd_haps = chip_smoke.active_region(n_reads=130)
    for h, jh in zip(haps, corpus.haplotypes):
        np.testing.assert_array_equal(h, jh.haplotype_bases)
    assert len(pd_haps) == len(corpus.pd_haplotypes) == 4
    for (h, pd), jh in zip(pd_haps, corpus.pd_haplotypes):
        np.testing.assert_array_equal(h, jh.haplotype_bases)
        np.testing.assert_array_equal(pd, jh.haplotype_pdbases)
    assert any(pd.any() for _, pd in pd_haps)
    _, records = bam.read_bam(corpus.bam_path)
    assert len(records) == len(reads) == 130
    for (seq, qual), rec in zip(reads, records):
        np.testing.assert_array_equal(seq, rec.seq)
        np.testing.assert_array_equal(qual, rec.qual)
    np.testing.assert_array_equal(deep, corpus.deep_lanes)
