"""The port's validation corpus (``gkl_tpu_torch.validation``) against the
JAX package's: the corpus BAM and its draws byte for byte, and the checker
run end to end on the CPU engines with the bounds of
``tests/test_gatk_corpus.py``."""

import numpy as np
import pytest
import torch

from gkl_tpu import validation as jvalidation
from gkl_tpu_torch import pipeline as tpipeline
from gkl_tpu_torch import validation as tvalidation


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_corpus_matches_jax(tmp_path):
    t = tvalidation.build_corpus(str(tmp_path / "t.bam"), n_reads=64, seed=7)
    j = jvalidation.build_corpus(str(tmp_path / "j.bam"), n_reads=64, seed=7)
    assert (tmp_path / "t.bam").read_bytes() == (tmp_path / "j.bam").read_bytes()
    np.testing.assert_array_equal(t.source_hap, j.source_hap)
    np.testing.assert_array_equal(t.deep_lanes, j.deep_lanes)
    assert len(t.haplotypes) == len(j.haplotypes) == 8
    for a, b in zip(t.haplotypes, j.haplotypes):
        np.testing.assert_array_equal(a.haplotype_bases, b.haplotype_bases)
    assert len(t.pd_haplotypes) == len(j.pd_haplotypes) == 4
    for a, b in zip(t.pd_haplotypes, j.pd_haplotypes):
        np.testing.assert_array_equal(a.haplotype_bases, b.haplotype_bases)
        np.testing.assert_array_equal(a.haplotype_pdbases, b.haplotype_pdbases)


def test_corpus_is_deterministic(tmp_path):
    a = tvalidation.build_corpus(str(tmp_path / "a.bam"), n_reads=64, seed=7)
    b = tvalidation.build_corpus(str(tmp_path / "b.bam"), n_reads=64, seed=7)
    assert np.array_equal(a.source_hap, b.source_hap)
    assert (tmp_path / "a.bam").read_bytes() == (tmp_path / "b.bam").read_bytes()
    c = tvalidation.build_corpus(str(tmp_path / "c.bam"), n_reads=64, seed=8)
    assert (tmp_path / "c.bam").read_bytes() != (tmp_path / "a.bam").read_bytes()


def test_corpus_end_to_end_small():
    stats = tvalidation.run(n_reads=192, sample_stride=8, seed=0, device="cpu")
    assert stats["n_reads"] == 192
    assert stats["n_deep_lanes"] == 3
    assert stats["pairhmm_max_err"] < 1e-4
    assert stats["pdhmm_max_err"] < 1e-4
    assert stats["n_sw_checked"] >= 16


def test_corpus_checker_catches_drift(tmp_path, monkeypatch):
    """Poison the PairHMM result after the pipeline and the oracle leg must
    trip; the engines stay on the CPU."""
    corpus = tvalidation.build_corpus(str(tmp_path / "c.bam"), n_reads=64, seed=1)
    real = tpipeline.region_bam

    def poisoned(*a, **kw):
        assert all(kw[k].device.type == "cpu" for k in ("hmm", "sw", "pdhmm"))
        res = real(*a, **kw)
        res.likelihoods[8, 0] += 3e-4  # just past the 1e-4 drift bound
        return res

    monkeypatch.setattr(tpipeline, "region_bam", poisoned)
    with pytest.raises(AssertionError, match="PairHMM drift"):
        tvalidation.check_corpus(corpus, sample_stride=8, device="cpu")
