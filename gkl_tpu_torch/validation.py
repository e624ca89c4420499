"""GATK-scale end-to-end validation corpus — counterpart of
``gkl_tpu/validation.py``.

A seeded-deterministic corpus of >= 10k mixed (read, haplotype) pairs
(varied lengths, PD events, deep-underflow lanes that force the f64 rescue)
is written to a real BAM by the port's own writer, streamed through the
whole region path (BAM -> codec -> batch planner -> PairHMM + SW + PDHMM on
the engines' device) and checked against the scalar oracles.  Any drift in
an engine, the dedup upload path or a rescue tier fails the check.  The
draws, bounds and messages are the JAX package's, and the corpus BAM is
byte for byte the one the JAX package writes.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class Corpus:
    bam_path: str
    haplotypes: list          # HaplotypeData
    pd_haplotypes: list       # PDHaplotypeData
    source_hap: np.ndarray    # (n_reads,) which haplotype each read came from
    deep_lanes: np.ndarray    # (n_reads,) bool: engineered underflow reads


def draw_corpus(n_reads: int = 10240, n_haplotypes: int = 8, n_pd_haplotypes: int = 4,
                seed: int = 0):
    """The corpus's random draws, in the JAX package's order (one generator
    for :func:`build_corpus` and anyone who needs the corpus in memory).

    * haplotypes: varied lengths (160..420), near-identical population
      (mutated copies of one ancestor — the assembled-haplotype shape);
    * reads: windows of a random haplotype with 1-5% mutations, lengths
      48..250, qualities 18..45;
    * every 64th read is a DEEP lane: long (250) and low-quality (q 4..8)
      with 25% mutations — its f32 likelihood underflows MIN_ACCEPTED and
      must go through the f64 rescue tier;
    * PD haplotypes: the first ``n_pd_haplotypes`` haplotypes with 0-2
      deletion events (DEL_START/DEL_END flag bytes) each.

    Returns (haplotypes, [(PD haplotype bases, PD flag bytes)], BamRecords,
    source haplotype per read, deep-lane mask).
    """
    from .bam import BamRecord

    rng = np.random.default_rng(seed)
    ancestor = _BASES[rng.integers(0, 4, 420)]
    haps = []
    for i in range(n_haplotypes):
        L = int(rng.integers(160, 421)) if i else 420
        seq = ancestor[:L].copy()
        mut = rng.random(L) < 0.01
        seq[mut] = _BASES[rng.integers(0, 4, int(mut.sum()))]
        haps.append(seq)

    pd_pairs = []
    for i in range(n_pd_haplotypes):
        seq = haps[i]
        pd = np.zeros(len(seq), np.uint8)
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(4, len(seq) - 12))
            span = int(rng.integers(2, 7))
            pd[j] = 2              # DEL_START
            pd[j + span] = 4       # DEL_END
        pd_pairs.append((seq, pd))

    source = np.zeros(n_reads, np.int32)
    deep = np.zeros(n_reads, bool)
    records = []
    for r in range(n_reads):
        hi = int(rng.integers(0, n_haplotypes))
        source[r] = hi
        hap = haps[hi]
        if r % 64 == 0:
            deep[r] = True
            L = 250
            mut_rate = 0.25
            qlo, qhi = 4, 9
        else:
            L = int(rng.integers(48, 251))
            mut_rate = float(rng.uniform(0.01, 0.05))
            qlo, qhi = 18, 46
        start = int(rng.integers(0, max(1, len(hap) - min(L, len(hap)) + 1)))
        seq = hap[start:start + L]
        if len(seq) < L:  # read overhangs the haplotype end: pad with noise
            seq = np.concatenate([seq, _BASES[rng.integers(0, 4, L - len(seq))]])
        seq = seq.copy()
        mut = rng.random(L) < mut_rate
        seq[mut] = _BASES[rng.integers(0, 4, int(mut.sum()))]
        qual = rng.integers(qlo, qhi, L).astype(np.uint8)
        records.append(BamRecord(name=f"synth{r:06d}", flag=0, ref_id=0, pos=start, mapq=60,
                                 cigar=[(L, "M")], seq=seq, qual=qual))
    return haps, pd_pairs, records, source, deep


def build_corpus(bam_path: str, *, n_reads: int = 10240, n_haplotypes: int = 8,
                 n_pd_haplotypes: int = 4, seed: int = 0) -> Corpus:
    """Deterministic synthetic active region (:func:`draw_corpus`), written
    as a real BAM at level 5."""
    from . import bam as bam_mod
    from .api import HaplotypeData
    from .api_pdhmm import PDHaplotypeData

    haps, pd_pairs, records, source, deep = draw_corpus(
        n_reads, n_haplotypes, n_pd_haplotypes, seed)
    header = bam_mod.BamHeader(text="@HD\tVN:1.6\n@SQ\tSN:synth\tLN:420\n",
                               ref_names=["synth"], ref_lengths=[420])
    bam_mod.write_bam_streaming(bam_path, header, iter(records), level=5)
    return Corpus(bam_path=bam_path,
                  haplotypes=[HaplotypeData(h) for h in haps],
                  pd_haplotypes=[PDHaplotypeData(h, haplotype_pdbases=p) for h, p in pd_pairs],
                  source_hap=source, deep_lanes=deep)


def _require(ok, message: str) -> None:
    """A check of the corpus run: raises AssertionError (also under -O)."""
    if not ok:
        raise AssertionError(message)


def check_corpus(corpus: Corpus, *, sample_stride: int = 16, chunk_reads: int = 2048,
                 threads: int | None = None, device: str | torch.device = "cuda") -> dict:
    """Run the full mixed pipeline over the corpus, with ``PairHMM``,
    ``SmithWaterman`` and ``PDHMM`` on ``device``, and verify against the
    scalar oracles.  Raises AssertionError on any drift; returns stats.

    * PairHMM: a deterministic sample (every ``sample_stride``-th read x
      every haplotype) PLUS every deep-underflow lane is recomputed with
      the f64 scalar oracle and must agree within 1e-4 — this corpus's
      250-base low-quality reads accumulate more f32 rounding than the
      golden vectors, so the exact 1e-5 precision contract stays pinned by
      the 104 golden cases while this bound catches engine/dedup/rescue
      drift;
    * SW: the sampled reads' realignment CIGARs/offsets must equal the
      scalar reference aligner's;
    * PDHMM: the sampled reads against every PD haplotype at 1e-4;
    * globally: every likelihood finite and <= 0.
    """
    from . import bam as bam_mod
    from . import pipeline
    from .api import PairHMM
    from .api_pdhmm import PDHMM
    from .api_sw import SmithWaterman
    from .ops import pairhmm_ref, pdhmm_ref, sw_ref

    res = pipeline.region_bam(corpus.bam_path, corpus.haplotypes,
                              pd_haplotypes=corpus.pd_haplotypes,
                              chunk_reads=chunk_reads, threads=threads,
                              hmm=PairHMM(device=device), sw=SmithWaterman(device=device),
                              pdhmm=PDHMM(device=device))
    n_reads = len(res.read_names)
    nh = len(corpus.haplotypes)
    _require(n_reads == len(corpus.source_hap),
             f"pipeline dropped reads: {n_reads} != {len(corpus.source_hap)}")
    lik = res.likelihoods
    _require(np.isfinite(lik).all(), "non-finite PairHMM likelihoods")
    _require((lik <= 1e-9).all(), "positive log10 likelihoods")
    _require(np.isfinite(res.pd_likelihoods).all(), "non-finite PDHMM")

    # the pipeline's exact engine inputs (qual floor + GOP/GCP defaults)
    # for the oracle legs
    _, records = bam_mod.read_bam(corpus.bam_path)
    _require([r.name for r in records] == res.read_names,
             "the BAM's read names differ from the pipeline's")
    reads = pipeline.reads_from_records(records)

    sample = sorted(set(range(0, n_reads, sample_stride))
                    | set(np.nonzero(corpus.deep_lanes)[0].tolist()))
    hs = [np.asarray(h.haplotype_bases, np.uint8) for h in corpus.haplotypes]

    # --- PairHMM oracle (threaded native f64) ---
    o_haps, o_reads, o_quals = [], [], []
    for i in sample:
        rd = reads[i]
        for h in hs:
            o_haps.append(h)
            o_reads.append(rd.read_bases)
            o_quals.append((rd.read_quals, rd.insertion_gop, rd.deletion_gop, rd.overall_gcp))
    expected = np.asarray(pairhmm_ref.pairhmm_scalar_batch(
        o_haps, o_reads, o_quals, threads=threads)).reshape(len(sample), nh)
    err = np.abs(lik[sample] - expected).max()
    _require(err < 1e-4, f"PairHMM drift: max |err| = {err:.3e}")

    # deep lanes really exercised the rescue tier: their f32 raw results
    # underflow, so agreement against f64 means the rescue path ran
    deep_min = lik[np.nonzero(corpus.deep_lanes)[0]].min()
    _require(deep_min < -60.0,
             f"deep lanes not deep (min log10 = {deep_min:.1f}) — the corpus no "
             "longer exercises the rescue tier")

    # --- SW oracle: realignment of sampled reads vs their best haplotype ---
    n_sw = 0
    for i in sample[: max(64, len(sample) // 4)]:
        b = int(res.best_haplotype[i])
        exp = sw_ref.sw_align(hs[b], reads[i].read_bases, 200, -150, -260, -11,
                              sw_ref.SOFTCLIP)
        _require(res.cigars[i] == exp.cigar,
                 f"SW cigar drift read {i}: {res.cigars[i]} != {exp.cigar}")
        _require(int(res.offsets[i]) == int(exp.offset), f"SW offset drift read {i}")
        n_sw += 1

    # --- PDHMM oracle ---
    p_haps, p_pds, p_reads, p_quals = [], [], [], []
    pd_sample = sample[: max(64, len(sample) // 4)]
    for i in pd_sample:
        rd = reads[i]
        for hp in corpus.pd_haplotypes:
            p_haps.append(hp.haplotype_bases)
            p_pds.append(hp.haplotype_pdbases)
            p_reads.append(rd.read_bases)
            p_quals.append((rd.read_quals, rd.insertion_gop, rd.deletion_gop, rd.overall_gcp))
    pd_expected = np.asarray(pdhmm_ref.pdhmm_scalar_batch(
        p_haps, p_pds, p_reads, p_quals, threads=threads)).reshape(
        len(pd_sample), len(corpus.pd_haplotypes))
    pd_err = np.abs(res.pd_likelihoods[pd_sample] - pd_expected).max()
    _require(pd_err < 1e-4, f"PDHMM drift: max |err| = {pd_err:.3e}")

    return {
        "n_reads": n_reads,
        "n_pairs": n_reads * nh + n_reads * len(corpus.pd_haplotypes),
        "n_oracle_pairs": len(sample) * nh + len(pd_sample) * len(corpus.pd_haplotypes),
        "n_sw_checked": n_sw,
        "n_deep_lanes": int(corpus.deep_lanes.sum()),
        "pairhmm_max_err": float(err),
        "pdhmm_max_err": float(pd_err),
    }


def run(bam_path: str | None = None, *, n_reads: int = 10240, sample_stride: int = 16,
        seed: int = 0, threads: int | None = None,
        device: str | torch.device = "cuda") -> dict:
    """Build + check in one call.  Without ``bam_path`` the corpus BAM is a
    temporary file, removed afterwards."""
    own = bam_path is None
    if own:
        fd, bam_path = tempfile.mkstemp(suffix=".bam", prefix="gkl_gatk_corpus_")
        os.close(fd)
    try:
        corpus = build_corpus(bam_path, n_reads=n_reads, seed=seed)
        return check_corpus(corpus, sample_stride=sample_stride, threads=threads,
                            device=device)
    finally:
        if own and os.path.exists(bam_path):
            os.unlink(bam_path)
