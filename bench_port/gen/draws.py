"""Draws shared by the region generators: haplotype variants, partially
determined deletion events, and reads with calibrated base qualities."""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
DEL_START, DEL_END = 2, 4


def substitute(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """A copy of ``seq`` with each base redrawn with probability ``rate``."""
    seq = seq.copy()
    mut = rng.random(len(seq)) < rate
    seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    return seq


def pd_bytes(rng, seq: np.ndarray, max_events: int) -> np.ndarray:
    """PD flag bytes with 0..max_events deletion events: DEL_START at a
    position, DEL_END 2-6 bases on."""
    pd = np.zeros(len(seq), np.uint8)
    for _ in range(int(rng.integers(0, max_events + 1))):
        j = int(rng.integers(4, len(seq) - 12))
        span = int(rng.integers(2, 7))
        pd[j] = DEL_START
        pd[j + span] = DEL_END
    return pd


def reads(rng, haps: list, n: int, length: int, min_length: int, quality_bins) -> list:
    """``n`` reads of ``length`` at uniform starts on ``haps`` (one drawn
    for each read), clipped to it, those under ``min_length`` dropped.
    Each base takes a quality from ``quality_bins`` ([quality, share]
    pairs) and is miscalled, as a different base, with that quality's
    probability 10^(-q/10).  Returns [(bases, qualities, start)]."""
    hap_len = np.array([len(h) for h in haps], np.int64)
    hap_off = np.concatenate([[0], np.cumsum(hap_len)[:-1]])
    src = rng.integers(0, len(haps), n)
    start = rng.integers(-(length - 1), hap_len[src])
    lo, hi = np.maximum(start, 0), np.minimum(start + length, hap_len[src])
    keep = hi - lo >= min_length
    src, lo, hi = src[keep], lo[keep], hi[keep]
    lens = hi - lo
    total = int(lens.sum())
    first = np.cumsum(lens) - lens
    idx = np.repeat(hap_off[src] + lo - first, lens) + np.arange(total)
    code = np.searchsorted(BASES, np.concatenate(haps)[idx])
    q_values = np.array([q for q, _ in quality_bins], np.uint8)
    shares = np.array([p for _, p in quality_bins], np.float64)
    qual = q_values[rng.choice(len(q_values), total, p=shares / shares.sum())]
    wrong = rng.random(total) < 10.0 ** (-qual.astype(np.float64) / 10.0)
    code[wrong] = (code[wrong] + rng.integers(1, 4, int(wrong.sum()))) % 4
    bases = BASES[code]
    cut = np.cumsum(lens)[:-1]
    return list(zip(np.split(bases, cut), np.split(qual, cut), lo.tolist()))
