"""Long HaplotypeCaller active regions read by two technologies at once.

* Region: a window of the mix's ``region_sizes`` (each at most the
  configuration's ``max_assembly_region_size``) padded by
  ``assembly_region_padding`` on each side, on a random reference window.
* Haplotypes, PD haplotypes and short reads: as ``active_region.region``
  draws them, with the mix's ``n_haplotypes``.
* Long reads: the configuration's ``long_reads`` model (``coverage``,
  ``read_length``, ``min_read_length``, ``read_quality_bins``), the model
  of ``draws.reads``: ``n = round(coverage * (window + read_length) /
  read_length)`` reads at uniform starts on the first two haplotypes,
  clipped to the window (so most span it), those under ``min_read_length``
  dropped, each base miscalled with its quality's probability.  They follow
  the short reads in one list, as one sample's two inputs reach the
  caller's three calls together.

Window sizes are stratified as ``active_region``'s: every block of
``strata`` regions holds the same evenly spaced quantiles of
``region_sizes`` in a seeded order.  So are a region's long reads, whose
lengths set most of its work: their starts are the n evenly spaced
quantiles of the uniform start, and their sources alternate between the
two haplotypes, each in a seeded order.  So every seed asks about the same
work.
"""

from __future__ import annotations

import numpy as np

from . import active_region, draws


def pool(config: dict, mix: dict, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    strata = mix["strata"]
    u = (np.arange(strata) + 0.5) / strata
    lo, hi = (min(s, config["max_assembly_region_size"]) for s in mix["region_sizes"])
    sizes = lo + np.floor((hi - lo + 1) * u).astype(int)
    out = []
    for _ in range(mix["pool_regions"] // strata):
        for size in rng.permutation(sizes):
            out.append(region(rng, config, int(size), mix["n_haplotypes"]))
    return out


def region(rng, config: dict, size: int, n_haps: int) -> dict:
    out = active_region.region(rng, config, size, n_haps)
    long = config["long_reads"]
    width = size + 2 * config["assembly_region_padding"]
    L = long["read_length"]
    out["reads"] += long_reads(rng, out["haps"][:2], round(long["coverage"] * (width + L) / L),
                               L, long["min_read_length"], long["read_quality_bins"])
    return out


def long_reads(rng, haps: list, n: int, length: int, min_length: int, quality_bins) -> list:
    """``draws.reads`` with stratified draws: read k starts at quantile
    ``(u_k + 0.5) / n`` of the uniform start on ``[-(length - 1),
    len(hap))`` and comes from haplotype ``s_k``, where u and s are seeded
    permutations of ``0..n-1`` and of ``k % len(haps)``.  Returns [(bases,
    qualities, start)]."""
    u = (rng.permutation(n) + 0.5) / n
    src = rng.permutation(np.arange(n) % len(haps))
    q_values = np.array([q for q, _ in quality_bins], np.uint8)
    shares = np.array([p for _, p in quality_bins], np.float64)
    out = []
    for uk, sk in zip(u, src):
        hap = haps[sk]
        start = -(length - 1) + int(uk * (len(hap) + length - 1))
        lo, hi = max(start, 0), min(start + length, len(hap))
        if hi - lo < min_length:
            continue
        code = np.searchsorted(draws.BASES, hap[lo:hi])
        qual = q_values[rng.choice(len(q_values), hi - lo, p=shares / shares.sum())]
        wrong = rng.random(hi - lo) < 10.0 ** (-qual.astype(np.float64) / 10.0)
        code[wrong] = (code[wrong] + rng.integers(1, 4, int(wrong.sum()))) % 4
        out.append((draws.BASES[code], qual, lo))
    return out
