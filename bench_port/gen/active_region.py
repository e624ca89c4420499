"""HaplotypeCaller active regions, as GATK hands them to its three calls.

* Region: an active region of ``min..max_assembly_region_size`` bases
  padded by ``assembly_region_padding`` on each side, on a random
  reference window.
* Haplotypes: the mix's ``n_haplotypes``, or ``1 + min(max_haplotypes - 1,
  Zipf(haplotype_zipf_a))``; each is the padded window with
  ``haplotype_substitution`` of its bases redrawn and
  ``haplotype_indels`` indels of ``indel_length`` bases, so that every
  haplotype spans the same window.
* Reads: ``round(coverage * (window + read_length) / read_length)`` reads
  of ``read_length`` at uniform starts on one of the first two haplotypes
  (the diploid sample's), clipped to the window, those under
  ``min_read_length`` dropped; base qualities from ``read_quality_bins``,
  each base miscalled with its quality's probability.
* PD haplotypes: the first ``n_pd_haplotypes`` haplotypes with up to
  ``pd_deletion_events`` deletion events each.

Region sizes and haplotype counts are stratified: every block of
``strata`` regions holds the same sizes and counts (evenly spaced
quantiles of their distributions) in a seeded order, so that every seed
and every stretch of the pool asks about the same work.
"""

from __future__ import annotations

import numpy as np

from . import draws


def zipf_quantiles(a: float, u: np.ndarray, kmax: int) -> np.ndarray:
    """The smallest k >= 1 with P(Zipf(a) <= k) >= u, capped at kmax."""
    k = np.arange(1, kmax + 1, dtype=np.float64)
    zeta = np.sum(np.arange(1, 1_000_000, dtype=np.float64) ** -a) + 1_000_000 ** (1 - a) / (a - 1)
    cdf = np.cumsum(k ** -a) / zeta
    return np.minimum(np.searchsorted(cdf, u) + 1, kmax)


def pool(config: dict, mix: dict, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    strata = mix["strata"]
    u = (np.arange(strata) + 0.5) / strata
    lo, hi = config["min_assembly_region_size"], config["max_assembly_region_size"]
    sizes = lo + np.floor((hi - lo + 1) * u).astype(int)
    if "n_haplotypes" in mix:
        counts = np.full(strata, mix["n_haplotypes"])
    else:
        counts = 1 + zipf_quantiles(mix["haplotype_zipf_a"], u, config["max_haplotypes"] - 1)
    out = []
    for _ in range(mix["pool_regions"] // strata):
        for size, k in zip(rng.permutation(sizes), rng.permutation(counts)):
            out.append(region(rng, config, int(size), int(k)))
    return out


def _haplotype(rng, window: np.ndarray, config: dict) -> np.ndarray:
    hap = draws.substitute(rng, window, config["haplotype_substitution"])
    lo, hi = config["indel_length"]
    for _ in range(int(rng.integers(config["haplotype_indels"][0],
                                    config["haplotype_indels"][1] + 1))):
        n = int(rng.integers(lo, hi + 1))
        at = int(rng.integers(0, len(hap) - n))
        if rng.random() < 0.5:
            hap = np.concatenate([hap[:at], draws.BASES[rng.integers(0, 4, n)], hap[at:]])
        else:
            hap = np.concatenate([hap[:at], hap[at + n:]])
    return hap


def region(rng, config: dict, size: int, n_haps: int) -> dict:
    width = size + 2 * config["assembly_region_padding"]
    window = draws.BASES[rng.integers(0, 4, width)]
    haps = [_haplotype(rng, window, config) for _ in range(n_haps)]
    pd_haps = [(h, draws.pd_bytes(rng, h, config["pd_deletion_events"]))
               for h in haps[:config["n_pd_haplotypes"]]]
    L = config["read_length"]
    reads = draws.reads(rng, haps[:2], round(config["coverage"] * (width + L) / L), L,
                        config["min_read_length"], config["read_quality_bins"])
    return {"haps": haps, "pd_haps": pd_haps, "reads": reads}
