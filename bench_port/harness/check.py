"""The check that decides ``correct``: the port's outputs against the plain
reference (``bench_port/reference``) on the same inputs.

After the window, a sample drawn from the seed: of the regions whose calls
completed, at most ``check_regions`` (every call of each is compared), and
of each such region's reads at most ``check_reads`` (null: all).  The
reference works out, from the generator's inputs alone, the float64
likelihoods of every sampled read against every haplotype and PD
haplotype, and the SW alignment of each sampled read against the
haplotype the calls realigned it to.  The numbers:

* ``pairhmm_err``, ``pdhmm_err``: the widest |log10 gap| between a
  compared likelihood and the reference's (equal infinities 0, NaN inf);
* ``best_gap``: the widest gap by which the reference's likelihood of the
  haplotype a read was realigned to lies below its best;
* ``sw_mismatches``: compared reads whose CIGAR or offset differs;
* ``bam_records`` (``region_stream``): reads whose decoded name differs
  from the one written at its place, and reads missing or extra.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference import pairhmm as ref_pairhmm
from bench_port.reference import pdhmm as ref_pdhmm
from bench_port.reference import sw as ref_sw

from . import drive, spec

STRATEGIES = {"SOFTCLIP": ref_sw.SOFTCLIP, "INDEL": ref_sw.INDEL,
              "LEADING_INDEL": ref_sw.LEADING_INDEL, "IGNORE": ref_sw.IGNORE}


def read_name(i: int) -> str:
    return f"r{i:06d}"


def plan(regions, pool: list, mix: dict, seed: int) -> dict:
    """{region: sorted read indices} to compare, drawn from the seed: at
    most ``check_regions`` of ``regions``, at most ``check_reads`` reads of
    each (null: all)."""
    rng = np.random.default_rng([seed, 1])
    regions = sorted(set(int(g) for g in regions))
    k = mix.get("check_regions")
    if k and len(regions) > k:
        regions = sorted(rng.choice(regions, k, replace=False).tolist())
    out = {}
    for g in regions:
        n, m = len(pool[g]["reads"]), mix.get("check_reads")
        out[g] = np.sort(rng.choice(n, m, replace=False)) if m and n > m else np.arange(n)
    return out


def likelihoods(pool: list, plan: dict, config: dict, *, dtype=torch.float64,
                device="cpu", rescue_below: float | None = None) -> dict:
    """{region: (PairHMM (S, haps), PDHMM (S, PD haps))} of the sampled
    reads, every region's lanes in one batch; lanes below ``rescue_below``
    in float64."""
    reads, haps, pd_haps, ph_lanes, pd_lanes, shapes = [], [], [], [], [], {}
    for g, idx in plan.items():
        raw = pool[g]
        r0, h0, p0 = len(reads), len(haps), len(pd_haps)
        reads += [drive.read_planes(*raw["reads"][i][:2], config) for i in idx]
        haps += raw["haps"]
        pd_haps += raw["pd_haps"]
        nh, npd = len(raw["haps"]), len(raw["pd_haps"])
        ph_lanes += [(r0 + a, h0 + b) for a in range(len(idx)) for b in range(nh)]
        pd_lanes += [(r0 + a, p0 + b) for a in range(len(idx)) for b in range(npd)]
        shapes[g] = (len(idx), nh, npd)
    ph = ref_pairhmm.log10_likelihoods(reads, haps, ph_lanes, dtype=dtype, device=device,
                                       rescue_below=rescue_below)
    pd = ref_pdhmm.log10_likelihoods(reads, pd_haps, pd_lanes, dtype=dtype, device=device,
                                     rescue_below=rescue_below)
    out, a, b = {}, 0, 0
    for g, (s, nh, npd) in shapes.items():
        out[g] = (ph[a:a + s * nh].reshape(s, nh), pd[b:b + s * npd].reshape(s, npd))
        a += s * nh
        b += s * npd
    return out


def alignments(pool: list, pairs, config: dict, *, dtype=torch.int32, device="cpu") -> dict:
    """{(region, read, haplotype): (CIGAR, offset)} of the read realigned to
    that haplotype."""
    pairs = sorted(set(pairs))
    got = ref_sw.align([pool[g]["haps"][h] for g, _, h in pairs],
                       [pool[g]["reads"][i][0] for g, i, _ in pairs],
                       *config["sw_parameters"], STRATEGIES[config["sw_strategy"]],
                       dtype=dtype, device=device)
    return dict(zip(pairs, got))


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    with np.errstate(invalid="ignore"):
        d = np.abs(got - want)
    d[got == want] = 0.0
    d[np.isnan(d)] = np.inf
    return float(d.max()) if d.size else 0.0


def compare(calls, pool: list, plan: dict, config: dict, *, device="cpu",
            bam: bool = False) -> tuple[dict, dict]:
    """The numbers over ``calls``: (region, Output of the sampled reads, in
    the order of ``plan[region]``, and the whole Output or None).  Returns
    (numbers, counts)."""
    ref = likelihoods(pool, plan, config, device=device)
    pairs = [(g, int(plan[g][a]), int(b)) for g, out, _ in calls
             for a, b in enumerate(out.best) if 0 <= b < len(pool[g]["haps"])]
    sw = alignments(pool, pairs, config, device=device)
    n = {"pairhmm_err": 0.0, "best_gap": 0.0, "sw_mismatches": 0, "pdhmm_err": 0.0}
    if bam:
        n["bam_records"] = 0
    lanes = 0
    for g, out, whole in calls:
        lik, pd = ref[g]
        n["pairhmm_err"] = max(n["pairhmm_err"], _gap(out.lik, lik))
        n["pdhmm_err"] = max(n["pdhmm_err"], _gap(out.pd, pd))
        rows = np.arange(len(out.best))
        chosen = np.where((out.best >= 0) & (out.best < lik.shape[1]), out.best, 0)
        gap = lik.max(axis=1) - lik[rows, chosen]
        gap[(out.best < 0) | (out.best >= lik.shape[1])] = np.inf
        n["best_gap"] = max(n["best_gap"], float(gap.max()) if gap.size else 0.0)
        for a, (cigar, offset, b) in enumerate(zip(out.cigars, out.offsets, out.best)):
            want = sw.get((g, int(plan[g][a]), int(b)))
            n["sw_mismatches"] += want != (cigar, int(offset))
        if bam:
            expected = [read_name(i) for i in range(len(pool[g]["reads"]))]
            names = whole.names or []
            n["bam_records"] += (sum(a != b for a, b in zip(names, expected))
                                 + abs(len(names) - len(expected)))
        lanes += lik.size + pd.size
    return n, {"calls": len(calls), "regions": len(plan), "lanes": lanes,
               "reads": sum(len(out.best) for _, out, _ in calls)}


def verdict(numbers: dict, limits: dict, error: str | None = None) -> bool:
    """``correct``: no call failed, and every number the limits name was
    compared and lies within its limit."""
    return (error is None and bool(numbers) and set(numbers) == set(limits)
            and all(v <= limits[k] for k, v in numbers.items()))


def program_calls(done: list, plan: dict, pool: list) -> list:
    """(region, the sampled reads' Output, the whole Output) of each compared
    call; an output without a row for every read of its region counts as
    wrong in every sampled read."""
    calls = []
    for d in done:
        if d.region not in plan:
            continue
        idx, raw = plan[d.region], pool[d.region]
        out = d.output
        rows = {len(out.best), len(out.cigars), len(out.offsets), out.lik.shape[0],
                out.pd.shape[0]}
        if rows != {len(raw["reads"])}:
            s = len(idx)
            out = drive.Output(np.full((s, len(raw["haps"])), np.nan), np.full(s, -1),
                               [None] * s, np.zeros(s, np.int64),
                               np.full((s, len(raw["pd_haps"])), np.nan), d.output.names)
            calls.append((d.region, out, out))
        else:
            calls.append((d.region, out.take(idx), out))
    return calls


def control_calls(pool: list, plan: dict, config: dict, *, device="cpu") -> list:
    """The reference in the program's place, a precision below the one the
    configuration states: float32 likelihoods where it states float64
    (``native_pair_hmm_use_double_precision``: GATK's default float-first
    mode), else bfloat16 (float32 stated); in both the lanes below the
    configuration's ``rescue_below`` recomputed in float64, as the
    float-first program's are; and int16 SW scores (int32 stated)."""
    dtype = torch.float32 if spec.double_precision(config) else torch.bfloat16
    low = likelihoods(pool, plan, config, dtype=dtype, device=device,
                      rescue_below=config["rescue_below"])
    best = {g: np.argmax(low[g][0], axis=1) for g in plan}
    sw = alignments(pool, [(g, int(plan[g][a]), int(b)) for g in plan
                           for a, b in enumerate(best[g])],
                    config, dtype=torch.int16, device=device)
    calls = []
    for g, idx in plan.items():
        al = [sw[(g, int(i), int(b))] for i, b in zip(idx, best[g])]
        calls.append((g, drive.Output(low[g][0], best[g], [c for c, _ in al],
                                      np.asarray([o for _, o in al]), low[g][1]), None))
    return calls
