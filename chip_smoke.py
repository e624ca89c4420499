#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the PairHMM main path once on one GPU.

Run from the repository root with ``python3 chip_smoke.py``.  It needs one
CUDA card of compute capability 9.0 (Hopper); without one it exits nonzero
before printing any result.  Phases, one line each:

0. device: name and power limit, torch and CUDA versions;
1. build: the CUDA kernel (nvcc, sm_90a) and the host C++ libraries;
2. kernel vs its plain PyTorch twin on the card at the benchmark shape
   (R=128, H=224, P=2048), with the gap quals as planes and as the GATK
   constants, both timed; and on a deep-lane batch;
3. the 104 golden cases through ``PairHMM()`` in both precision modes;
4. the BAM pipeline against ``tests/data/pipeline_golden.txt``;
5. a GATK-scale active region (10,240 reads x 8 haplotypes) through
   ``PairHMM.compute_likelihoods``, checked against the f64 oracle — the
   main-path run whose kernel launches are counted.  Each of its kernel
   outputs is held against the twin on the same batch, and the rescue
   is recounted lane by lane from them;
6. long pairs (H=4096, R=300) against the f64 oracle.

The line before the last is a JSON object describing each kernel of the
path (``max_abs_err`` is the largest in-range kernel-vs-twin difference of
phases 2 and 5; ``ms``/``plain_ms`` are the bench shape with the GATK
constants, the main path's branch); the last is ``{"ok": true, "device": {...}}``.  Any failure raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# log10 tolerances: in-range lanes of kernel vs twin, and any engine vs
# the exact f64 oracle on the long corpus reads (f32 rounding over 250
# rows; the golden file pins 1e-5)
TOL_IN_RANGE = 1e-5
TOL_ORACLE = 1e-4
# log10 likelihoods above this hold an f32 raw over MIN_ACCEPTED (the
# bound is log10(1e-28 / 2^120) = -64.1): the kernel's in-range lanes
F32_RANGE_LOG10 = -64.0
# insertion/deletion GOP and GCP of GATK's default-GOP reads
GATK_GAP_QUALS = (45, 45, 10)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def gatk_like_batch(R, H, P, seed=0):
    """Reads are mutated haplotype prefixes (likelihoods in f32 range, like
    HaplotypeCaller's read-vs-assembled-haplotype pairs)."""
    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, size=(H, P))]
    read = hap[:R].copy()
    mut = rng.random((R, P)) < 0.02
    read[mut] = BASES[rng.integers(0, 4, size=int(mut.sum()))]
    q = rng.integers(20, 40, size=(R, P)).astype(np.uint8)
    iq = rng.integers(30, 45, size=(R, P)).astype(np.uint8)
    dq = rng.integers(30, 45, size=(R, P)).astype(np.uint8)
    gcp = np.full((R, P), 10, np.uint8)
    haplen = np.full(P, H, np.int32)
    rslen = np.full(P, R, np.int32)
    return hap, read, q, iq, dq, gcp, haplen, rslen


def active_region(n_reads=10240, n_haplotypes=8, n_pd_haplotypes=4, seed=0):
    """The synthetic active region of ``gkl_tpu/validation.py::build_corpus``
    (same generator, same draws): haplotypes 160-420 from one ancestor,
    reads 48-250 with 1-5% mutations and quals 18-45, every 64th read a
    deep lane (250 bases, 25% mutations, quals 4-8).  Returns (haps,
    [(seq, qual)], deep mask)."""
    rng = np.random.default_rng(seed)
    ancestor = BASES[rng.integers(0, 4, 420)]
    haps = []
    for i in range(n_haplotypes):
        L = int(rng.integers(160, 421)) if i else 420
        seq = ancestor[:L].copy()
        mut = rng.random(L) < 0.01
        seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        haps.append(seq)
    for i in range(n_pd_haplotypes):  # PD events: drawn to keep the stream
        for _ in range(int(rng.integers(0, 3))):
            rng.integers(4, len(haps[i]) - 12)
            rng.integers(2, 7)
    reads, deep = [], np.zeros(n_reads, bool)
    for r in range(n_reads):
        hap = haps[int(rng.integers(0, n_haplotypes))]
        if r % 64 == 0:
            deep[r] = True
            L, mut_rate, qlo, qhi = 250, 0.25, 4, 9
        else:
            L = int(rng.integers(48, 251))
            mut_rate, qlo, qhi = float(rng.uniform(0.01, 0.05)), 18, 46
        start = int(rng.integers(0, max(1, len(hap) - min(L, len(hap)) + 1)))
        seq = hap[start:start + L]
        if len(seq) < L:
            seq = np.concatenate([seq, BASES[rng.integers(0, 4, L - len(seq))]])
        seq = seq.copy()
        mut = rng.random(L) < mut_rate
        seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        reads.append((seq, rng.integers(qlo, qhi, L).astype(np.uint8)))
    return haps, reads, deep


def to_read_data(reads):
    """GATK input normalisation, as ``pipeline.reads_from_records``."""
    from gkl_tpu_torch import ReadData

    out = []
    for seq, qual in reads:
        n = len(seq)
        out.append(ReadData(seq, np.maximum(qual, 6).astype(np.uint8),
                            *(np.full(n, v, np.uint8) for v in GATK_GAP_QUALS)))
    return out


def oracle(haps, reads):
    """Exact f64 log10 likelihoods of (hap, ReadData) pairs."""
    from gkl_tpu_torch.ops import pairhmm_ref

    return pairhmm_ref.pairhmm_scalar_batch(
        haps, [r.read_bases for r in reads],
        [(r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp) for r in reads])


def device_batch(pk, dev):
    """An indexed batch's planes as card tensors, keyed as the arguments of
    ``pairhmm_cuda.pairhmm_scaled``."""
    import torch

    names = ["hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen"]
    out = {k: torch.from_numpy(np.ascontiguousarray(getattr(pk, k))).to(dev) for k in names}
    if pk.quals_u is None:
        out["const_quals"] = pk.const_quals
    else:
        out["quals_u"] = torch.from_numpy(pk.quals_u).to(dev)
    return out


def twin_of(t):
    """The plain twin's (mantissa, exp2, flag) of a ``device_batch``."""
    from gkl_tpu_torch.ops import pairhmm_cuda as pc

    planes = pc.expand_indexed_planes(t["hap_u"], t["readq_u"], t["ridx"], t["hidx"],
                                      const_quals=t.get("const_quals"),
                                      quals_u=t.get("quals_u"))
    return pc.pairhmm_raw_scaled_reference(*planes, t["haplen"], t["rslen"])


def compare_to_twin(kernel_out, twin_out, what, n=None):
    """Hold a kernel result (mantissa, exp2, flag) against its plain twin's
    on the same inputs, over the first ``n`` lanes: lanes the twin puts in
    the f32 range agree within TOL_IN_RANGE in log10, and the kernel flags
    every lane the twin flags.  Returns (max |log10 diff|, lane counts)."""
    from gkl_tpu_torch.ops.pairhmm_cuda import log10_of

    km, ke, kf = (t.cpu().numpy()[:n] for t in kernel_out)
    tm, te, tf = (t.cpu().numpy()[:n] for t in twin_out)
    k_res, t_res = log10_of(km, ke), log10_of(tm, te)
    in_range = t_res > F32_RANGE_LOG10
    err = float(np.abs(k_res - t_res)[in_range].max()) if in_range.any() else 0.0
    if not np.isfinite(k_res[in_range]).all() or err > TOL_IN_RANGE:
        raise AssertionError(f"kernel vs twin, {what}: max |log10 diff| = {err:.3e}")
    missed = int(np.sum((tf != 0) & (kf == 0)))
    if missed:
        raise AssertionError(f"kernel vs twin, {what}: kernel misses {missed} twin flags")
    return err, {"lanes_in_range": int(in_range.sum()), "flags_kernel": int((kf != 0).sum()),
                 "flags_twin": int((tf != 0).sum())}


def cuda_ms(fn, iters):
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    from gkl_tpu_torch import utils

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)
    card = utils.cuda_device(0)
    if card is None:
        raise SystemExit("no CUDA device: torch.cuda.is_available() is False")
    log("0 device", name=repr(card.name), capability=card.capability, count=card.count,
        torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    if not card.is_hopper:
        raise SystemExit(f"the kernels are built for compute capability 9.0, "
                         f"card has {card.capability}")


def phase_build():
    from gkl_tpu_torch import cuda_build, native_lib

    for name in ("gkl_pairhmm_oracle", "gkl_codec", "gkl_bam"):
        t0 = time.perf_counter()
        native_lib.load(name)
        log("1 build", library=name, seconds=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    cuda_build.load()
    log("1 build", library="gkl_tpu_torch_kernels (nvcc sm_90a)",
        seconds=round(time.perf_counter() - t0, 3))
    for line in cuda_build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("1 build", ptxas=line.strip().replace(" ", "_"))


def phase_kernel_vs_twin():
    import torch

    from gkl_tpu_torch import batch as batch_mod
    from gkl_tpu_torch.ops import pairhmm_cuda as pc

    dev = torch.device("cuda")
    R, H, P = 128, 224, 2048
    hap, read, q, iq, dq, gcp, haplen, rslen = (
        torch.from_numpy(a).to(dev) for a in gatk_like_batch(R, H, P))
    lanes = torch.arange(P, dtype=torch.int32, device=dev)
    # three inputs that differ in every base qual: each timed call computes
    # a different DP (bench.py's perturbation)
    variants = [torch.stack([read, q + i]).contiguous() for i in range(3)]
    cells = R * H * P

    def bench(quals):
        """Kernel vs twin, both timed, with the gap quals given as planes
        (bench.py) or as the GATK constants the main path's reads carry."""
        def kernel(i):
            return pc.pairhmm_scaled(hap, variants[i % 3], lanes, lanes, haplen, rslen, **quals)

        def twin(i):
            planes = pc.expand_indexed_planes(hap, variants[i % 3], lanes, lanes, **quals)
            return pc.pairhmm_raw_scaled_reference(*planes, haplen, rslen)

        what = f"bench shape, {next(iter(quals))}"
        err, flags = compare_to_twin(pc.unpack(kernel(0)), twin(0), what)
        if flags["lanes_in_range"] != P:
            raise AssertionError(f"{what}: {P - flags['lanes_in_range']} lanes out of f32 range")
        ms, plain_ms = cuda_ms(kernel, 50), cuda_ms(twin, 5)
        log("2 kernel_vs_twin", shape=f"R{R}_H{H}_P{P}", quals=next(iter(quals)),
            max_abs_log10_err=err, **flags, kernel_ms=ms, twin_ms=plain_ms,
            kernel_gcells_per_s=cells / ms / 1e6, twin_gcells_per_s=cells / plain_ms / 1e6)
        return err, ms, plain_ms

    err_u, _, _ = bench({"quals_u": torch.stack([iq, dq, gcp]).contiguous()})
    err_c, ms, plain_ms = bench({"const_quals": GATK_GAP_QUALS})
    err = max(err_u, err_c)

    # deep lanes: the active region's deep reads (quals 4-8, 25% mutations)
    # against every haplotype, plus random reads at Q50 (log10 ~ -250)
    haps, reads, deep = active_region(n_reads=64 * 32)
    rd = to_read_data([reads[i] for i in np.nonzero(deep)[0]])
    rng = np.random.default_rng(1)
    q50 = np.full(256, 50, np.uint8)
    from gkl_tpu_torch import ReadData

    rd += [ReadData(BASES[rng.integers(0, 4, 256)], q50, q50, q50, np.full(256, 10, np.uint8))
           for _ in range(8)]
    pk = batch_mod.pack_pairs_indexed(
        haps, [r.read_bases for r in rd],
        [(r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp) for r in rd])
    t = device_batch(pk, dev)
    km, ke, kf = (x.cpu().numpy()[: pk.n_real] for x in pc.unpack(pc.pairhmm_scaled(**t)))
    tm, te, tf = (x.cpu().numpy()[: pk.n_real] for x in twin_of(t))
    nh = len(haps)
    exact = oracle([haps[j] for _ in rd for j in range(nh)], [r for r in rd for _ in range(nh)])
    k_res, t_res = pc.log10_of(km, ke), pc.log10_of(tm, te)
    ok = np.isfinite(k_res) & np.isfinite(t_res)
    kernel_vs_twin = float(np.abs(k_res - t_res)[ok].max())
    trusted = (kf == 0) & np.isfinite(k_res) & (k_res >= -600.0)
    trusted_err = float(np.abs(k_res - exact)[trusted].max()) if trusted.any() else 0.0
    missed = (tf != 0) & (kf == 0)
    # a twin-flagged lane the kernel trusts is acceptable only where the
    # kernel's own result already agrees with the exact f64 value
    missed_bad = missed & ~(np.abs(k_res - exact) < TOL_ORACLE)
    log("2 kernel_vs_twin", shape="deep", lanes=pk.n_real, min_log10=float(exact.min()),
        max_abs_log10_kernel_vs_twin=kernel_vs_twin, flags_kernel=int((kf != 0).sum()),
        flags_twin=int((tf != 0).sum()), twin_only_flags=int(missed.sum()),
        unflagged_vs_f64=trusted_err)
    if trusted_err > TOL_ORACLE:
        raise AssertionError(f"unflagged deep lanes vs f64: {trusted_err:.3e}")
    if missed_bad.any():
        raise AssertionError(f"{int(missed_bad.sum())} twin-flagged lanes unflagged and wrong")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_golden():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden

    from gkl_tpu_torch import HaplotypeData, PairHMM, PairHMMNativeArguments, ReadData

    cases = golden.load_pairhmm_cases()
    expected = np.array([c.expected for c in cases])
    for dbl in (False, True):
        hmm = PairHMM(PairHMMNativeArguments(use_double_precision=dbl))
        got = np.array([hmm.compute_likelihoods([ReadData(c.read, c.q, c.iq, c.dq, c.gcp)],
                                                [HaplotypeData(c.hap)])[0] for c in cases])
        err = float(np.abs(got - expected).max())
        log("3 golden", double=dbl, cases=len(cases), max_abs_err=err)
        if err > TOL_IN_RANGE:
            raise AssertionError(f"golden (double={dbl}): max |err| = {err:.3e}")


def phase_bam_pipeline():
    from gkl_tpu_torch import HaplotypeData, bam, pipeline

    path = os.path.join(DATA, "HiSeq.1mb.1RG.2k_lines.bam")
    _, records = bam.read_bam(path, limit=8)
    haps = [HaplotypeData(records[i].seq) for i in (0, 1, 2, 3)]
    res = pipeline.pairhmm_bam(path, haps, limit=24, chunk_reads=8)
    names, rows = [], []
    with open(os.path.join(DATA, "pipeline_golden.txt")) as fh:
        for line in fh:
            if not line.startswith("#"):
                parts = line.split()
                names.append(parts[0])
                rows.append([float(v) for v in parts[1:]])
    if res.read_names != names:
        raise AssertionError("pipeline read names differ from the golden snapshot")
    err = float(np.abs(res.likelihoods - np.array(rows)).max())
    log("4 bam_pipeline", reads=len(names), max_abs_err=err)
    if err > TOL_IN_RANGE:
        raise AssertionError(f"pipeline golden: max |err| = {err:.3e}")


def phase_active_region():
    import torch

    from gkl_tpu_torch import HaplotypeData, PairHMM, profiling
    from gkl_tpu_torch.context import MIN_ACCEPTED
    from gkl_tpu_torch.ops import pairhmm_cuda

    class RecordingPairHMM(PairHMM):
        """The engine, keeping each batch's packing and raw kernel output
        (mantissa, exp2, flag) as its rescue policy receives them."""

        def __init__(self):
            super().__init__()
            self.batches = []

        def _forward_scaled_finalize(self, pk, stacked):
            self.batches.append((pk, stacked.copy()))
            return super()._forward_scaled_finalize(pk, stacked)

    haps, reads, deep = active_region()
    rd = to_read_data(reads)
    hd = [HaplotypeData(h) for h in haps]
    nr, nh = len(rd), len(hd)
    cells = sum(len(r.read_bases) for r in rd) * sum(len(h) for h in haps)
    hmm = RecordingPairHMM()
    os.environ.pop("GKL_TPU_RESCUE", None)  # the default (flagged) policy
    os.environ["GKL_TPU_METRICS"] = "1"
    profiling.METRICS.reset()
    pairhmm_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lik = hmm.compute_likelihoods(rd, hd).reshape(nr, nh)
    wall = time.perf_counter() - t0
    launches = pairhmm_cuda.LAUNCHES
    rescued = profiling.METRICS.snapshot().get("pairhmm_rescue", {}).get("items", 0)
    os.environ.pop("GKL_TPU_METRICS")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        PairHMM().compute_likelihoods(rd, hd)
        walls.append(time.perf_counter() - t0)

    # the main path's own kernel outputs against the twin on the same
    # batches, and its rescue recounted lane by lane from those outputs
    dev = torch.device("cuda")
    twin_err = 0.0
    lanes = dict(flagged=0, below_f32_range=0, flagged_below=0, beyond_window=0,
                 rescue_deep_reads=0, rescue_other_reads=0)
    for pk, stacked in hmm.batches:
        n = pk.n_real
        out = pairhmm_cuda.unpack(torch.from_numpy(stacked))
        e, _ = compare_to_twin(out, twin_of(device_batch(pk, dev)),
                               f"active-region batch R{pk.readq_u.shape[1]} "
                               f"H{pk.hap_u.shape[0]}", n)
        twin_err = max(twin_err, e)
        mant, ex, flag = (x.numpy()[:n] for x in out)
        raw32 = np.ldexp(mant.astype(np.float64), ex.astype(np.int64)).astype(np.float32)
        below = ~(raw32 >= MIN_ACCEPTED)
        flagged_below = below & (flag != 0)
        # past the f64 subnormal parity bound, or no finite result
        beyond = below & (flag == 0) & ~(pairhmm_cuda.log10_of(mant, ex) >= -600.0)
        rescue = flagged_below | beyond
        # deep reads are the only ones whose base quals are under 18
        deep_read = pk.readq_u[1][0, pk.ridx[:n]] <= 8
        lanes["flagged"] += int((flag != 0).sum())
        lanes["below_f32_range"] += int(below.sum())
        lanes["flagged_below"] += int(flagged_below.sum())
        lanes["beyond_window"] += int(beyond.sum())
        lanes["rescue_deep_reads"] += int((rescue & deep_read).sum())
        lanes["rescue_other_reads"] += int((rescue & ~deep_read).sum())

    sample = sorted(set(range(0, nr, 16)) | set(np.nonzero(deep)[0].tolist()))
    exact = oracle([haps[j] for _ in sample for j in range(nh)],
                   [rd[i] for i in sample for _ in range(nh)]).reshape(len(sample), nh)
    err = float(np.abs(lik[sample] - exact).max())
    deep_min = float(lik[deep].min())
    log("5 active_region", reads=nr, haplotypes=nh, pairs=nr * nh, cells=cells,
        wall_s_first=wall, wall_s_median_of_3=float(np.median(walls)),
        gcells_per_s_median=cells / float(np.median(walls)) / 1e9,
        reads_per_s_median=nr / float(np.median(walls)),
        oracle_pairs=len(sample) * nh, max_abs_err=err, deep_min_log10=deep_min,
        kernel_launches=launches, batches=len(hmm.batches), kernel_vs_twin=twin_err,
        rescued_lanes=rescued, **{f"lanes_{k}": v for k, v in lanes.items()})
    if not (np.isfinite(lik).all() and (lik <= 1e-9).all()):
        raise AssertionError("non-finite or positive likelihoods")
    if err >= TOL_ORACLE:
        raise AssertionError(f"active region vs f64 oracle: max |err| = {err:.3e}")
    if deep_min >= -60.0:
        raise AssertionError(f"deep lanes not deep: min log10 = {deep_min:.1f}")
    if launches <= 0 or launches != len(hmm.batches):
        raise AssertionError(f"{launches} kernel launches for {len(hmm.batches)} batches")
    expected = lanes["flagged_below"] + lanes["beyond_window"]
    if not 0 < rescued == expected:
        raise AssertionError(f"rescue not lane-granular: {rescued} lanes rescued, {expected} "
                             f"flagged or past the window below the f32 range")
    return launches, twin_err


def phase_long_pairs():
    from gkl_tpu_torch import HaplotypeData, PairHMM, ReadData

    rng = np.random.default_rng(3)
    hap = BASES[rng.integers(0, 4, 4096)]
    rd = []
    for _ in range(6):
        start = int(rng.integers(0, 4096 - 300))
        seq = hap[start:start + 300].copy()
        mut = rng.random(300) < 0.02
        seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        n = 300
        rd.append(ReadData(seq, rng.integers(20, 40, n).astype(np.uint8),
                           np.full(n, 45, np.uint8), np.full(n, 45, np.uint8),
                           np.full(n, 10, np.uint8)))
    got = PairHMM().compute_likelihoods(rd, [HaplotypeData(hap)])
    err = float(np.abs(got - oracle([hap] * len(rd), rd)).max())
    log("6 long_pairs", H=4096, R=300, pairs=len(rd), max_abs_err=err)
    if not np.isfinite(got).all() or err >= TOL_ORACLE:
        raise AssertionError(f"long pairs vs f64 oracle: max |err| = {err:.3e}")


def main() -> int:
    sys.path.insert(0, ROOT)
    phase_device()
    import torch

    phase_build()
    timing = phase_kernel_vs_twin()
    phase_golden()
    phase_bam_pipeline()
    launches, path_err = phase_active_region()
    timing["max_abs_err"] = max(timing["max_abs_err"], path_err)
    phase_long_pairs()
    print(json.dumps({"kernels": [{
        "name": "pairhmm_scaled", "route": "cuda",
        "source": "gkl_tpu_torch/csrc/pairhmm_scaled.cu",
        "replaces": "gkl_tpu/ops/pairhmm_pallas.py:69",
        "launches": launches, **timing}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
