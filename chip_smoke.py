#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's active-region path once on one GPU.

Run from the repository root with ``python3 chip_smoke.py``.  It needs one
CUDA card of compute capability 9.0 (Hopper); without one it exits nonzero
before printing any result.  Phases, one line each (or a few):

0. device: name and power limit, torch and CUDA versions;
1. build: the CUDA kernels (one nvcc per source, sm_90a, all started
   together, linked into one library) and the host C++ libraries, with
   the registers and spills of both instances of the row kernel and of
   each instance of the column, SW and PDHMM kernels;
2. PairHMM kernel vs its plain PyTorch twin on the card at the benchmark
   shape (R=128, H=224, P=2048), with the gap quals as planes and as the
   GATK constants, both timed; and on a deep-lane batch.  Each is also held
   against the twin in the kernel's order bit for bit (mantissa, exp2 and
   flag of every lane);
3. the 104 PairHMM golden cases through ``PairHMM()`` in both precision
   modes;
4. the BAM pipeline against ``tests/data/pipeline_golden.txt``;
5. a GATK-scale active region (10,240 reads x 8 haplotypes) through
   ``PairHMM.compute_likelihoods``, checked against the f64 oracle — the
   PairHMM path's run whose kernel launches are counted and timed (CUDA
   events around each).  Each of its kernel outputs is held against the
   twin on the same batch, the largest also against the kernel-order twin
   bit for bit, and the rescue is recounted lane by lane from them; the
   warps' padding (steps run / steps needed) is logged;
6. long PairHMM pairs (H=4096, R=300, the column kernel) against the f64
   oracle;
7. Smith-Waterman kernel vs twin, bit for bit on the region the host walk
   reads (bt codes of rows < reflen and columns < altlen, lastrow[:altlen],
   lastcol[:reflen]): (a) the realignment shape N=448, M=256, P=10,240;
   (b) the haplotype-to-reference shape N=4,096, alts 600-1,000, P=256,
   each with the launch's geometry (rows a thread, passes, warps);
   (c) two pairs at the 32,767-base limit through ``SmithWaterman`` against
   the native scalar aligner;
8. PDHMM kernel vs twin (in-range lanes at 1e-5 in log10, the same lanes
   below MIN_ACCEPTED) and bit for bit vs the twin in the kernel's order:
   (a) R=256, H=448, P=8,192; (b) R=1,024, H=512, P=512, each with the
   launch's geometry (rows a thread, passes, warps);
9. the 3 PDHMM golden files through ``PDHMM()`` in both precision modes;
10. ``pipeline.region_bam`` against every column of
    ``tests/data/region_golden.txt``, then the whole test BAM with a sample
    held against the oracles;
11. the GATK-scale active region with its 4 PD haplotypes through the
    public calls in region_stream's order (``PairHMM.compute_likelihoods``
    -> argmax -> ``SmithWaterman.align_batch`` ->
    ``PDHMM.compute_likelihoods``): the main path, whose launches of all
    three kernels are counted, checked against the oracles as
    ``gkl_tpu/validation.py::check_corpus`` does, timed median of 3 (the
    first run's PairHMM, SW and PDHMM launches also by CUDA events).  Each
    SW and PDHMM launch of its first run is held against the twin on the
    same tensors, at the shapes the path gave it, the PDHMM launch also bit
    for bit against the twin in the kernel's order;
12. the long-haplotype kernels vs their twins, timed: (a) the rows kernel
    (the scaled kernel's plain instance) through ``PairHMM._raw_batch``,
    the dense batch's entry point, at phase 2's shape, also held against
    the scaled kernel's in-range lanes and bit for bit against the twin in
    the kernel's order; the column kernel, one kernel for
    both TPU kernels it replaces, (b) at R=128, H=4,096, P=2,048 (the JAX
    cols kernel's read range) and (c) at the JAX package's long-read bench
    shape, R=1,024, H=4,096, P=256 (its relay's range), each with the
    launch's geometry (rows a thread, passes, warps).  In-range lanes agree
    within TOL_IN_RANGE in log10, and the lanes below MIN_ACCEPTED are the
    same save lanes within TOL_IN_RANGE of it; the lanes that differ from
    the twin in any bit are counted (the twin runs the kernel's order);
13. the long-haplotype active region through ``PairHMM.compute_likelihoods``
    (4 haplotypes of 2,300-5,000 bases, 4,096 short reads of 101 and 151
    bases, 64 long reads of 1,000-3,000): the slice's path, whose launches
    are counted, timed median of 3 with reads/s, each launch's geometry and
    time logged.  A sample of every launch is held against the f64 oracle,
    the rescued count against the lanes
    below MIN_ACCEPTED, and the first launch of the column kernel with
    reads of up to 128 rows, and the first with longer reads, against its
    twin on the same tensors.

``python3 chip_smoke.py --profile`` runs phases 0-1 and then the main path
under ``torch.profiler`` instead: stage times, the card's busy time and
idle share, and device time by kernel and copy, as one JSON line.

The line before the last is a JSON object describing each kernel
(``launches`` from the path that reaches it: phase 11 for the scaled, SW
and PDHMM kernels, phase 13 for the column kernel, phase 12a's
``_raw_batch`` call for the rows kernel, which no group of
``compute_likelihoods`` reaches on one card, as in the JAX package;
``ms``/``plain_ms`` from phase 2's GATK constants, 12a, 12b, 7a and 8a;
``bound_ms`` the least time the card could take for that timed work;
``max_abs_err`` the largest in-range kernel-vs-twin difference seen); the
last is ``{"ok": true, "device": {...}}``.  Any failure raises.
"""

from __future__ import annotations

import json
import os
import re
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
# the JAX package's crossover between its cols and relay kernels
# (gkl_tpu/api.py COLS_MAX_READ); the port's column kernel covers both, and
# phases 12-13 show it on reads on either side
JAX_COLS_MAX_READ = 128
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# memory 3.35 TB/s, f32 outside the tensor cores 67 TFLOP/s.  int32 (the SW
# cells): the Hopper white paper's 64 INT32 units per SM, x 132 SMs x the
# 1.98 GHz boost clock.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_INT32_PER_S = 64 * 132 * 1.98e9
# operations per DP cell, counted from each kernel's inner loop (f32
# products and sums; SW: int32 sums, maximums, comparisons and ORs), and
# the bytes of the tables each kernel reads.  The PairHMM kernels also sum
# M+X over the haplen columns of row rslen-1 for the result: 2 operations
# a column of that one row (RESULT_OPS_PER_COLUMN).
OPS_PER_CELL = {"pairhmm_scaled": 11, "pairhmm_rows": 11, "pairhmm_cols": 11,
                "sw_forward": 13, "pdhmm": 12}
RESULT_OPS_PER_COLUMN = 2
TABLE_BYTES = {"pairhmm_scaled": 33536, "pairhmm_rows": 33536, "pairhmm_cols": 33536,
               "sw_forward": 0, "pdhmm": 131584}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def default_rescue_policy() -> None:
    """The PairHMM rescue's default (flagged) policy: neither
    GKL_TPU_RESCUE nor GKL_TPU_EXACT_RESCUE set."""
    for name in ("GKL_TPU_RESCUE", "GKL_TPU_EXACT_RESCUE"):
        os.environ.pop(name, None)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(kernel, io_bytes, cells, result_columns=0):
    """``bound_ms`` and ``bound_by`` of a kernel call: the larger of its
    bytes (each input read once, each output written once, its tables)
    over the memory rate and its operations (cells the data needs x
    operations per cell, plus the PairHMM result's sum over
    ``result_columns``, the lanes' haplen summed) over the peak rate of
    their type."""
    peak = PEAK_INT32_PER_S if kernel == "sw_forward" else PEAK_F32_PER_S
    t_bytes = (io_bytes + TABLE_BYTES[kernel]) / PEAK_BYTES_PER_S
    t_ops = (OPS_PER_CELL[kernel] * cells + RESULT_OPS_PER_COLUMN * result_columns) / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lane_cells(haplen, rslen) -> int:
    import torch

    return int((haplen.to(torch.int64) * rslen.to(torch.int64)).sum())


def indexed_args(planes):
    """Dense card planes (hap, read, q, iq, dq, gcp, haplen, rslen) as the
    indexed batch of ``pairhmm_rows`` and ``pairhmm_cols``: ridx = hidx =
    0..P-1 and the gap quals as planes."""
    import torch

    hap, read, q, iq, dq, gcp, haplen, rslen = planes
    lanes = torch.arange(hap.shape[1], dtype=torch.int32, device=hap.device)
    return dict(hap_u=hap, readq_u=torch.stack([read, q]).contiguous(), ridx=lanes, hidx=lanes,
                haplen=haplen, rslen=rslen, quals_u=torch.stack([iq, dq, gcp]).contiguous())


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
    deep lane (250 bases, 25% mutations, quals 4-8), and the first
    ``n_pd_haplotypes`` haplotypes again as PD haplotypes with 0-2 deletion
    events each.  Returns (haps, [(seq, qual)], deep mask, [(seq, pd)])."""
    rng = np.random.default_rng(seed)
    ancestor = BASES[rng.integers(0, 4, 420)]
    haps = []
    for i in range(n_haplotypes):
        L = int(rng.integers(160, 421)) if i else 420
        seq = ancestor[:L].copy()
        mut = rng.random(L) < 0.01
        seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        haps.append(seq)
    pd_haps = []
    for i in range(n_pd_haplotypes):
        pd = np.zeros(len(haps[i]), np.uint8)
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(4, len(haps[i]) - 12))
            span = int(rng.integers(2, 7))
            pd[j] = 2  # DEL_START
            pd[j + span] = 4  # DEL_END
        pd_haps.append((haps[i], pd))
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
    return haps, reads, deep, pd_haps


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


def twin_in_kernel_order(t, scaled=True):
    """The kernel-order twin's output of a ``device_batch``: (mantissa,
    exp2, flag), or with ``scaled=False`` the plain instance's raw f32."""
    from gkl_tpu_torch.ops import pairhmm_cuda as pc

    planes = pc.expand_indexed_planes(t["hap_u"], t["readq_u"], t["ridx"], t["hidx"],
                                      const_quals=t.get("const_quals"),
                                      quals_u=t.get("quals_u"))
    return pc.pairhmm_raw_scaled_kernel_order(*planes, t["haplen"], t["rslen"], scaled=scaled)


def lanes_not_bit_equal(kernel_out, twin_out, what) -> int:
    """Hold a scaled-kernel result (its (3, P) int32 tensor or array)
    against the kernel-order twin's (mantissa, exp2, flag), bit for bit:
    raises if any lane differs in any bit of mantissa, exp2 or flag;
    returns 0."""
    import torch

    k = torch.as_tensor(kernel_out).cpu()
    tm, te, tf = (x.cpu() for x in twin_out)
    t = torch.stack([tm.view(torch.int32), te, tf])
    differ = int((k != t).any(dim=0).sum())
    if differ:
        raise AssertionError(f"kernel vs kernel-order twin, {what}: {differ} lanes differ "
                             f"in mantissa, exp2 or flag")
    return differ


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


def timed(fn, events):
    """``fn`` with CUDA events recorded around each call into ``events``
    (device time of the launches it enqueues)."""
    import torch

    def call(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    return call


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
    """The CUDA kernels (one nvcc per source, all started together, linked
    into one library) and the host C++ libraries."""
    from gkl_tpu_torch import cuda_build, native_lib

    t0 = time.perf_counter()
    cuda_build.load()
    log("1 build", library="gkl_tpu_torch_kernels (nvcc sm_90a)",
        seconds=round(time.perf_counter() - t0, 3))
    for name in ("gkl_pairhmm_oracle", "gkl_codec", "gkl_bam", "gkl_sw_runtime",
                 "gkl_pdhmm_oracle"):
        t0 = time.perf_counter()
        native_lib.load(name)
        log("1 build", library=name, seconds=round(time.perf_counter() - t0, 3))
    build_log = cuda_build.build_log()
    for line in build_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log("1 build", ptxas=line.strip().replace(" ", "_"))
    from gkl_tpu_torch.ops import pairhmm_cols, pdhmm_cuda, sw_cuda
    row_instances = kernel_instances(build_log, r"pairhmm_kernelILb([01])E")
    for flag, kernel in (("1", "pairhmm_scaled"), ("0", "pairhmm_rows")):
        if flag not in row_instances:
            raise AssertionError(f"no {kernel} instance in the ptxas log")
        log("1 build", kernel=kernel, **row_instances[flag])
    for kernel, entry, module in (("pairhmm_cols", "pairhmm_cols_kernel", pairhmm_cols),
                                  ("sw_forward", "sw_forward_kernel", sw_cuda),
                                  ("pdhmm", "pdhmm_kernel", pdhmm_cuda)):
        instances = kernel_instances(build_log, entry + r"ILi(\d+)E")
        for rows in module.ROWS_PER_THREAD:
            if str(rows) not in instances:
                raise AssertionError(f"no {kernel} instance for {rows} rows a thread in the "
                                     f"ptxas log")
            log("1 build", kernel=kernel, rows_per_thread=rows, **instances[str(rows)])


def kernel_instances(build_log: str, pattern: str) -> dict:
    """Registers and spill bytes of each instance of a templated kernel,
    keyed by the template argument that ``pattern``'s group captures from
    the mangled entry name, from the ``-Xptxas -v`` messages."""
    found, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        arg = re.search(pattern, name or "")
        if arg is None:
            continue
        entry = found.setdefault(arg.group(1), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry.update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return found


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
        k_out = kernel(0)
        err, flags = compare_to_twin(pc.unpack(k_out), twin(0), what)
        planes = pc.expand_indexed_planes(hap, variants[0], lanes, lanes, **quals)
        not_bit_equal = lanes_not_bit_equal(
            k_out, pc.pairhmm_raw_scaled_kernel_order(*planes, haplen, rslen), what)
        if flags["lanes_in_range"] != P:
            raise AssertionError(f"{what}: {P - flags['lanes_in_range']} lanes out of f32 range")
        ms, plain_ms = cuda_ms(kernel, 50), cuda_ms(twin, 5)
        b = bound("pairhmm_scaled", nbytes(hap, variants[0], lanes, lanes, haplen, rslen,
                                           quals.get("quals_u"), k_out), cells, H * P)
        log("2 kernel_vs_twin", shape=f"R{R}_H{H}_P{P}", quals=next(iter(quals)),
            max_abs_log10_err=err, **flags, lanes_not_bit_equal_kernel_order=not_bit_equal,
            kernel_ms=ms, twin_ms=plain_ms,
            kernel_gcells_per_s=cells / ms / 1e6, twin_gcells_per_s=cells / plain_ms / 1e6, **b)
        return err, ms, plain_ms, b

    err_u, _, _, _ = bench({"quals_u": torch.stack([iq, dq, gcp]).contiguous()})
    err_c, ms, plain_ms, b = bench({"const_quals": GATK_GAP_QUALS})
    err = max(err_u, err_c)

    # deep lanes: the active region's deep reads (quals 4-8, 25% mutations)
    # against every haplotype, plus random reads at Q50 (log10 ~ -250)
    haps, reads, deep, _ = active_region(n_reads=64 * 32)
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
    k_out = pc.pairhmm_scaled(**t)
    not_bit_equal = lanes_not_bit_equal(k_out, twin_in_kernel_order(t), "deep lanes")
    km, ke, kf = (x.cpu().numpy()[: pk.n_real] for x in pc.unpack(k_out))
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
        unflagged_vs_f64=trusted_err, lanes_not_bit_equal_kernel_order=not_bit_equal)
    if trusted_err > TOL_ORACLE:
        raise AssertionError(f"unflagged deep lanes vs f64: {trusted_err:.3e}")
    if missed_bad.any():
        raise AssertionError(f"{int(missed_bad.sum())} twin-flagged lanes unflagged and wrong")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}


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

    haps, reads, deep, _ = active_region()
    rd = to_read_data(reads)
    hd = [HaplotypeData(h) for h in haps]
    nr, nh = len(rd), len(hd)
    cells = sum(len(r.read_bases) for r in rd) * sum(len(h) for h in haps)
    hmm = RecordingPairHMM()
    real_scaled, events = pairhmm_cuda.pairhmm_scaled, []
    default_rescue_policy()
    os.environ["GKL_TPU_METRICS"] = "1"
    profiling.METRICS.reset()
    pairhmm_cuda.LAUNCHES = 0
    pairhmm_cuda.pairhmm_scaled = timed(real_scaled, events)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lik = hmm.compute_likelihoods(rd, hd).reshape(nr, nh)
        wall = time.perf_counter() - t0
    finally:
        pairhmm_cuda.pairhmm_scaled = real_scaled
    launches = pairhmm_cuda.LAUNCHES
    kernel_ms = sum(s.elapsed_time(e) for s, e in events)
    rescue_metric = profiling.METRICS.snapshot().get("pairhmm_rescue", {})
    rescued = rescue_metric.get("items", 0)
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

    # the largest batch against the kernel-order twin, bit for bit; the
    # steps the warps run against the steps their lanes need
    pk, stacked = max(hmm.batches, key=lambda b: lane_cells(*(
        torch.from_numpy(getattr(b[0], k)) for k in ("haplen", "rslen"))))
    largest = f"R{pk.readq_u.shape[1]}_H{pk.hap_u.shape[0]}_P{pk.ridx.shape[0]}"
    not_bit_equal = lanes_not_bit_equal(stacked, twin_in_kernel_order(device_batch(pk, dev)),
                                        f"active-region batch {largest}")
    run, needed = (sum(x) for x in zip(*(pairhmm_cuda.band_steps(b.haplen, b.rslen)
                                         for b, _ in hmm.batches)))
    # the groups that the in-flight byte budget left to result() (the
    # batches come in dispatch order)
    inflight, lazy = 0, 0
    for b, _ in hmm.batches:
        if inflight and inflight + b.device_bytes() > PairHMM._ASYNC_INFLIGHT_BYTES:
            lazy += 1
        else:
            inflight += b.device_bytes()

    sample = sorted(set(range(0, nr, 16)) | set(np.nonzero(deep)[0].tolist()))
    exact = oracle([haps[j] for _ in sample for j in range(nh)],
                   [rd[i] for i in sample for _ in range(nh)]).reshape(len(sample), nh)
    err = float(np.abs(lik[sample] - exact).max())
    deep_min = float(lik[deep].min())
    log("5 active_region", reads=nr, haplotypes=nh, pairs=nr * nh, cells=cells,
        wall_s_first=wall, rescue_s_first=rescue_metric.get("seconds", 0.0),
        kernel_ms_first=kernel_ms, wall_s_median_of_3=float(np.median(walls)),
        gcells_per_s_median=cells / float(np.median(walls)) / 1e9,
        reads_per_s_median=nr / float(np.median(walls)),
        oracle_pairs=len(sample) * nh, max_abs_err=err, deep_min_log10=deep_min,
        kernel_launches=launches, batches=len(hmm.batches), batches_lazy=lazy,
        kernel_vs_twin=twin_err,
        largest_batch=largest, lanes_not_bit_equal_kernel_order=not_bit_equal,
        warp_steps_run=run, lane_steps_needed=needed, warp_padding=run / needed,
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
    from gkl_tpu_torch.ops import pairhmm_cols, pairhmm_cuda

    cols, scaled = pairhmm_cols.LAUNCHES, pairhmm_cuda.LAUNCHES
    got = PairHMM().compute_likelihoods(rd, [HaplotypeData(hap)])
    err = float(np.abs(got - oracle([hap] * len(rd), rd)).max())
    log("6 long_pairs", H=4096, R=300, pairs=len(rd), max_abs_err=err,
        launches_pairhmm_cols=pairhmm_cols.LAUNCHES - cols,
        launches_pairhmm_scaled=pairhmm_cuda.LAUNCHES - scaled)
    if not np.isfinite(got).all() or err >= TOL_ORACLE:
        raise AssertionError(f"long pairs vs f64 oracle: max |err| = {err:.3e}")
    if (pairhmm_cols.LAUNCHES - cols, pairhmm_cuda.LAUNCHES - scaled) != (1, 0):
        raise AssertionError("long pairs did not take the column kernel")

# HaplotypeCaller's read-to-haplotype realignment scores
SW_GATK = (200, -150, -260, -11)
SOFTCLIP, INDEL = 9, 10


def sw_batch(N, P, ref_lo, alt_lo, alt_hi, seed):
    """(ref (N, P), alt (M, P), reflen, altlen) with M the alt length's
    bucket: each alt is a window of its lane's reference with 3%
    substitutions, two deleted and two inserted bases."""
    from gkl_tpu_torch import batch as batch_mod

    rng = np.random.default_rng(seed)
    M = batch_mod.bucket_length(alt_hi)
    ref = BASES[rng.integers(0, 4, (N, P))]
    alt = np.ones((M, P), np.uint8)
    reflen = rng.integers(ref_lo, N + 1, P).astype(np.int32)
    altlen = rng.integers(alt_lo, alt_hi + 1, P).astype(np.int32)
    for p in range(P):
        n, m = int(reflen[p]), int(altlen[p])
        start = int(rng.integers(0, max(1, n - m)))
        a = np.resize(ref[start:n, p], m + 2)
        a = np.delete(a, rng.integers(0, len(a), 2))
        a = np.insert(a, rng.integers(0, len(a), 2), BASES[rng.integers(0, 4, 2)])[:m]
        mut = rng.random(m) < 0.03
        a[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        alt[:m, p] = a
    return ref, alt, reflen, altlen


def phase_sw_kernel_vs_twin():
    import torch

    from gkl_tpu_torch import api_sw
    from gkl_tpu_torch.ops import sw as sw_ops
    from gkl_tpu_torch.ops import sw_cuda

    dev = torch.device("cuda")
    timing = None
    shapes = (("7a realign", 448, 10240, 160, 48, 250, SOFTCLIP, 5),
              ("7b hap_to_ref", 4096, 256, 2049, 600, 1000, INDEL, 3))
    for what, N, P, ref_lo, alt_lo, alt_hi, strategy, reps in shapes:
        args = [torch.from_numpy(a).to(dev) for a in sw_batch(N, P, ref_lo, alt_lo, alt_hi, 7)]
        indel = strategy == INDEL

        def kernel(i):
            return sw_cuda.sw_forward(*args, *SW_GATK, indel_boundary=indel)

        def twin(i):
            return sw_ops.sw_forward(*args, *SW_GATK, indel_boundary=indel, pack_bt=True)

        k_out, t_out = kernel(0), twin(0)
        bad = sw_cuda.in_range_mismatches(k_out, t_out, args[2], args[3])
        if bad:
            raise AssertionError(f"SW kernel vs twin, {what}: {bad} in-range cells differ")
        ms, plain_ms = cuda_ms(kernel, reps), cuda_ms(twin, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt_host = k_out[0].cpu()
        copy_ms = (time.perf_counter() - t0) * 1e3
        cells = lane_cells(args[2], args[3])
        b = bound("sw_forward", nbytes(*args, *k_out), cells)
        rows, pass_rows, passes = sw_cuda.sw_geometry(N)
        log(what.split()[0] + " sw_kernel_vs_twin", shape=f"N{N}_M{args[1].shape[0]}_P{P}",
            rows_per_thread=rows, pass_rows=pass_rows, passes=passes, warps=P,
            strategy=strategy, in_range_mismatches=bad, kernel_ms=ms, twin_ms=plain_ms,
            kernel_gcells_per_s=cells / ms / 1e6, twin_gcells_per_s=cells / plain_ms / 1e6,
            bt_bytes=bt_host.numel(), bt_copy_ms=copy_ms,
            bt_copy_gb_per_s=bt_host.numel() / copy_ms / 1e6, **b)
        del k_out, t_out, bt_host
        if timing is None:
            timing = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b}

    # pairs at the length limit, one thread of 33M cells each
    rng = np.random.default_rng(8)
    long_seq = BASES[rng.integers(0, 4, api_sw.MAX_SW_SEQUENCE_LENGTH)]
    window = long_seq[20000:21000].copy()
    mut = rng.random(1000) < 0.03
    window[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    params = api_sw.SWParameters(*SW_GATK)
    sw = api_sw.SmithWaterman()
    for what, ref, alt in (("32767_ref_vs_1000_alt", long_seq, window),
                           ("1000_ref_vs_32767_alt", window, long_seq)):
        if not sw._device_eligible(len(ref), len(alt)):
            raise AssertionError(f"{what} is not a device pair")
        launches = sw_cuda.LAUNCHES
        t0 = time.perf_counter()
        got = sw.align(ref, alt, params, api_sw.OverhangStrategy.SOFTCLIP)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = api_sw.sw_align_scalar_batch([ref], [alt], params, SOFTCLIP)[0]
        scalar_s = time.perf_counter() - t0
        log("7c sw_length_limit", pair=what, launches=sw_cuda.LAUNCHES - launches,
            device_wall_s=wall, scalar_s=scalar_s, cigar_len=len(got.cigar),
            offset=got.alignment_offset)
        if sw_cuda.LAUNCHES != launches + 1:
            raise AssertionError(f"{what}: the kernel did not run")
        if (got.cigar, got.alignment_offset) != (want.cigar, want.alignment_offset):
            raise AssertionError(f"{what}: {got} != scalar {want}")
    return timing


def pdhmm_batch(R, H, P, seed):
    """An indexed PDHMM batch of P lanes (one unique read and haplotype per
    lane) as card tensors: reads are mutated haplotype windows, every 16th
    a random read (deep); half the lanes carry a deletion event and a
    quarter a PD SNP."""
    import torch

    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, (H, P))]
    haplen = rng.integers(3 * H // 4, H + 1, P).astype(np.int32)
    rslen = rng.integers(R // 2, R + 1, P).astype(np.int32)
    read = np.resize(hap, (R, P)).copy()
    mut = rng.random((R, P)) < 0.03
    read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    read[:, ::16] = BASES[rng.integers(0, 4, (R, len(range(0, P, 16))))]
    quals = [rng.integers(18, 46, (R, P)), rng.integers(30, 46, (R, P)),
             rng.integers(30, 46, (R, P)), np.full((R, P), 10)]
    pd = np.zeros((H, P), np.uint8)
    pd[H // 4, ::2] = 2
    pd[H // 4 + 4, ::2] = 4
    pd[H // 2, 1::4] = 1 | 16
    lanes = np.arange(P, dtype=np.int32)
    arrays = dict(hap_u=hap, happd_u=pd,
                  readq_u=np.stack([read] + [q.astype(np.uint8) for q in quals]),
                  ridx=lanes, hidx=lanes, haplen=haplen, rslen=rslen)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda") for k, v in arrays.items()}


def compare_raw(k_raw, t_raw, what, near=0.0):
    """Kernel vs twin raw f32 results: every value finite, the same lanes
    below MIN_ACCEPTED (save lanes within ``near`` in log10 of it), and the
    lanes both put in range within TOL_IN_RANGE in log10.  Returns (max
    |log10 diff|, lanes below in the twin)."""
    from gkl_tpu_torch.context import MIN_ACCEPTED

    k, t = k_raw.cpu().numpy(), t_raw.cpu().numpy()
    for name, x in (("kernel", k), ("twin", t)):
        if not np.isfinite(x).all():
            raise AssertionError(f"{what}: {int((~np.isfinite(x)).sum())} non-finite "
                                 f"{name} results")
    below_k, below_t = k < MIN_ACCEPTED, t < MIN_ACCEPTED
    with np.errstate(divide="ignore"):
        lk, lt = np.log10(k.astype(np.float64)), np.log10(t.astype(np.float64))
    differ = (below_k != below_t) & ~(np.abs(lt - np.log10(float(MIN_ACCEPTED))) < near)
    if differ.any():
        raise AssertionError(f"{what}: {int(differ.sum())} lanes are below MIN_ACCEPTED "
                             f"in one engine only")
    ok = ~below_t & ~below_k
    err = float(np.abs(lk[ok] - lt[ok]).max()) if ok.any() else 0.0
    if not err <= TOL_IN_RANGE:
        raise AssertionError(f"{what}: max |log10 diff| = {err:.3e}")
    return err, int(below_t.sum())


def pdhmm_lanes_not_bit_equal(k_raw, t, what) -> int:
    """Hold a PDHMM kernel result against the twin in the kernel's order
    (``pdhmm_cuda.pdhmm_kernel_order``) on the same inputs, bit for bit:
    raises if any lane's f32 differs in any bit; returns 0."""
    import torch

    from gkl_tpu_torch.ops import pdhmm_cuda

    want = pdhmm_cuda.pdhmm_kernel_order(**t)
    differ = int((k_raw.view(torch.int32) != want.view(torch.int32)).sum())
    if differ:
        raise AssertionError(f"PDHMM kernel vs kernel-order twin, {what}: {differ} lanes differ")
    return differ


def phase_pdhmm_kernel_vs_twin():
    import torch

    from gkl_tpu_torch.ops import pdhmm_cuda

    timing = None
    for what, R, H, P, reps in (("8a corpus", 256, 448, 8192, 5),
                                ("8b long_reads", 1024, 512, 512, 3)):
        t = pdhmm_batch(R, H, P, seed=11)
        k_out = pdhmm_cuda.pdhmm(**t)
        err, below = compare_raw(k_out, pdhmm_cuda.pdhmm_indexed_reference(**t),
                                 f"PDHMM {what}")
        differ = pdhmm_lanes_not_bit_equal(k_out, t, what)
        ms = cuda_ms(lambda i: pdhmm_cuda.pdhmm(**t), reps)
        plain_ms = cuda_ms(lambda i: pdhmm_cuda.pdhmm_indexed_reference(**t), 1)
        cells = lane_cells(t["haplen"], t["rslen"])
        b = bound("pdhmm", nbytes(*t.values(), k_out), cells)
        rows, pass_rows, passes = pdhmm_cuda.pdhmm_geometry(R)
        log(what.split()[0] + " pdhmm_kernel_vs_twin", shape=f"R{R}_H{H}_P{P}",
            rows_per_thread=rows, pass_rows=pass_rows, passes=passes, warps=P,
            max_abs_log10_err=err, lanes_below_min_accepted=below,
            lanes_not_bit_equal_kernel_order=differ, kernel_ms=ms,
            twin_ms=plain_ms, kernel_gcells_per_s=cells / ms / 1e6,
            twin_gcells_per_s=cells / plain_ms / 1e6, x_bound=ms / b["bound_ms"], **b)
        if timing is None:
            timing = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
        timing["max_abs_err"] = max(timing["max_abs_err"], err)
    return timing


def flat_pdhmm(cases):
    """The flat (batch, maxLen) arrays of ``PDHMM.compute_pdhmm``."""
    hl = np.array([len(c.hap) for c in cases])
    rl = np.array([len(c.read) for c in cases])
    hap = np.zeros((len(cases), hl.max()), np.uint8)
    pd = np.zeros_like(hap)
    planes = [np.zeros((len(cases), rl.max()), np.uint8) for _ in range(5)]
    for i, c in enumerate(cases):
        hap[i, :hl[i]], pd[i, :hl[i]] = c.hap, c.hap_pd
        for plane, v in zip(planes, (c.read, c.q, c.iq, c.dq, c.gcp)):
            plane[i, :rl[i]] = v
    return (hap, pd, *planes, hl, rl)


def phase_pdhmm_golden():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden

    from gkl_tpu_torch import PDHMM, PDHMMNativeArguments
    from gkl_tpu_torch.ops import pdhmm_cuda

    for name in ("pdhmm_syn_990_1_2.txt", "pdhmm_syn_199_68_51.txt",
                 "pdhmm_syn_1412_129_223.txt"):
        cases = golden.load_pdhmm_cases(name)
        for dbl in (False, True):
            launches = pdhmm_cuda.LAUNCHES
            got = PDHMM(PDHMMNativeArguments(use_double_precision=dbl)).compute_pdhmm(
                *flat_pdhmm(cases))
            err = float(np.abs(got - np.array([c.expected for c in cases])).max())
            log("9 pdhmm_golden", file=name, double=dbl, cases=len(cases), max_abs_err=err,
                launches=pdhmm_cuda.LAUNCHES - launches)
            if err > TOL_ORACLE:
                raise AssertionError(f"PDHMM golden {name} (double={dbl}): {err:.3e}")
            if (pdhmm_cuda.LAUNCHES == launches) != dbl:
                raise AssertionError(f"PDHMM golden {name}: kernel launches do not fit the mode")


def region_haplotypes(records):
    from gkl_tpu_torch import HaplotypeData, PDHaplotypeData

    haps = [HaplotypeData(records[i].seq) for i in (0, 1, 2, 3)]
    pd0 = np.zeros(len(records[0].seq), np.uint8)
    pd0[10] = 2  # DEL_START
    pd0[13] = 4  # DEL_END
    pd_haps = [PDHaplotypeData(records[0].seq, haplotype_pdbases=pd0),
               PDHaplotypeData(records[1].seq,
                               haplotype_pdbases=np.zeros(len(records[1].seq), np.uint8))]
    return haps, pd_haps


def region_golden():
    """The columns of ``tests/data/region_golden.txt``: names, best
    haplotypes, offsets, CIGARs, likelihoods (n, 4), PD likelihoods (n, 2)."""
    names, bests, offs, cigars, liks, pdliks = [], [], [], [], [], []
    with open(os.path.join(DATA, "region_golden.txt")) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            p = line.split()
            names.append(p[0])
            bests.append(int(p[1]))
            offs.append(int(p[2]))
            cigars.append(p[3])
            liks.append([float(v) for v in p[4:8]])
            pdliks.append([float(v) for v in p[8:10]])
    return names, bests, offs, cigars, np.array(liks), np.array(pdliks)


def check_region_sample(reads, sample, lik, cigars, offsets, best, pd_lik, haps, pd_haps):
    """``check_corpus``'s oracle legs on the sampled reads: PairHMM and
    PDHMM against their f64 oracles at TOL_ORACLE, SW CIGAR and offset
    against the native scalar aligner.  Returns (PairHMM err, PDHMM err,
    SW reads checked)."""
    from gkl_tpu_torch import api_sw
    from gkl_tpu_torch.ops import pdhmm_ref

    nh = len(haps)
    exact = oracle([haps[j] for _ in sample for j in range(nh)],
                   [reads[i] for i in sample for _ in range(nh)]).reshape(len(sample), nh)
    err = float(np.abs(lik[sample] - exact).max())
    sw_want = api_sw.sw_align_scalar_batch(
        [haps[best[i]] for i in sample], [reads[i].read_bases for i in sample],
        api_sw.SWParameters(*SW_GATK), SOFTCLIP)
    for i, w in zip(sample, sw_want):
        if (cigars[i], int(offsets[i])) != (w.cigar, w.alignment_offset):
            raise AssertionError(f"SW read {i}: {cigars[i]} {offsets[i]} != scalar "
                                 f"{w.cigar} {w.alignment_offset}")
    pd_exact = pdhmm_ref.pdhmm_scalar_batch(
        [h for _ in sample for h, _ in pd_haps], [p for _ in sample for _, p in pd_haps],
        [reads[i].read_bases for i in sample for _ in pd_haps],
        [(reads[i].read_quals, reads[i].insertion_gop, reads[i].deletion_gop,
          reads[i].overall_gcp) for i in sample for _ in pd_haps]).reshape(len(sample), -1)
    pd_err = float(np.abs(pd_lik[sample] - pd_exact).max())
    for name, e in (("PairHMM", err), ("PDHMM", pd_err)):
        if not e < TOL_ORACLE:
            raise AssertionError(f"{name} sample vs f64 oracle: max |err| = {e:.3e}")
    for name, x in (("PairHMM", lik), ("PDHMM", pd_lik)):
        if not (np.isfinite(x).all() and (x <= 1e-9).all()):
            raise AssertionError(f"non-finite or positive {name} likelihoods")
    return err, pd_err, len(sample)


def phase_region():
    from gkl_tpu_torch import bam, pipeline

    path = os.path.join(DATA, "HiSeq.1mb.1RG.2k_lines.bam")
    _, records = bam.read_bam(path, limit=8)
    haps, pd_haps = region_haplotypes(records)
    res = pipeline.region_bam(path, haps, pd_haplotypes=pd_haps, limit=24, chunk_reads=8)
    names, bests, offs, cigars, liks, pdliks = region_golden()
    if (res.read_names, list(res.best_haplotype), list(res.offsets), res.cigars) != \
            (names, bests, offs, cigars):
        raise AssertionError("region names, best haplotypes, offsets or CIGARs differ "
                             "from the golden snapshot")
    err = float(np.abs(res.likelihoods - liks).max())
    pd_err = float(np.abs(res.pd_likelihoods - pdliks).max())
    log("10 region_golden", reads=len(names), columns_exact=4, lik_max_abs_err=err,
        pd_lik_max_abs_err=pd_err)
    if err > TOL_IN_RANGE or pd_err > TOL_ORACLE:
        raise AssertionError(f"region golden: {err:.3e} / {pd_err:.3e}")

    # the whole BAM, a sample of every 16th read against the oracles
    t0 = time.perf_counter()
    res = pipeline.region_bam(path, haps, pd_haplotypes=pd_haps)
    wall = time.perf_counter() - t0
    _, records = bam.read_bam(path)
    kept = [r for r in records if not pipeline._is_filtered(r) and len(r.seq)]
    if [r.name for r in kept] != res.read_names:
        raise AssertionError("region_bam dropped or reordered reads")
    reads = pipeline.reads_from_records(kept)
    sample = list(range(0, len(reads), 16))
    err, pd_err, n_sw = check_region_sample(
        reads, sample, res.likelihoods, res.cigars, res.offsets, res.best_haplotype,
        res.pd_likelihoods, [h.haplotype_bases for h in haps],
        [(h.haplotype_bases, h.haplotype_pdbases) for h in pd_haps])
    log("10 region_whole_bam", reads=len(reads), wall_s=wall, sampled_reads=len(sample),
        pairhmm_max_abs_err=err, pdhmm_max_abs_err=pd_err, sw_reads_exact=n_sw)


def region_corpus():
    """The full-size corpus as the public calls take it."""
    from gkl_tpu_torch import HaplotypeData, PDHaplotypeData

    haps, reads, deep, pd_pairs = active_region()
    return dict(haps=haps, deep=deep, pd_pairs=pd_pairs, rd=to_read_data(reads),
                hd=[HaplotypeData(h) for h in haps],
                pdd=[PDHaplotypeData(h, haplotype_pdbases=p) for h, p in pd_pairs])


def run_region(c, hmm, sw, pdhmm):
    """region_stream's three calls, in its order, once on corpus ``c``.
    Returns the outputs and each stage's wall seconds."""
    import torch

    from gkl_tpu_torch import SWParameters
    from gkl_tpu_torch.api_sw import OverhangStrategy

    nr = len(c["rd"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lik = hmm.compute_likelihoods(c["rd"], c["hd"]).reshape(nr, len(c["hd"]))
    t1 = time.perf_counter()
    best = np.argmax(lik, axis=1)
    aligned = sw.align_batch([c["haps"][b] for b in best], [r.read_bases for r in c["rd"]],
                             SWParameters(*SW_GATK), OverhangStrategy.SOFTCLIP)
    t2 = time.perf_counter()
    pd_lik = pdhmm.compute_likelihoods(c["rd"], c["pdd"]).reshape(nr, len(c["pdd"]))
    t3 = time.perf_counter()
    return (lik, best, aligned, pd_lik), (t1 - t0, t2 - t1, t3 - t2)


def phase_region_corpus():
    """The main path: region_stream's three calls on the full-size corpus,
    three times; launches and stage times are read around each run.  The
    first run's outputs are checked against the oracles, and each SW and
    PDHMM launch it made is held against the twin on the same tensors."""
    from gkl_tpu_torch import PDHMM, PairHMM, SmithWaterman, profiling
    from gkl_tpu_torch.ops import pairhmm_cuda, pdhmm_cuda, sw_cuda
    from gkl_tpu_torch.ops import sw as sw_ops

    c = region_corpus()
    nr = len(c["rd"])
    engines = (PairHMM(), SmithWaterman(), PDHMM())
    real_sw, real_pd, real_hmm = sw_cuda.sw_forward, pdhmm_cuda.pdhmm, pairhmm_cuda.pairhmm_scaled
    calls = {"sw_forward": [], "pdhmm": []}
    hmm_events = []  # CUDA events around the first run's PairHMM launches
    sw_events = []  # around its SW launches
    pd_events = []  # and around its PDHMM launches
    timed_sw, timed_pd = timed(real_sw, sw_events), timed(real_pd, pd_events)

    def recording_sw(*args, **kw):
        out = timed_sw(*args, **kw)
        calls["sw_forward"].append((args, kw, out))
        return out

    def recording_pd(**t):
        out = timed_pd(**t)
        calls["pdhmm"].append((t, out))
        return out

    default_rescue_policy()
    os.environ["GKL_TPU_METRICS"] = "1"
    runs = []
    for k in range(3):
        profiling.METRICS.reset()
        pairhmm_cuda.LAUNCHES = sw_cuda.LAUNCHES = pdhmm_cuda.LAUNCHES = 0
        if k == 0:
            sw_cuda.sw_forward, pdhmm_cuda.pdhmm = recording_sw, recording_pd
            pairhmm_cuda.pairhmm_scaled = timed(real_hmm, hmm_events)
        try:
            outputs, (pairhmm_s, sw_s, pdhmm_s) = run_region(c, *engines)
        finally:
            sw_cuda.sw_forward, pdhmm_cuda.pdhmm = real_sw, real_pd
            pairhmm_cuda.pairhmm_scaled = real_hmm
        m = profiling.METRICS.snapshot()
        runs.append(dict(
            outputs=outputs,
            launches={"pairhmm_scaled": pairhmm_cuda.LAUNCHES, "sw_forward": sw_cuda.LAUNCHES,
                      "pdhmm": pdhmm_cuda.LAUNCHES},
            pairhmm_s=pairhmm_s, sw_s=sw_s, pdhmm_s=pdhmm_s,
            wall_s=pairhmm_s + sw_s + pdhmm_s,
            pairhmm_rescued=m.get("pairhmm_rescue", {}).get("items", 0),
            pairhmm_rescue_s=m.get("pairhmm_rescue", {}).get("seconds", 0.0),
            sw_bt_bytes=m.get("sw_bt_copy", {}).get("items", 0),
            sw_bt_copy_s=m.get("sw_bt_copy", {}).get("seconds", 0.0),
            sw_host_walk_s=m.get("sw_host_walk", {}).get("seconds", 0.0),
            pdhmm_rescued=m.get("pdhmm_rescue", {}).get("items", 0),
            pdhmm_rescue_s=m.get("pdhmm_rescue", {}).get("seconds", 0.0)))
    os.environ.pop("GKL_TPU_METRICS")
    launches = runs[0]["launches"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path did not run: {launches}")

    # the first run's own SW and PDHMM launches against the twins
    for name in calls:
        if len(calls[name]) != launches[name]:
            raise AssertionError(f"{len(calls[name])} {name} calls recorded for "
                                 f"{launches[name]} launches")
    for (args, kw, k_out), (start, end) in zip(calls.pop("sw_forward"), sw_events):
        ref, alt, reflen, altlen = args[:4]
        bad = sw_cuda.in_range_mismatches(
            k_out, sw_ops.sw_forward(*args, **kw, pack_bt=True), reflen, altlen)
        log("11 region_kernel_vs_twin", kernel="sw_forward",
            shape=f"N{ref.shape[0]}_M{alt.shape[0]}_P{ref.shape[1]}",
            rows_per_thread=sw_cuda.sw_geometry(ref.shape[0])[0],
            kernel_ms=start.elapsed_time(end), in_range_mismatches=bad)
        if bad:
            raise AssertionError(f"SW kernel vs twin on the main path: {bad} cells differ")
    pd_err = 0.0
    for (t, k_raw), (start, end) in zip(calls.pop("pdhmm"), pd_events):
        R = t["readq_u"].shape[1]
        shape = (f"R{R}_H{t['hap_u'].shape[0]}_P{t['ridx'].shape[0]}"
                 f"_unique_reads{t['readq_u'].shape[2]}_unique_haps{t['hap_u'].shape[1]}")
        err, below = compare_raw(k_raw, pdhmm_cuda.pdhmm_indexed_reference(**t),
                                 f"PDHMM main path {shape}")
        differ = pdhmm_lanes_not_bit_equal(k_raw, t, f"main path {shape}")
        rows, _, passes = pdhmm_cuda.pdhmm_geometry(R)
        log("11 region_kernel_vs_twin", kernel="pdhmm", shape=shape, rows_per_thread=rows,
            passes=passes, kernel_ms=start.elapsed_time(end), max_abs_log10_err=err,
            lanes_below_min_accepted=below, lanes_not_bit_equal_kernel_order=differ)
        pd_err = max(pd_err, err)

    lik, best, aligned, pd_lik = runs[0]["outputs"]
    sample = sorted(set(range(0, nr, 16)) | set(np.nonzero(c["deep"])[0].tolist()))
    err, pd_oracle_err, n_sw = check_region_sample(
        c["rd"], sample, lik, [a.cigar for a in aligned], [a.alignment_offset for a in aligned],
        best, pd_lik, c["haps"], c["pd_pairs"])
    med = {k: float(np.median([r[k] for r in runs])) for k in
           ("wall_s", "pairhmm_s", "pairhmm_rescue_s", "sw_s", "pdhmm_s", "sw_bt_copy_s",
            "sw_host_walk_s", "pdhmm_rescue_s")}
    log("11 region_corpus", reads=nr, haplotypes=len(c["hd"]), pd_haplotypes=len(c["pdd"]),
        **{f"launches_{k}": v for k, v in launches.items()},
        **{f"{k}_median_of_3": v for k, v in med.items()},
        reads_per_s_median=nr / med["wall_s"],
        pairhmm_kernel_ms_first=sum(s.elapsed_time(e) for s, e in hmm_events),
        sw_kernel_ms_first=sum(s.elapsed_time(e) for s, e in sw_events),
        pdhmm_kernel_ms_first=sum(s.elapsed_time(e) for s, e in pd_events),
        pairhmm_rescued_lanes=runs[0]["pairhmm_rescued"],
        pdhmm_lanes=nr * len(c["pdd"]), pdhmm_rescued_lanes=runs[0]["pdhmm_rescued"],
        sw_bt_bytes=runs[0]["sw_bt_bytes"], oracle_sample_reads=len(sample),
        pairhmm_max_abs_err=err, pdhmm_max_abs_err=pd_oracle_err, sw_reads_exact=n_sw)
    if n_sw < 640:
        raise AssertionError(f"only {n_sw} SW reads checked")
    return launches, pd_err


def dense_batch(R, H, P, seed, mut, deep_every=16):
    """Dense planes as card tensors, in the order of ``pairhmm_cols``'s
    arguments: ragged lengths (haplen 3H/4..H, rslen R/2..R), reads are
    windows of their lane's haplotype with ``mut`` substitutions, quals
    18-45, gap quals 30-45 and GCP 10; every ``deep_every``-th lane a random
    read (below MIN_ACCEPTED)."""
    import torch

    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, (H, P))]
    haplen = rng.integers(3 * H // 4, H + 1, P).astype(np.int32)
    rslen = rng.integers(R // 2, R + 1, P).astype(np.int32)
    start = rng.integers(0, haplen - rslen + 1)
    rows = np.minimum(start[None, :] + np.arange(R)[:, None], H - 1)
    read = np.take_along_axis(hap, rows, axis=0)
    m = rng.random((R, P)) < mut
    read[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    read[:, ::deep_every] = BASES[rng.integers(0, 4, (R, len(range(0, P, deep_every))))]
    quals = [rng.integers(18, 46, (R, P)), rng.integers(30, 46, (R, P)),
             rng.integers(30, 46, (R, P)), np.full((R, P), 10)]
    arrays = [hap, read, *(q.astype(np.uint8) for q in quals), haplen, rslen]
    return [torch.from_numpy(np.ascontiguousarray(a)).to("cuda") for a in arrays]


def phase_long_kernels():
    """12: the rows kernel through ``_raw_batch`` and the column kernel on
    reads in the ranges of both TPU kernels it replaces, each against its
    twin on the same card tensors, timed.  Returns the kernels-line entries
    of the rows and column kernels and the rows kernel's launches through
    ``_raw_batch``."""
    import torch

    from gkl_tpu_torch import PairHMM
    from gkl_tpu_torch import batch as batch_mod
    from gkl_tpu_torch.context import MIN_ACCEPTED
    from gkl_tpu_torch.ops import pairhmm as pairhmm_ops
    from gkl_tpu_torch.ops import pairhmm_cols
    from gkl_tpu_torch.ops import pairhmm_cuda as pc

    dev = torch.device("cuda")
    # (a) the rows kernel at phase 2's shape, through the dense batch's
    # entry point, then timed on the same card tensors
    arrays = gatk_like_batch(128, 224, 2048)
    (H, P), R = arrays[0].shape, arrays[1].shape[0]
    hap, read, q, iq, dq, gcp, haplen, rslen = (torch.from_numpy(a).to(dev) for a in arrays)
    pc.ROWS_LAUNCHES = 0
    raw = PairHMM()._raw_batch(batch_mod.PackedPairs(*arrays, n_real=P))
    rows_launches = pc.ROWS_LAUNCHES
    if rows_launches != 1:
        raise AssertionError(f"_raw_batch made {rows_launches} rows-kernel launches, not 1")
    lanes = torch.arange(P, dtype=torch.int32, device=dev)
    quals_u = torch.stack([iq, dq, gcp]).contiguous()
    variants = [torch.stack([read, q + i]).contiguous() for i in range(3)]

    def rows(i):
        return pc.pairhmm_rows(hap, variants[i % 3], lanes, lanes, haplen, rslen, quals_u=quals_u)

    def rows_twin(i):
        planes = pc.expand_indexed_planes(hap, variants[i % 3], lanes, lanes, quals_u=quals_u)
        return pairhmm_ops.pairhmm_raw(*planes, haplen, rslen, dtype="float32")

    k_raw = torch.from_numpy(raw)
    err, below = compare_raw(k_raw, rows_twin(0), "rows kernel vs twin", near=TOL_IN_RANGE)
    if not torch.equal(rows(0).cpu(), k_raw):
        raise AssertionError("rows kernel: _raw_batch and the wrapper differ on one batch")
    planes = pc.expand_indexed_planes(hap, variants[0], lanes, lanes, quals_u=quals_u)
    order = pc.pairhmm_raw_scaled_kernel_order(*planes, haplen, rslen, scaled=False).cpu()
    not_bit_equal = int((k_raw.view(torch.int32) != order.view(torch.int32)).sum())
    if not_bit_equal:
        raise AssertionError(f"rows kernel vs kernel-order twin: {not_bit_equal} lanes differ")
    mant, ex, _ = (t.cpu().numpy() for t in pc.unpack(pc.pairhmm_scaled(
        hap, variants[0], lanes, lanes, haplen, rslen, quals_u=quals_u)))
    scaled_log = np.log10(mant.astype(np.float64)) + ex * np.log10(2.0)
    in_range = raw >= MIN_ACCEPTED
    vs_scaled = float(np.abs(np.log10(raw[in_range].astype(np.float64))
                             - scaled_log[in_range]).max())
    if not vs_scaled <= TOL_IN_RANGE:
        raise AssertionError(f"rows kernel vs scaled kernel: {vs_scaled:.3e}")
    ms, plain_ms = cuda_ms(rows, 50), cuda_ms(rows_twin, 5)
    cells = R * H * P
    b = bound("pairhmm_rows", nbytes(hap, variants[0], quals_u, lanes, lanes, haplen, rslen,
                                     k_raw), cells, H * P)
    log("12a rows_kernel_vs_twin", shape=f"R{R}_H{H}_P{P}", launches_via_raw_batch=rows_launches,
        max_abs_log10_err=err, lanes_below_min_accepted=below,
        lanes_not_bit_equal_kernel_order=not_bit_equal,
        max_abs_log10_vs_scaled_in_range=vs_scaled, kernel_ms=ms, twin_ms=plain_ms,
        kernel_gcells_per_s=cells / ms / 1e6, twin_gcells_per_s=cells / plain_ms / 1e6, **b)
    rows_entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}

    # the column kernel, one launch for any read length: (b) reads of up
    # to 128 rows (the JAX cols kernel's range), (c) the JAX package's
    # long-read bench shape (its relay's range), the twin in one chunk
    cols_entry = None
    for what, jax_kernel, R, H, P, mut, iters in (
            ("12b", "_kernel", 128, 4096, 2048, 0.02, 10),
            ("12c", "_kernel_relay", 1024, 4096, 256, 0.003, 3)):
        planes = dense_batch(R, H, P, seed=R, mut=mut)
        t = indexed_args(planes)
        variants = [torch.stack([planes[1], planes[2] + i]).contiguous() for i in range(3)]

        def kernel(i):
            return pairhmm_cols.pairhmm_cols(**dict(t, readq_u=variants[i % 3]))

        def twin(i):
            return pairhmm_cols.pairhmm_raw_cols(planes[0], planes[1], planes[2] + i % 3,
                                                 *planes[3:])

        k_out, t_out = kernel(0), twin(0)
        err, below = compare_raw(k_out, t_out, f"column kernel vs twin, {what}",
                                 near=TOL_IN_RANGE)
        ms, plain_ms = cuda_ms(kernel, iters), cuda_ms(twin, 1)
        cells = lane_cells(t["haplen"], t["rslen"])
        b = bound("pairhmm_cols", nbytes(*t.values(), k_out), cells, int(t["haplen"].sum()))
        log(f"{what} cols_kernel_vs_twin", shape=f"R{R}_H{H}_P{P}",
            range_of=f"pairhmm_pallas_cols.{jax_kernel}", **cols_launch_geometry(t),
            max_abs_log10_err=err, lanes_not_bit_equal=int((k_out != t_out).sum()),
            lanes_below_min_accepted=below, kernel_ms=ms, twin_ms=plain_ms,
            kernel_gcells_per_s=cells / ms / 1e6, twin_gcells_per_s=cells / plain_ms / 1e6, **b)
        if cols_entry is None:
            cols_entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
        cols_entry["max_abs_err"] = max(cols_entry["max_abs_err"], err)
        del planes, t, variants, k_out, t_out
    return rows_entry, cols_entry, rows_launches


def cols_launch_geometry(t) -> dict:
    """Rows a thread, rows a pass, passes and warps (one a lane) of a
    column-kernel launch on the indexed batch ``t``."""
    from gkl_tpu_torch.ops import pairhmm_cols

    rows, pass_rows, passes = pairhmm_cols.cols_geometry(t["readq_u"].shape[1])
    return {"rows_per_thread": rows, "pass_rows": pass_rows, "passes": passes,
            "warps": t["ridx"].shape[0]}


def long_region(seed=0):
    """The long-haplotype active region: 4 haplotypes of 2,300, 3,000, 4,000
    and 5,000 bases on one random backbone, each with its own 0.5% SNPs and
    three indels of 1-10 bases; 4,096 short reads (the first half 101
    bases, the second 151) sampled from a haplotype with quals 18-45 and 1%
    mutations, every 64th a deep read (quals 4-8, 25% mutations, as
    ``gkl_tpu/validation.py::build_corpus``); 64 HiFi-class reads of
    1,000-3,000 bases, quals 20-40, 0.2-0.5% mutations.  Returns (haps,
    [(seq, qual)], deep mask)."""
    rng = np.random.default_rng(seed)
    backbone = BASES[rng.integers(0, 4, 5100)]
    haps = []
    for L in (2300, 3000, 4000, 5000):
        seq = backbone.copy()
        snp = rng.random(len(seq)) < 0.005
        seq[snp] = BASES[rng.integers(0, 4, int(snp.sum()))]
        for _ in range(3):
            j, span = int(rng.integers(100, L - 100)), int(rng.integers(1, 11))
            if rng.random() < 0.5:
                seq = np.delete(seq, np.arange(j, j + span))
            else:
                seq = np.insert(seq, j, BASES[rng.integers(0, 4, span)])
        haps.append(seq[:L].copy())

    def sample(hap, L, rate, qlo, qhi):
        start = int(rng.integers(0, len(hap) - L + 1))
        seq = hap[start:start + L].copy()
        mut = rng.random(L) < rate
        seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        return seq, rng.integers(qlo, qhi, L).astype(np.uint8)

    reads, deep = [], []
    for r in range(4096):
        deep.append(r % 64 == 0)
        rate, qlo, qhi = (0.25, 4, 9) if deep[-1] else (0.01, 18, 46)
        reads.append(sample(haps[int(rng.integers(0, 4))], 101 if r < 2048 else 151,
                            rate, qlo, qhi))
    for _ in range(64):
        L = int(rng.integers(1000, 3001))
        fits = [h for h in haps if len(h) >= L]
        reads.append(sample(fits[int(rng.integers(0, len(fits)))], L,
                            float(rng.uniform(0.002, 0.005)), 20, 41))
        deep.append(False)
    return haps, reads, np.array(deep)


def phase_long_region():
    """13: the slice's path.  The long-haplotype region through
    ``PairHMM.compute_likelihoods``: a first run with each column-kernel
    launch recorded (and timed with CUDA events) and each batch's raw
    result kept, then three timed runs.  Returns (launches of the column
    kernel in the first run, largest kernel-vs-twin difference)."""
    import torch

    from gkl_tpu_torch import HaplotypeData, PairHMM, profiling
    from gkl_tpu_torch.context import MIN_ACCEPTED
    from gkl_tpu_torch.ops import pairhmm_cols, pairhmm_cuda

    class RecordingPairHMM(PairHMM):
        """The engine, keeping each column-kernel batch and its raw f32
        result as the rescue rule receives them."""

        def __init__(self):
            super().__init__()
            self.batches = []

        def _forward_raw_finalize(self, packed, raw):
            self.batches.append((packed, raw.copy()))
            return super()._forward_raw_finalize(packed, raw)

    haps, reads, deep = long_region()
    rd = to_read_data(reads)
    hd = [HaplotypeData(h) for h in haps]
    nr, nh = len(rd), len(hd)
    cells = sum(len(r.read_bases) for r in rd) * sum(len(h) for h in haps)
    real_cols = pairhmm_cols.pairhmm_cols
    calls = []

    def recording_cols(**t):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_cols(**t)
        end.record()
        calls.append((t, out, start, end))
        return out

    default_rescue_policy()
    os.environ["GKL_TPU_METRICS"] = "1"
    hmm = RecordingPairHMM()
    profiling.METRICS.reset()
    pairhmm_cols.LAUNCHES = pairhmm_cuda.LAUNCHES = pairhmm_cuda.ROWS_LAUNCHES = 0
    pairhmm_cols.pairhmm_cols = recording_cols
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = hmm.compute_likelihoods_async(rd, hd)
        t1 = time.perf_counter()
        groups = [(kind, idxs) for kind, idxs, _, _ in pending._work]
        lik = pending.result().reshape(nr, nh)
        t2 = time.perf_counter()
    finally:
        pairhmm_cols.pairhmm_cols = real_cols
    launches = {"pairhmm_cols": pairhmm_cols.LAUNCHES, "pairhmm_scaled": pairhmm_cuda.LAUNCHES,
                "pairhmm_rows": pairhmm_cuda.ROWS_LAUNCHES}
    first = profiling.METRICS.snapshot().get("pairhmm_rescue", {})
    kernel_ms = sum(s.elapsed_time(e) for _, _, s, e in calls)
    long_ms = sum(s.elapsed_time(e) for t, _, s, e in calls if t["readq_u"].shape[1] >= 1000)

    walls, rescue_s = [], []
    for _ in range(3):
        profiling.METRICS.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        PairHMM().compute_likelihoods(rd, hd)
        walls.append(time.perf_counter() - t)
        rescue_s.append(profiling.METRICS.snapshot().get("pairhmm_rescue", {}).get("seconds", 0.0))
    os.environ.pop("GKL_TPU_METRICS")

    # launches: the column kernel only, on groups in the read ranges of
    # both TPU kernels it replaces
    cols_range = [t["readq_u"].shape[1] <= JAX_COLS_MAX_READ for t, _, _, _ in calls]
    if (launches["pairhmm_cols"] != len(calls) or launches["pairhmm_scaled"]
            or launches["pairhmm_rows"] or not any(cols_range) or all(cols_range)):
        raise AssertionError(f"launches {launches}, read bucket <= 128 per launch {cols_range}")
    # the rescue: every lane below MIN_ACCEPTED, and only those
    below = sum(int(np.sum(raw[: pk.n_real] < MIN_ACCEPTED)) for pk, raw in hmm.batches)
    if not 0 < first.get("items", 0) == below:
        raise AssertionError(f"{first.get('items', 0)} lanes rescued, {below} below MIN_ACCEPTED")
    # the first launch in each range against the twin on the same tensors
    twin_err = 0.0
    for in_cols_range in (True, False):
        t, out, _, _ = calls[cols_range.index(in_cols_range)]
        shape = f"R{t['readq_u'].shape[1]}_H{t['hap_u'].shape[0]}_P{t['ridx'].shape[0]}"
        planes = pairhmm_cuda.expand_indexed_planes(
            t["hap_u"], t["readq_u"], t["ridx"], t["hidx"], const_quals=t.get("const_quals"),
            quals_u=t.get("quals_u"))
        t_out = pairhmm_cols.pairhmm_raw_cols(*planes, t["haplen"], t["rslen"])
        err, n_below = compare_raw(out, t_out, f"column kernel vs twin on the path, {shape}",
                                   near=TOL_IN_RANGE)
        log("13 long_region_kernel_vs_twin", shape=shape,
            range_of="pairhmm_pallas_cols." + ("_kernel" if in_cols_range else "_kernel_relay"),
            max_abs_log10_err=err, lanes_not_bit_equal=int((out != t_out).sum()),
            lanes_below_min_accepted=n_below)
        twin_err = max(twin_err, err)
        del planes, t_out
    # each launch's geometry and device time beside its bound
    for t, out, s, e in calls:
        tensors = [v for v in t.values() if isinstance(v, torch.Tensor)]
        log("13 long_region_launch",
            shape=f"R{t['readq_u'].shape[1]}_H{t['hap_u'].shape[0]}_P{t['ridx'].shape[0]}",
            **cols_launch_geometry(t), kernel_ms=s.elapsed_time(e),
            **bound("pairhmm_cols", nbytes(*tensors, out), lane_cells(t["haplen"], t["rslen"]),
                    int(t["haplen"].sum())))
    del calls
    # a sample of every launch (8 evenly spaced lanes) against the oracle
    flat = lik.ravel()
    sample = sorted({int(idxs[k]) for _, idxs in groups
                     for k in np.linspace(0, len(idxs) - 1, min(8, len(idxs))).astype(int)})
    exact = oracle([haps[i % nh] for i in sample], [rd[i // nh] for i in sample])
    # a long read against a haplotype that lacks most of it underflows
    # even the f64 range: there the rescue returns the oracle's -inf
    if (np.isneginf(flat[sample]) != np.isneginf(exact)).any():
        raise AssertionError("lanes past the f64 range differ from the oracle's")
    finite = np.isfinite(exact)
    err = float(np.abs(flat[sample][finite] - exact[finite]).max())
    n_long = sum(len(r.read_bases) >= 1000 for r in rd)
    log("13 long_region", reads=nr, short_reads=nr - n_long, long_reads=n_long, haplotypes=nh,
        lanes=nr * nh, cells=cells, groups=len(groups),
        launches_pairhmm_cols=launches["pairhmm_cols"],
        groups_reads_to_128=sum(cols_range),
        groups_reads_past_128=len(cols_range) - sum(cols_range),
        launches_pairhmm_scaled=launches["pairhmm_scaled"],
        launches_pairhmm_rows=launches["pairhmm_rows"],
        wall_s_first=t2 - t0, dispatch_s_first=t1 - t0, result_s_first=t2 - t1,
        kernel_ms_first=kernel_ms, kernel_ms_long_reads_first=long_ms,
        kernel_share_of_wall_first=kernel_ms / 1e3 / (t2 - t0),
        rescued_lanes=first.get("items", 0),
        rescue_s_first=first.get("seconds", 0.0), wall_s_median_of_3=float(np.median(walls)),
        rescue_s_median_of_3=float(np.median(rescue_s)),
        reads_per_s_median=nr / float(np.median(walls)),
        gcells_per_s_median=cells / float(np.median(walls)) / 1e9,
        oracle_lanes=len(sample), oracle_lanes_past_f64_range=int((~finite).sum()),
        max_abs_err=err, kernel_vs_twin=twin_err, deep_reads=int(deep.sum()),
        lanes_past_f64_range=int(np.isneginf(lik).sum()))
    if not (lik <= 1e-9).all():
        raise AssertionError("NaN or positive likelihoods")
    if err >= TOL_ORACLE:
        raise AssertionError(f"long region vs f64 oracle: max |err| = {err:.3e}")
    return launches["pairhmm_cols"], twin_err


def phase_profile():
    """``--profile``: the main path once to warm up, then once under
    ``torch.profiler``: each stage's wall time, the card's busy time (the
    union of its kernel and copy intervals), its idle share of the wall
    time, and device time by kernel or copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gkl_tpu_torch import PDHMM, PairHMM, SmithWaterman

    c = region_corpus()
    engines = (PairHMM(), SmithWaterman(), PDHMM())
    run_region(c, *engines)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, stages = run_region(c, *engines)
    wall = sum(stages)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + e - s)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({"profile": {
        "wall_s": wall, "stages_s": {"pairhmm": stages[0], "sw": stages[1],
                                     "pdhmm": stages[2]},
        "device_busy_s": busy_us / 1e6, "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_ops": [{"name": name[:80], "count": n, "ms": us / 1e3}
                       for name, (n, us) in top]}}), flush=True)


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    phase_device()
    import torch

    phase_build()
    if argv == ["--profile"]:
        phase_profile()
        return 0
    if argv:
        raise SystemExit(f"usage: {sys.argv[0]} [--profile]")
    timing = phase_kernel_vs_twin()
    phase_golden()
    phase_bam_pipeline()
    _, path_err = phase_active_region()
    timing["max_abs_err"] = max(timing["max_abs_err"], path_err)
    phase_long_pairs()
    sw_timing = phase_sw_kernel_vs_twin()
    pd_timing = phase_pdhmm_kernel_vs_twin()
    phase_pdhmm_golden()
    phase_region()
    launches, path_err = phase_region_corpus()
    pd_timing["max_abs_err"] = max(pd_timing["max_abs_err"], path_err)
    rows_timing, cols_timing, launches["pairhmm_rows"] = phase_long_kernels()
    launches["pairhmm_cols"], path_err = phase_long_region()
    cols_timing["max_abs_err"] = max(cols_timing["max_abs_err"], path_err)
    kernels = [
        ("pairhmm_scaled", "pairhmm_scaled.cu", "gkl_tpu/ops/pairhmm_pallas.py:69", timing),
        ("pairhmm_rows", "pairhmm_scaled.cu", "gkl_tpu/ops/pairhmm_pallas.py:268", rows_timing),
        ("pairhmm_cols", "pairhmm_cols.cu",
         "gkl_tpu/ops/pairhmm_pallas_cols.py:44 and :166", cols_timing),
        ("sw_forward", "sw_forward.cu", "gkl_tpu/ops/sw_pallas.py:63 and :206", sw_timing),
        ("pdhmm", "pdhmm.cu", "gkl_tpu/ops/pdhmm_pallas.py:198 and :483", pd_timing),
    ]
    band = ("eight threads a lane on an 8-row band wavefront, four lanes a warp; the "
            "renormalisation at the band barrier")
    notes = {"pairhmm_scaled": band, "pairhmm_rows": band + " (none in this instance)",
             "pairhmm_cols": "a warp per lane on an anti-diagonal wavefront, 4, 8 or 16 read "
                             "rows a thread in passes of 32 strips; one kernel for both TPU "
                             "kernels",
             "sw_forward": "a warp per lane on an anti-diagonal wavefront, 2, 4 or 8 reference "
                           "rows a thread in passes of 32 strips, the pass boundary in (P, M) "
                           "planes, bt written lane-major in 8-column words; one kernel for "
                           "both TPU kernels",
             "pdhmm": "a warp per lane on an anti-diagonal wavefront, 2, 4 or 8 read rows a "
                      "thread in passes of 32 strips, the jump state riding down the warp "
                      "with the haplotype byte, the pass boundary in (P, H) planes only past "
                      "one pass; one kernel for both TPU kernels"}
    # no single PyTorch call computes a PairHMM, PDHMM or SW forward
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"gkl_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": launches[name], **t, "library_ms": None,
        **({"note": notes[name]} if name in notes else {})}
        for name, source, replaces, t in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
