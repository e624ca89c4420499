#!/usr/bin/env python3
"""Time the PDHMM kernel's f64 instances on the lanes the long cell rescues.

    python3 scripts/torch_pdhmm_f64_rescue.py [--regions N]

draws N regions of the benchmark's long cell (``hc_long_region.region``,
its largest window, ``bench_port/gen``; seeds from ``chip_smoke``'s), runs
each through ``PDHMM()`` on one CUDA card with its rescue spied, and runs
every rescue's lanes through each f64 instance of ``csrc/pdhmm.cu`` (2 and
4 read rows a thread; ``ops/pdhmm_cuda.pdhmm_geometry`` picks 4 for these
reads) with 1, 2, 4 and 8 warps a lane (``f64_lane_warps`` picks 8 for a
few dozen lanes), each forced in turn.  It prints the card's name and
power limit, the PDHMM instances' registers and spills (``-Xptxas -v``),
then one JSON line per rescue, instance and warps a lane: lanes, the
longest read and haplotype, passes, the kernel's ms (CUDA events, mean of
3 after a warm-up), its bound at the card's FP64 rate
(``chip_smoke.bound``), the largest log10 gap to the host oracle and the
oracle's wall seconds on this host.  Last, the other side of
``f64_lane_warps``' choice: the 1,412 lanes of the deepest golden file
(a read bucket of 448 rows, four passes, every lane below MIN_ACCEPTED in
f32), many short lanes as a deep low-quality region rescues them, at 1, 2,
4 and 8 warps a lane.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402  (the repo root on sys.path first)


def main() -> int:
    import torch

    from gkl_tpu_torch import batch as batch_mod
    from gkl_tpu_torch import cuda_build
    from gkl_tpu_torch.context import pdhmm_context
    from gkl_tpu_torch.ops import pdhmm_cuda, pdhmm_ref

    parser = argparse.ArgumentParser()
    parser.add_argument("--regions", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for name, ptxas in smoke.kernel_instances(cuda_build.build_log(),
                                              r"(pdhmm_kernelI[fd]Li\d+E)").items():
        print(json.dumps({"instance": name, **ptxas}), flush=True)
    names = ("hap_u", "happd_u", "readq_u", "ridx", "hidx", "haplen", "rslen")
    L = pdhmm_context("float64").INITIAL_CONDITION_LOG10
    picked, picked_warps = pdhmm_cuda.pdhmm_geometry, pdhmm_cuda.f64_lane_warps
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for k in range(args.regions):
            t0 = time.perf_counter()
            _, rescues = smoke.long_cell_rescue(seed=smoke.LONG_CELL_SEED + k)
            call_s = time.perf_counter() - t0
            for j, (ridx, hidx, planes) in enumerate(rescues):
                pk, _ = batch_mod.pack_pdhmm_lanes(*planes, ridx, hidx)
                t = {n: torch.from_numpy(getattr(pk, n)).to("cuda") for n in names}
                t0 = time.perf_counter()
                exact = pdhmm_ref.pdhmm_scalar_batch(*planes.pairs(ridx, hidx))
                oracle_s = time.perf_counter() - t0
                cells = smoke.lane_cells(t["haplen"][:pk.n_real], t["rslen"][:pk.n_real])
                R = pk.readq_u.shape[1]
                for rows, warps in ((4, 1), (4, 2), (4, 4), (4, 8), (2, 8)):
                    pdhmm_cuda.pdhmm_geometry = (
                        lambda n, dtype="float32", r=rows: (r, 32 * r, -(-n // (32 * r))))
                    pdhmm_cuda.f64_lane_warps = lambda P, passes, sms, w=warps: w
                    raw = pdhmm_cuda.pdhmm_f64(**t)
                    with np.errstate(divide="ignore"):
                        got = np.log10(raw.cpu().numpy()[:pk.n_real]) - L
                    ms = smoke.cuda_ms(lambda i: pdhmm_cuda.pdhmm_f64(**t), 3)
                    b = smoke.bound("pdhmm_f64", smoke.nbytes(*t.values(), raw), cells)
                    print(json.dumps({
                        "region": k, "rescue": j, "call_s": call_s, "lanes": int(pk.n_real),
                        "R": int(R), "H": int(pk.hap_u.shape[0]),
                        "max_read": int(pk.rslen.max()), "max_hap": int(pk.haplen.max()),
                        "rows_per_thread": rows, "passes": pdhmm_cuda.pdhmm_geometry(R)[2],
                        "lane_warps": warps,
                        "picked": (picked(R, "float64")[0] == rows and warps == picked_warps(
                            pk.n_real, picked(R, "float64")[2], sms)), "cells": cells,
                        "kernel_ms": ms, "x_bound": ms / b["bound_ms"], **b,
                        "max_abs_log10_err_vs_oracle": float(np.abs(got - exact).max()),
                        "oracle_s": oracle_s}), flush=True)
        sys.path.insert(0, os.path.join(HERE, "tests"))
        import golden

        cases = golden.load_pdhmm_cases("pdhmm_syn_1412_129_223.txt")
        args = ([c.hap for c in cases], [c.hap_pd for c in cases], [c.read for c in cases],
                [(c.q, c.iq, c.dq, c.gcp) for c in cases])
        lanes = np.arange(len(cases))
        pk = batch_mod.pack_pdhmm_indexed(*args, lanes, lanes)
        t = {n: torch.from_numpy(getattr(pk, n)).to("cuda") for n in names}
        R = pk.readq_u.shape[1]
        cells = smoke.lane_cells(t["haplen"][:pk.n_real], t["rslen"][:pk.n_real])
        for warps in (1, 2, 4, 8):
            pdhmm_cuda.f64_lane_warps = lambda P, passes, sms, w=warps: w
            ms = smoke.cuda_ms(lambda i: pdhmm_cuda.pdhmm_f64(**t), 10)
            b = smoke.bound("pdhmm_f64", smoke.nbytes(*t.values()), cells)
            print(json.dumps({
                "golden": "pdhmm_syn_1412_129_223", "lanes": int(pk.n_real), "R": int(R),
                "H": int(pk.hap_u.shape[0]), "passes": picked(R, "float64")[2],
                "lane_warps": warps, "picked": warps == picked_warps(
                    pk.n_real, picked(R, "float64")[2], sms),
                "kernel_ms": ms, "x_bound": ms / b["bound_ms"], **b}), flush=True)
    finally:
        pdhmm_cuda.pdhmm_geometry, pdhmm_cuda.f64_lane_warps = picked, picked_warps
    return 0


if __name__ == "__main__":
    sys.exit(main())
