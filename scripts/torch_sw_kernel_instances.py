#!/usr/bin/env python3
"""Time each instance of the Smith-Waterman kernel at phase 7's shapes.

    python3 scripts/torch_sw_kernel_instances.py

runs ``gkl_tpu_torch/csrc/sw_forward.cu`` on one CUDA card with 2, 4 and 8
reference rows a thread (``ops/sw_cuda.sw_geometry`` picks one of them
from N; here each is forced in turn) at ``chip_smoke.py``'s 7a shape
(N=448, alts 48-250 in M=256, P=10,240, SOFTCLIP: a warp for each of
10,240 lanes) and 7b shape (N=4,096, alts 600-1,000 in M=1,024, P=256,
INDEL: about two warps an SM).  Each launch is held against the plain twin
(0 in-range mismatches, or it raises).  It prints the card's name and
power limit, then one JSON line per shape and instance: the ms of the
wrapper's call (CUDA events, mean of 20 or 5 calls after a warm-up; the
transposes and the zeroed outputs included), the ms of zeroing the bt
buffer alone, Gcells/s and the bound of ``chip_smoke.bound``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402  (the repo root on sys.path first)


def main() -> int:
    import torch

    from gkl_tpu_torch.ops import sw as sw_ops
    from gkl_tpu_torch.ops import sw_cuda

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    picked = sw_cuda.sw_geometry
    shapes = (("7a", 448, 10240, 160, 48, 250, smoke.SOFTCLIP, 20),
              ("7b", 4096, 256, 2049, 600, 1000, smoke.INDEL, 5))
    try:
        for what, N, P, ref_lo, alt_lo, alt_hi, strategy, reps in shapes:
            args = [torch.from_numpy(a).to(dev)
                    for a in smoke.sw_batch(N, P, ref_lo, alt_lo, alt_hi, 7)]
            indel = strategy == smoke.INDEL
            M = args[1].shape[0]
            want = sw_ops.sw_forward(*args, *smoke.SW_GATK, indel_boundary=indel, pack_bt=True)
            zeros_ms = smoke.cuda_ms(
                lambda i: torch.zeros((P, N // 2, M), dtype=torch.uint8, device=dev), reps)
            cells = smoke.lane_cells(args[2], args[3])
            for rows in sw_cuda.ROWS_PER_THREAD:
                sw_cuda.sw_geometry = lambda n, r=rows: (r, 32 * r, -(-n // (32 * r)))

                def kernel(i):
                    return sw_cuda.sw_forward(*args, *smoke.SW_GATK, indel_boundary=indel)

                out = kernel(0)
                bad = sw_cuda.in_range_mismatches(out, want, args[2], args[3])
                if bad:
                    raise AssertionError(f"{what}, {rows} rows a thread: {bad} cells differ")
                ms = smoke.cuda_ms(kernel, reps)
                b = smoke.bound("sw_forward", smoke.nbytes(*args, *out), cells)
                print(json.dumps({"shape": what, "N": N, "M": M, "P": P, "rows_per_thread": rows,
                                  "picked": picked(N)[0] == rows, "in_range_mismatches": bad,
                                  "kernel_ms": ms, "bt_zeros_ms": zeros_ms,
                                  "gcells_per_s": cells / ms / 1e6,
                                  "x_bound": ms / b["bound_ms"], **b}), flush=True)
            del want
    finally:
        sw_cuda.sw_geometry = picked
    return 0


if __name__ == "__main__":
    sys.exit(main())
