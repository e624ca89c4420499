#!/usr/bin/env python3
"""Time each instance of the PDHMM kernel at phase 8's shapes.

    python3 scripts/torch_pdhmm_kernel_instances.py

runs ``gkl_tpu_torch/csrc/pdhmm.cu`` on one CUDA card with 2, 4 and 8 read
rows a thread (``ops/pdhmm_cuda.pdhmm_geometry`` picks one of them from R;
here each is forced in turn) at ``chip_smoke.py``'s 8a shape (R=256,
H=448, P=8,192: a warp for each of 8,192 lanes) and 8b shape (R=1,024,
H=512, P=512: about four warps an SM).  Each launch is held bit for bit
against the twin in the kernel's order (or it raises).  It prints the
card's name and power limit, then one JSON line per shape and instance: the
ms of the wrapper's call (CUDA events, mean of 10 or 3 calls after a
warm-up; the boundary planes' allocation included), the passes, Gcells/s
and the bound of ``chip_smoke.bound``.
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

    from gkl_tpu_torch.ops import pdhmm_cuda

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    picked = pdhmm_cuda.pdhmm_geometry
    try:
        for what, R, H, P, reps in (("8a", 256, 448, 8192, 10), ("8b", 1024, 512, 512, 3)):
            t = smoke.pdhmm_batch(R, H, P, seed=11)
            cells = smoke.lane_cells(t["haplen"], t["rslen"])
            for rows in pdhmm_cuda.ROWS_PER_THREAD:
                pdhmm_cuda.pdhmm_geometry = lambda n, r=rows: (r, 32 * r, -(-n // (32 * r)))
                out = pdhmm_cuda.pdhmm(**t)
                smoke.pdhmm_lanes_not_bit_equal(out, t, f"{what}, {rows} rows a thread")
                ms = smoke.cuda_ms(lambda i: pdhmm_cuda.pdhmm(**t), reps)
                b = smoke.bound("pdhmm", smoke.nbytes(*t.values(), out), cells)
                print(json.dumps({"shape": what, "R": R, "H": H, "P": P, "rows_per_thread": rows,
                                  "passes": pdhmm_cuda.pdhmm_geometry(R)[2],
                                  "picked": picked(R)[0] == rows, "lanes_not_bit_equal": 0,
                                  "kernel_ms": ms, "gcells_per_s": cells / ms / 1e6,
                                  "x_bound": ms / b["bound_ms"], **b}), flush=True)
    finally:
        pdhmm_cuda.pdhmm_geometry = picked
    return 0


if __name__ == "__main__":
    sys.exit(main())
