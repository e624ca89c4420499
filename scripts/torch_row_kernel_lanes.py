#!/usr/bin/env python3
"""Time the PairHMM row kernel against the number of lanes in a launch.

    python3 scripts/torch_row_kernel_lanes.py [P ...]

runs both instances of ``gkl_tpu_torch/csrc/pairhmm_scaled.cu`` on one CUDA
card at ``chip_smoke.py`` phase 2's shape (R=128, H=224; the scaled
instance with the GATK gap quals as constants, the plain one with them as
planes), with P lanes (default 2,048, 4,096, 8,192, 16,384 and 32,768:
phase 2's 2,048 lanes repeated). Four lanes fill a warp, so P/4 warps
share the card's 528 warp schedulers: the rate against P shows how far one
launch of phase 2's size fills the card. It prints the card's name and
power limit, then one JSON line per P: kernel ms (CUDA events, mean of 20
launches after a warm-up), Gcells/s and the bound of ``chip_smoke.bound``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402  (the repo root on sys.path first)


def main(argv) -> int:
    import torch

    from gkl_tpu_torch.ops import pairhmm_cuda as pc

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sizes = [int(a) for a in argv] or [2048, 4096, 8192, 16384, 32768]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    R, H, base = 128, 224, 2048
    dev = torch.device("cuda")
    hap, read, q, iq, dq, gcp, haplen, rslen = (
        torch.from_numpy(a).to(dev) for a in smoke.gatk_like_batch(R, H, base))
    readq = torch.stack([read, q]).contiguous()
    quals_u = torch.stack([iq, dq, gcp]).contiguous()
    for P in sizes:
        lanes = torch.arange(P, dtype=torch.int32, device=dev) % base
        hl, rl = haplen[lanes.long()].contiguous(), rslen[lanes.long()].contiguous()
        cells = smoke.lane_cells(hl, rl)
        runs = {
            "pairhmm_scaled": lambda i: pc.pairhmm_scaled(
                hap, readq, lanes, lanes, hl, rl, const_quals=smoke.GATK_GAP_QUALS),
            "pairhmm_rows": lambda i: pc.pairhmm_rows(
                hap, readq, lanes, lanes, hl, rl, quals_u=quals_u),
        }
        for name, fn in runs.items():
            ms = smoke.cuda_ms(fn, 20)
            out = fn(0)
            io = smoke.nbytes(hap, readq, lanes, lanes, hl, rl,
                              quals_u if name == "pairhmm_rows" else None, out)
            b = smoke.bound(name, io, cells, int(hl.sum()))
            print(json.dumps({"kernel": name, "R": R, "H": H, "P": P, "warps": -(-P // 4),
                              "kernel_ms": ms, "gcells_per_s": cells / ms / 1e6,
                              "x_bound": ms / b["bound_ms"], **b}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
