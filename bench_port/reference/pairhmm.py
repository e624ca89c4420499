"""GATK's PairHMM forward likelihood, vectorised over lanes.

The DP of ``PairHMM.java``/``IntelPairHmm``'s double kernel: over read rows
r and haplotype columns j,

    M[r,j] = prior(r,j) * (p_mm[r] M[r-1,j-1] + p_gapm[r] (X[r-1,j-1] + Y[r-1,j-1]))
    X[r,j] = p_mx[r] M[r-1,j] + p_xx[r] X[r-1,j]
    Y[r,j] = p_my[r] M[r,j-1] + p_yy[r] Y[r,j-1]

with row 0 holding Y = 2^1020 / haplotype length in every column and
column 0 of the other rows 0; the likelihood is log10 of the sum over
columns of M + X in the read's last row, less log10 2^1020.  Every lane
walks its anti-diagonals r + j = d together; each product and sum is
taken in the order written above, so in float64 the result is that of the
plain scalar loop.  A narrower ``dtype`` starts from 2^120 and rounds every
operation to its type: the control of the benchmark's check.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lanes as lanes_mod
from . import tables


def log10_likelihoods(reads, haps, lanes, *, dtype=torch.float64, device="cpu",
                      block: int = 16384, rescue_below: float | None = None) -> np.ndarray:
    """log10 likelihood of each lane.

    ``reads``: unique reads as (bases, q, iq, dq, gcp) uint8 arrays;
    ``haps``: unique haplotype bases; ``lanes``: (n, 2) (read, haplotype)
    indices.  Lanes whose sum, its initial constant still in, lies below
    ``rescue_below`` are computed again in float64, as the program's float
    kernels hand them to its rescue.  Returns (n,) float64."""
    bases = [np.asarray(r[0], np.uint8) for r in reads]
    rows = [tables.pairhmm_rows(*r[1:]) for r in reads]
    haps = [np.asarray(h, np.uint8) for h in haps]
    exp2 = tables.initial_exp2(str(dtype).split(".")[-1])
    lanes = np.asarray(lanes, np.int64).reshape(-1, 2)
    out = np.empty(len(lanes), np.float64)
    low: list = []
    for b in lanes_mod.blocks(bases, rows, haps, lanes, block, dtype, device):
        total = _forward(b, exp2, dtype)
        out[b.lanes] = lanes_mod.log10_total(total, exp2)
        low.append(b.lanes[lanes_mod.below(total, rescue_below)])
    low = np.concatenate(low) if low else np.zeros(0, np.int64)
    if len(low):
        out[low] = log10_likelihoods(reads, haps, lanes[low], device=device, block=block)
    return out


def _forward(b: lanes_mod.Block, exp2: int, dtype) -> torch.Tensor:
    L, R = b.read.shape
    H = b.hap.shape[1]
    dev = b.read.device
    pmm, pgapm, pmx, pxx, pmy, pyy, pmatch, pmis = b.rows.unbind(-1)
    init = (torch.full((L,), 2.0 ** exp2, dtype=torch.float64, device=dev)
            / b.hl.to(torch.float64)).to(dtype)
    rr = torch.arange(1, R + 1, device=dev)
    zero_col = torch.zeros((L, 1), dtype=dtype, device=dev)
    # diagonals d-1 (M1, X1, Y1) and d-2 (M2, X2, Y2), each over rows 0..R
    M1, X1, Y1 = (torch.zeros((L, R + 1), dtype=dtype, device=dev) for _ in range(3))
    Y1[:, 0] = init  # d = 0: the cell (0, 0)
    M2, X2, Y2 = (torch.zeros_like(M1) for _ in range(3))
    total = torch.zeros(L, dtype=dtype, device=dev)
    last = b.rl.unsqueeze(1)
    for d in range(1, int((b.rl + b.hl).max()) + 1):
        j = d - rr
        y = b.hap[:, (j - 1).clamp(0, H - 1)]
        match = (b.read == y) | (b.read == lanes_mod.N_BASE) | (y == lanes_mod.N_BASE)
        prior = torch.where(match, pmatch, pmis)
        M = prior * (pmm * M2[:, :R] + pgapm * (X2[:, :R] + Y2[:, :R]))
        X = pmx * M1[:, :R] + pxx * X1[:, :R]
        Y = pmy * M1[:, 1:] + pyy * Y1[:, 1:]
        valid = (j >= 1) & (j.unsqueeze(0) <= b.hl.unsqueeze(1))
        M, X, Y = (torch.where(valid, t, 0.0) for t in (M, X, Y))
        row0 = torch.where(b.hl >= d, init, 0.0).unsqueeze(1)
        M2, X2, Y2 = M1, X1, Y1
        M1 = torch.cat([zero_col, M], 1)
        X1 = torch.cat([zero_col, X], 1)
        Y1 = torch.cat([row0, Y], 1)
        jl = d - b.rl
        in_row = (jl >= 1) & (jl <= b.hl)
        total = torch.where(in_row, total + (M1.gather(1, last) + X1.gather(1, last))[:, 0], total)
    return total
