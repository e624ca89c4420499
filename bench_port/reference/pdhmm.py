"""DRAGEN-GATK's PDHMM forward likelihood, vectorised over lanes.

The serial recurrence of GKL's ``pdhmm-serial.cc``: a PairHMM over match
(M), insertion (I) and deletion (D) states, plus three branch matrices (BM,
BI, BD) that carry the path around a partially determined deletion.  Each
haplotype column has a jump state that only its PD bytes set, the same in
every row: it starts NORMAL; after a column whose PD byte has DEL_START it
is INSIDE_DEL, after one with DEL_END it is AFTER_DEL (for one column,
DEL_END winning).  In a cell (r, j):

* NORMAL: the branch values copy the left cell's M, D and I;
* INSIDE_DEL: they copy the left cell's branch values;
* AFTER_DEL: they take the larger of the two, and the diagonal and left
  inputs of M and D take the larger of the normal and branch values;

    M = prior * (m_diag t_mm + i_diag t_im + d_diag t_im)
    D = m_left t_md + d_left t_dd
    I = M_up t_mi + I_up t_ii, where a DEL_END column takes the larger
        of the normal and branch values of the cell above.

A read base also matches a column whose PD byte has SNP and the base's
bit.  Row 0 holds D = 2^1020 / haplotype length in every column, column 0
of the other rows is 0, and the likelihood is log10 of the sum over columns
of M + I in the last row, less log10 2^1020.  As in ``pairhmm``, lanes walk
anti-diagonals together and a narrower ``dtype`` is the check's control.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lanes as lanes_mod
from . import tables

SNP, DEL_START, DEL_END = 1, 2, 4
NORMAL, INSIDE_DEL, AFTER_DEL = 0, 1, 2
# the PD byte's bit of each read base, upper and lower case
_BASE_BIT = np.zeros(256, np.uint8)
for _c, _bit in zip(b"ACGTacgt", (8, 16, 32, 64, 8, 16, 32, 64)):
    _BASE_BIT[_c] = _bit


def column_states(pd: np.ndarray) -> np.ndarray:
    """(len(pd),) jump state of each column j = 1..len(pd)."""
    out = np.empty(len(pd), np.uint8)
    state = NORMAL
    for j, p in enumerate(np.asarray(pd, np.uint8).tolist()):
        out[j] = state
        if state == AFTER_DEL:
            state = NORMAL
        if p & DEL_START:
            state = INSIDE_DEL
        if p & DEL_END:
            state = AFTER_DEL
    return out


def log10_likelihoods(reads, pd_haps, lanes, *, dtype=torch.float64, device="cpu",
                      block: int = 16384, rescue_below: float | None = None) -> np.ndarray:
    """log10 likelihood of each lane.

    ``reads``: unique reads as (bases, q, iq, dq, gcp) uint8 arrays;
    ``pd_haps``: unique (bases, PD bytes); ``lanes``: (n, 2) (read,
    haplotype) indices.  Lanes whose sum, its initial constant still in, lies below
    ``rescue_below`` are computed again in float64, as the program's float
    kernels hand them to its rescue.  Returns (n,) float64."""
    bases = [np.asarray(r[0], np.uint8) for r in reads]
    rows = [tables.pdhmm_rows(*r[1:]) for r in reads]
    haps = [np.asarray(h, np.uint8) for h, _ in pd_haps]
    pds = [np.asarray(p, np.uint8) for _, p in pd_haps]
    states = [column_states(p) for p in pds]
    exp2 = tables.initial_exp2(str(dtype).split(".")[-1])
    lanes = np.asarray(lanes, np.int64).reshape(-1, 2)
    out = np.empty(len(lanes), np.float64)
    low: list = []
    for b in lanes_mod.blocks(bases, rows, haps, lanes, block, dtype, device):
        H = b.hap.shape[1]
        pd = torch.from_numpy(lanes_mod.pad_rows([pds[h] for h in b.hap_idx], H)).to(device)
        st = torch.from_numpy(lanes_mod.pad_rows([states[h] for h in b.hap_idx], H)).to(device)
        total = _forward(b, pd, st, exp2, dtype)
        out[b.lanes] = lanes_mod.log10_total(total, exp2)
        low.append(b.lanes[lanes_mod.below(total, rescue_below)])
    low = np.concatenate(low) if low else np.zeros(0, np.int64)
    if len(low):
        out[low] = log10_likelihoods(reads, pd_haps, lanes[low], device=device, block=block)
    return out


def _forward(b: lanes_mod.Block, pd: torch.Tensor, st: torch.Tensor, exp2: int,
             dtype) -> torch.Tensor:
    L, R = b.read.shape
    H = b.hap.shape[1]
    dev = b.read.device
    t_mm, t_mi, t_md, t_im, t_ii, pmatch, pmis, _ = b.rows.unbind(-1)
    t_dd = t_ii
    read_bit = torch.from_numpy(_BASE_BIT).to(dev)[b.read.long()]
    init = (torch.full((L,), 2.0 ** exp2, dtype=torch.float64, device=dev)
            / b.hl.to(torch.float64)).to(dtype)
    rr = torch.arange(1, R + 1, device=dev)
    zero_col = torch.zeros((L, 1), dtype=dtype, device=dev)
    names = ("M", "I", "D", "BM", "BI", "BD")
    # diagonals d-1 and d-2, each over rows 0..R; d = 0 is the cell (0, 0)
    prev = {k: torch.zeros((L, R + 1), dtype=dtype, device=dev) for k in names}
    prev["D"][:, 0] = init
    prev2 = {k: torch.zeros_like(v) for k, v in prev.items()}
    total = torch.zeros(L, dtype=dtype, device=dev)
    last = b.rl.unsqueeze(1)
    mx = torch.maximum
    for d in range(1, int((b.rl + b.hl).max()) + 1):
        j = d - rr
        col = (j - 1).clamp(0, H - 1)
        y, p, s = b.hap[:, col], pd[:, col], st[:, col]
        match = ((b.read == y) | (b.read == lanes_mod.N_BASE) | (y == lanes_mod.N_BASE)
                 | (((p & SNP) != 0) & ((p & read_bit) != 0)))
        prior = torch.where(match, pmatch, pmis)
        diag = {k: v[:, :R] for k, v in prev2.items()}   # (r-1, j-1)
        left = {k: v[:, 1:] for k, v in prev.items()}     # (r, j-1)
        up = {k: v[:, :R] for k, v in prev.items()}       # (r-1, j)
        normal, inside, after = s == NORMAL, s == INSIDE_DEL, s == AFTER_DEL
        new = {}
        for k, bk in (("M", "BM"), ("D", "BD"), ("I", "BI")):
            new[bk] = torch.where(normal, left[k], torch.where(
                inside, left[bk], mx(left[bk], left[k])))
        m_diag = torch.where(after, mx(diag["M"], diag["BM"]), diag["M"])
        i_diag = torch.where(after, mx(diag["I"], diag["BI"]), diag["I"])
        d_diag = torch.where(after, mx(diag["D"], diag["BD"]), diag["D"])
        m_left = torch.where(after, mx(left["M"], left["BM"]), left["M"])
        d_left = torch.where(after, mx(left["D"], left["BD"]), left["D"])
        new["M"] = prior * (m_diag * t_mm + i_diag * t_im + d_diag * t_im)
        new["D"] = m_left * t_md + d_left * t_dd
        del_end = (p & DEL_END) != 0
        new["I"] = torch.where(del_end,
                               mx(up["BM"], up["M"]) * t_mi + mx(up["BI"], up["I"]) * t_ii,
                               up["M"] * t_mi + up["I"] * t_ii)
        valid = (j >= 1) & (j.unsqueeze(0) <= b.hl.unsqueeze(1))
        row0 = torch.where(b.hl >= d, init, 0.0).unsqueeze(1)
        prev2 = prev
        prev = {k: torch.cat([row0 if k == "D" else zero_col, torch.where(valid, v, 0.0)], 1)
                for k, v in new.items()}
        jl = d - b.rl
        in_row = (jl >= 1) & (jl <= b.hl)
        total = torch.where(
            in_row, total + (prev["M"].gather(1, last) + prev["I"].gather(1, last))[:, 0], total)
    return total
