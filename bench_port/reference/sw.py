"""Affine-gap Smith-Waterman with GKL's backtrack and overhang strategies.

The score DP of GKL's ``PairWiseSW.h`` over reference rows i and alternate
columns j, in integers:

    E[i,j] = max(H[i,j-1] + open, E[i,j-1] + extend)
    F[i,j] = max(H[i-1,j] + open, F[i-1,j] + extend)
    H[i,j] = max(max(CUTOFF, H[i-1,j-1] + (match or mismatch)), E, F)

with E and F starting at INT_MIN / 2, the first row and column 0 (or
``open + (k-1) extend`` for the INDEL strategies), the backtrack code MATCH
0, INSERT 1 (E won), DELETE 2 (F won) and the flags INSERT_EXT 4 and
DELETE_EXT 8 where a gap's extension was not beaten by its opening.  The
DP runs on the device, every lane on its anti-diagonals at once; the end
cell is picked from the last row (SOFTCLIP, IGNORE) and the last column
in GKL's anti-diagonal order and tie-breaks, and the CIGAR is walked on
the host.  A narrower integer ``dtype`` (its own INT_MIN / 2 and CUTOFF at
its minimum) is the check's control.
"""

from __future__ import annotations

import numpy as np
import torch

MATCH, INSERT, DELETE = 0, 1, 2
INSERT_EXT, DELETE_EXT = 4, 8
SOFTCLIP, INDEL, LEADING_INDEL, IGNORE = 9, 10, 11, 12
CUTOFF = -100000000
_OP_CHAR = {MATCH: "M", INSERT: "I", DELETE: "D", SOFTCLIP: "S"}


def align(refs, alts, match: int, mismatch: int, open_: int, extend: int, strategy: int,
          *, dtype=torch.int32, device="cpu", block: int = 2048) -> list[tuple[str, int]]:
    """(CIGAR, alignment offset) of each alt against its ref."""
    refs = [np.asarray(r, np.uint8) for r in refs]
    alts = [np.asarray(a, np.uint8) for a in alts]
    out: list = [None] * len(refs)
    order = np.argsort([len(r) + len(a) for r, a in zip(refs, alts)], kind="stable")
    for s0 in range(0, len(order), block):
        pos = order[s0:s0 + block]
        bt, lastrow, lastcol = _dp([refs[k] for k in pos], [alts[k] for k in pos], match,
                                   mismatch, open_, extend, strategy, dtype, device)
        for c, k in enumerate(pos):
            n, m = len(refs[k]), len(alts[k])
            _, mi, mj = select_max(lastrow[c], lastcol[c], n, m, strategy)
            out[k] = walk(bt[c], n, m, mi, mj, strategy)
    return out


def _dp(refs, alts, match, mismatch, open_, extend, strategy, dtype, device):
    """Backtrack codes (L, N+1, M+1) uint8, H of each lane's last row
    (L, M) and last column (L, N), as numpy arrays."""
    L = len(refs)
    N, M = max(len(r) for r in refs), max(len(a) for a in alts)
    info = torch.iinfo(dtype)
    low, cut = info.min // 2, max(CUTOFF, info.min)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    ref = np.zeros((L, N), np.uint8)
    alt = np.zeros((L, M), np.uint8)
    for c, (r, a) in enumerate(zip(refs, alts)):
        ref[c, :len(r)] = r
        alt[c, :len(a)] = a
    ref = torch.from_numpy(ref).to(device)
    alt = torch.from_numpy(alt).to(device)
    n = torch.tensor([len(r) for r in refs], dtype=torch.int64, device=device)
    m = torch.tensor([len(a) for a in alts], dtype=torch.int64, device=device)
    indel = strategy in (INDEL, LEADING_INDEL)
    jj = torch.arange(M + 1, device=device)

    def boundary(k):  # H of the first row or column at index k >= 1
        return t(open_ + (k - 1) * extend) if indel else t(0)

    bt = torch.zeros((L, N + 1, M + 1), dtype=torch.uint8, device=device)
    lastrow = torch.zeros((L, M), dtype=dtype, device=device)
    lastcol = torch.zeros((L, N), dtype=dtype, device=device)
    rows = torch.arange(L, device=device)
    # diagonals d-1 and d-2, indexed by the alt column j = 0..M (row i = d - j)
    H1 = torch.zeros((L, M + 1), dtype=dtype, device=device)
    E1 = torch.full_like(H1, low)
    F1 = torch.full_like(H1, low)
    H2 = H1.clone()
    for d in range(1, N + M + 1):
        i = d - jj
        H = torch.zeros_like(H1)
        E = torch.full_like(H1, low)
        F = torch.full_like(H1, low)
        # interior cells: i >= 1 and j >= 1, i.e. j in [max(1, d-N), min(M, d-1)]
        j0, j1 = max(1, d - N), min(M, d - 1)
        if j0 <= j1:
            js = slice(j0, j1 + 1)
            jm = slice(j0 - 1, j1)
            open_h = H1[:, jm] + t(open_)
            ext_h = E1[:, jm] + t(extend)
            e = torch.maximum(open_h, ext_h)
            open_v = H1[:, js] + t(open_)
            ext_v = F1[:, js] + t(extend)
            f = torch.maximum(open_v, ext_v)
            rb = ref[:, (i[js] - 1)]
            ab = alt[:, j0 - 1:j1]
            h = torch.maximum(H2[:, jm] + torch.where(rb == ab, t(match), t(mismatch)), t(cut))
            code = torch.where(e > h, INSERT, MATCH)
            h = torch.maximum(h, e)
            code = torch.where(f > h, DELETE, code)
            h = torch.maximum(h, f)
            code = (code | torch.where(open_h > ext_h, 0, INSERT_EXT)
                    | torch.where(open_v > ext_v, 0, DELETE_EXT))
            H[:, js], E[:, js], F[:, js] = h, e, f
            bt[:, i[js], jj[js]] = code.to(torch.uint8)
        # the first column (i = d, j = 0) and the first row (i = 0, j = d)
        if d <= N:
            H[:, 0] = boundary(d)
        if d <= M:
            H[:, d] = boundary(d)
        # the last row (i = n, j = d - n) and last column (i = d - m, j = m)
        jl = d - n
        ok = (jl >= 1) & (jl <= m)
        if bool(ok.any()):
            lastrow[rows[ok], jl[ok] - 1] = H[rows[ok], jl[ok]]
        il = d - m
        ok = (il >= 1) & (il <= n)
        if bool(ok.any()):
            lastcol[rows[ok], il[ok] - 1] = H[rows[ok], m[ok]]
        H2, H1, E1, F1 = H1, H, E, F
    return bt.cpu().numpy(), lastrow.cpu().numpy(), lastcol.cpu().numpy()


def select_max(lastrow, lastcol, n: int, m: int, strategy: int) -> tuple[int, int, int]:
    """GKL's end cell: anti-diagonals in order, the last-row cell (SOFTCLIP
    and IGNORE only) before the last-column cell, ties to the cell nearer
    the main diagonal.  ``lastrow[j-1] = H[n, j]``, ``lastcol[i-1] =
    H[i, m]``.  Returns (score, i, j)."""
    lastrow = lastrow.tolist()
    lastcol = lastcol.tolist()
    best, bi, bj = -(2 ** 31), 0, 0
    for d in range(1, n + m + 1):
        if d >= n + 1 and strategy in (SOFTCLIP, IGNORE):
            j0 = d - n
            if 1 <= j0 <= m:
                s = lastrow[j0 - 1]
                if best < s or (best == s and abs(n - j0) < abs(bi - bj)):
                    best, bi, bj = s, n, j0
        if d >= m + 1:
            i0 = d - m
            if 1 <= i0 <= n:
                s = lastcol[i0 - 1]
                if best < s or (best == s and (bj == m or abs(i0 - m) <= abs(bi - bj))):
                    best, bi, bj = s, i0, m
    return best, bi, bj


def walk(bt, n: int, m: int, max_i: int, max_j: int, strategy: int) -> tuple[str, int]:
    """The backtrack walk from the end cell, the overhang tails, the merge
    of equal neighbours and the offset (GKL ``PairWiseSW.h``)."""
    width = bt.shape[1]
    codes = bt.tobytes()
    elems: list[list[int]] = []
    if strategy == INDEL:
        i, j = n, m
    elif strategy == LEADING_INDEL:
        i, j = max_i, m
    else:
        i, j = max_i, max_j
    if j < m:
        elems.append([SOFTCLIP, m - j])
    state = 0
    while i > 0 and j > 0:
        code = codes[i * width + j]
        if state == INSERT_EXT:
            j -= 1
            elems[-1][1] += 1
            state = code & INSERT_EXT
        elif state == DELETE_EXT:
            i -= 1
            elems[-1][1] += 1
            state = code & DELETE_EXT
        elif code & 3 == MATCH:
            i -= 1
            j -= 1
            elems.append([MATCH, 1])
            state = 0
        elif code & 3 == INSERT:
            j -= 1
            elems.append([INSERT, 1])
            state = code & INSERT_EXT
        else:
            i -= 1
            elems.append([DELETE, 1])
            state = code & DELETE_EXT
    if strategy == SOFTCLIP:
        if j > 0:
            elems.append([SOFTCLIP, j])
        offset = i
    elif strategy == IGNORE:
        if j > 0:
            elems.append([elems[-1][0] if elems else MATCH, j])
        offset = i - j
    else:
        if i > 0:
            elems.append([DELETE, i])
        elif j > 0:
            elems.append([INSERT, j])
        offset = 0
    merged: list[list[int]] = []
    for op, count in elems:
        if merged and merged[-1][0] == op:
            merged[-1][1] += count
        else:
            merged.append([op, count])
    cigar = "".join(f"{c}{_OP_CHAR.get(op, 'R')}" for op, c in reversed(merged) if c > 0)
    return cigar, int(offset)
