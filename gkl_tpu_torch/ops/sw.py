"""Affine-gap Smith-Waterman score and backtrack DP in plain PyTorch.

Counterpart of ``gkl_tpu/ops/sw.py``, and the plain twin of the CUDA kernel
``csrc/sw_forward.cu`` (see ``ops/sw_cuda.py``).  Same recurrence, codes and
outputs (semantics from ``PairWiseSW.h:27-263``): a scan over reference
rows with alt columns and lanes vectorised; F and the match term are
elementwise on the previous row, and the within-row E recurrence
``E[j] = max(H[j-1]+open, E[j-1]+extend)`` becomes, with
``H = max(hclamp, E, F)`` substituted, ``E[j] = max(g[j], E[j-1] + w)`` with
``w = max(open, extend)`` and ``g[j] = open + max(hclamp, F)[j-1]``.  Its
solution ``E[j] = max_k(g[k] + (j-k)*w)`` is a running maximum of
``g[k] - k*w``, exact in integers, so every cell equals the jnp engine's
bit for bit, padded cells included.

:func:`sw_walk`, the maximum selection and CIGAR walk of every lane on
those outputs, is the plain twin of ``csrc/sw_walk.cu``; the JAX package
has no counterpart (it walks on the host).
"""

from __future__ import annotations

import torch

MATCH, INSERT, DELETE = 0, 1, 2
INSERT_EXT, DELETE_EXT = 4, 8
# overhang strategies (``api_sw.OverhangStrategy``); SOFTCLIP is also the
# soft-clip op of a walked run
SOFTCLIP, INDEL, LEADING_INDEL, IGNORE = 9, 10, 11, 12
MATRIX_MIN_CUTOFF = -100000000
INT32_MIN = -(2**31)
LOW_INIT_VALUE = INT32_MIN // 2


def _shift_cols(arr: torch.Tensor, first) -> torch.Tensor:
    """Column j of the result is column j-1 of ``arr``; column 0 is ``first``."""
    out = torch.empty_like(arr)
    out[0] = first
    out[1:] = arr[:-1]
    return out


def sw_forward(ref, alt, reflen, altlen, match, mismatch, gap_open, gap_extend, *,
               indel_boundary: bool, pack_bt: bool = False):
    """Score DP producing backtrack codes and boundary score rows.

    Args:
      ref:    (N, P) uint8 reference bases (rows / seq1).
      alt:    (M, P) uint8 alternate bases (columns / seq2).
      reflen, altlen: (P,) int32 true lengths.
      match/mismatch/gap_open/gap_extend: int scores.
      indel_boundary: True for the INDEL / LEADING_INDEL overhang
        strategies (boundary rows seeded with open+(k-1)*extend,
        PairWiseSW.h:212-221).
      pack_bt: two 4-bit codes per byte along the row axis, rows 2k/2k+1
        in the low/high nibble (N must be even).

    Returns, on the inputs' device:
      bt:      (P, N, M) uint8 codes (cell (i, j) at [p, i-1, j-1]), or
               (P, N//2, M) row-pair packed with ``pack_bt``.
      lastrow: (M, P) int32, H(reflen[p], j).
      lastcol: (P, N) int32, H(i, altlen[p]).
    """
    N, P = ref.shape
    M = alt.shape[0]
    if pack_bt and N % 2:
        raise ValueError("packed backtrack requires an even row count")
    dev = ref.device
    i32, i64 = torch.int32, torch.int64
    w_open, w_extend = int(gap_open), int(gap_extend)
    w = max(w_open, w_extend)
    low, cutoff = LOW_INIT_VALUE, MATRIX_MIN_CUTOFF

    alt_i = alt.to(i32)
    ref_i = ref.to(i32)
    altlen = altlen.to(i64)
    reflen = reflen.to(i64)
    col = torch.arange(1, M + 1, dtype=i32, device=dev)[:, None]  # 1-based j
    if indel_boundary:
        h_prev = (w_open + (col - 1) * w_extend).expand(M, P).contiguous()
    else:
        h_prev = torch.zeros((M, P), dtype=i32, device=dev)
    f_prev = torch.full((M, P), low, dtype=i32, device=dev)
    lastrow = torch.zeros((M, P), dtype=i32, device=dev)
    lastcol_onehot = (col.to(i64) == altlen[None, :]).to(i64)
    kw = (col.to(i64) - 1) * w           # k * w for 0-based k
    low_s = low + col.to(i64) * w       # the E(i, 0) = LOW term, (j+1)*w later
    sbt_match = torch.tensor(int(match), dtype=i32, device=dev)
    sbt_mismatch = torch.tensor(int(mismatch), dtype=i32, device=dev)

    def boundary(i):
        """H(i, 0)."""
        return w_open + (i - 1) * w_extend if indel_boundary and i >= 1 else 0

    bt_rows, lastcol = [], []
    pending = None
    for i in range(1, N + 1):
        b_i, b_prev = boundary(i), boundary(i - 1)
        sbt = torch.where(alt_i == ref_i[i - 1][None, :], sbt_match, sbt_mismatch)
        hc = torch.clamp_min(_shift_cols(h_prev, b_prev) + sbt, cutoff)

        open_v = h_prev + w_open
        ext_v = f_prev + w_extend
        f_new = torch.maximum(open_v, ext_v)
        dext = open_v <= ext_v

        g = _shift_cols(torch.maximum(hc, f_new), b_i).to(i64) + w_open
        t = torch.cummax(g - kw, dim=0).values + kw
        e_new = torch.maximum(t, low_s).to(i32)

        e_gt = e_new > hc
        h_after_e = torch.maximum(hc, e_new)
        f_gt = f_new > h_after_e
        h_new = torch.maximum(h_after_e, f_new)

        iext = _shift_cols(h_new, b_i) + w_open <= _shift_cols(e_new, low) + w_extend
        code = (torch.where(f_gt, DELETE, torch.where(e_gt, INSERT, MATCH))
                | torch.where(iext, INSERT_EXT, 0)
                | torch.where(dext, DELETE_EXT, 0)).to(torch.uint8)
        if not pack_bt:
            bt_rows.append(code)
        elif pending is None:
            pending = code
        else:
            bt_rows.append(pending | (code << 4))
            pending = None

        lastcol.append((h_new.to(i64) * lastcol_onehot).sum(dim=0).to(i32))
        lastrow = torch.where((reflen == i)[None, :], h_new, lastrow)
        h_prev, f_prev = h_new, f_new

    bt = torch.stack(bt_rows).permute(2, 0, 1).contiguous()
    return bt, lastrow, torch.stack(lastcol, dim=1)



def walk_capacity(N: int, M: int) -> int:
    """Run rows a lane of an (N, M) bucket can need: a run a step of the
    walk (n + m at most), a leading soft clip and a tail, and room."""
    return N + M + 4


def sw_walk(bt, lastrow, lastcol, reflen, altlen, strategy):
    """Maximum selection and CIGAR walk of every lane, from the outputs of
    :func:`sw_forward` with ``pack_bt=True``: the plain twin of the CUDA
    kernel ``csrc/sw_walk.cu`` and the semantics of
    ``native/sw_runtime.cc::sw_postprocess_packed``, vectorised over lanes,
    a loop over the anti-diagonals and then over the walk's steps.

    Returns ``(2 + cap, P)`` int32 with ``cap = walk_capacity(N, M)``: row
    0 each lane's run count, row 1 its offset, row ``2 + k`` its ``k``-th
    merged run in CIGAR order as ``count << 4 | op`` (op 0 M, 1 I, 2 D, 9
    S); zeros past a lane's count.  A lane with a length out of ``[1, N]``
    or ``[1, M]`` gets count 0 and offset 0."""
    P, half, M = bt.shape
    N = 2 * half
    cap = walk_capacity(N, M)
    dev = bt.device
    i64 = torch.int64
    out = torch.zeros((2 + cap, P), dtype=torch.int32, device=dev)
    n, m = reflen.to(i64), altlen.to(i64)
    lanes = torch.nonzero((n >= 1) & (n <= N) & (m >= 1) & (m <= M)).flatten()
    if lanes.numel() == 0:
        return out
    n, m = n[lanes], m[lanes]
    L = lanes.numel()
    zero = torch.zeros(L, dtype=i64, device=dev)

    # select_max over the anti-diagonals d in (min(n, m), n + m], lastrow
    # first: the held cell ends as the fold of the runtime's rule over the
    # cells of the highest score alone (a cell of that score beats any
    # lower one, whatever it held), so only diagonals holding one are visited
    d = torch.arange(int(torch.minimum(n, m).min()) + 1, int((n + m).max()) + 1,
                     device=dev)[:, None]
    j0, i0 = d - n, d - m                                  # (D, L)
    row_ok = (j0 >= 1) & (j0 <= m) & (int(strategy) in (SOFTCLIP, IGNORE))
    col_ok = (i0 >= 1) & (i0 <= n)
    below = INT32_MIN - 1
    row_sc = torch.where(row_ok, lastrow.to(i64)[:, lanes].gather(0, (j0 - 1).clamp(0, M - 1)),
                         below)
    col_sc = torch.where(col_ok, lastcol.to(i64)[lanes].t().gather(0, (i0 - 1).clamp(0, N - 1)),
                         below)
    top = torch.maximum(row_sc.max(0).values, col_sc.max(0).values)
    row_hit, col_hit = row_sc == top, col_sc == top
    score = torch.full((L,), INT32_MIN, dtype=i64, device=dev)
    max_i, max_j = zero.clone(), zero.clone()
    for t in torch.nonzero((row_hit | col_hit).any(1)).flatten().tolist():
        take = row_hit[t] & ((score < top) | ((n - j0[t]).abs() < (max_i - max_j).abs()))
        score = torch.where(take, top, score)
        max_i = torch.where(take, n, max_i)
        max_j = torch.where(take, j0[t], max_j)
        take = col_hit[t] & ((score < top) | (max_j == m)
                             | ((i0[t] - m).abs() <= (max_i - max_j).abs()))
        score = torch.where(take, top, score)
        max_i = torch.where(take, i0[t], max_i)
        max_j = torch.where(take, m, max_j)

    s = int(strategy)
    if s == INDEL:
        i, j = n.clone(), m.clone()
    elif s == LEADING_INDEL:
        i, j = max_i, m.clone()
    else:
        i, j = max_i, max_j

    # runs in walk order: each lane's open run (op, cnt), op -1 before its first
    runs = torch.zeros((cap, L), dtype=i64, device=dev)
    nr, op, cnt = zero.clone(), torch.full((L,), -1, dtype=i64, device=dev), zero.clone()
    idx = torch.arange(L, device=dev)

    def push(mask, o, c):
        nonlocal op, cnt
        same = mask & (op == o)
        new = mask & (op != o)
        close = new & (op >= 0)
        runs[nr[close], idx[close]] = (cnt << 4 | op)[close]
        nr.add_(close.to(i64))
        op = torch.where(new, o, op)
        cnt = torch.where(new, c, torch.where(same, cnt + c, cnt))

    push(j < m, SOFTCLIP, m - j)
    flat = bt.reshape(-1)
    base = lanes.to(i64) * (half * M)
    state = zero.clone()
    live = (i > 0) & (j > 0)
    while bool(live.any()):
        b = flat[torch.where(live, base + ((i - 1) >> 1) * M + (j - 1), 0)].to(i64)
        code = torch.where(((i - 1) & 1) == 1, b >> 4, b & 0xF)
        ext_i = live & (state == INSERT_EXT)
        ext_d = live & (state == DELETE_EXT)
        fresh = live & ~ext_i & ~ext_d
        step = torch.clamp_max(code & 3, DELETE)          # 3 walks as a deletion
        mt, ins, dl = fresh & (step == MATCH), fresh & (step == INSERT), fresh & (step == DELETE)
        cnt = cnt + (ext_i | ext_d).to(i64)
        push(fresh, step, 1)
        i = i - (ext_d | mt | dl).to(i64)
        j = j - (ext_i | mt | ins).to(i64)
        state = torch.where(ext_i | ins, code & INSERT_EXT,
                            torch.where(ext_d | dl, code & DELETE_EXT,
                                        torch.where(mt, 0, state)))
        live = (i > 0) & (j > 0)

    if s == SOFTCLIP:
        push(j > 0, SOFTCLIP, j)
        offset = i
    elif s == IGNORE:
        push(j > 0, torch.where(op < 0, MATCH, op), j)
        offset = i - j
    else:
        push(i > 0, DELETE, i)
        push((i == 0) & (j > 0), INSERT, j)
        offset = zero
    push(op >= 0, -1, 0)  # close every lane's open run

    # CIGAR order: each lane's runs reversed
    k = torch.arange(cap, device=dev)[:, None]
    src = (nr[None, :] - 1 - k).clamp_min(0)
    ordered = torch.where(k < nr[None, :], runs.gather(0, src), 0)
    out[2:, lanes] = ordered.to(torch.int32)
    out[0, lanes] = nr.to(torch.int32)
    out[1, lanes] = offset.to(torch.int32)
    return out
