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
"""

from __future__ import annotations

import torch

MATCH, INSERT, DELETE = 0, 1, 2
INSERT_EXT, DELETE_EXT = 4, 8
MATRIX_MIN_CUTOFF = -100000000
LOW_INIT_VALUE = -(2**31) // 2


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
