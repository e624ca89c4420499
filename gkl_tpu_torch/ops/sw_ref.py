"""Scalar reference for affine-gap Smith-Waterman with CIGAR backtrack.

Counterpart of ``gkl_tpu/ops/sw_ref.py`` (numpy only, the same code).
Re-derivation of the reference's semantics
(``src/main/native/smithwaterman/PairWiseSW.h``):

Score DP over ref rows i (seq1) x alt columns j (seq2), int32::

    E(i,j) = max(H(i,j-1)+open, E(i,j-1)+extend)       # insertion (gap in ref)
    F(i,j) = max(H(i-1,j)+open, F(i-1,j)+extend)       # deletion  (gap in alt)
    m      = H(i-1,j-1) + (match? w_match : w_mismatch)
    H(i,j) = max(max(MATRIX_MIN_CUTOFF, m), E, F)

with 4-bit backtrack codes {MATCH=0, INSERT=1, DELETE=2} plus extension
flags INSERT_EXT=4 / DELETE_EXT=8 set when the gap came from an extension
(open path NOT strictly greater, PairWiseSW.h:33-35,43-44).  Boundary rows
H(0,j)/H(i,0) are ``open+(k-1)*extend`` for INDEL/LEADING_INDEL else 0
(PairWiseSW.h:212-221); E(i,0)=F(0,j)=INT32_MIN/2.

Maximum tracking follows the reference's anti-diagonal visit order with its
tie-breaking (closest to the main diagonal; PairWiseSW.h:226-250): last-row
cells (only for SOFTCLIP/IGNORE) are checked before last-column cells (all
strategies) within each anti-diagonal.

The CIGAR walk (state machine honouring extension bits), run-length
encoding, overhang-strategy tails and alignment offset follow
PairWiseSW.h:265-451.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MATCH, INSERT, DELETE = 0, 1, 2
INSERT_EXT, DELETE_EXT = 4, 8
SOFTCLIP, INDEL, LEADING_INDEL, IGNORE = 9, 10, 11, 12

MATRIX_MIN_CUTOFF = -100000000
LOW_INIT_VALUE = np.int32(np.iinfo(np.int32).min // 2)


@dataclasses.dataclass
class SWResult:
    cigar: str
    offset: int
    max_i: int
    max_j: int
    score: int


def sw_matrices(ref: np.ndarray, alt: np.ndarray, match: int, mismatch: int, open_: int, extend: int, strategy: int):
    """Full H and backtrack matrices plus the tracked maximum."""
    n, m = len(ref), len(alt)
    H = np.zeros((n + 1, m + 1), np.int64)
    E = np.full((n + 1, m + 1), int(LOW_INIT_VALUE), np.int64)
    F = np.full((n + 1, m + 1), int(LOW_INIT_VALUE), np.int64)
    bt = np.zeros((n + 1, m + 1), np.uint8)

    indel_boundary = strategy in (INDEL, LEADING_INDEL)
    for j in range(1, m + 1):
        H[0, j] = open_ + (j - 1) * extend if indel_boundary else 0
    for i in range(1, n + 1):
        H[i, 0] = open_ + (i - 1) * extend if indel_boundary else 0

    for i in range(1, n + 1):
        for j in range(1, m + 1):
            open_h = H[i, j - 1] + open_
            ext_h = E[i, j - 1] + extend
            E[i, j] = max(open_h, ext_h)
            i_ext = 0 if open_h > ext_h else INSERT_EXT

            open_v = H[i - 1, j] + open_
            ext_v = F[i - 1, j] + extend
            F[i, j] = max(open_v, ext_v)
            d_ext = 0 if open_v > ext_v else DELETE_EXT

            sbt = match if ref[i - 1] == alt[j - 1] else mismatch
            h = max(MATRIX_MIN_CUTOFF, H[i - 1, j - 1] + sbt)
            code = MATCH
            if E[i, j] > h:
                code = INSERT
                h = E[i, j]
            if F[i, j] > h:
                code = DELETE
                h = F[i, j]
            bt[i, j] = code | i_ext | d_ext
            H[i, j] = h

    # maximum tracking in anti-diagonal order (PairWiseSW.h:226-250)
    max_score = -(2**31)
    max_i = max_j = 0
    for d in range(1, n + m + 1):
        if d >= n + 1 and strategy in (SOFTCLIP, IGNORE):
            j0 = d - n
            if 1 <= j0 <= m:
                score = H[n, j0]
                if max_score < score or (max_score == score and abs(n - j0) < abs(max_i - max_j)):
                    max_score, max_i, max_j = score, n, j0
        if d >= m + 1:
            i0 = d - m
            if 1 <= i0 <= n:
                score = H[i0, m]
                if max_score < score or (
                    max_score == score and (max_j == m or abs(i0 - m) <= abs(max_i - max_j))
                ):
                    max_score, max_i, max_j = score, i0, m
    return H, bt, int(max_score), int(max_i), int(max_j)


def select_max(lastrow: np.ndarray, lastcol: np.ndarray, n: int, m: int, strategy: int) -> tuple[int, int, int]:
    """Maximum tracking from boundary score rows, in the reference's
    anti-diagonal visit order with its tie-breaks (PairWiseSW.h:226-250).

    ``lastrow[j-1] = H(n, j)``; ``lastcol[i-1] = H(i, m)``.
    Returns (max_score, max_i, max_j).
    """
    max_score = -(2**31)
    max_i = max_j = 0
    for d in range(1, n + m + 1):
        if d >= n + 1 and strategy in (SOFTCLIP, IGNORE):
            j0 = d - n
            if 1 <= j0 <= m:
                score = int(lastrow[j0 - 1])
                if max_score < score or (max_score == score and abs(n - j0) < abs(max_i - max_j)):
                    max_score, max_i, max_j = score, n, j0
        if d >= m + 1:
            i0 = d - m
            if 1 <= i0 <= n:
                score = int(lastcol[i0 - 1])
                if max_score < score or (
                    max_score == score and (max_j == m or abs(i0 - m) <= abs(max_i - max_j))
                ):
                    max_score, max_i, max_j = score, i0, m
    return max_score, max_i, max_j


def cigar_from_btrack(bt: np.ndarray, n: int, m: int, max_i: int, max_j: int, strategy: int) -> tuple[str, int]:
    """Backtrack walk + RLE + overhang tails (PairWiseSW.h:265-451).

    ``bt`` is (n+1, m+1) with entries for i,j >= 1.
    """
    elems: list[list[int]] = []  # [op, count]

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
        btr = int(bt[i, j])
        if state == INSERT_EXT:
            j -= 1
            elems[-1][1] += 1
            state = btr & INSERT_EXT
        elif state == DELETE_EXT:
            i -= 1
            elems[-1][1] += 1
            state = btr & DELETE_EXT
        else:
            code = btr & 3
            if code == MATCH:
                i -= 1
                j -= 1
                elems.append([MATCH, 1])
                state = 0
            elif code == INSERT:
                j -= 1
                elems.append([INSERT, 1])
                state = btr & INSERT_EXT
            else:  # DELETE
                i -= 1
                elems.append([DELETE, 1])
                state = btr & DELETE_EXT

    if strategy == SOFTCLIP:
        if j > 0:
            elems.append([SOFTCLIP, j])
        offset = i
    elif strategy == IGNORE:
        if j > 0:
            # the reference extends the previous element's op (PairWiseSW.h:371-376)
            elems.append([elems[-1][0] if elems else MATCH, j])
        offset = i - j
    else:  # INDEL / LEADING_INDEL
        if i > 0:
            elems.append([DELETE, i])
        elif j > 0:
            elems.append([INSERT, j])
        offset = 0

    # merge adjacent equal ops (PairWiseSW.h:397-416)
    merged: list[list[int]] = []
    for op, cnt in elems:
        if merged and merged[-1][0] == op:
            merged[-1][1] += cnt
        else:
            merged.append([op, cnt])

    op_char = {MATCH: "M", INSERT: "I", DELETE: "D", SOFTCLIP: "S"}
    cigar = "".join(f"{cnt}{op_char.get(op, 'R')}" for op, cnt in reversed(merged) if cnt > 0)
    return cigar, int(offset)


def sw_align(ref, alt, match: int, mismatch: int, open_: int, extend: int, strategy: int) -> SWResult:
    ref = np.frombuffer(bytes(ref), dtype=np.uint8) if isinstance(ref, (bytes, bytearray)) else np.asarray(ref, np.uint8)
    alt = np.frombuffer(bytes(alt), dtype=np.uint8) if isinstance(alt, (bytes, bytearray)) else np.asarray(alt, np.uint8)
    H, bt, max_score, max_i, max_j = sw_matrices(ref, alt, match, mismatch, open_, extend, strategy)
    cigar, offset = cigar_from_btrack(bt, len(ref), len(alt), max_i, max_j, strategy)
    return SWResult(cigar, offset, max_i, max_j, max_score)
