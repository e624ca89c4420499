"""Scalar reference and native batch oracle for PDHMM.

Counterpart of ``gkl_tpu/ops/pdhmm_ref.py``.  :func:`pdhmm_scalar` is the
per-pair Python oracle (the same code); :func:`pdhmm_scalar_batch` runs the
threaded exact-f64 DP of ``gkl_tpu_torch/native/pdhmm_oracle.cc`` (a
byte-identical copy of ``gkl_tpu/native/pdhmm_oracle.cc``, built by
``native_lib``), the engine of the double-precision mode, of
``KernelLevel.SCALAR`` and of the rescue of lanes below ``MIN_ACCEPTED``.
Direct re-derivation of the serial recurrence in
``src/main/native/pdhmm/pdhmm-serial.cc:279-412``: a PairHMM with three
extra "branch" matrices and a per-column jump-state machine driven by the
haplotype's partially-determined (PD) flag bytes
(``pdhmm/MathUtils.h:66-76``):

* ``DEL_START`` at hap position j-1 -> enter INSIDE_DEL at column j+1
* ``DEL_END``   at hap position j-1 -> enter AFTER_DEL at column j+1
  (overrides DEL_START; AFTER_DEL lasts exactly one column)
* in NORMAL the branch matrices copy the left values, in INSIDE_DEL they
  freeze, and in AFTER_DEL branch and normal paths max-merge.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import context as ctx_mod
from .. import native_lib
from .. import utils as utils_mod

SNP = 1
DEL_START = 2
DEL_END = 4
_BASE_BIT = {65: 8, 97: 8, 67: 16, 99: 16, 71: 32, 103: 32, 84: 64, 116: 64}  # A C G T upper/lower

NORMAL, INSIDE_DEL, AFTER_DEL = 0, 1, 2


def _is_pd_matching(read_byte: int, pd: int) -> bool:
    if pd & SNP:
        bit = _BASE_BIT.get(int(read_byte), 0)
        return (pd & bit) != 0
    return False


def pdhmm_scalar(hap, hap_pd, read, q, iq, dq, gcp, dtype: str = "float64") -> float:
    """log10 likelihood for a single (hap, read) pair."""
    ctx = ctx_mod.pdhmm_context(dtype)
    f = np.dtype(dtype).type
    q2e = ctx.qual_to_error_prob
    Hl, Rl = len(hap), len(read)

    def q2e_at(qual):
        return q2e[min(int(qual) & 0xFF, ctx_mod.MAX_QUAL)]

    # transitions per row (pdhmm-serial.cc:181-226)
    t_mm = np.zeros(Rl + 1, dtype)
    t_im = np.zeros(Rl + 1, dtype)
    t_mi = np.zeros(Rl + 1, dtype)
    t_ii = np.zeros(Rl + 1, dtype)
    t_md = np.zeros(Rl + 1, dtype)
    t_dd = np.zeros(Rl + 1, dtype)
    for r in range(1, Rl + 1):
        i_, d_, c_ = int(iq[r - 1]) & 0xFF, int(dq[r - 1]) & 0xFF, int(gcp[r - 1]) & 0xFF
        t_mm[r] = ctx.set_mm_prob(i_, d_)
        t_mi[r] = q2e_at(i_)
        t_md[r] = q2e_at(d_)
        t_im[r] = f(1.0) - q2e_at(c_)
        t_ii[r] = t_dd[r] = q2e_at(c_)

    ic = f(ctx.INITIAL_CONDITION) / f(Hl)
    M = np.zeros((Rl + 1, Hl + 1), dtype)
    I = np.zeros((Rl + 1, Hl + 1), dtype)
    D = np.zeros((Rl + 1, Hl + 1), dtype)
    BM = np.zeros((Rl + 1, Hl + 1), dtype)
    BI = np.zeros((Rl + 1, Hl + 1), dtype)
    BD = np.zeros((Rl + 1, Hl + 1), dtype)
    D[0, :] = ic

    for r in range(1, Rl + 1):
        x = int(read[r - 1])
        err = q2e_at(q[r - 1])
        p_match = f(1.0) - err
        p_mis = err / f(3.0)
        state = NORMAL
        for j in range(1, Hl + 1):
            y = int(hap[j - 1])
            pd = int(hap_pd[j - 1])
            match = (x == y) or x == ord("N") or y == ord("N") or _is_pd_matching(x, pd)
            prior = p_match if match else p_mis

            # Column 0 of rows >= 1 stays 0 in every matrix (matching the
            # serial rolling arrays, whose dmDiag resets to 0 except on row 1
            # where it reads the D[0][0]=ic initial row).
            m_diag, i_diag, d_diag = M[r - 1, j - 1], I[r - 1, j - 1], D[r - 1, j - 1]
            bm_diag, bi_diag, bd_diag = BM[r - 1, j - 1], BI[r - 1, j - 1], BD[r - 1, j - 1]
            m_left, i_left, d_left = M[r, j - 1], I[r, j - 1], D[r, j - 1]
            bm_left, bi_left, bd_left = BM[r, j - 1], BI[r, j - 1], BD[r, j - 1]

            if state == NORMAL:
                BM[r, j], BD[r, j], BI[r, j] = m_left, d_left, i_left
            elif state == INSIDE_DEL:
                BM[r, j], BD[r, j], BI[r, j] = bm_left, bd_left, bi_left
            else:  # AFTER_DEL
                BM[r, j] = max(bm_left, m_left)
                BD[r, j] = max(bd_left, d_left)
                BI[r, j] = max(bi_left, i_left)
                m_diag = max(m_diag, bm_diag)
                i_diag = max(i_diag, bi_diag)
                d_diag = max(d_diag, bd_diag)
                m_left = max(m_left, bm_left)
                d_left = max(d_left, bd_left)

            M[r, j] = prior * (m_diag * t_mm[r] + i_diag * t_im[r] + d_diag * t_im[r])
            D[r, j] = m_left * t_md[r] + d_left * t_dd[r]

            if pd & DEL_END:
                I[r, j] = max(BM[r - 1, j], M[r - 1, j]) * t_mi[r] + max(BI[r - 1, j], I[r - 1, j]) * t_ii[r]
            else:
                I[r, j] = M[r - 1, j] * t_mi[r] + I[r - 1, j] * t_ii[r]

            if state == AFTER_DEL:
                state = NORMAL
            if pd & DEL_START:
                state = INSIDE_DEL
            if pd & DEL_END:
                state = AFTER_DEL

    total = f(0.0)
    for j in range(1, Hl + 1):
        total += M[Rl, j] + I[Rl, j]
    return float(np.log10(total) - ctx.INITIAL_CONDITION_LOG10)


def _oracle():
    lib = native_lib.load("gkl_pdhmm_oracle")
    if not hasattr(lib, "_pdhmm_ready"):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.gkl_pdhmm_oracle_batch.restype = None
        lib.gkl_pdhmm_oracle_batch.argtypes = [
            u8p, i64p, i32p, u8p, u8p, i64p, i32p, f64p, f64p,
            ctypes.c_int, f64p, ctypes.c_int,
        ]
        lib._pdhmm_ready = True
    return lib


def pdhmm_scalar_batch(haps, hap_pds, reads, quals, threads=None) -> np.ndarray:
    """Exact-f64 log10 likelihoods of a pair batch on the native thread pool
    (gradual underflow preserved).  ``quals`` holds (q, iq, dq, gcp) per
    pair.  The probability tables are built here from the context, the same
    ones :func:`pdhmm_scalar` uses, and shipped as per-row transitions."""
    n = len(haps)
    if n == 0:
        return np.zeros(0, np.float64)
    lib = _oracle()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    ctx = ctx_mod.pdhmm_context("float64")
    q2e = ctx.qual_to_error_prob

    hap_len = np.array([len(h) for h in haps], np.int32)
    read_len = np.array([len(r) for r in reads], np.int32)
    if hap_len.min() < 1 or read_len.min() < 1:
        raise ValueError("empty haplotype or read in oracle batch")
    if any(len(p) != len(h) for p, h in zip(hap_pds, haps)):
        raise ValueError("PD bytes must have the haplotype's length")
    hap_off = np.zeros(n, np.int64)
    read_off = np.zeros(n, np.int64)
    np.cumsum(hap_len[:-1], out=hap_off[1:])
    np.cumsum(read_len[:-1], out=read_off[1:])
    hap_buf = np.concatenate([np.ascontiguousarray(h, np.uint8) for h in haps])
    pd_buf = np.concatenate([np.ascontiguousarray(p, np.uint8) for p in hap_pds])
    read_buf = np.concatenate([np.ascontiguousarray(r, np.uint8) for r in reads])

    def qidx(x):
        return np.minimum(np.asarray(x).astype(np.int32) & 0xFF, ctx_mod.MAX_QUAL)

    trans = np.empty((int(read_len.sum()), 7), np.float64)
    for k in range(n):
        q, iq, dq, gcp = quals[k]
        o, L = int(read_off[k]), int(read_len[k])
        if any(len(v) != L for v in quals[k]):
            raise ValueError("quality arrays must have the read's length")
        i_, d_, c_, q_ = qidx(iq), qidx(dq), qidx(gcp), qidx(q)
        trans[o:o + L, 0] = ctx.set_mm_prob(i_, d_)
        trans[o:o + L, 1] = q2e[i_]
        trans[o:o + L, 2] = q2e[d_]
        trans[o:o + L, 3] = 1.0 - q2e[c_]
        trans[o:o + L, 4] = q2e[c_]
        err = q2e[q_]
        trans[o:o + L, 5] = 1.0 - err
        trans[o:o + L, 6] = err / 3.0
    ic = np.float64(ctx.INITIAL_CONDITION) / hap_len.astype(np.float64)

    out_raw = np.zeros(n, np.float64)
    lib.gkl_pdhmm_oracle_batch(
        hap_buf.ctypes.data_as(u8p), hap_off.ctypes.data_as(i64p),
        hap_len.ctypes.data_as(i32p), pd_buf.ctypes.data_as(u8p),
        read_buf.ctypes.data_as(u8p), read_off.ctypes.data_as(i64p),
        read_len.ctypes.data_as(i32p), trans.ctypes.data_as(f64p),
        ic.ctypes.data_as(f64p), ctypes.c_int(n), out_raw.ctypes.data_as(f64p),
        ctypes.c_int(threads or utils_mod.default_host_threads()),
    )
    with np.errstate(divide="ignore"):
        return np.log10(out_raw) - float(ctx.INITIAL_CONDITION_LOG10)
