"""Scalar reference + native batch oracle for the PairHMM forward DP.

Counterpart of ``gkl_tpu/ops/pairhmm_ref.py``.  The reference recomputes
only the underflowed pair in double (``pairhmm/IntelPairHmm.cc:157-165``);
:func:`pairhmm_scalar_batch` is that rescue engine: the threaded exact-f64
DP of ``gkl_tpu_torch/native/pairhmm_oracle.cc`` (a byte-identical copy of
``gkl_tpu/native/pairhmm_oracle.cc``, built by ``native_lib``) over a
compacted lane batch.  :func:`pairhmm_scalar` is the
per-pair Python oracle the native DP is pinned against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import context as ctx_mod
from .. import native_lib
from .. import utils as utils_mod


def _trans_rows(q, iq, dq, gcp, ctx) -> np.ndarray:
    """(R, 8) f64 per-row probabilities {p_mm, p_gapm, p_mx, p_xx, p_my,
    p_yy, distm_match, distm_mis} from the context tables."""
    ph2pr = ctx.ph2pr
    m2m = ctx.match_to_match
    qm = np.asarray(q).astype(np.int32) & 127
    im = np.asarray(iq).astype(np.int32) & 127
    dm = np.asarray(dq).astype(np.int32) & 127
    cm = np.asarray(gcp).astype(np.int32) & 127
    out = np.empty((len(qm), 8), np.float64)
    out[:, 0] = m2m[ctx_mod.triangular_index(np.maximum(im, dm), np.minimum(im, dm))]
    out[:, 1] = 1.0 - ph2pr[cm]
    out[:, 2] = ph2pr[im]
    out[:, 3] = ph2pr[cm]
    out[:, 4] = ph2pr[dm]
    out[:, 5] = ph2pr[cm]
    distm = ph2pr[qm]
    out[:, 6] = 1.0 - distm
    out[:, 7] = distm / 3.0
    return out


def pairhmm_scalar(hap, read, q, iq, dq, gcp) -> float:
    """log10 likelihood for a single (hap, read) pair — sequential f64 DP in
    the evaluation order of the native oracle (rolling rows, columns
    ascending, result summed in column order)."""
    ctx = ctx_mod.pairhmm_context("float64")
    hap = np.asarray(hap, np.uint8)
    read = np.asarray(read, np.uint8)
    Hl, Rl = len(hap), len(read)
    trans = _trans_rows(q, iq, dq, gcp, ctx)
    init_y = np.float64(ctx.INITIAL_CONSTANT) / np.float64(Hl)

    n = ord("N")
    Mp = np.zeros(Hl + 1)
    Xp = np.zeros(Hl + 1)
    Yp = np.full(Hl + 1, init_y)
    Mc = np.zeros(Hl + 1)
    Xc = np.zeros(Hl + 1)
    Yc = np.zeros(Hl + 1)
    for r in range(1, Rl + 1):
        p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, dmatch, dmis = trans[r - 1]
        x = int(read[r - 1])
        Mc[0] = Xc[0] = Yc[0] = 0.0
        for j in range(1, Hl + 1):
            y = int(hap[j - 1])
            match = x == y or x == n or y == n
            prior = dmatch if match else dmis
            Mc[j] = prior * (p_mm * Mp[j - 1] + p_gapm * (Xp[j - 1] + Yp[j - 1]))
            Xc[j] = p_mx * Mp[j] + p_xx * Xp[j]
            Yc[j] = p_my * Mc[j - 1] + p_yy * Yc[j - 1]
        Mp, Mc = Mc, Mp
        Xp, Xc = Xc, Xp
        Yp, Yc = Yc, Yp

    total = 0.0
    for j in range(1, Hl + 1):
        total += Mp[j] + Xp[j]
    with np.errstate(divide="ignore"):
        return float(np.log10(total) - ctx.LOG10_INITIAL_CONSTANT)


def _oracle():
    lib = native_lib.load("gkl_pairhmm_oracle")
    if not hasattr(lib, "_pairhmm_ready"):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.gkl_pairhmm_oracle_batch.restype = None
        lib.gkl_pairhmm_oracle_batch.argtypes = [
            u8p, i64p, i32p, u8p, i64p, i32p, f64p, f64p,
            ctypes.c_int, f64p, ctypes.c_int,
        ]
        lib._pairhmm_ready = True
    return lib


def pairhmm_scalar_batch(haps, reads, quals, threads=None) -> np.ndarray:
    """Exact-f64 log10 likelihoods of a pair batch on the native thread pool
    (gradual underflow preserved).  ``quals`` holds (q, iq, dq, gcp) per
    pair."""
    lib = _oracle()
    n = len(haps)
    if n == 0:
        return np.zeros(0, np.float64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)

    ctx = ctx_mod.pairhmm_context("float64")
    hap_len = np.array([len(h) for h in haps], np.int32)
    read_len = np.array([len(r) for r in reads], np.int32)
    if hap_len.min() < 1 or read_len.min() < 1:
        raise ValueError("empty haplotype or read in oracle batch")
    hap_off = np.zeros(n, np.int64)
    read_off = np.zeros(n, np.int64)
    np.cumsum(hap_len[:-1], out=hap_off[1:])
    np.cumsum(read_len[:-1], out=read_off[1:])
    hap_buf = np.concatenate([np.ascontiguousarray(h, np.uint8) for h in haps])
    read_buf = np.concatenate([np.ascontiguousarray(r, np.uint8) for r in reads])
    trans = np.empty((int(read_len.sum()), 8), np.float64)
    for k in range(n):
        o, L = int(read_off[k]), int(read_len[k])
        if any(len(qv) != L for qv in quals[k]):
            raise ValueError("quality arrays must have the read's length")
        trans[o : o + L] = _trans_rows(*quals[k], ctx)
    init_y = np.float64(ctx.INITIAL_CONSTANT) / hap_len.astype(np.float64)

    out_raw = np.zeros(n, np.float64)
    lib.gkl_pairhmm_oracle_batch(
        hap_buf.ctypes.data_as(u8p), hap_off.ctypes.data_as(i64p),
        hap_len.ctypes.data_as(i32p), read_buf.ctypes.data_as(u8p),
        read_off.ctypes.data_as(i64p), read_len.ctypes.data_as(i32p),
        trans.ctypes.data_as(f64p), init_y.ctypes.data_as(f64p),
        ctypes.c_int(n), out_raw.ctypes.data_as(f64p),
        ctypes.c_int(threads or utils_mod.default_host_threads()),
    )
    with np.errstate(divide="ignore"):
        return np.log10(out_raw) - float(ctx.LOG10_INITIAL_CONSTANT)
