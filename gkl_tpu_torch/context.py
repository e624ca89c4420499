"""Quality-score probability tables for the PairHMM and PDHMM forward DPs.

Counterpart of ``gkl_tpu/context.py``, in numpy and bit-identical to it:

* ``ph2pr[q] = 10^(-q/10)`` — phred to error probability
  (reference: ``src/main/native/pairhmm/Context.h:137-140,178-181``);
* the Jacobian log-sum correction table, step 1e-4, max tolerance 8.0
  (``Context.h:30-34,65-72``);
* the triangular match-to-match transition cache over qual pairs <= 254
  (``Context.h:74-89``; ``pdhmm/pdhmm-common.h:175-184``);
* PDHMM's qual-to-error table over quals 0..254 (``pdhmm-common.h:129-137``).

Two quirks of the reference are kept because the golden vectors depend on
them: the PairHMM context's truncated ``INV_LN10 = 0.434294``
(``Context.h:78``) where PDHMM uses the exact ``1/ln(10)``
(``pdhmm/MathUtils.cc:38-39``), and the float32 PairHMM context evaluating
``approximateLog10SumLog10`` in float32.
"""

from __future__ import annotations

import functools

import numpy as np

MAX_QUAL = 254
MAX_JACOBIAN_TOLERANCE = 8.0
JACOBIAN_LOG_TABLE_STEP = 1e-4
JACOBIAN_LOG_TABLE_SIZE = int(MAX_JACOBIAN_TOLERANCE / JACOBIAN_LOG_TABLE_STEP) + 1
MTM_TABLE_SIZE = ((MAX_QUAL + 1) * (MAX_QUAL + 2)) >> 1

# PairHMM float-first rescue threshold (reference: pairhmm_common.h:39).
MIN_ACCEPTED = np.float32(1e-28)

# Truncated constant of the PairHMM context (Context.h:77-78).
_PAIRHMM_INV_LN10 = 0.434294
# Exact constant of PDHMM (MathUtils.cc:38-39).
_PDHMM_INV_LN10 = 1.0 / np.log(10.0)


def _fast_round(d: np.ndarray) -> np.ndarray:
    """C-style ``(int)(d + 0.5)`` for d > 0, ``(int)(d - 0.5)`` otherwise
    (``Context.h:91-94``)."""
    return np.where(d > 0, np.trunc(d + 0.5), np.trunc(d - 0.5)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def jacobian_log_table(dtype: str) -> np.ndarray:
    """``log10(1 + 10^(-k * step))`` for k in [0, 80000], computed in double
    and cast (``Context.h:65-72``)."""
    k = np.arange(JACOBIAN_LOG_TABLE_SIZE, dtype=np.float64)
    tab = np.log10(1.0 + np.power(10.0, -k * JACOBIAN_LOG_TABLE_STEP))
    return tab.astype(dtype)


def _approximate_log10_sum_log10_f32(small: np.ndarray, big: np.ndarray) -> np.ndarray:
    """Float32 approximateLog10SumLog10 (Context.h:96-122, NUMBER=float)."""
    small = small.astype(np.float32)
    big = big.astype(np.float32)
    lo = np.minimum(small, big)
    hi = np.maximum(small, big)
    diff = (hi - lo).astype(np.float32)
    tab = jacobian_log_table("float32")
    idx = _fast_round((diff * np.float32(1.0 / JACOBIAN_LOG_TABLE_STEP)).astype(np.float32))
    idx = np.clip(idx, 0, JACOBIAN_LOG_TABLE_SIZE - 1)
    corrected = (hi + tab[idx]).astype(np.float32)
    return np.where(diff >= np.float32(MAX_JACOBIAN_TOLERANCE), hi, corrected)


def _approximate_log10_sum_log10_f64(small: np.ndarray, big: np.ndarray) -> np.ndarray:
    """Double approximateLog10SumLog10 (Context.h:96-122, NUMBER=double)."""
    lo = np.minimum(small, big)
    hi = np.maximum(small, big)
    diff = hi - lo
    tab = jacobian_log_table("float64")
    idx = np.clip(_fast_round(diff * (1.0 / JACOBIAN_LOG_TABLE_STEP)), 0, JACOBIAN_LOG_TABLE_SIZE - 1)
    return np.where(diff >= MAX_JACOBIAN_TOLERANCE, hi, hi + tab[idx])


def approximate_log10_sum_log10(a, b, dtype: str = "float64"):
    """Vectorised Jacobian-table log10(10^a + 10^b) approximation."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if dtype == "float32":
        return _approximate_log10_sum_log10_f32(a.astype(np.float32), b.astype(np.float32))
    return _approximate_log10_sum_log10_f64(a, b)


@functools.lru_cache(maxsize=None)
def ph2pr_table(dtype: str) -> np.ndarray:
    """``10^(-q/10)`` for q in [0, 128) (Context.h:137-140,178-181)."""
    q = np.arange(128, dtype=np.float64)
    if dtype == "float32":
        # reference: powf(10.f, -x/10.f)
        return np.power(np.float32(10.0), (-(q.astype(np.float32)) / np.float32(10.0))).astype(np.float32)
    return np.power(10.0, -q / 10.0)


@functools.lru_cache(maxsize=None)
def qual_to_error_prob_table(dtype: str = "float64") -> np.ndarray:
    """``10^(-q/10)`` for q in [0, 254] (pdhmm-common.h:129-137,186-195)."""
    q = np.arange(MAX_QUAL + 1, dtype=np.float64)
    return np.power(10.0, q / -10.0).astype(dtype)


def triangular_index(max_q, min_q):
    """Position of the (max_q, min_q) pair in the match-to-match cache."""
    return ((max_q * (max_q + 1)) >> 1) + min_q


@functools.lru_cache(maxsize=None)
def match_to_match_table(dtype: str, exact_inv_ln10: bool = False) -> np.ndarray:
    """Triangular matchToMatchProb cache:
    ``m2m[tri(i,j)] = 10^(log1p(-min(1, 10^log10sum(-0.1i, -0.1j))) * inv_ln10)``.

    PairHMM flavour (``exact_inv_ln10=False``, Context.h:74-89): the
    truncated 0.434294, and the log10sum in float32 for the float32
    context.  PDHMM flavour: the exact 1/ln(10), doubles throughout
    (pdhmm-common.h:175-184)."""
    i, j = np.meshgrid(np.arange(MAX_QUAL + 1), np.arange(MAX_QUAL + 1), indexing="ij")
    mask = j <= i
    ii = i[mask].astype(np.float64)
    jj = j[mask].astype(np.float64)
    if dtype == "float32" and not exact_inv_ln10:
        # NUMBER=float: operands are (-0.1f * i) computed in f32.
        small = (np.float32(-0.1) * ii.astype(np.float32)).astype(np.float32)
        big = (np.float32(-0.1) * jj.astype(np.float32)).astype(np.float32)
        log10_sum = _approximate_log10_sum_log10_f32(small, big).astype(np.float64)
    else:
        log10_sum = _approximate_log10_sum_log10_f64(-0.1 * ii, -0.1 * jj)
    with np.errstate(divide="ignore"):
        # log1p(-1) = -inf at i=j=0 is intended: the cached prob is 0.
        m2m_log10 = np.log1p(-np.minimum(1.0, np.power(10.0, log10_sum))) * (
            _PDHMM_INV_LN10 if exact_inv_ln10 else _PAIRHMM_INV_LN10)
    vals = np.power(10.0, m2m_log10)
    out = np.zeros(MTM_TABLE_SIZE, dtype=np.float64)
    out[triangular_index(i[mask], j[mask])] = vals
    return out.astype(dtype)


def match_to_match_prob(ins_qual, del_qual, dtype: str = "float64",
                        exact_inv_ln10: bool = False):
    """Vectorised ``set_mm_prob`` (Context.h:156-167; pdhmm-serial.cc:157-179).

    Quals must already be masked to the reference's range (``& 127`` for
    PairHMM, ``& 0xFF`` for PDHMM).  Values above MAX_QUAL fall back to the
    direct formula.
    """
    iq = np.asarray(ins_qual, dtype=np.int64)
    dq = np.asarray(del_qual, dtype=np.int64)
    min_q = np.minimum(iq, dq)
    max_q = np.maximum(iq, dq)
    tab = match_to_match_table(dtype, exact_inv_ln10)
    cached = tab[triangular_index(np.minimum(max_q, MAX_QUAL), np.minimum(min_q, MAX_QUAL))]
    if np.any(max_q > MAX_QUAL):
        ls = approximate_log10_sum_log10(-0.1 * min_q, -0.1 * max_q, dtype)
        direct = (1.0 - np.power(10.0, ls.astype(np.float64))).astype(dtype)
        return np.where(max_q > MAX_QUAL, direct, cached)
    return cached


class PairHmmContext:
    """Numeric constants for one PairHMM precision (Context.h:125-210)."""

    def __init__(self, dtype: str):
        if dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported PairHMM precision: {dtype!r}")
        self.dtype = dtype
        self.ph2pr = ph2pr_table(dtype)
        self.match_to_match = match_to_match_table(dtype)
        if dtype == "float32":
            self.INITIAL_CONSTANT = np.float32(np.ldexp(1.0, 120))
            self.LOG10_INITIAL_CONSTANT = np.float32(np.log10(np.float32(self.INITIAL_CONSTANT)))
        else:
            self.INITIAL_CONSTANT = np.float64(np.ldexp(1.0, 1020))
            self.LOG10_INITIAL_CONSTANT = np.float64(np.log10(self.INITIAL_CONSTANT))

    def set_mm_prob(self, ins_qual, del_qual):
        return match_to_match_prob(ins_qual, del_qual, self.dtype)


@functools.lru_cache(maxsize=None)
def pairhmm_context(dtype: str) -> PairHmmContext:
    return PairHmmContext(dtype)


class PDHmmContext:
    """Numeric constants for PDHMM (pdhmm/MathUtils.cc, pdhmm-common.h).

    The reference is double-only (INITIAL_CONDITION 2^1020); the float32
    context starts from 2^120, like the PairHMM float context, so that
    intermediates stay in range."""

    def __init__(self, dtype: str = "float64"):
        if dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported PDHMM precision: {dtype!r}")
        self.dtype = dtype
        self.qual_to_error_prob = qual_to_error_prob_table(dtype)
        self.match_to_match = match_to_match_table(dtype, exact_inv_ln10=True)
        if dtype == "float32":
            self.INITIAL_CONDITION = np.float32(np.ldexp(1.0, 120))
            self.INITIAL_CONDITION_LOG10 = np.float32(np.log10(np.float32(self.INITIAL_CONDITION)))
        else:
            self.INITIAL_CONDITION = np.float64(np.ldexp(1.0, 1020))
            self.INITIAL_CONDITION_LOG10 = np.float64(np.log10(self.INITIAL_CONDITION))

    def set_mm_prob(self, ins_qual, del_qual):
        return match_to_match_prob(ins_qual, del_qual, self.dtype, exact_inv_ln10=True)


@functools.lru_cache(maxsize=None)
def pdhmm_context(dtype: str = "float64") -> PDHmmContext:
    return PDHmmContext(dtype)
