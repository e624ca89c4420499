"""Quality tables of GATK's PairHMM and PDHMM, in float64.

* ``ph2pr[q] = 10^(-q/10)`` for q < 128 (PairHMM ``Context.h``);
* ``q2e[q] = 10^(q/-10)`` for q <= 254 (PDHMM ``pdhmm-common.h``);
* match-to-match ``10^(log1p(-min(1, 10^s)) * inv_ln10)`` with ``s`` the
  Jacobian-table ``approximateLog10SumLog10(-0.1 max_q, -0.1 min_q)``; the
  PairHMM uses the truncated ``inv_ln10 = 0.434294``, PDHMM the exact
  ``1 / ln 10``.
"""

from __future__ import annotations

import functools

import numpy as np

MAX_QUAL = 254
JACOBIAN_STEP = 1e-4
JACOBIAN_MAX_TOLERANCE = 8.0
JACOBIAN_SIZE = int(JACOBIAN_MAX_TOLERANCE / JACOBIAN_STEP) + 1
PAIRHMM_INV_LN10 = 0.434294
PDHMM_INV_LN10 = 1.0 / np.log(10.0)
# the forward DPs start from 2^1020 in float64 and 2^120 in narrower types
INITIAL_EXP2 = {"float64": 1020}
NARROW_INITIAL_EXP2 = 120


def initial_exp2(dtype_name: str) -> int:
    return INITIAL_EXP2.get(dtype_name, NARROW_INITIAL_EXP2)


@functools.lru_cache(maxsize=None)
def _jacobian() -> np.ndarray:
    k = np.arange(JACOBIAN_SIZE, dtype=np.float64)
    return np.log10(1.0 + np.power(10.0, -k * JACOBIAN_STEP))


def _fast_round(d: np.ndarray) -> np.ndarray:
    """C's ``(int)(d + 0.5)`` above zero and ``(int)(d - 0.5)`` otherwise."""
    return np.where(d > 0, np.trunc(d + 0.5), np.trunc(d - 0.5)).astype(np.int64)


def log10_sum_log10(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """approximateLog10SumLog10 in float64: the larger plus the table's
    correction at the rounded difference, or the larger alone past 8."""
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    diff = hi - lo
    idx = np.clip(_fast_round(diff * (1.0 / JACOBIAN_STEP)), 0, JACOBIAN_SIZE - 1)
    return np.where(diff >= JACOBIAN_MAX_TOLERANCE, hi, hi + _jacobian()[idx])


def match_to_match(q1: np.ndarray, q2: np.ndarray, inv_ln10: float) -> np.ndarray:
    """Match-to-match probability of an (insertion, deletion) quality pair."""
    hi = np.maximum(q1, q2).astype(np.float64)
    lo = np.minimum(q1, q2).astype(np.float64)
    s = log10_sum_log10(-0.1 * hi, -0.1 * lo)
    with np.errstate(divide="ignore"):
        return np.power(10.0, np.log1p(-np.minimum(1.0, np.power(10.0, s))) * inv_ln10)


def ph2pr(q: np.ndarray) -> np.ndarray:
    return np.power(10.0, -np.asarray(q, np.float64) / 10.0)


def q2e(q: np.ndarray) -> np.ndarray:
    return np.power(10.0, np.asarray(q, np.float64) / -10.0)


def pairhmm_rows(q, iq, dq, gcp) -> np.ndarray:
    """(R, 8) per-row probabilities of one read: p_mm, p_gapm, p_mx, p_xx,
    p_my, p_yy, prior of a match, prior of a mismatch.  Qualities are taken
    modulo 128, as GATK's PairHMM does."""
    q, iq, dq, gcp = (np.asarray(x).astype(np.int64) & 127 for x in (q, iq, dq, gcp))
    out = np.empty((len(q), 8), np.float64)
    out[:, 0] = match_to_match(iq, dq, PAIRHMM_INV_LN10)
    out[:, 1] = 1.0 - ph2pr(gcp)
    out[:, 2] = ph2pr(iq)
    out[:, 3] = ph2pr(gcp)
    out[:, 4] = ph2pr(dq)
    out[:, 5] = ph2pr(gcp)
    err = ph2pr(q)
    out[:, 6] = 1.0 - err
    out[:, 7] = err / 3.0
    return out


def pdhmm_rows(q, iq, dq, gcp) -> np.ndarray:
    """(R, 8) per-row probabilities of one read for PDHMM: t_mm, t_mi, t_md,
    t_im, t_ii (= t_dd), prior of a match, prior of a mismatch, and 0.
    Qualities are taken modulo 256 and capped at 254, as the f64 DP the
    program rescues with does."""
    q, iq, dq, gcp = (np.minimum(np.asarray(x).astype(np.int64) & 0xFF, MAX_QUAL)
                      for x in (q, iq, dq, gcp))
    out = np.zeros((len(q), 8), np.float64)
    out[:, 0] = match_to_match(iq, dq, PDHMM_INV_LN10)
    out[:, 1] = q2e(iq)
    out[:, 2] = q2e(dq)
    out[:, 3] = 1.0 - q2e(gcp)
    out[:, 4] = q2e(gcp)
    err = q2e(q)
    out[:, 5] = 1.0 - err
    out[:, 6] = err / 3.0
    return out
