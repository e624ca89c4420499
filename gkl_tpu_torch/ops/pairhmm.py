"""PairHMM forward likelihood in plain PyTorch — counterpart of ``gkl_tpu/ops/pairhmm.py``.

For read row ``r`` (1-based) and haplotype column ``c``
(``avx-pairhmm-template.h:208-223,334-371``)::

    M[r][c] = prior[r][c] * (pMM[r]*M[r-1][c-1] + pGAPM[r]*(X[r-1][c-1] + Y[r-1][c-1]))
    X[r][c] = pMX[r]*M[r-1][c] + pXX[r]*X[r-1][c]
    Y[r][c] = pMY[r]*M[r][c-1] + pYY[r]*Y[r][c-1]

with ``Y[0][c] = INITIAL_CONSTANT / haplen``, everything else on row 0 and
column 0 zero, and the result ``sum_c M[rslen][c] + X[rslen][c]``.  Lanes are
pairs; M and X rows are elementwise over (H, P), and the Y recurrence is an
affine Hillis-Steele scan along the column axis whose coefficients ride as
(mantissa, exponent) pairs so that products of many gap probabilities keep
their full range.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import context as ctx_mod

N_CODE = ord("N")

_BITS = {
    torch.float32: (torch.int32, 23, 127, 0xFF),
    torch.float64: (torch.int64, 52, 1023, 0x7FF),
}


def _mant_exp(a: torch.Tensor):
    """``(m, e)`` with ``a == m * 2^e`` and ``m`` in [1, 2), for positive
    normal ``a`` — bitwise frexp (exact at every exponent)."""
    ib, sh, bias, mask = _BITS[a.dtype]
    e = ((a.view(ib) >> sh) & mask) - bias
    m = a * ((bias - e) << sh).view(a.dtype)
    return m, e.to(torch.int32)


def _pow2_mul(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x * 2^e`` for ``e <= 0`` far below the normal-exponent range: two
    exact power-of-two factors cover ``e >= -2*(bias-1)``; smaller
    coefficients are zeroed."""
    ib, sh, bias, _ = _BITS[x.dtype]
    eh = e >> 1
    el = e - eh

    def pow2(v):
        return ((v + bias).clamp(1, 2 * bias).to(ib) << sh).view(x.dtype)

    return torch.where(e < -(2 * (bias - 1)), torch.zeros_like(x),
                       (x * pow2(eh)) * pow2(el))


def _affine_combine(left, right):
    """Compose affine maps y -> a*y + b (left applied first); the
    coefficient is a (mantissa, exponent) pair."""
    m_l, e_l, b_l = left
    m_r, e_r, b_r = right
    m, d = _mant_exp(m_l * m_r)  # product in [1, 4) -> d in {0, 1}
    return m, e_l + e_r + d, _pow2_mul(m_r * b_l, e_r) + b_r


def _shift_down(a: torch.Tensor, k: int, fill: torch.Tensor) -> torch.Tensor:
    """Rows moved down by ``k`` along axis 0, the first ``k`` rows ``fill``."""
    return torch.cat([fill.expand(k, *a.shape[1:]), a[:-k]], dim=0)


def lane_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 of a (length, lane) tensor, each lane in one order
    whatever the batch's width: PyTorch's sum along a strided axis groups
    the terms by the lane count, so a lane's last bits would depend on its
    neighbours, and a sharded batch would not equal the whole batch."""
    return a.t().contiguous().sum(dim=1)


def affine_scan(am: torch.Tensor, ae: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the affine maps ``y -> 2^ae[c] * am[c] * y + b[c]``
    along axis 0 (Hillis-Steele, log2(H) levels): entry ``c`` of the
    result is the composition of maps 0..c, as (mantissa, exponent,
    offset); the offsets are ``y[c] = 2^ae[c] * am[c] * y[c-1] + b[c]``
    from ``y[-1] = 0``."""
    H = b.shape[0]
    one = torch.ones((1,) + tuple(am.shape[1:]), dtype=am.dtype, device=am.device)
    zero_e = torch.zeros((1,) + tuple(ae.shape[1:]), dtype=ae.dtype, device=ae.device)
    zero_b = torch.zeros((1,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
    k = 1
    while k < H:
        left = (_shift_down(am, k, one), _shift_down(ae, k, zero_e),
                _shift_down(b, k, zero_b))
        am, ae, b = _affine_combine(left, (am, ae, b))
        k <<= 1
    return am, ae, b


def transition_rows(q, iq, dq, gcp, ctx, dtype, device):
    """Per-row transition probabilities, gathered from the exact context
    tables (``avx-pairhmm-template.h:106-152,180-183``): (p_mm, p_gapm,
    p_mx, p_xx, p_my, p_yy, distm_match, distm_mis), each shaped like q."""
    ph2pr = torch.as_tensor(ctx.ph2pr, dtype=dtype, device=device)
    m2m = torch.as_tensor(ctx.match_to_match, dtype=dtype, device=device)
    qm = q.to(torch.int64) & 127
    im = iq.to(torch.int64) & 127
    dm = dq.to(torch.int64) & 127
    cm = gcp.to(torch.int64) & 127
    p_mm = m2m[ctx_mod.triangular_index(torch.maximum(im, dm), torch.minimum(im, dm))]
    ph_c = ph2pr[cm]
    distm = ph2pr[qm]
    one = torch.tensor(1.0, dtype=dtype, device=device)
    return (p_mm, one - ph_c, ph2pr[im], ph_c, ph2pr[dm], ph_c,
            one - distm, distm / torch.tensor(3.0, dtype=dtype, device=device))


def pairhmm_raw(hap, read, q, iq, dq, gcp, haplen, rslen, *,
                dtype: str = "float32") -> torch.Tensor:
    """Forward probability (pre-log, scaled by INITIAL_CONSTANT) per lane.

    Args:
      hap:    (H, P) uint8 haplotype bases (ASCII), padded arbitrarily.
      read:   (R, P) uint8 read bases (ASCII).
      q/iq/dq/gcp: (R, P) uint8 base/insertion/deletion/GCP quals (raw
        bytes, masked ``& 127`` like ``avx-pairhmm-template.h:134-150``).
      haplen: (P,) int32 per-lane haplotype length.
      rslen:  (P,) int32 per-lane read length.
      dtype:  "float32" or "float64".

    Returns:
      (P,) raw forward probability in ``dtype``, on the inputs' device.
    """
    ctx = ctx_mod.pairhmm_context(dtype)
    f = getattr(torch, dtype)
    hap, read, q, iq, dq, gcp, haplen, rslen = (
        torch.as_tensor(a) for a in (hap, read, q, iq, dq, gcp, haplen, rslen))
    dev = hap.device
    H, P = hap.shape
    R = read.shape[0]

    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, dmatch, dmis = transition_rows(
        q, iq, dq, gcp, ctx, f, dev)
    init_y = torch.tensor(ctx.INITIAL_CONSTANT, dtype=f, device=dev) / haplen.to(f)
    hap_is_n = hap == N_CODE
    col_valid = (torch.arange(1, H + 1, device=dev)[:, None] <= haplen[None, :]).to(f)
    zero_row = torch.zeros((1, P), dtype=f, device=dev)

    m = torch.zeros((H, P), dtype=f, device=dev)
    x = torch.zeros((H, P), dtype=f, device=dev)
    y = init_y[None, :].expand(H, P).clone()
    acc = torch.zeros(P, dtype=f, device=dev)
    for r in range(R):
        rc = read[r]
        match = (hap == rc[None, :]) | hap_is_n | (rc == N_CODE)[None, :]
        prior = torch.where(match, dmatch[r][None, :], dmis[r][None, :])
        # Y[r-1][0] is init_y on row 0 and 0 afterwards
        y0 = init_y[None, :] if r == 0 else zero_row
        m_new = prior * (p_mm[r] * _shift_down(m, 1, zero_row)
                         + p_gapm[r] * (_shift_down(x, 1, zero_row)
                                        + _shift_down(y, 1, y0)))
        x_new = p_mx[r] * m + p_xx[r] * x
        b = p_my[r] * _shift_down(m_new, 1, zero_row)
        am, ae = _mant_exp(p_yy[r][None, :].expand(H, P))
        y = affine_scan(am, ae, b)[2]
        m, x = m_new, x_new
        row_sum = lane_sum((m + x) * col_valid)
        acc = acc + torch.where(rslen == r + 1, row_sum, torch.zeros_like(row_sum))
    return acc


def pairhmm_log10_from_raw_f32(raw_f32) -> np.ndarray:
    """Float path postprocess: ``(double)(log10f(p) - LOG10_INITIAL_CONSTANT)``
    (``pairhmm/IntelPairHmm.cc:163-166``)."""
    ctx = ctx_mod.pairhmm_context("float32")
    raw = np.asarray(raw_f32, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        res = np.log10(raw).astype(np.float32) - ctx.LOG10_INITIAL_CONSTANT
    return res.astype(np.float64)


def pairhmm_log10_from_raw_f64(raw_f64) -> np.ndarray:
    """Double path postprocess (``IntelPairHmm.cc:159-162``)."""
    ctx = ctx_mod.pairhmm_context("float64")
    raw = np.asarray(raw_f64, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log10(raw) - ctx.LOG10_INITIAL_CONSTANT
