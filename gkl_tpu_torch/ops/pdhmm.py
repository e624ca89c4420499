"""PDHMM forward likelihood in plain PyTorch — counterpart of ``gkl_tpu/ops/pdhmm.py``.

Semantics of the reference serial kernel (``pdhmm-serial.cc:279-412``; see
``pdhmm_ref.py`` for the scalar oracle): a PairHMM with three branch
matrices BM/BI/BD and a NORMAL/INSIDE_DEL/AFTER_DEL jump state driven by
the haplotype's PD flag bytes.  The state depends only on the haplotype,
so it is per column and row-invariant (:func:`column_states`).

:func:`pdhmm_raw` is the plain twin of the CUDA kernel ``csrc/pdhmm.cu``
and follows the JAX engine's layout: a sweep over haplotype columns with
read rows and lanes vectorised.  Every left and diagonal dependency then
lives in the previous column, and the one within-column recurrence, the
insertion ``I[r] = max(c[r], a[r]*I[r-1] + b[r])``, is a Hillis-Steele
scan of max-affine maps whose coefficients (products of ``t_ii`` over row
spans) ride as (mantissa, exponent) pairs so that they keep their range.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import context as ctx_mod
from .pairhmm import _mant_exp, _pow2_mul
from .pairhmm_cuda import _ftz

SNP = 1
DEL_START = 2
DEL_END = 4

N_CODE = 78

# read byte -> base class (A=0, C=1, G=2, T=3, other=4), case-folded, for
# the PD SNP-matching bits A=8, C=16, G=32, T=64 (pdhmm/MathUtils.h:66-76)
_BASE_CLASS = np.full(256, 4, np.int64)
for _c, _k in ((65, 0), (97, 0), (67, 1), (99, 1), (71, 2), (103, 2), (84, 3), (116, 3)):
    _BASE_CLASS[_c] = _k

ST_NORMAL, ST_INSIDE, ST_AFTER = 0, 1, 2


def column_states(hap_pd: np.ndarray) -> np.ndarray:
    """Per-column jump state (uint8) from (H, P) PD flag bytes: the state
    *when processing* column j+1 (0-based index j), in the update order of
    pdhmm-serial.cc:370-385 (AFTER_DEL resets to NORMAL, DEL_START enters
    INSIDE_DEL, DEL_END overriding it enters AFTER_DEL).

    The state after column j follows from the last deletion event e <= j
    alone: INSIDE_DEL after a DEL_START without DEL_END, AFTER_DEL after a
    DEL_END at e = j, NORMAL after an older DEL_END or with no event; so
    the whole plane is one forward fill of the last event's column."""
    hap_pd = np.asarray(hap_pd, np.uint8)
    H, P = hap_pd.shape
    cols = np.arange(H)[:, None]
    event = (hap_pd & (DEL_START | DEL_END)) != 0
    last = np.maximum.accumulate(np.where(event, cols, -1), axis=0)
    pd_last = np.take_along_axis(hap_pd, np.maximum(last, 0), axis=0)
    after = np.where((pd_last & DEL_END) != 0,
                     np.where(last == cols, ST_AFTER, ST_NORMAL), ST_INSIDE)
    out = np.zeros((H, P), np.uint8)
    out[1:] = np.where(last < 0, ST_NORMAL, after)[:-1]
    return out


def lane_event_key(hap_pd: np.ndarray) -> int:
    """Batch-planner sort key for one lane's PD bytes: its first eventful
    column, or a sentinel past every column when it has none.  Lanes with
    events at nearby columns then sit together, and lanes with none form
    event-free batches."""
    nz = np.flatnonzero(hap_pd)
    return int(nz[0]) if nz.size else 1 << 30


def _shift_rows(arr: torch.Tensor, first) -> torch.Tensor:
    """Row r of the result is row r-1 of ``arr``; row 0 is ``first``."""
    out = torch.empty_like(arr)
    out[0] = first
    out[1:] = arr[:-1]
    return out


def _span_coefficients(a: torch.Tensor, levels: int, fl):
    """(mantissa, exponent) of the product of ``a`` over the row span each
    element covers before each scan level: level l's entry for row r spans
    rows max(0, r - 2^l + 1) .. r."""
    m, e = _mant_exp(a)
    out = []
    for lvl in range(levels):
        out.append((m, e))
        s = 1 << lvl
        m2, d = _mant_exp(fl(m[:-s] * m[s:]))  # mantissas in [1, 2): no underflow
        m = torch.cat([m[:s], m2])
        e = torch.cat([e[:s], e[:-s] + e[s:] + d])
    return out


def pdhmm_raw(hap, hap_pd, states, read, q, iq, dq, gcp, haplen, rslen, boost_row=None,
              boost_log2: float = 0.0, *, dtype: str = "float64") -> torch.Tensor:
    """Forward probability per lane, before the log and scaled by the
    context's INITIAL_CONDITION (2^120 in float32, 2^1020 in float64).

    Args (torch tensors on one device):
      hap, hap_pd, states: (H, P) uint8 bases, PD flag bytes and
        :func:`column_states`.
      read, q, iq, dq, gcp: (R, P) uint8 (PDHMM takes quals up to 254).
      haplen, rslen: (P,) int32 true lengths.
      boost_row, boost_log2: an optional per-lane rescale, the JAX
        package's (``gkl_tpu/ops/pdhmm.py:106-137``): every transition that
        carries row r-1 into row r is multiplied by ``2**boost_log2`` where
        r is the lane's ``boost_row`` (1-based; a value past the read moves
        nothing), which scales every row from there on by that power of
        two; the caller subtracts ``boost_log2 * log10(2)`` from the log.

    In float32 every product is flushed to zero below the normal range, as
    the kernel (built with -ftz=true) and XLA do.  That cannot move a lane
    whose result is at least MIN_ACCEPTED: a flushed value is under 2^-126,
    and the transitions it would have fed are at most 1, so its share of
    the result is under haplen * 2^-126, some 1e-8 of 1e-28.
    """
    ctx = ctx_mod.pdhmm_context(dtype)
    f = torch.float32 if dtype == "float32" else torch.float64
    fl = _ftz if f == torch.float32 else (lambda x: x)
    dev = hap.device
    H, P = hap.shape
    R = read.shape[0]

    q2e = torch.as_tensor(ctx.qual_to_error_prob, dtype=f).to(dev)
    m2m = torch.as_tensor(ctx.match_to_match, dtype=f).to(dev)

    def qidx(x):
        return x.to(torch.int64).clamp(max=ctx_mod.MAX_QUAL)

    im, dm, cm, qm = qidx(iq), qidx(dq), qidx(gcp), qidx(q)
    max_q, min_q = torch.maximum(im, dm), torch.minimum(im, dm)
    t_mm = m2m[((max_q * (max_q + 1)) >> 1) + min_q]  # (R, P)
    t_mi = q2e[im]
    t_md = q2e[dm]
    t_im = 1.0 - q2e[cm]
    t_dd = q2e[cm]
    t_ii = t_dd
    if boost_row is not None:
        rows = torch.arange(1, R + 1, device=dev)[:, None]
        boost = torch.where(rows == torch.as_tensor(boost_row, device=dev).to(torch.int64),
                            torch.tensor(2.0, dtype=f, device=dev) ** boost_log2,
                            torch.tensor(1.0, dtype=f, device=dev))
        t_mm, t_im, t_mi, t_ii = (t * boost for t in (t_mm, t_im, t_mi, t_ii))
    err = q2e[qm]
    p_match = 1.0 - err
    p_mis = err / 3.0

    read_i = read.to(torch.int64)
    read_cls = torch.as_tensor(_BASE_CLASS).to(dev)[read_i]
    read_is_n = read_i == N_CODE
    ic = torch.tensor(float(ctx.INITIAL_CONDITION), dtype=f, device=dev) / haplen.to(f)
    row_is_last = (torch.arange(1, R + 1, device=dev)[:, None]
                   == rslen.to(torch.int64)[None, :]).to(f)
    levels = max(1, (R - 1).bit_length())
    spans = _span_coefficients(t_ii, levels, fl)

    zeros = torch.zeros((R, P), dtype=f, device=dev)
    m_l = i_l = d_l = bm_l = bi_l = bd_l = zeros
    acc = torch.zeros(P, dtype=f, device=dev)
    for j in range(H):
        st = states[j].to(torch.int64)[None, :]
        st_n, st_i, st_a = st == ST_NORMAL, st == ST_INSIDE, st == ST_AFTER
        pd = hap_pd[j].to(torch.int64)[None, :]
        del_end = (pd & DEL_END) != 0
        y = hap[j].to(torch.int64)[None, :]
        pd_match = ((pd & SNP) != 0) & (((pd >> (3 + read_cls)) & 1) != 0) & (read_cls < 4)
        match = (read_i == y) | read_is_n | (y == N_CODE) | pd_match
        prior = torch.where(match, p_match, p_mis)

        # branch matrices of this column, from the previous column
        bm = torch.where(st_n, m_l, torch.where(st_i, bm_l, torch.maximum(bm_l, m_l)))
        bd = torch.where(st_n, d_l, torch.where(st_i, bd_l, torch.maximum(bd_l, d_l)))
        bi = torch.where(st_n, i_l, torch.where(st_i, bi_l, torch.maximum(bi_l, i_l)))

        # diagonal: the previous column one row up; row 0 is 0 except D = ic
        m_dg = _shift_rows(m_l, 0.0)
        i_dg = _shift_rows(i_l, 0.0)
        d_dg = _shift_rows(d_l, ic)
        m_dg = torch.where(st_a, torch.maximum(m_dg, _shift_rows(bm_l, 0.0)), m_dg)
        i_dg = torch.where(st_a, torch.maximum(i_dg, _shift_rows(bi_l, 0.0)), i_dg)
        d_dg = torch.where(st_a, torch.maximum(d_dg, _shift_rows(bd_l, 0.0)), d_dg)
        m = fl(prior * (fl(m_dg * t_mm) + fl(i_dg * t_im) + fl(d_dg * t_im)))

        # deletion from the left; AFTER_DEL max-merges with the branch
        m_left = torch.where(st_a, torch.maximum(m_l, bm_l), m_l)
        d_left = torch.where(st_a, torch.maximum(d_l, bd_l), d_l)
        d = fl(m_left * t_md) + fl(d_left * t_dd)

        # insertion: I[r] = max(c, a*I[r-1] + b) with a = t_ii, I[0] = 0
        m_top = _shift_rows(m, 0.0)
        b = fl(t_mi * torch.where(del_end, torch.maximum(_shift_rows(bm, 0.0), m_top), m_top))
        c = torch.where(del_end, b + fl(t_ii * _shift_rows(bi, 0.0)), 0.0)
        for lvl, (am, ae) in enumerate(spans):
            s = 1 << lvl
            mr, er = am[s:], ae[s:]
            c_new = torch.maximum(c[s:], fl(_pow2_mul(fl(mr * c[:-s]), er)) + b[s:])
            b_new = fl(_pow2_mul(fl(mr * b[:-s]), er)) + b[s:]
            c = torch.cat([c[:s], c_new])
            b = torch.cat([b[:s], b_new])
        ins = torch.maximum(c, b)

        valid = ((j + 1) <= haplen.to(torch.int64)).to(f)[None, :]
        acc = acc + ((m + ins) * row_is_last * valid).sum(dim=0)
        m_l, i_l, d_l, bm_l, bi_l, bd_l = m, ins, d, bm, bi, bd
    return acc
