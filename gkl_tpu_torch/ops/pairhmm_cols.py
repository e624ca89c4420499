"""PairHMM forward by haplotype columns: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``gkl_tpu/ops/pairhmm_pallas_cols.py`` (``_kernel``,
``_kernel_relay`` and their wrappers ``pairhmm_raw_pallas_cols`` and
``pairhmm_raw_pallas_cols_relay``), the engine of haplotype buckets past
2048.  :func:`pairhmm_cols` takes the indexed batch of
``ops.pairhmm_cuda.pairhmm_rows``: on CUDA tensors it launches
``csrc/pairhmm_cols.cu`` (built for sm_90a) or raises; on CPU tensors it
runs :func:`pairhmm_raw_cols`, the same function in plain PyTorch, on the
expanded planes.  Both return the plain f32 forward probability per lane,
scaled by the initial constant 2^120, as ``ops.pairhmm.pairhmm_raw`` does.
"""

from __future__ import annotations

import torch

from .. import context as ctx_mod
from .. import cuda_build
from .pairhmm import N_CODE, _shift_down, transition_rows
from .pairhmm_cuda import (_check_indexed, _ftz, _launch, _renorm_mant, _split_coeff,
                           expand_indexed_planes)

# Launches of the CUDA kernel in this process.
LAUNCHES = 0


def _x_ladder(p_c: torch.Tensor):
    """Coefficients of the within-column X scan over a chunk's rows: level
    k applies the product of pXX over the k rows above a row, as a
    (mantissa, exponent) pair split into two exact f32 factors (spans 1-2
    cannot underflow for & 127 quals and ride as one product)."""
    n = p_c.shape[0]
    row_iota = torch.arange(n, device=p_c.device)[:, None]
    one = torch.ones((), dtype=p_c.dtype, device=p_c.device)
    zero_e = torch.zeros((), dtype=torch.int32, device=p_c.device)
    levels = []
    am, ae = _renorm_mant(p_c)
    k = 1
    while k < n:
        q_k, p2_k = _split_coeff(am, ae)
        levels.append((k, q_k * p2_k, None) if k <= 2 else (k, q_k, p2_k))
        above = row_iota >= k
        m2 = am * torch.where(above, torch.roll(am, k, 0), one)
        e2 = ae + torch.where(above, torch.roll(ae, k, 0), zero_e)
        am, d = _renorm_mant(m2)
        ae = e2 + d
        k <<= 1
    return levels


def pairhmm_raw_cols(hap, read, q, iq, dq, gcp, haplen, rslen, *,
                     r_chunk: int | None = None) -> torch.Tensor:
    """Plain-f32 PairHMM forward as a column sweep, in plain PyTorch.

    Dense (length, lane) planes as in ``ops.pairhmm.pairhmm_raw``.  The
    state is the current column's M/X/Y over the read rows: M takes its
    diagonal from the previous column shifted one row, Y comes from the
    previous column, and X is a within-column affine scan over the rows
    (Hillis-Steele, split power-of-two coefficients).  With ``r_chunk`` the
    sweep runs over read chunks of that many rows and the M/X/Y of each
    chunk's last row ride to the next chunk as three (H, P) planes, as in
    ``pairhmm_raw_pallas_cols_relay``; ``None`` is one chunk, the plain
    cols kernel.  Subnormals flush after every product, as in the kernel.
    Returns the (P,) float32 raw forward probability.
    """
    f = torch.float32
    ctx = ctx_mod.pairhmm_context("float32")
    dev = hap.device
    H, P = hap.shape
    R = read.shape[0]
    step = R if r_chunk is None else int(r_chunk)
    if step < 1:
        raise ValueError(f"r_chunk must be positive, got {r_chunk}")
    # pXX == pYY == p_c, the gap continuation probability
    p_mm, p_gapm, p_mx, p_c, p_my, _, dmatch, dmis = transition_rows(
        q, iq, dq, gcp, ctx, f, dev)
    inity = (torch.tensor(ctx.INITIAL_CONSTANT, dtype=f, device=dev) / haplen.to(f))[None, :]
    read_is_n = read == N_CODE
    col_valid = (torch.arange(H, device=dev)[:, None] < haplen[None, :].to(torch.int64)).to(f)
    zrow = torch.zeros((1, P), dtype=f, device=dev)

    # the boundary row above the chunk at every column: the virtual row 0
    bm = torch.zeros((H, P), dtype=f, device=dev)
    bx = torch.zeros((H, P), dtype=f, device=dev)
    by = inity.expand(H, P).clone()
    acc = torch.zeros(P, dtype=f, device=dev)
    for r0 in range(0, R, step):
        sl = slice(r0, min(r0 + step, R))
        n = sl.stop - r0
        rd, rd_n, dm, ds, pmm, pgapm, pmx, pc, pmy = (
            a[sl] for a in (read, read_is_n, dmatch, dmis, p_mm, p_gapm, p_mx, p_c, p_my))
        last_row = ((torch.arange(n, device=dev)[:, None] + 1 + r0)
                    == rslen[None, :].to(torch.int64)).to(f)
        levels = _x_ladder(pc)
        m = torch.zeros((n, P), dtype=f, device=dev)
        x = torch.zeros_like(m)
        y = torch.zeros_like(m)
        # the boundary at the previous column; at the virtual column 0
        # only the virtual row 0 holds a value, Y = inity
        pbm, pbx, pby = zrow, zrow, (inity if r0 == 0 else zrow)
        more = sl.stop < R  # a later chunk reads this one's last row
        out_m, out_x, out_y = (torch.empty_like(bm) if more else None for _ in range(3))
        for j in range(H):
            hb = hap[j][None, :]
            match = (rd == hb) | rd_n | (hb == N_CODE)
            prior = torch.where(match, dm, ds)
            bm_c, bx_c, by_c = bm[j:j + 1], bx[j:j + 1], by[j:j + 1]
            m_dg = _shift_down(m, 1, pbm)
            xy_dg = _shift_down(x + y, 1, pbx + pby)
            m_new = _ftz(prior * (_ftz(pmm * m_dg) + _ftz(pgapm * xy_dg)))
            y_new = _ftz(pmy * m) + _ftz(pc * y)
            # X: the first row's seed folds in pMX*M + pXX*X of the boundary
            seed = _ftz(pmx[:1] * bm_c) + _ftz(pc[:1] * bx_c)
            b = torch.cat([seed, _ftz(pmx[1:] * m_new[:-1])])
            for k, q_k, p2_k in levels:
                b_sh = _shift_down(b, k, zrow)
                t = _ftz(q_k * b_sh)
                if p2_k is not None:
                    t = _ftz(t * p2_k)
                b = t + b
            m, x, y = m_new, b, y_new
            pbm, pbx, pby = bm_c, bx_c, by_c
            if more:
                out_m[j], out_x[j], out_y[j] = m[-1], x[-1], y[-1]
            acc = acc + ((m + x) * last_row).sum(dim=0) * col_valid[j]
        bm, bx, by = out_m, out_x, out_y
    return acc


def pairhmm_cols(hap_u, readq_u, ridx, hidx, haplen, rslen, *,
                 const_quals=None, quals_u=None) -> torch.Tensor:
    """Plain-f32 PairHMM forward of an indexed batch, by haplotype columns.

    The arguments are those of ``ops.pairhmm_cuda.pairhmm_rows``: unique
    hap columns ``hap_u`` (H, nu_h), ``readq_u`` (2, R, nu_r), per-lane
    ``ridx``/``hidx``/``haplen``/``rslen``, and the gap quals as
    ``const_quals`` or ``quals_u`` (3, R, nu_r); any H and R.  Returns the
    (P,) float32 raw forward probability on the inputs' device: CPU
    tensors run :func:`pairhmm_raw_cols` in one read chunk on the expanded
    planes; CUDA tensors launch the kernel (a malformed lane gets NaN).
    """
    global LAUNCHES
    H, nu_h, R, nu_r, P = _check_indexed(hap_u, readq_u, ridx, hidx, haplen, rslen,
                                         const_quals, quals_u)
    if hap_u.device.type == "cpu":
        planes = expand_indexed_planes(hap_u, readq_u, ridx, hidx,
                                       const_quals=const_quals, quals_u=quals_u)
        return pairhmm_raw_cols(*planes, haplen, rslen)

    lib = cuda_build.load()
    out = torch.empty(P, dtype=torch.float32, device=hap_u.device)
    _launch(lib.gkl_pairhmm_cols, hap_u, readq_u, ridx, hidx, haplen, rslen,
            const_quals, quals_u, H, nu_h, R, nu_r, P, out)
    LAUNCHES += 1
    return out
