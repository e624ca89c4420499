"""PairHMM forward by read rows: the CUDA kernel's wrappers and their plain twins.

Counterpart of ``gkl_tpu/ops/pairhmm_pallas.py`` (``_scaled_kernel``,
``_kernel``, their wrappers, ``expand_indexed_planes`` and the transition
prep).  Both wrappers take a deduplicated batch and launch an instance of
``csrc/pairhmm_scaled.cu`` (built for sm_90a; eight threads a lane on an
8-row band wavefront) on CUDA tensors, or raise:

* :func:`pairhmm_scaled`: the per-lane forward probability as
  ``mantissa * 2^exp2`` plus a window flag (see the kernel's source note);
  its twin on CPU tensors is :func:`pairhmm_raw_scaled_reference`;
* :func:`pairhmm_rows`: the plain f32 forward without rescaling; its twin
  on CPU tensors is ``ops.pairhmm.pairhmm_raw(..., dtype="float32")``.

:func:`pairhmm_raw_scaled_kernel_order` computes both instances in the
kernel's own order (band by band, anti-diagonal by anti-diagonal, Y
carried serially): the kernel equals it bit for bit, so the card is held
to it.  The CPU twins above differ from the kernel in the last bits (their
Y is a scan, their result sum a tree).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import context as ctx_mod
from .. import cuda_build, debug, profiling
from .pairhmm import N_CODE, _shift_down, lane_sum, pairhmm_raw, transition_rows

# LAUNCHES and ROWS_LAUNCHES: launches of the scaled instance and of the
# plain (rows) instance of the CUDA kernel in this process
__getattr__ = profiling.launch_counts(__name__, LAUNCHES="pairhmm_scaled",
                                      ROWS_LAUNCHES="pairhmm_rows")

_MAX_SUBNORMAL = 2.0 ** -126 - 2.0 ** -149  # largest f32 subnormal
_M2M_ENTRIES = 128 * 129 // 2  # match-to-match cache entries for quals <= 127
_INITIAL_EXP2 = 120  # the f32 INITIAL_CONSTANT is 2^120 (context.py)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush f32 subnormals to zero, as the kernel (built with -ftz=true)
    and the TPU do after every product.  For the DP's values, which are
    never negative."""
    return torch.nn.functional.threshold(x, _MAX_SUBNORMAL, 0.0)


def _as_f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).view(torch.float32)


def _exponent_of(v: torch.Tensor) -> torch.Tensor:
    return (((v.view(torch.int32) >> 23) & 0xFF) - 127).clamp(-126, 126)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e for integer e in [-126, 127], exact."""
    return _as_f32((e + 127) << 23)


def _pow2m(d: torch.Tensor) -> torch.Tensor:
    """2^d for d <= 0 as the product of two exact factors, flushing below
    2^-126."""
    d1 = d.clamp(min=-126)
    d2 = (d - d1).clamp(-126, 0)
    return _ftz(_pow2(d1) * _pow2(d2))


def _renorm_mant(m: torch.Tensor):
    """``(m2, e)`` with ``m == m2 * 2^e`` and ``m2`` in [1, 2)."""
    e = ((m.view(torch.int32) >> 23) & 0xFF) - 127
    return m * _pow2(-e), e


def _split_coeff(m: torch.Tensor, e: torch.Tensor):
    """Split a scan coefficient ``m * 2^e`` (m in [1, 2), e <= 0) into two
    f32 factors whose product applies it exactly; zero below 2^-252."""
    eh = e >> 1
    el = e - eh

    def pow2c(x):
        return _as_f32((x + 127).clamp(1, 254) << 23)

    q = torch.where(e < -252, torch.zeros_like(m), m * pow2c(eh))
    return q, pow2c(el)


def _fold(acc_m, e_acc, e_state, acc_chunk):
    """Fold a band's result-row sum into the accumulator by value exponents
    (the kernel's integer and power-of-two steps): ``(acc_m, e_acc)``."""
    has_acc = acc_m > 0
    has_chunk = acc_chunk > 0
    chunk_e = e_state + _exponent_of(acc_chunk)
    e_new = torch.where(has_acc & has_chunk, torch.maximum(e_acc, chunk_e),
                        torch.where(has_acc, e_acc, chunk_e))
    d_acc = torch.where(has_acc, e_acc - e_new, torch.zeros_like(e_acc))
    d_chunk = torch.where(has_chunk, e_state - e_new, torch.zeros_like(e_acc))
    acc_m = _ftz(acc_m * _pow2m(d_acc)) + _ftz(acc_chunk * _pow2m(d_chunk))
    ea = torch.where(acc_m > 0, _exponent_of(acc_m), torch.zeros_like(e_acc))
    acc_m = acc_m * _pow2(-ea)
    return acc_m, torch.where(acc_m > 0, e_new + ea, e_state)


def pairhmm_raw_scaled_reference(hap, read, q, iq, dq, gcp, haplen, rslen):
    """Scaled-f32 PairHMM forward in plain PyTorch, on the inputs' device.

    Dense (length, lane) planes as in ``ops.pairhmm.pairhmm_raw``; ``R`` a
    multiple of 8.  Returns ``(mantissa (P,) f32, exp2 (P,) i32, flag (P,)
    i32)``: a row sweep with the Y recurrence as a Hillis-Steele scan over
    split power-of-two coefficients, per-lane renormalisation to ~2^90
    every 8 rows, an accumulator with its own exponent, and the liveness
    flag sampled at row 3 and row 7 of each 8-row chunk.  Subnormals are
    flushed after every product, as in the kernel.
    """
    f = torch.float32
    ctx = ctx_mod.pairhmm_context("float32")
    dev = hap.device
    H, P = hap.shape
    R = read.shape[0]
    if R % 8:
        raise ValueError(f"read rows must be a multiple of 8, got {R}")
    # pXX == pYY == p_c, the gap continuation probability
    p_mm, p_gapm, p_mx, p_c, p_my, _, dmatch, dmis = transition_rows(
        q, iq, dq, gcp, ctx, f, dev)
    inity = (torch.tensor(ctx.INITIAL_CONSTANT, dtype=f, device=dev) / haplen.to(f))[None, :]
    hap_is_n = hap == N_CODE
    row_iota = torch.arange(H, device=dev)[:, None]
    valid = (row_iota + 1) <= haplen[None, :].to(torch.int64)
    col_valid = valid.to(f)
    rslen = rslen.to(torch.int32)
    zero_row = torch.zeros((1, P), dtype=f, device=dev)

    m = torch.zeros((H, P), dtype=f, device=dev)
    x = torch.zeros((H, P), dtype=f, device=dev)
    y = inity.expand(H, P).clone()
    live = valid.clone()
    flag = torch.zeros(P, dtype=torch.int32, device=dev)
    acc_m = torch.zeros(P, dtype=f, device=dev)
    e_acc = torch.zeros(P, dtype=torch.int32, device=dev)
    e_state = torch.zeros(P, dtype=torch.int32, device=dev)

    # Y-scan span coefficients pYY^(2^level) for every row at once: spans
    # 1-2 as plain products (pYY >= 2^-43 for & 127 quals, so pYY^2 cannot
    # underflow), wider spans as (mantissa, exponent) pairs applied as two
    # exact factors
    spans = []
    alpha = p_c
    am = ae = None
    k_span = 1
    while k_span < H:
        if k_span == 1:
            spans.append((alpha, None))
        elif k_span == 2:
            alpha = _ftz(alpha * alpha)
            spans.append((alpha, None))
        else:
            if am is None:
                am, ae = _renorm_mant(alpha)
            am, d = _renorm_mant(am * am)
            ae = ae * 2 + d
            spans.append(_split_coeff(am, ae))
        k_span <<= 1

    for c in range(R // 8):
        acc_chunk = torch.zeros(P, dtype=f, device=dev)
        live_mid = None
        for k in range(8):
            r = 8 * c + k
            rc = read[r]
            match = (hap == rc[None, :]) | hap_is_n | (rc == N_CODE)[None, :]
            prior = torch.where(match, dmatch[r][None, :], dmis[r][None, :])
            t_comb = _ftz(p_mm[r] * m) + _ftz(p_gapm[r] * (x + y))
            first = _ftz(p_gapm[r] * inity[0])[None, :] if r == 0 else zero_row
            m_new = _ftz(prior * _shift_down(t_comb, 1, first))
            x_new = _ftz(p_mx[r] * m) + _ftz(p_c[r] * x)
            b = _ftz(p_my[r] * _shift_down(m_new, 1, zero_row))
            for level, (q_a, p2_a) in enumerate(spans):
                b_sh = _shift_down(b, 1 << level, zero_row)
                if p2_a is None:
                    b = _ftz(q_a[r] * b_sh) + b
                else:
                    b = _ftz(_ftz(q_a[r] * b_sh) * p2_a[r]) + b
            m, x, y = m_new, x_new, b
            row_sum = lane_sum((m + x) * col_valid)
            acc_chunk = acc_chunk + torch.where(rslen == r + 1, row_sum, torch.zeros_like(row_sum))
            if k == 3:
                live_mid = ((m + x + y) * col_valid) > 0
        acc_m, e_acc = _fold(acc_m, e_acc, e_state, acc_chunk)
        # renormalise; columns past haplen are zeroed first
        m_v, x_v, y_v = m * col_valid, x * col_valid, y * col_valid
        live_now = (m_v + x_v + y_v) > 0
        lost = (live & ~(live_mid & live_now)).any(dim=0)
        gate = rslen > 8 * c
        flag = flag | (gate & lost).to(torch.int32)
        live = live_now
        mx = torch.maximum(m_v, torch.maximum(x_v, y_v)).amax(dim=0)
        e = _exponent_of(mx)
        sf = _pow2(-e)[None, :]
        up = torch.tensor(2.0 ** 90, dtype=f, device=dev)
        m = _ftz(_ftz(m_v * sf) * up)
        x = _ftz(_ftz(x_v * sf) * up)
        y = _ftz(_ftz(y_v * sf) * up)
        e_state = e_state + e - 90
    return acc_m, e_acc, flag


def pairhmm_raw_scaled_kernel_order(hap, read, q, iq, dq, gcp, haplen, rslen, *,
                                    scaled: bool = True):
    """PairHMM forward in the CUDA kernel's order, in plain PyTorch: what
    ``csrc/pairhmm_scaled.cu`` computes, bit for bit.

    Dense (length, lane) planes as in ``ops.pairhmm.pairhmm_raw``.  The
    rows go in bands of 8, and a band is swept over its anti-diagonals, its
    eight rows of every lane at once: at step s row k computes column
    s - k from its row above (row k-1's values of the step before; for row
    0 the band's boundary row, the last row of the band before, scaled on
    read), with the kernel's products and sums in its order, Y carried
    serially along the columns, and the result row summed in column order.
    Subnormals flush after every product (the kernel's -ftz=true).

    ``scaled=True`` (``R`` a multiple of 8): the scaled instance, with the
    renormalisation at every band's end, the accumulator fold and the
    flag's bits (bit 0 alive at the last renormalisation, bit 1 the row-3
    sample, lost at row 7); returns ``(mantissa (P,) f32, exp2 (P,) i32,
    flag (P,) i32)``.  ``scaled=False``: the plain instance, rows up to
    rslen-1 only; returns the (P,) f32 raw forward.  Nothing on the main
    path calls it.
    """
    f = torch.float32
    ctx = ctx_mod.pairhmm_context("float32")
    dev = hap.device
    H, P = hap.shape
    R = read.shape[0]
    if scaled and R % 8:
        raise ValueError(f"read rows must be a multiple of 8, got {R}")
    # pXX == pYY == p_c, the gap continuation probability
    p_mm, p_gapm, p_mx, p_c, p_my, _, dmatch, dmis = transition_rows(
        q, iq, dq, gcp, ctx, f, dev)
    inity = torch.tensor(ctx.INITIAL_CONSTANT, dtype=f, device=dev) / haplen.to(f)
    hl = haplen.to(torch.int64)[None, :]
    rl = rslen.to(torch.int64)
    nbands = (rl + 7) // 8
    # the row planes in whole bands (rows past R are never visited)
    pad = -R % 8
    rows = [torch.cat([a, a.new_zeros((pad, P))]) if pad else a
            for a in (read, p_mm, p_gapm, p_mx, p_c, p_my, dmatch, dmis)]
    # hap bytes by anti-diagonal: row k of step s reads column s - k, a
    # reversed window of the padded haplotype
    hap_rev = torch.cat([hap.new_zeros((7, P)), hap, hap.new_zeros((8, P))]).flip(0)
    width = hap_rev.shape[0]
    band_row = torch.arange(8, device=dev)
    zero = torch.zeros((8, P), dtype=f, device=dev)
    zrow = torch.zeros(P, dtype=f, device=dev)
    up = torch.tensor(2.0 ** 90, dtype=f, device=dev)

    # the boundary row above the band as stored (unscaled)
    bm = bx = by = None
    acc_m = torch.zeros(P, dtype=f, device=dev)
    e_acc = torch.zeros(P, dtype=torch.int32, device=dev)
    e_state = torch.zeros_like(e_acc)
    flag = torch.zeros_like(e_acc)
    sf = torch.ones(P, dtype=f, device=dev)
    for c in range(int(nbands.max()) if P else 0):
        active = c < nbands
        r = 8 * c + band_row
        on = active[None, :] & (r[:, None] < (8 * nbands if scaled else rl)[None, :])
        rd, pmm, pgapm, pmx, pc, pmy, dm, ds = (a[8 * c:8 * c + 8] for a in rows)
        rd_n = rd == N_CODE
        last = on & (r[:, None] + 1 == rl[None, :])
        # t carries pMM*M + pGAPM*(X + Y) of the row above at column j-1
        t = zero.clone()
        if c == 0:
            t[0] = _ftz(pgapm[0] * inity)
            b_m = b_x = torch.zeros((H, P), dtype=f, device=dev)  # the virtual row 0
            b_y = inity.expand(H, P)
            live0 = torch.ones((H, P), dtype=torch.bool, device=dev)
        else:
            live0 = (bm != 0) | (bx != 0) | (by != 0)
            b_m, b_x, b_y = ((_ftz(_ftz(v * sf) * up) for v in (bm, bx, by)) if scaled
                             else (bm, bx, by))
        m = x = y = zero  # each row at its last column
        row_sum, mx = zero, zrow
        lost = torch.zeros(P, dtype=torch.bool, device=dev)
        live3 = torch.zeros((H, P), dtype=torch.bool, device=dev)
        bm, bx, by = (torch.zeros((H, P), dtype=f, device=dev) for _ in range(3))
        for s in range(H + 7):
            j = s - band_row
            valid = on & (j >= 0)[:, None] & (j[:, None] < hl)
            hb = hap_rev[width - s - 8:width - s]
            top = (b_m[s], b_x[s], b_y[s]) if s < H else (zrow, zrow, zrow)
            up_m, up_x, up_y = (torch.cat([v0[None], v[:-1]]) for v0, v in zip(top, (m, x, y)))
            prior = torch.where((hb == rd) | (hb == N_CODE) | rd_n, dm, ds)
            mn = _ftz(prior * t)
            xn = _ftz(pmx * up_m) + _ftz(pc * up_x)
            yn = _ftz(pc * y) + _ftz(pmy * m)
            tn = _ftz(pmm * up_m) + _ftz(pgapm * (up_x + up_y))
            m, x, y, t = (torch.where(valid, a, b) for a, b in ((mn, m), (xn, x), (yn, y), (tn, t)))
            row_sum = row_sum + torch.where(valid & last, mn + xn, 0.0)
            j7 = s - 7  # row 7's column: the flag's test, the maximum, the boundary row
            if scaled:
                alive = (mn != 0) | (xn != 0) | (yn != 0)
                if 0 <= s - 3 < H:
                    live3[s - 3] = valid[3] & alive[3]
                if 0 <= j7:
                    v7 = valid[7]
                    lost = lost | (v7 & live0[j7] & ~(live3[j7] & alive[7]))
                    mx = torch.where(v7, torch.maximum(mx, torch.maximum(
                        mn[7], torch.maximum(xn[7], yn[7]))), mx)
            if 0 <= j7 < H:
                for plane, v in ((bm, mn), (bx, xn), (by, yn)):
                    plane[j7] = torch.where(valid[7], v[7], 0.0)
        acc_chunk = row_sum.sum(dim=0)  # one row at most holds rslen-1
        if not scaled:
            acc_m = torch.where(active, acc_m + acc_chunk, acc_m)
            continue
        new_acc, new_e_acc = _fold(acc_m, e_acc, e_state, acc_chunk)
        e = _exponent_of(mx)
        acc_m = torch.where(active, new_acc, acc_m)
        e_acc = torch.where(active, new_e_acc, e_acc)
        flag = torch.where(active & lost, 1, flag)
        sf = torch.where(active, _pow2(-e), sf)
        e_state = torch.where(active, e_state + e - 90, e_state)
    return (acc_m, e_acc, flag) if scaled else acc_m


def band_steps(haplen, rslen, *, scaled: bool = True) -> tuple[int, int]:
    """The row kernel's schedule on a batch, in lane-steps: ``(run,
    needed)``.  A lane needs haplen + 7 steps for each of its
    ceil(rslen/8) bands (the plain instance, on a lane's last band: haplen
    + the rows of that band below rslen, less one); a warp holds four
    lanes and runs, for each band, the most steps any of its lanes still
    in that band needs.  ``run / needed`` is what the warp-uniform loops
    cost."""
    hl = np.asarray(haplen, np.int64)
    rl = np.asarray(rslen, np.int64)
    fill = -len(hl) % 4  # the last warp's lanes past P need nothing
    hl, rl = np.pad(hl, (0, fill)), np.pad(rl, (0, fill))
    nbands = (rl + 7) // 8
    run = needed = 0
    for c in range(int(nbands.max(initial=0))):
        last_k = 7 if scaled else np.minimum(7, rl - 1 - 8 * c)
        need = np.where(c < nbands, hl + last_k, 0)
        needed += int(need.sum())
        run += 4 * int(need.reshape(-1, 4).max(axis=1).sum())
    return run, needed


def expand_indexed_planes(hap_u, readq_u, ridx, hidx, *, const_quals=None,
                          quals_u=None):
    """Per-lane dense planes of an indexed batch: gather each lane's read
    and hap columns, and fill constant iq/dq/gcp planes when the batch
    carries the GATK default-GOP constants.  Returns (hap, read, q, iq,
    dq, gcp)."""
    ri = ridx.to(torch.int64)
    read = readq_u[0].index_select(1, ri)
    q = readq_u[1].index_select(1, ri)
    hap = hap_u.index_select(1, hidx.to(torch.int64))
    if const_quals is not None:
        iq, dq, gcp = (torch.full_like(read, int(v)) for v in const_quals)
    else:
        iq, dq, gcp = (quals_u[i].index_select(1, ri) for i in range(3))
    return hap, read, q, iq, dq, gcp


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """The exact f32 context tables the kernel reads: ph2pr (128,) and the
    match-to-match cache for quals <= 127 (8256,)."""
    ctx = ctx_mod.pairhmm_context("float32")
    ph2pr = torch.as_tensor(ctx.ph2pr, dtype=torch.float32).to(device)
    m2m = torch.as_tensor(ctx.match_to_match[:_M2M_ENTRIES], dtype=torch.float32).to(device)
    return ph2pr, m2m


def _check(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got {t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_indexed(hap_u, readq_u, ridx, hidx, haplen, rslen, const_quals, quals_u):
    """Validate an indexed batch's tensors; returns (H, nu_h, R, nu_r, P)."""
    device = hap_u.device
    _check("hap_u", hap_u, torch.uint8, 2, device)
    _check("readq_u", readq_u, torch.uint8, 3, device)
    for name, t in (("ridx", ridx), ("hidx", hidx), ("haplen", haplen), ("rslen", rslen)):
        _check(name, t, torch.int32, 1, device)
    H, nu_h = hap_u.shape
    _, R, nu_r = readq_u.shape
    P = ridx.shape[0]
    if readq_u.shape[0] != 2:
        raise ValueError(f"readq_u must be (2, R, nu_r), got {tuple(readq_u.shape)}")
    if not hidx.shape[0] == haplen.shape[0] == rslen.shape[0] == P:
        raise ValueError("ridx, hidx, haplen and rslen must have one entry per lane")
    if (const_quals is None) == (quals_u is None):
        raise ValueError("give exactly one of const_quals and quals_u")
    if quals_u is not None:
        _check("quals_u", quals_u, torch.uint8, 3, device)
        if tuple(quals_u.shape) != (3, R, nu_r):
            raise ValueError(f"quals_u must be (3, {R}, {nu_r}), got {tuple(quals_u.shape)}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no PairHMM kernel for device {device}")
    return H, nu_h, R, nu_r, P


def _launch(fn, hap_u, readq_u, ridx, hidx, haplen, rslen, const_quals, quals_u,
            H, nu_h, R, nu_r, P, out, *extra):
    """Launch one of the PairHMM kernels (``fn``: an instance of the row
    kernel, or the column kernel) on an indexed batch's CUDA tensors into
    ``out``, with three fresh (H, P) f32 planes for the boundary row's
    M/X/Y that a band (row kernel) or a pass (column kernel) hands to the
    next.  ``extra`` (ints) go between the planes and ``out``."""
    device = hap_u.device
    ph2pr, m2m = _device_tables(device)
    Ms = torch.empty((H, P), dtype=torch.float32, device=device)
    Xs = torch.empty_like(Ms)
    Ys = torch.empty_like(Ms)
    ciq, cdq, cgcp = const_quals if const_quals is not None else (0, 0, 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the launcher launches on the current card
        rc = fn(
            hap_u.data_ptr(), H, nu_h,
            readq_u.data_ptr(), R, nu_r,
            quals_u.data_ptr() if quals_u is not None else None,
            int(ciq), int(cdq), int(cgcp),
            ridx.data_ptr(), hidx.data_ptr(), haplen.data_ptr(), rslen.data_ptr(), P,
            ph2pr.data_ptr(), m2m.data_ptr(),
            Ms.data_ptr(), Xs.data_ptr(), Ys.data_ptr(),
            *extra,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {rc}")
    debug.after_launch(device)
    return out


def pairhmm_scaled(hap_u, readq_u, ridx, hidx, haplen, rslen, *,
                   const_quals=None, quals_u=None) -> torch.Tensor:
    """Scaled-f32 PairHMM forward of an indexed batch.

    Args:
      hap_u:   (H, nu_h) uint8 unique haplotype columns.
      readq_u: (2, R, nu_r) uint8 unique [read bases, base quals]; R % 8 == 0.
      ridx/hidx: (P,) int32 lane -> unique read / hap column.
      haplen/rslen: (P,) int32 per-lane lengths (1..H, 1..R).
      const_quals: (iq, dq, gcp) constants, or None with
      quals_u: (3, R, nu_r) uint8 unique [iq, dq, gcp] planes.

    Returns a (3, P) int32 tensor on the inputs' device: row 0 holds the
    f32 mantissa's bits (``out[0].view(torch.float32)``), row 1 the exp2,
    row 2 the flag.  CPU tensors run the plain twin; CUDA tensors launch
    the kernel (a lane with out-of-range indices or lengths gets a NaN
    mantissa and flag -1).
    """
    H, nu_h, R, nu_r, P = _check_indexed(hap_u, readq_u, ridx, hidx, haplen, rslen,
                                         const_quals, quals_u)
    if R % 8:
        raise ValueError(f"readq_u must be (2, R, nu_r) with R % 8 == 0, got {tuple(readq_u.shape)}")
    device = hap_u.device
    if device.type == "cpu":
        planes = expand_indexed_planes(hap_u, readq_u, ridx, hidx,
                                       const_quals=const_quals, quals_u=quals_u)
        mant, ex, flag = pairhmm_raw_scaled_reference(*planes, haplen, rslen)
        return torch.stack([mant.view(torch.int32), ex, flag])

    lib = cuda_build.load()
    out = torch.empty((3, P), dtype=torch.int32, device=device)
    _launch(lib.gkl_pairhmm_scaled, hap_u, readq_u, ridx, hidx, haplen, rslen,
            const_quals, quals_u, H, nu_h, R, nu_r, P, out)
    profiling.METRICS.launch("pairhmm_scaled")
    return out


def pairhmm_rows(hap_u, readq_u, ridx, hidx, haplen, rslen, *,
                 const_quals=None, quals_u=None) -> torch.Tensor:
    """Plain-f32 PairHMM forward of an indexed batch, without rescaling.

    The arguments are those of :func:`pairhmm_scaled`, with any read
    bucket R; a dense batch passes ``ridx = hidx = arange(P)`` and its
    iq/dq/gcp planes as ``quals_u``.  Returns the (P,) float32 raw forward
    probability (scaled by the initial constant 2^120, as
    ``ops.pairhmm.pairhmm_raw``) on the inputs' device: CPU tensors run
    that twin on the expanded planes; CUDA tensors launch the kernel's
    plain instance (a malformed lane gets NaN).
    """
    H, nu_h, R, nu_r, P = _check_indexed(hap_u, readq_u, ridx, hidx, haplen, rslen,
                                         const_quals, quals_u)
    if hap_u.device.type == "cpu":
        planes = expand_indexed_planes(hap_u, readq_u, ridx, hidx,
                                       const_quals=const_quals, quals_u=quals_u)
        return pairhmm_raw(*planes, haplen, rslen, dtype="float32")

    lib = cuda_build.load()
    out = torch.empty(P, dtype=torch.float32, device=hap_u.device)
    _launch(lib.gkl_pairhmm_rows, hap_u, readq_u, ridx, hidx, haplen, rslen,
            const_quals, quals_u, H, nu_h, R, nu_r, P, out)
    profiling.METRICS.launch("pairhmm_rows")
    return out


def unpack(out: torch.Tensor):
    """(mantissa f32, exp2 i32, flag i32) views of a :func:`pairhmm_scaled` result."""
    return out[0].view(torch.float32), out[1], out[2]


def log10_of(mant, exp2) -> np.ndarray:
    """float64 log10 likelihood of scaled results ``mant * 2^exp2``, with the
    f32 initial constant 2^120 the kernel and its twin start from removed
    exactly.  A zero mantissa gives -inf."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return (np.log10(np.asarray(mant, np.float64))
                + (np.asarray(exp2, np.float64) - _INITIAL_EXP2) * np.log10(2.0))
