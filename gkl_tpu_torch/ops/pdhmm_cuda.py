"""PDHMM forward in f32: the CUDA kernel's wrapper and its plain twins on an
indexed batch.

Counterpart of ``gkl_tpu/ops/pdhmm_pallas.py`` (``pdhmm_raw_pallas``,
``pdhmm_raw_pallas_chunked`` and their prep) with the lane expansion of
``api_pdhmm._pdhmm_indexed_jit``.  :func:`pdhmm` takes a deduplicated
batch: on CUDA tensors it launches ``csrc/pdhmm.cu`` (a warp per lane on an
anti-diagonal wavefront, in the geometry :func:`pdhmm_geometry` picks) or
raises; on CPU tensors it runs :func:`pdhmm_indexed_reference`, the lane
gather and ``ops.pdhmm.pdhmm_raw`` in plain PyTorch.
:func:`pdhmm_kernel_order` is the same function in the kernel's order of
operations, which the kernel equals bit for bit.
"""

from __future__ import annotations

import functools

import torch

from .. import context as ctx_mod
from .. import cuda_build
from . import pdhmm as pdhmm_ops
from .pairhmm_cuda import _check, _ftz

# Launches of the CUDA kernel in this process.
LAUNCHES = 0

# The kernel's instances: read rows each of a lane's 32 threads holds.
ROWS_PER_THREAD = (2, 4, 8)


def pdhmm_geometry(R: int) -> tuple[int, int, int]:
    """The PDHMM kernel's geometry for a read bucket of ``R`` rows:
    ``(rows_per_thread, pass_rows, passes)``.  A lane's warp covers
    ``pass_rows = 32 * rows_per_thread`` read rows a pass and runs over the
    read in at most ``passes`` passes (a lane runs only its own rslen): the
    smallest instance whose one pass holds the bucket, else 8 rows a
    thread, 256 a pass."""
    R = int(R)
    if R < 1:
        raise ValueError(f"read bucket must be positive, got {R}")
    rows = next((k for k in ROWS_PER_THREAD if 32 * k >= R), ROWS_PER_THREAD[-1])
    return rows, 32 * rows, -(-R // (32 * rows))


def boundary_bytes_per_lane(R: int, H: int) -> int:
    """Device bytes per lane of the kernel's pass boundary for a read bucket
    of ``R`` rows and a haplotype bucket of ``H`` columns: six f32 planes
    (24 bytes a column) when the bucket needs more than one pass, else
    none."""
    return 24 * int(H) if pdhmm_geometry(R)[2] > 1 else 0


def expand_indexed(hap_u, happd_u, readq_u, ridx, hidx):
    """Per-lane dense planes of an indexed batch: (hap, hap_pd, states,
    read, q, iq, dq, gcp), with the column states computed once per unique
    haplotype."""
    hi = hidx.to(torch.int64)
    ri = ridx.to(torch.int64)
    states_u = torch.from_numpy(
        pdhmm_ops.column_states(happd_u.cpu().numpy())).to(happd_u.device)
    hap, hap_pd, states = (t.index_select(1, hi) for t in (hap_u, happd_u, states_u))
    read, q, iq, dq, gcp = (readq_u[k].index_select(1, ri) for k in range(5))
    return hap, hap_pd, states, read, q, iq, dq, gcp


def pdhmm_indexed_reference(hap_u, happd_u, readq_u, ridx, hidx, haplen, rslen):
    """The kernel's function in plain PyTorch, on the inputs' device."""
    planes = expand_indexed(hap_u, happd_u, readq_u, ridx, hidx)
    return pdhmm_ops.pdhmm_raw(*planes, haplen, rslen, dtype="float32")


def pdhmm_kernel_order(hap_u, happd_u, readq_u, ridx, hidx, haplen, rslen) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order of
    operations: what ``csrc/pdhmm.cu`` equals bit for bit.

    Takes the arguments of :func:`pdhmm` and returns the (P,) float32 raw
    forward probability on the inputs' device.  The sweep runs over the
    anti-diagonals r + j = d of the read rows r and haplotype columns j,
    every row and lane at once: a cell's left operands are its row's values
    from diagonal d-1, the row above at its column those of the row above
    from diagonal d-1, and the diagonal operands the row above's values
    before that.  Each cell does the kernel's products and sums in its
    order, subnormals flush after every product and sum (as ``-ftz=true``
    does), and row rslen's M + I is summed in column order.  Lanes must be
    well formed.  Nothing on the main path calls it: it is the yardstick
    the kernel is held to.
    """
    hap, hap_pd, states, read, q, iq, dq, gcp = expand_indexed(
        hap_u, happd_u, readq_u, ridx, hidx)
    ctx = ctx_mod.pdhmm_context("float32")
    f = torch.float32
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
    t_mi, t_md, t_dd = q2e[im], q2e[dm], q2e[cm]
    t_im = 1.0 - t_dd
    err = q2e[qm]
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds otherwise than err / 3.f
    p_match, p_mis = 1.0 - err, err / torch.full_like(err, 3.0)
    read_i = read.to(torch.int64)
    read_cls = torch.as_tensor(pdhmm_ops._BASE_CLASS).to(dev)[read_i]
    read_is_n = read_i == pdhmm_ops.N_CODE

    rows = torch.arange(R, device=dev)[:, None]  # 0-based: read row r + 1
    hl = haplen.to(torch.int64)[None, :]
    rl = rslen.to(torch.int64)[None, :]
    last = (rl - 1).clamp(0, R - 1)  # each lane's result row
    ic = (torch.tensor(float(ctx.INITIAL_CONDITION), dtype=f, device=dev) / haplen.to(f))[None]
    zero = torch.zeros((1, P), dtype=f, device=dev)
    # the virtual row 0 at every column from -1 on: M, I, D, BM, BI, BD
    top = (zero, zero, ic, zero, zero, zero)
    # each row's six values at its newest column and at the column before
    cur = [torch.zeros((R, P), dtype=f, device=dev) for _ in range(6)]
    prev = [torch.zeros((R, P), dtype=f, device=dev) for _ in range(6)]
    acc = torch.zeros(P, dtype=f, device=dev)

    def above(planes):
        return [torch.cat([b, a[:-1]]) for b, a in zip(top, planes)]

    for d in range(R + H - 1):
        j = d - rows
        jc = j.clamp(0, H - 1)[:, 0]
        y = hap.index_select(0, jc).to(torch.int64)
        pd = hap_pd.index_select(0, jc).to(torch.int64)
        st = states.index_select(0, jc).to(torch.int64)
        live = (j >= 0) & (j < hl) & (rows < rl)
        after, inside = st == pdhmm_ops.ST_AFTER, st == pdhmm_ops.ST_INSIDE
        del_end = (pd & pdhmm_ops.DEL_END) != 0
        pd_match = (((pd & pdhmm_ops.SNP) != 0) & (((pd >> (3 + read_cls)) & 1) != 0)
                    & (read_cls < 4))
        match = (read_i == y) | read_is_n | (y == pdhmm_ops.N_CODE) | pd_match
        prior = torch.where(match, p_match, p_mis)

        ml, il, dl, bml, bil, bdl = cur
        um, ui, _, ubm, ubi, _ = above(cur)   # the row above at column j
        dm_, di, dd, dbm, dbi, dbd = above(prev)  # and at column j - 1
        mx_m, mx_d, mx_i = torch.maximum(bml, ml), torch.maximum(bdl, dl), torch.maximum(bil, il)
        bm = torch.where(after, mx_m, torch.where(inside, bml, ml))
        bd = torch.where(after, mx_d, torch.where(inside, bdl, dl))
        bi = torch.where(after, mx_i, torch.where(inside, bil, il))
        m_dg = torch.where(after, torch.maximum(dm_, dbm), dm_)
        i_dg = torch.where(after, torch.maximum(di, dbi), di)
        d_dg = torch.where(after, torch.maximum(dd, dbd), dd)
        m_le = torch.where(after, mx_m, ml)
        d_le = torch.where(after, mx_d, dl)
        m = _ftz(prior * _ftz(_ftz(_ftz(m_dg * t_mm) + _ftz(i_dg * t_im)) + _ftz(d_dg * t_im)))
        dn = _ftz(_ftz(m_le * t_md) + _ftz(d_le * t_dd))
        m_up = torch.where(del_end, torch.maximum(ubm, um), um)
        i_up = torch.where(del_end, torch.maximum(ubi, ui), ui)
        i = _ftz(_ftz(m_up * t_mi) + _ftz(i_up * t_dd))

        prev = [torch.where(live, c, p) for c, p in zip(cur, prev)]
        cur = [torch.where(live, n, c) for n, c in zip((m, i, dn, bm, bi, bd), cur)]
        col = d - last  # the result row's column on this diagonal
        res = _ftz(m + i).gather(0, last)[0]
        acc = torch.where(((col >= 0) & (col < hl))[0], _ftz(acc + res), acc)
    return acc


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """The exact f32 PDHMM tables the kernel reads: q2e (255,) and the
    match-to-match cache (32640,)."""
    ctx = ctx_mod.pdhmm_context("float32")
    q2e = torch.as_tensor(ctx.qual_to_error_prob, dtype=torch.float32).to(device)
    m2m = torch.as_tensor(ctx.match_to_match, dtype=torch.float32).to(device)
    return q2e, m2m


def pdhmm(hap_u, happd_u, readq_u, ridx, hidx, haplen, rslen) -> torch.Tensor:
    """f32 PDHMM forward of an indexed batch.

    Args:
      hap_u/happd_u: (H, nu_h) uint8 unique haplotype bases and PD bytes.
      readq_u: (5, R, nu_r) uint8 unique [bases, q, iq, dq, gcp].
      ridx/hidx: (P,) int32 lane -> unique read / haplotype column.
      haplen/rslen: (P,) int32 per-lane lengths (1..H, 1..R).

    Returns the (P,) float32 forward probability before the log, scaled by
    2^120, on the inputs' device (a lane with out-of-range indices or
    lengths gets NaN from the kernel).  On CUDA the kernel's instance comes
    from :func:`pdhmm_geometry` of R, and the pass boundary planes
    (:func:`boundary_bytes_per_lane`) are allocated only when R needs more
    than one pass.
    """
    global LAUNCHES
    device = hap_u.device
    _check("hap_u", hap_u, torch.uint8, 2, device)
    _check("happd_u", happd_u, torch.uint8, 2, device)
    _check("readq_u", readq_u, torch.uint8, 3, device)
    for name, t in (("ridx", ridx), ("hidx", hidx), ("haplen", haplen), ("rslen", rslen)):
        _check(name, t, torch.int32, 1, device)
    H, nu_h = hap_u.shape
    _, R, nu_r = readq_u.shape
    P = ridx.shape[0]
    if happd_u.shape != hap_u.shape or readq_u.shape[0] != 5:
        raise ValueError("happd_u must match hap_u, and readq_u must be (5, R, nu_r)")
    if not hidx.shape[0] == haplen.shape[0] == rslen.shape[0] == P:
        raise ValueError("ridx, hidx, haplen and rslen must have one entry per lane")
    if device.type == "cpu":
        return pdhmm_indexed_reference(hap_u, happd_u, readq_u, ridx, hidx, haplen, rslen)
    if device.type != "cuda":
        raise ValueError(f"no PDHMM kernel for device {device}")

    lib = cuda_build.load()
    q2e, m2m = _device_tables(device)
    rows_per_thread, _, _ = pdhmm_geometry(R)
    # six lane-major (P, H) f32 planes, or nothing for a one-pass bucket
    planes = torch.empty(P * boundary_bytes_per_lane(R, H) // 4, dtype=torch.float32,
                         device=device)
    out = torch.empty(P, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.gkl_pdhmm(
        hap_u.data_ptr(), happd_u.data_ptr(), H, nu_h, readq_u.data_ptr(), R, nu_r,
        ridx.data_ptr(), hidx.data_ptr(), haplen.data_ptr(), rslen.data_ptr(), P,
        q2e.data_ptr(), m2m.data_ptr(), planes.data_ptr(), rows_per_thread, out.data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"pdhmm kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
