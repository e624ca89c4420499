"""PairHMM forward by haplotype columns: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``gkl_tpu/ops/pairhmm_pallas_cols.py`` (``_kernel``,
``_kernel_relay`` and their wrappers ``pairhmm_raw_pallas_cols`` and
``pairhmm_raw_pallas_cols_relay``), the engine of haplotype buckets past
2048.  :func:`pairhmm_cols` takes the indexed batch of
``ops.pairhmm_cuda.pairhmm_rows``: on CUDA tensors it launches
``csrc/pairhmm_cols.cu`` (built for sm_90a; a warp per lane, in the
geometry :func:`cols_geometry` picks) or raises; on CPU tensors it runs
:func:`pairhmm_raw_cols`, the same function in plain PyTorch, on the
expanded planes.  Both return the plain f32 forward probability per lane,
scaled by the initial constant 2^120, as ``ops.pairhmm.pairhmm_raw`` does.
"""

from __future__ import annotations

import torch

from .. import context as ctx_mod
from .. import cuda_build, profiling
from .pairhmm import N_CODE, _shift_down, transition_rows
from .pairhmm_cuda import _check_indexed, _ftz, _launch, expand_indexed_planes

# LAUNCHES: launches of the CUDA kernel in this process
__getattr__ = profiling.launch_counts(__name__, LAUNCHES="pairhmm_cols")

# The kernel's instances: read rows each of a lane's 32 threads holds.
ROWS_PER_THREAD = (4, 8, 16)


def cols_geometry(R: int) -> tuple[int, int, int]:
    """The column kernel's geometry for a read bucket of ``R`` rows:
    ``(rows_per_thread, pass_rows, passes)``.  A lane's warp covers
    ``pass_rows = 32 * rows_per_thread`` read rows a pass and runs over the
    read in ``passes`` passes: the smallest instance whose one pass holds
    the bucket (reads of up to 128 rows take 4 rows a thread), else 16 rows
    a thread, 512 a pass."""
    R = int(R)
    if R < 1:
        raise ValueError(f"read bucket must be positive, got {R}")
    rows = next((k for k in ROWS_PER_THREAD if 32 * k >= R), ROWS_PER_THREAD[-1])
    return rows, 32 * rows, -(-R // (32 * rows))


def pairhmm_raw_cols(hap, read, q, iq, dq, gcp, haplen, rslen, *,
                     r_chunk: int | None = None) -> torch.Tensor:
    """Plain-f32 PairHMM forward in the kernel's order, in plain PyTorch.

    Dense (length, lane) planes as in ``ops.pairhmm.pairhmm_raw``.  The
    sweep runs over the anti-diagonals r + j = d of the read rows r and hap
    columns j: a cell's M takes its operands from diagonal d-2 (the cell
    above-left), X from d-1 (the cell above, so X is carried down the rows
    one product and one sum a row, as in the kernel) and Y from d-1 (the
    cell to the left).  Every cell does the kernel's products and sums in
    its order, and the result of row rslen-1 is summed in column order.
    With ``r_chunk`` the sweep runs over read chunks of that many rows and
    the M/X/Y of each chunk's last row ride to the next chunk as three (H,
    P) planes, as the kernel's passes do and as in
    ``pairhmm_raw_pallas_cols_relay``; ``None`` is one chunk.  The chunks do
    not change the result.  Subnormals flush after every product, as in the
    kernel.  Returns the (P,) float32 raw forward probability.
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
    hl = haplen.to(torch.int64)
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
        rows = torch.arange(n, device=dev)[:, None]
        # the chunk row of each lane's result row, where it lies in the chunk
        last = rslen.to(torch.int64)[None, :] - 1 - r0
        owns = (last >= 0) & (last < n)
        last_row = last.clamp(0, n - 1)
        # hap bytes by anti-diagonal: row r of diagonal d reads column d - r,
        # a reversed window of the padded haplotype (pads never match)
        hap_rev = torch.cat([torch.zeros((n - 1, P), dtype=hap.dtype, device=dev), hap,
                             torch.zeros((n, P), dtype=hap.dtype, device=dev)]).flip(0)
        width = hap_rev.shape[0]
        # M/X/Y by chunk row on the previous two diagonals; cells left of
        # column 0 stay zero (the virtual column 0)
        m1 = x1 = y1 = m2 = x2 = y2 = torch.zeros((n, P), dtype=f, device=dev)
        # the boundary at column d-1 (at the virtual column 0 only the
        # virtual row 0 holds a value, Y = inity)
        b_prev = (zrow, zrow, inity if r0 == 0 else zrow)
        more = sl.stop < R  # a later chunk reads this one's last row
        out_m, out_x, out_y = (torch.zeros_like(bm) if more else None for _ in range(3))
        for d in range(n + H - 1):
            hb = hap_rev[width - d - n:width - d]
            match = (rd == hb) | rd_n | (hb == N_CODE)
            prior = torch.where(match, dm, ds)
            b_cur = ((bm[d:d + 1], bx[d:d + 1], by[d:d + 1]) if d < H else (zrow, zrow, zrow))
            m_dg = _shift_down(m2, 1, b_prev[0])
            xy_dg = _shift_down(x2 + y2, 1, b_prev[1] + b_prev[2])
            m = _ftz(prior * (_ftz(pmm * m_dg) + _ftz(pgapm * xy_dg)))
            x = _ftz(pmx * _shift_down(m1, 1, b_cur[0])) + _ftz(pc * _shift_down(x1, 1, b_cur[1]))
            y = _ftz(pmy * m1) + _ftz(pc * y1)
            j = d - rows
            in_grid = (j >= 0) & (j < H)
            m, x, y = (torch.where(in_grid, a, 0.0) for a in (m, x, y))
            col = d - last  # the result row's column on this diagonal
            res = (m + x).gather(0, last_row)[0]
            acc = acc + torch.where((owns & (col >= 0) & (col < hl[None, :]))[0], res, 0.0)
            if more and 0 <= d - (n - 1) < H:
                out_m[d - n + 1], out_x[d - n + 1], out_y[d - n + 1] = m[-1], x[-1], y[-1]
            m2, x2, y2, m1, x1, y1 = m1, x1, y1, m, x, y
            b_prev = b_cur
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
    planes; CUDA tensors launch the kernel's instance for the read bucket
    R (:func:`cols_geometry`; a malformed lane gets NaN).
    """
    H, nu_h, R, nu_r, P = _check_indexed(hap_u, readq_u, ridx, hidx, haplen, rslen,
                                         const_quals, quals_u)
    if hap_u.device.type == "cpu":
        planes = expand_indexed_planes(hap_u, readq_u, ridx, hidx,
                                       const_quals=const_quals, quals_u=quals_u)
        return pairhmm_raw_cols(*planes, haplen, rslen)

    lib = cuda_build.load()
    rows_per_thread, _, _ = cols_geometry(R)
    out = torch.empty(P, dtype=torch.float32, device=hap_u.device)
    _launch(lib.gkl_pairhmm_cols, hap_u, readq_u, ridx, hidx, haplen, rslen,
            const_quals, quals_u, H, nu_h, R, nu_r, P, out, rows_per_thread)
    profiling.METRICS.launch("pairhmm_cols")
    return out
