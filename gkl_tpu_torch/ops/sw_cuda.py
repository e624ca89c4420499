"""Smith-Waterman on the card: the wrappers of the DP and walk kernels.

:func:`sw_forward` is the counterpart of ``gkl_tpu/ops/sw_pallas.py``
(``sw_forward_pallas``, the relay wrapper ``sw_forward_pallas_relay`` and
the alt-slab wrapper ``_sw_mrelay_call``): one launch of
``csrc/sw_forward.cu`` (a warp per lane on an anti-diagonal wavefront, in
the geometry :func:`sw_geometry` picks) covers any N, M <= 32767.
:func:`sw_walk` selects each lane's maximum and walks its CIGAR where the
backtrack lies (``csrc/sw_walk.cu``, one thread per lane), so that only
the runs leave the card; the JAX package walks on the host.  On CUDA
tensors each wrapper launches its kernel or raises; on CPU tensors it runs
the plain twin in ``ops.sw``.
"""

from __future__ import annotations

import torch

from .. import cuda_build, debug, profiling
from . import sw as sw_ops
from .pairhmm_cuda import _check

# LAUNCHES, WALK_LAUNCHES: launches of the DP and walk kernels in this process
__getattr__ = profiling.launch_counts(__name__, LAUNCHES="sw_forward",
                                      WALK_LAUNCHES="sw_walk")

# The kernel's instances: reference rows each of a lane's 32 threads holds
# (even, so that a thread owns whole bt bytes).
ROWS_PER_THREAD = (2, 4, 8)


def sw_geometry(N: int) -> tuple[int, int, int]:
    """The SW kernel's geometry for a reference bucket of ``N`` rows:
    ``(rows_per_thread, pass_rows, passes)``.  A lane's warp covers
    ``pass_rows = 32 * rows_per_thread`` reference rows a pass and runs
    over the reference in at most ``passes`` passes (a lane runs only its
    own reflen): the smallest instance whose one pass holds the bucket,
    else 8 rows a thread, 256 a pass."""
    N = int(N)
    if N < 1:
        raise ValueError(f"reference bucket must be positive, got {N}")
    rows = next((k for k in ROWS_PER_THREAD if 32 * k >= N), ROWS_PER_THREAD[-1])
    return rows, 32 * rows, -(-N // (32 * rows))


def sw_forward(ref, alt, reflen, altlen, match, mismatch, gap_open, gap_extend, *,
               indel_boundary: bool):
    """Score DP with row-pair packed backtrack.

    Args:
      ref: (N, P) uint8, N even; alt: (M, P) uint8, on CUDA M % 8 == 0 (every
        rung of the length ladder is).
      reflen/altlen: (P,) int32 in [1, N] and [1, M].
      match/mismatch/gap_open/gap_extend: int scores.
      indel_boundary: True for the INDEL / LEADING_INDEL strategies.

    Returns ``(bt (P, N//2, M) uint8, lastrow (M, P) int32, lastcol (P, N)
    int32)`` on the inputs' device, the contract of ``ops.sw.sw_forward``
    with ``pack_bt=True``.  The kernel writes them in that layout, each
    lane's in-range region only (bt codes of rows < reflen and columns <
    altlen, ``lastrow[:altlen]``, ``lastcol[:reflen]``) and leaves zeros
    elsewhere; the twin fills every cell.  A lane with a length out of
    range gets nothing.
    """
    device = ref.device
    _check("ref", ref, torch.uint8, 2, device)
    _check("alt", alt, torch.uint8, 2, device)
    _check("reflen", reflen, torch.int32, 1, device)
    _check("altlen", altlen, torch.int32, 1, device)
    N, P = ref.shape
    M = alt.shape[0]
    if alt.shape[1] != P or reflen.shape[0] != P or altlen.shape[0] != P:
        raise ValueError("ref, alt, reflen and altlen must have one lane each")
    if N % 2:
        raise ValueError(f"the reference row count must be even, got {N}")
    if device.type == "cpu":
        return sw_ops.sw_forward(ref, alt, reflen, altlen, match, mismatch, gap_open,
                                 gap_extend, indel_boundary=indel_boundary, pack_bt=True)
    if device.type != "cuda":
        raise ValueError(f"no Smith-Waterman kernel for device {device}")
    if M % 8:
        raise ValueError(f"the alt row count must be a multiple of 8 on CUDA, got {M}")

    lib = cuda_build.load()
    rows_per_thread, _, _ = sw_geometry(N)
    ref_t = ref.t().contiguous()  # (P, N): a warp's fetches are contiguous
    alt_t = alt.t().contiguous()  # (P, M)
    hs = torch.empty((P, M), dtype=torch.int32, device=device)
    fs = torch.empty_like(hs)
    bt = torch.zeros((P, N // 2, M), dtype=torch.uint8, device=device)
    lastrow = torch.zeros((M, P), dtype=torch.int32, device=device)
    lastcol = torch.zeros((P, N), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the launcher launches on the current card
        rc = lib.gkl_sw_forward(
            ref_t.data_ptr(), N, alt_t.data_ptr(), M, reflen.data_ptr(), altlen.data_ptr(), P,
            int(match), int(mismatch), int(gap_open), int(gap_extend), int(bool(indel_boundary)),
            hs.data_ptr(), fs.data_ptr(), bt.data_ptr(), lastrow.data_ptr(), lastcol.data_ptr(),
            rows_per_thread, stream)
    if rc != 0:
        raise RuntimeError(f"sw_forward kernel launch failed: CUDA error {rc}")
    debug.after_launch(device)
    profiling.METRICS.launch("sw_forward")
    return bt, lastrow, lastcol


def sw_walk(bt, lastrow, lastcol, reflen, altlen, strategy):
    """Each lane's maximum, merged CIGAR runs and offset, from
    :func:`sw_forward`'s outputs as they lie, in the layout of
    ``ops.sw.sw_walk``: ``(2 + cap, P)`` int32, row 0 the run counts, row 1
    the offsets, row ``2 + k`` each lane's ``k``-th run (``count << 4 |
    op``), ``cap = ops.sw.walk_capacity(N, M)``.  The kernel leaves the
    rows past a lane's count as they were; the twin zeroes them.
    ``strategy`` is an ``OverhangStrategy`` value (9-12)."""
    device = bt.device
    _check("bt", bt, torch.uint8, 3, device)
    _check("lastrow", lastrow, torch.int32, 2, device)
    _check("lastcol", lastcol, torch.int32, 2, device)
    _check("reflen", reflen, torch.int32, 1, device)
    _check("altlen", altlen, torch.int32, 1, device)
    P, half, M = bt.shape
    N = 2 * half
    if (tuple(lastrow.shape) != (M, P) or tuple(lastcol.shape) != (P, N)
            or reflen.shape[0] != P or altlen.shape[0] != P):
        raise ValueError("bt, lastrow, lastcol, reflen and altlen must be one launch's")
    if int(strategy) not in (sw_ops.SOFTCLIP, sw_ops.INDEL, sw_ops.LEADING_INDEL,
                             sw_ops.IGNORE):
        raise ValueError(f"unknown overhang strategy {strategy}")
    if device.type == "cpu":
        return sw_ops.sw_walk(bt, lastrow, lastcol, reflen, altlen, strategy)
    if device.type != "cuda":
        raise ValueError(f"no Smith-Waterman kernel for device {device}")

    lib = cuda_build.load()
    cap = sw_ops.walk_capacity(N, M)
    out = torch.empty((2 + cap, P), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = lib.gkl_sw_walk(bt.data_ptr(), N, M, lastrow.data_ptr(), lastcol.data_ptr(),
                             reflen.data_ptr(), altlen.data_ptr(), P, int(strategy), cap,
                             out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sw_walk kernel launch failed: CUDA error {rc}")
    debug.after_launch(device)
    profiling.METRICS.launch("sw_walk")
    return out


def walk_mismatches(a, b) -> int:
    """Lanes where two :func:`sw_walk` results differ in their run count,
    offset or any run below the count.  Runs on the results' device."""
    k = torch.arange(a.shape[0] - 2, device=a.device)[:, None]
    live = k < a[0][None, :]
    runs = ((a[2:] != b[2:]) & live).any(dim=0)
    return int(((a[0] != b[0]) | (a[1] != b[1]) | runs).sum())


def in_range_mismatches(a, b, reflen, altlen) -> int:
    """Cells where two ``sw_forward`` results differ inside the region the
    host walk reads: bt codes of rows < reflen and columns < altlen,
    ``lastrow[:altlen]`` and ``lastcol[:reflen]`` of each lane.  Runs on the
    results' device."""
    bt_a, lr_a, lc_a = a
    bt_b, lr_b, lc_b = b
    P, half, M = bt_a.shape
    dev = bt_a.device
    reflen = reflen.to(dev, torch.int64)
    altlen = altlen.to(dev, torch.int64)
    rows = torch.arange(2 * half, device=dev)
    cols = torch.arange(M, device=dev)
    row_ok = rows[None, :] < reflen[:, None]                    # (P, N)
    col_ok = cols[None, :] < altlen[:, None]                    # (P, M)
    bad = 0
    for nib, parity in ((0x0F, 0), (0xF0, 1)):
        diff = (bt_a & nib) != (bt_b & nib)                      # (P, N/2, M)
        ok = row_ok[:, parity::2, None] & col_ok[:, None, :]
        bad += int((diff & ok).sum())
    bad += int(((lr_a != lr_b) & col_ok.t()).sum())
    bad += int(((lc_a != lc_b) & row_ok).sum())
    return bad
