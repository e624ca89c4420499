"""Smith-Waterman score and backtrack DP: the CUDA kernel's wrapper.

Counterpart of ``gkl_tpu/ops/sw_pallas.py`` (``sw_forward_pallas``, the
relay wrapper ``sw_forward_pallas_relay`` and the alt-slab wrapper
``_sw_mrelay_call``): one launch of ``csrc/sw_forward.cu`` (a warp per
lane on an anti-diagonal wavefront, in the geometry :func:`sw_geometry`
picks) covers any N, M <= 32767.  On CUDA tensors :func:`sw_forward`
launches the kernel or raises; on CPU tensors it runs the plain twin
``ops.sw.sw_forward``.
"""

from __future__ import annotations

import torch

from .. import cuda_build, debug, profiling
from . import sw as sw_ops
from .pairhmm_cuda import _check

# LAUNCHES: launches of the CUDA kernel in this process
__getattr__ = profiling.launch_counts(__name__, LAUNCHES="sw_forward")

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
