"""Packed Smith-Waterman backtracks for the walk's tests, and the native
runtime's walk of them (numpy and the port only: no JAX, so the GPU tests
can use them where JAX is absent).

A case is ``(bt (P, N/2, M) u8, lastrow (M, P) i32, lastcol (P, N) i32,
reflen (P,) i32, altlen (P,) i32)`` as ``ops.sw_cuda.sw_forward`` returns
them: random codes (every nibble value, extension bits included) and
scores, so that the walk's paths are not only those a DP would leave."""

import re

import numpy as np

from gkl_tpu_torch import api_sw

INT32_MIN = np.iinfo(np.int32).min


def _case(rng, N, M, P, reflen, altlen, scores=(-500, 500), bt=None):
    if bt is None:
        bt = rng.integers(0, 256, (P, N // 2, M)).astype(np.uint8)
    lo, hi = scores
    lastrow = rng.integers(lo, hi, (M, P)).astype(np.int32)
    lastcol = rng.integers(lo, hi, (P, N)).astype(np.int32)
    return (bt, lastrow, lastcol, np.asarray(reflen, np.int32), np.asarray(altlen, np.int32))


def walk_case(name: str, seed: int = 0):
    """The case ``name`` of :data:`WALK_CASES`."""
    rng = np.random.default_rng(seed)
    if name == "random":
        N, M, P = 48, 40, 24
        return _case(rng, N, M, P, rng.integers(1, N + 1, P), rng.integers(1, M + 1, P))
    if name == "ties":
        # scores of three values: most lastrow and lastcol cells tie
        N, M, P = 40, 32, 24
        return _case(rng, N, M, P, rng.integers(1, N + 1, P), rng.integers(1, M + 1, P),
                     scores=(0, 3))
    if name == "n1":
        N, M, P = 8, 40, 16
        return _case(rng, N, M, P, np.ones(P), rng.integers(1, M + 1, P), scores=(0, 4))
    if name == "m1":
        N, M, P = 40, 8, 16
        return _case(rng, N, M, P, rng.integers(1, N + 1, P), np.ones(P), scores=(0, 4))
    if name == "padded":
        # short lanes in a large bucket, lanes of one base as the lane
        # padding packs them, and lanes whose lengths are out of range
        N, M, P = 96, 64, 16
        reflen = np.array([5, 17, 1, 1, 0, N + 1, 30, 2, 9, 12, 1, 40, 3, 7, 60, 1])
        altlen = np.array([9, 3, 1, 1, 4, 5, 0, M + 1, 12, 2, 1, 25, 8, 7, 33, 1])
        return _case(rng, N, M, P, reflen, altlen)
    if name == "parity":
        # the last row of a lane in the low nibble (odd n) and the high (even n)
        N, M, P = 32, 24, 16
        reflen = np.array([N - 1, N, 1, 2, 15, 16, 31, 32] * 2)
        return _case(rng, N, M, P, reflen, rng.integers(1, M + 1, P))
    if name == "long_runs":
        # runs past 255: a whole-lane match, and insertion and deletion
        # extensions as long as the lane
        N, M, P = 320, 320, 8
        bt = np.zeros((P, N // 2, M), np.uint8)
        bt[1] = 0x55    # INSERT | INSERT_EXT in both nibbles
        bt[2] = 0xAA    # DELETE | DELETE_EXT
        bt[3, :, :] = 0x55
        bt[3, :, :40] = 0x00
        bt[4:] = rng.integers(0, 256, (P - 4, N // 2, M)).astype(np.uint8)
        bt[4:] &= 0xCC  # every code a match with extension bits: long diagonals
        reflen = np.array([300, 300, 300, 310, 320, 299, 320, 301])
        altlen = np.array([300, 290, 300, 300, 320, 318, 257, 256])
        case = _case(rng, N, M, P, reflen, altlen, bt=bt)
        # the maximum at (n, m) in every lane, so every strategy starts there
        for c in range(P):
            case[1][altlen[c] - 1, c] = case[2][c, reflen[c] - 1] = 10**6
        return case
    if name == "no_step":
        # every score INT32_MIN: with m > n no cell beats the start, the
        # maximum stays at (0, 0) and the walk takes no step
        N, M, P = 16, 24, 8
        bt, lastrow, lastcol, reflen, altlen = _case(
            rng, N, M, P, np.array([3, 5, 1, 16, 2, 7, 10, 15]),
            np.array([4, 24, 2, 20, 3, 9, 11, 16]))
        lastrow[:] = INT32_MIN
        lastcol[:] = INT32_MIN
        return bt, lastrow, lastcol, reflen, altlen
    raise KeyError(name)


WALK_CASES = ("random", "ties", "n1", "m1", "padded", "parity", "long_runs", "no_step")


def valid_lanes(case) -> np.ndarray:
    bt, _, _, reflen, altlen = case
    N, M = 2 * bt.shape[1], bt.shape[2]
    return (reflen >= 1) & (reflen <= N) & (altlen >= 1) & (altlen <= M)


def native_walk(case, strategy) -> list:
    """``(cigar, offset)`` of each lane by ``sw_postprocess_packed``, the
    native runtime's walk; None for a lane with a length out of range."""
    bt, lastrow, lastcol, reflen, altlen = case
    sw = api_sw.SmithWaterman(device="cpu")
    lastrow_t = np.ascontiguousarray(lastrow.T)
    out = []
    for c, ok in enumerate(valid_lanes(case)):
        if not ok:
            out.append(None)
            continue
        res = sw._postprocess(bt[c], int(reflen[c]), int(altlen[c]), lastrow_t[c],
                              lastcol[c], api_sw.OverhangStrategy(strategy))
        out.append((res.cigar, res.alignment_offset))
    return out


def walked(walk) -> list:
    """``(cigar, offset, runs)`` of each lane of a walk's output (``(2 +
    cap, P)`` int32, on any device)."""
    host = walk.cpu().numpy()
    cigars = api_sw.format_cigars(host[2:], host[0])
    return list(zip(cigars, host[1].tolist(), host[0].tolist()))


def cigar_runs(cigar: str) -> int:
    return len(re.findall(r"\d+[MIDS]", cigar))
