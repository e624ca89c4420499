"""Shared PairHMM inputs for the port's tests (numpy only: no JAX, so the
GPU tests can use them where JAX is absent)."""

import numpy as np

# One lane where a column dies by row 3 of a chunk and is refilled by row 7:
# only the mid-chunk liveness sample flags it (hap, read, q/iq/dq/gcp hex).
DIE_AND_REFILL = (
    "CTCCGATAGAATCCAATTAGAGGCTTACTTTACATGCGGACTTTTTTA",
    "GTAAAACGTGCTCTTCCCGATGTCGATCCCTC",
    "007f7f52007f001a7f00070000007f007f7f007f007f00007f00007f7f7f7f00",
    "7f7f230000007f007f7f7f7f7f00007f7f0000007f7f7f00007f7f7f007f3030",
    "007f00007c7f007f007f0000007f000000445100007f3f7f7f00327f7f007f7f",
    "75000000004f0000044f007f0001007f000c7f7f000000000b00007f0000117f",
)


def flag_cases():
    """(name, dense planes) with flagged and unflagged lanes: random bases
    and quals over the whole 0-127 range (many lanes die against the f32
    window, many do not), and the die-and-refill lane."""
    rng = np.random.default_rng(9)
    R, H, P = 24, 24, 64
    bases = np.frombuffer(b"ACGTN", np.uint8)
    wide = [bases[rng.integers(0, 5, (H, P))], bases[rng.integers(0, 5, (R, P))]]
    wide += [rng.integers(0, 128, (R, P)).astype(np.uint8) for _ in range(4)]
    wide += [rng.integers(1, H + 1, P).astype(np.int32), rng.integers(1, R + 1, P).astype(np.int32)]
    hap, read, *quals = DIE_AND_REFILL
    lane = [np.frombuffer(hap.encode(), np.uint8), np.frombuffer(read.encode(), np.uint8)]
    lane += [np.frombuffer(bytes.fromhex(h), np.uint8) for h in quals]
    refill = [np.repeat(a[:, None], 8, axis=1) for a in lane]
    refill += [np.full(8, len(hap), np.int32), np.full(8, len(read), np.int32)]
    return [("wide_quals", wide), ("die_and_refill", refill)]
