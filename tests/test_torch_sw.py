"""The port's Smith-Waterman against the JAX package on the CPU: the scalar
oracle, the plain twin of the CUDA kernel against the jnp engine and the
Pallas kernels in interpret mode, the API, and the shape-bucket merge."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from gkl_tpu import api_sw as japi
from gkl_tpu.ops import sw as jsw
from gkl_tpu.ops import sw_pallas
from gkl_tpu.ops import sw_ref as jref
from gkl_tpu_torch import api_sw as tapi
from gkl_tpu_torch.ops import sw as tsw
from gkl_tpu_torch.ops import sw_cuda
from gkl_tpu_torch.ops import sw_ref as tref

import torch_sw_walk_cases as walk_cases

BASES = np.frombuffer(b"ACGT", np.uint8)
GATK = (200, -150, -260, -11)
STRATEGIES = list(tapi.OverhangStrategy)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(N=24, M=32, P=16, seed=0):
    """Alts are mutated reference windows, with ragged lengths."""
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, (N, P))]
    alt = BASES[rng.integers(0, 4, (M, P))]
    alt[: min(N, M)] = ref[: min(N, M)]
    mut = rng.random((M, P)) < 0.15
    alt[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    reflen = rng.integers(8, N + 1, P).astype(np.int32)
    altlen = rng.integers(8, M + 1, P).astype(np.int32)
    return ref, alt, reflen, altlen


def _twin(args, indel_boundary, pack_bt=True):
    return tsw.sw_forward(*(torch.from_numpy(a) for a in args), *GATK,
                          indel_boundary=indel_boundary, pack_bt=pack_bt)


def _pairs(seed, n=24, max_ref=90, max_alt=70):
    rng = np.random.default_rng(seed)
    refs, alts = [], []
    for _ in range(n):
        r = BASES[rng.integers(0, 4, int(rng.integers(1, max_ref)))]
        m = int(rng.integers(1, max_alt))
        a = r[int(rng.integers(0, max(1, len(r) // 2))):][:m].copy()
        if len(a) < m:
            a = np.concatenate([a, BASES[rng.integers(0, 4, m - len(a))]])
        mut = rng.random(m) < 0.1
        a[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        refs.append(r)
        alts.append(a)
    return refs, alts


@pytest.mark.parametrize("strategy", STRATEGIES, ids=[s.name for s in STRATEGIES])
def test_sw_ref_equals_jax(strategy):
    """The port's copy of the scalar oracle: matrices, maximum and CIGAR
    equal the JAX package's on random pairs."""
    for ref, alt in zip(*_pairs(1, n=12, max_ref=30, max_alt=30)):
        args = (ref, alt, *GATK, int(strategy))
        a, b = jref.sw_matrices(*args), tref.sw_matrices(*args)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert (dataclasses.astuple(jref.sw_align(*args))
                == dataclasses.astuple(tref.sw_align(*args)))
        H, bt, _, mi, mj = b
        n, m = len(ref), len(alt)
        assert tref.select_max(H[n, 1:], H[1:, m], n, m, int(strategy)) == \
            jref.select_max(H[n, 1:], H[1:, m], n, m, int(strategy))
        assert tref.cigar_from_btrack(bt, n, m, mi, mj, int(strategy)) == \
            jref.cigar_from_btrack(bt, n, m, mi, mj, int(strategy))


@pytest.mark.parametrize("pack_bt", [False, True])
@pytest.mark.parametrize("indel_boundary", [False, True])
def test_twin_bit_exact_vs_jnp(indel_boundary, pack_bt):
    """The twin equals the jnp engine bit for bit in every cell, padded ones
    included, with ragged lengths: bt, lastrow and lastcol (tolerance 0)."""
    args = _batch(seed=2)
    want = jsw.sw_forward(*args, *GATK, indel_boundary=indel_boundary, pack_bt=pack_bt)
    got = _twin(args, indel_boundary, pack_bt)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("indel_boundary", [False, True])
def test_twin_vs_pallas_tall(indel_boundary):
    """Against the tall Pallas kernel (row 7) in interpret mode: bit equal."""
    args = _batch(seed=3)
    want = sw_pallas.sw_forward_pallas(*args, *GATK, indel_boundary=indel_boundary,
                                       lane_block=8, interpret=True)
    for w, g in zip(want, _twin(args, indel_boundary)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("indel_boundary", [False, True])
def test_twin_vs_pallas_relay(indel_boundary):
    """Against the segment relay of the tall kernel with 16-row segments
    (carried H/F/lastrow across 4 segments): bit equal."""
    args = _batch(N=64, M=24, P=16, seed=5)
    want = sw_pallas.sw_forward_pallas_relay(*args, *GATK, indel_boundary=indel_boundary,
                                             seg=16, lane_block=8, interpret=True)
    for w, g in zip(want, _twin(args, indel_boundary)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("indel_boundary", [False, True])
def test_twin_vs_pallas_slab(indel_boundary, monkeypatch):
    """Against the alt-slab kernel ``_kernel_m`` (row 8).  Both its
    constants are patched, the slab height and the alt length past which
    slabs are taken, so that M=40 runs 3 slabs of 16, and the test asserts
    that the slab wrapper ran.  The slab path pads M to 48: the real-M prefix
    of bt and lastrow is compared, and all of lastcol (tolerance 0)."""
    calls = []
    real_call = sw_pallas._sw_mrelay_call

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real_call(*a, **kw)

    monkeypatch.setattr(sw_pallas, "SW_M_SLAB", 16)
    monkeypatch.setattr(sw_pallas, "SW_M_RELAY_MIN", 32)
    monkeypatch.setattr(sw_pallas, "_sw_mrelay_call", spy)
    sw_pallas.sw_forward_pallas.clear_cache()
    args = _batch(N=24, M=40, P=16, seed=11)
    try:
        bt_w, lr_w, lc_w = (np.asarray(x) for x in sw_pallas.sw_forward_pallas(
            *args, *GATK, indel_boundary=indel_boundary, lane_block=8, interpret=True))
    finally:
        sw_pallas.sw_forward_pallas.clear_cache()
    assert len(calls) == 3 and all(s[0] == 16 for s in calls)
    assert bt_w.shape[2] == 48
    bt, lr, lc = (x.numpy() for x in _twin(args, indel_boundary))
    np.testing.assert_array_equal(bt, bt_w[:, :, :40])
    np.testing.assert_array_equal(lr, lr_w[:40])
    np.testing.assert_array_equal(lc, lc_w)


def test_wrapper_cpu_runs_twin_and_in_range_compare():
    """On CPU tensors the wrapper returns the twin's packed result and
    launches nothing; ``in_range_mismatches`` sees a change inside a lane's
    region and ignores one outside it."""
    ref, alt, reflen, altlen = (torch.from_numpy(a) for a in _batch(seed=4))
    launches = sw_cuda.LAUNCHES
    got = sw_cuda.sw_forward(ref, alt, reflen, altlen, *GATK, indel_boundary=False)
    assert sw_cuda.LAUNCHES == launches
    want = tsw.sw_forward(ref, alt, reflen, altlen, *GATK, indel_boundary=False, pack_bt=True)
    assert sw_cuda.in_range_mismatches(got, want, reflen, altlen) == 0
    bt = want[0].clone()
    p = int(torch.argmin(altlen))
    bt[p, 0, int(altlen[p])] ^= 0x0F  # column altlen: outside the lane
    assert sw_cuda.in_range_mismatches((bt, *want[1:]), want, reflen, altlen) == 0
    bt[p, 0, 0] ^= 0x0F
    assert sw_cuda.in_range_mismatches((bt, *want[1:]), want, reflen, altlen) == 1
    with pytest.raises(ValueError):
        sw_cuda.sw_forward(ref[:-1], alt, reflen, altlen, *GATK, indel_boundary=False)


def test_sw_geometry_every_bucket():
    """The kernel's geometry for every reference bucket up to the 32,767
    limit: an even number of rows a thread (whole bt bytes), the smallest
    instance whose one pass holds the bucket, else 8 rows a thread and
    enough 256-row passes to cover it."""
    from gkl_tpu_torch import batch as tbatch

    buckets = sorted({tbatch.bucket_length(n) for n in range(1, 32768, 7)} | {32768})
    for N in buckets:
        rows, pass_rows, passes = sw_cuda.sw_geometry(N)
        assert rows in sw_cuda.ROWS_PER_THREAD and rows % 2 == 0
        assert pass_rows == 32 * rows and (passes - 1) * pass_rows < N <= passes * pass_rows
        if N <= 256:
            assert passes == 1 and (rows == 2 or 16 * rows < N)
        else:
            assert rows == 8
    assert [sw_cuda.sw_geometry(N)[0] for N in (8, 64, 96, 128, 160, 448, 4096)] == \
        [2, 2, 4, 4, 8, 8, 8]
    assert sw_cuda.sw_geometry(448)[2] == 2 and sw_cuda.sw_geometry(32768)[2] == 128
    with pytest.raises(ValueError):
        sw_cuda.sw_geometry(0)


@pytest.mark.parametrize("strategy", STRATEGIES, ids=[s.name for s in STRATEGIES])
def test_api_matches_jax(strategy):
    """SmithWaterman(device="cpu") against the JAX SmithWaterman: CIGAR and
    offset exact, with the GATK scores, small scores and the largest match
    value."""
    refs, alts = _pairs(7)
    jsw_api = japi.SmithWaterman(lane_multiple=8)
    tsw_api = tapi.SmithWaterman(device="cpu")
    for params in (GATK, (1, -1, -2, -1), (65536, -1, -3, -1)):
        want = jsw_api.align_batch(refs, alts, japi.SWParameters(*params), int(strategy))
        got = tsw_api.align_batch(refs, alts, tapi.SWParameters(*params), strategy)
        assert [(r.cigar, r.alignment_offset) for r in got] == \
            [(r.cigar, r.alignment_offset) for r in want]


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e)
    return None


def test_api_exceptions_match_jax():
    """The same exception types as the JAX API for null parameters or
    strategy, a null sequence, empty and too long sequences and a match
    value over the limit."""
    jsw_api = japi.SmithWaterman(lane_multiple=8)
    tsw_api = tapi.SmithWaterman(device="cpu")
    too_long = b"A" * (tapi.MAX_SW_SEQUENCE_LENGTH + 1)
    cases = [
        (b"A", b"A", GATK, None),
        (b"A", b"A", None, 9),
        (None, b"A", GATK, 9),
        (b"", b"A", GATK, 9),
        (b"A", b"", GATK, 9),
        (too_long, b"A", GATK, 9),
        (b"A", too_long, GATK, 9),
        (b"A", b"A", (65537, -1, -2, -1), 9),
    ]
    for ref, alt, params, strategy in cases:
        jp = None if params is None else japi.SWParameters(*params)
        tp = None if params is None else tapi.SWParameters(*params)
        want = _raises(lambda: jsw_api.align(ref, alt, jp, strategy))
        got = _raises(lambda: tsw_api.align(ref, alt, tp, strategy))
        assert want is not None and got is want, (ref[:4] if ref else ref, params, strategy)
    assert tapi.MAX_SW_SEQUENCE_LENGTH == japi.MAX_SW_SEQUENCE_LENGTH
    assert tapi.MAXIMUM_SW_MATCH_VALUE == japi.MAXIMUM_SW_MATCH_VALUE


def test_merge_shape_groups_sorted():
    """The bucket merge re-sorts after every merge and joins equal keys, so
    its groups come out sorted and distinct, at most 4, each pair in one
    group; on bucket sets that force many merges."""
    rng = np.random.default_rng(0)
    ladder = [8, 16, 24, 32, 48, 64, 96, 128, 160]
    for _ in range(200):
        keys = {(int(rng.choice(ladder)), int(rng.choice(ladder))) for _ in range(9)}
        groups, k = {}, 0
        for key in keys:
            c = int(rng.integers(1, 6))
            groups[key] = list(range(k, k + c))
            k += c
        merged = tapi.merge_shape_groups(groups)
        got = [key for key, _ in merged]
        assert got == sorted(set(got)) and len(got) <= tapi.SW_MAX_SHAPE_GROUPS
        assert sorted(i for _, idxs in merged for i in idxs) == list(range(k))
        for (n, m), idxs in merged:  # every pair fits the launch it joined
            for key, members in groups.items():
                if set(members) & set(idxs):
                    assert key[0] <= n and key[1] <= m


def test_api_many_buckets_matches_jax():
    """A batch spanning 9 shape buckets (merged down to 4 launches) gives
    the JAX API's CIGARs and offsets."""
    rng = np.random.default_rng(3)
    refs, alts = [], []
    for n, m in [(5, 7), (12, 30), (20, 9), (40, 60), (70, 17), (100, 90), (150, 40),
                 (33, 120), (9, 200)]:
        for _ in range(2):
            r = BASES[rng.integers(0, 4, n)]
            a = np.resize(r, m).copy()
            mut = rng.random(m) < 0.1
            a[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
            refs.append(r)
            alts.append(a)
    want = japi.SmithWaterman(lane_multiple=8).align_batch(
        refs, alts, japi.SWParameters(*GATK), 9)
    got = tapi.SmithWaterman(device="cpu").align_batch(
        refs, alts, tapi.SWParameters(*GATK), tapi.OverhangStrategy.SOFTCLIP)
    assert [(r.cigar, r.alignment_offset) for r in got] == \
        [(r.cigar, r.alignment_offset) for r in want]


def test_pairs_past_the_budget_take_the_scalar_aligner(monkeypatch):
    """A pair whose backtrack exceeds the device budget goes to the threaded
    scalar aligner and gives the oracle's CIGAR; the others stay on the
    device."""
    monkeypatch.setattr(tapi, "SW_BT_BUDGET", 8 * 24 * 64)
    refs, alts = _pairs(9, n=6, max_ref=40, max_alt=40)
    refs.append(np.resize(BASES, 60))
    alts.append(np.resize(BASES, 70))
    assert not tapi.SmithWaterman._device_eligible(60, 70)
    assert tapi.SmithWaterman._device_eligible(8, 8)
    got = tapi.SmithWaterman(device="cpu").align_batch(
        refs, alts, tapi.SWParameters(*GATK), tapi.OverhangStrategy.SOFTCLIP)
    for r, a, res in zip(refs, alts, got):
        want = tref.sw_align(r, a, *GATK, 9)
        assert (res.cigar, res.alignment_offset) == (want.cigar, want.offset)


@pytest.mark.parametrize("strategy", list(tapi.OverhangStrategy))
@pytest.mark.parametrize("case", walk_cases.WALK_CASES)
def test_walk_twin_matches_native_walk(case, strategy):
    """``ops.sw.sw_walk`` (the walk kernel's twin) against the native
    runtime's ``sw_postprocess_packed`` lane by lane on random packed
    backtracks: the same CIGAR, offset and number of runs; count 0 and
    offset 0 for a lane whose lengths are out of range.  IGNORE's "M when
    no op was walked" needs a start in row 0 past column 0, which no
    maximum gives (a lastrow cell has i = n >= 1); ``no_step`` covers the
    start at (0, 0), where no step is walked (INDEL starts at (n, m))."""
    arrays = walk_cases.walk_case(case, seed=len(case) + int(strategy))
    walk = tsw.sw_walk(*(torch.from_numpy(a) for a in arrays), strategy)
    cap = tsw.walk_capacity(2 * arrays[0].shape[1], arrays[0].shape[2])
    assert tuple(walk.shape) == (2 + cap, arrays[0].shape[0])
    got = walk_cases.walked(walk)
    want = walk_cases.native_walk(arrays, strategy)
    for (cigar, offset, runs), w in zip(got, want):
        if w is None:
            assert (cigar, offset, runs) == ("", 0, 0)
        else:
            assert (cigar, offset, runs) == (w[0], w[1], walk_cases.cigar_runs(w[0]))
    if case == "long_runs":
        assert max(int(r[:-1]) for c, _, _ in got for r in re.findall(r"\d+[MIDS]", c)) > 255
    if case == "no_step" and strategy != tapi.OverhangStrategy.INDEL:
        assert all(runs <= 1 for _, _, runs in got)  # INDEL starts at (n, m) whatever


def test_walk_wrapper_cpu_runs_twin():
    """``sw_cuda.sw_walk`` on CPU tensors is the twin and counts no
    launch; it refuses tensors of two launches and unknown strategies;
    ``walk_mismatches`` counts lanes, reading runs only below a lane's
    count."""
    args = [torch.from_numpy(a) for a in walk_cases.walk_case("random")]
    launches = sw_cuda.WALK_LAUNCHES
    got = sw_cuda.sw_walk(*args, tapi.OverhangStrategy.SOFTCLIP)
    assert sw_cuda.WALK_LAUNCHES == launches
    want = tsw.sw_walk(*args, 9)
    assert torch.equal(got, want) and sw_cuda.walk_mismatches(got, want) == 0
    other = want.clone()
    lane = int(torch.nonzero(want[0] > 0)[0])
    other[2 + int(want[0, lane]), lane] += 1        # past the count: not read
    assert sw_cuda.walk_mismatches(other, want) == 0
    other[2, lane] += 16
    other[1, lane + 1] += 1
    assert sw_cuda.walk_mismatches(other, want) == 2
    with pytest.raises(ValueError, match="one launch"):
        sw_cuda.sw_walk(args[0], args[1][:-1], *args[2:], 9)
    with pytest.raises(ValueError, match="strategy"):
        sw_cuda.sw_walk(*args, 8)


def test_format_cigars_shares_equal_lanes():
    """Lanes with equal runs get equal strings; rows past a lane's count
    are never read; runs past 255 and every op letter."""
    runs = np.array([[150 << 4 | 0, 5 << 4 | 9, 150 << 4 | 0, 3 << 4 | 1],
                     [0, 300 << 4 | 0, 99, 1 << 4 | 0],
                     [0, 2 << 4 | 2, 7, 5]], np.int32)
    counts = np.array([1, 3, 1, 2])
    assert tapi.format_cigars(runs, counts) == ["150M", "5S300M2D", "150M", "3I1M"]
    assert tapi.format_cigars(runs[:, :0], counts[:0]) == []


def test_api_copies_the_runs_again_past_the_first_rows(monkeypatch):
    """With one run row in the first copy, a chunk whose longest CIGAR has
    more runs copies again up to it: the results stay the scalar
    aligner's, and ``sw_bt_copy``'s items are the rows of the longest."""
    from gkl_tpu_torch import profiling

    monkeypatch.setattr(tapi, "SW_RUNS_FIRST_COPY", 1)
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    rng = np.random.default_rng(7)
    refs = [BASES[rng.integers(0, 4, 60)] for _ in range(12)]
    # 44-base windows with two bases deleted and one inserted: one bucket
    # (64, 48), 16 lanes, and CIGARs of several runs
    alts = [np.concatenate([r[5:20], r[22:35], BASES[rng.integers(0, 4, 1)], r[35:50]])
            for r in refs]
    profiling.METRICS.reset()
    try:
        got = tapi.SmithWaterman(device="cpu").align_batch(
            refs, alts, tapi.SWParameters(*GATK), tapi.OverhangStrategy.SOFTCLIP)
        snap = profiling.METRICS.snapshot()
    finally:
        profiling.METRICS.reset()
    want = tapi.sw_align_scalar_batch(refs, alts, tapi.SWParameters(*GATK), 9)
    assert [(g.cigar, g.alignment_offset) for g in got] == \
        [(w.cigar, w.alignment_offset) for w in want]
    longest = max(walk_cases.cigar_runs(w.cigar) for w in want)
    assert longest > 1 and snap["sw_card_walk"]["items"] == len(refs)
    assert snap["sw_bt_copy"]["calls"] == 1
    assert snap["sw_bt_copy"]["items"] == (2 + longest) * 16 * 4
