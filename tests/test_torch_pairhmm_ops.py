"""The port's PairHMM engines against the JAX package's on one set of inputs:
the plain-torch ``pairhmm_raw`` against ``gkl_tpu.ops.pairhmm.pairhmm_raw``,
and the scaled kernel's plain twin against the Pallas ``_scaled_kernel`` in
interpret mode.  The CUDA kernel itself is checked against the twin on the
card in ``test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import golden
from torch_cases import flag_cases
from gkl_tpu import batch as jbatch
from gkl_tpu.ops import pairhmm as jops
from gkl_tpu.ops.pairhmm_pallas import pairhmm_raw_pallas_scaled
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.ops import pairhmm as tops
from gkl_tpu_torch.ops import pairhmm_cuda, pairhmm_ref

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gatk_like_packed(seed, n=24, R=40, H=56):
    """Ragged GATK-shaped pairs (reads are mutated hap windows, in f32
    range), packed once by the JAX package and carried into the port."""
    rng = np.random.default_rng(seed)
    haps, reads, quals = [], [], []
    for _ in range(n):
        hl = int(rng.integers(H // 2, H + 1))
        rl = int(rng.integers(R // 2, R + 1))
        hap = BASES[rng.integers(0, 4, hl)]
        start = int(rng.integers(0, max(1, hl - rl)))
        read = np.resize(hap[start:], rl).copy()
        mut = rng.random(rl) < 0.03
        read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        read[rng.integers(0, rl)] = ord("N")
        haps.append(hap)
        reads.append(read)
        quals.append((rng.integers(10, 45, rl).astype(np.uint8),
                      rng.integers(25, 50, rl).astype(np.uint8),
                      rng.integers(25, 50, rl).astype(np.uint8),
                      rng.integers(5, 20, rl).astype(np.uint8)))
    packed = jbatch.pack_pairs(haps, reads, quals, lane_multiple=8)
    return packed, tbatch.from_reference(packed)


def _planes(pk):
    return (pk.hap, pk.read, pk.q, pk.iq, pk.dq, pk.gcp, pk.haplen, pk.rslen)


def _torch_planes(pk):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in _planes(pk)]


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("seed", [0, 1])
def test_pairhmm_raw_matches_jax(dtype, rtol, seed):
    jpk, tpk = _gatk_like_packed(seed)
    want = np.asarray(jops.pairhmm_raw(*_planes(jpk), dtype=dtype))
    got = tops.pairhmm_raw(*_torch_planes(tpk), dtype=dtype).numpy()
    assert got.dtype == np.dtype(dtype)
    n = jpk.n_real
    assert (want[:n] > 0).all()
    np.testing.assert_allclose(got[:n], want[:n], rtol=rtol)


def test_log10_finalizers_match_jax():
    raw = np.array([1e-3, 3.5e10, 0.0, 2.0 ** 100], np.float32)
    np.testing.assert_array_equal(tops.pairhmm_log10_from_raw_f32(raw),
                                  jops.pairhmm_log10_from_raw_f32(raw))
    raw64 = np.array([1e-300, 2.0 ** 1000, 0.0])
    np.testing.assert_array_equal(tops.pairhmm_log10_from_raw_f64(raw64),
                                  jops.pairhmm_log10_from_raw_f64(raw64))


def _golden_packed():
    cases = golden.load_pairhmm_cases()[:24]
    packed = jbatch.pack_pairs([c.hap for c in cases], [c.read for c in cases],
                               [(c.q, c.iq, c.dq, c.gcp) for c in cases], lane_multiple=8)
    return packed, tbatch.from_reference(packed)


@pytest.mark.parametrize("source", ["golden", "gatk_like"])
def test_scaled_twin_matches_pallas_interpret(source):
    """In-range lanes within 1e-5 in log10; flags equal, or the twin's a
    superset of the Pallas kernel's."""
    jpk, tpk = _golden_packed() if source == "golden" else _gatk_like_packed(3)
    jm, je, jf = pairhmm_raw_pallas_scaled(*_planes(jpk), lane_block=8, interpret=True)
    tm, te, tf = pairhmm_cuda.pairhmm_raw_scaled_reference(*_torch_planes(tpk))
    n = jpk.n_real
    want = pairhmm_cuda.log10_of(jm, je)[:n]
    got = pairhmm_cuda.log10_of(tm.numpy(), te.numpy())[:n]
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jf, tf = np.asarray(jf)[:n], tf.numpy()[:n]
    assert not np.any((jf != 0) & (tf == 0)), "twin misses a flag the Pallas kernel raises"


@pytest.mark.parametrize("name,planes", flag_cases(), ids=[c[0] for c in flag_cases()])
def test_scaled_twin_flags_equal_pallas(name, planes):
    """Flags exactly equal to the Pallas kernel's where some lanes are
    flagged and some are not; results within 1e-5 in log10 wherever the
    Pallas result is positive and in the f32 range."""
    jm, je, jf = pairhmm_raw_pallas_scaled(*planes, lane_block=8, interpret=True)
    tm, te, tf = pairhmm_cuda.pairhmm_raw_scaled_reference(*(torch.from_numpy(a) for a in planes))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    if name == "wide_quals":
        assert 0 < int(np.asarray(jf).sum()) < len(jf)
    else:
        assert (tf.numpy() == 1).all()
    want = pairhmm_cuda.log10_of(jm, je)
    ok = (np.asarray(jm) > 0) & (want > -64.0)
    assert ok.any()
    np.testing.assert_allclose(pairhmm_cuda.log10_of(tm.numpy(), te.numpy())[ok], want[ok],
                               rtol=0, atol=1e-5)


def _deep_packed():
    """Random reads against one random haplotype at Q50: log10 ~ -100."""
    rng = np.random.default_rng(0)
    hap = BASES[rng.integers(0, 4, 120)]
    reads = [BASES[rng.integers(0, 4, 96)] for _ in range(8)]
    quals = [tuple(np.full(96, v, np.uint8) for v in (50, 50, 50, 10)) for _ in range(8)]
    packed = jbatch.pack_pairs([hap] * 8, reads, quals, lane_multiple=8)
    return packed, tbatch.from_reference(packed), hap, reads, quals


def test_scaled_twin_deep_lanes_vs_f64():
    """Deep-underflow lanes: the twin's scaled result matches the exact f64
    oracle at 1e-4, and its flags match the Pallas kernel's."""
    jpk, tpk, hap, reads, quals = _deep_packed()
    tm, te, tf = pairhmm_cuda.pairhmm_raw_scaled_reference(*_torch_planes(tpk))
    got = pairhmm_cuda.log10_of(tm.numpy(), te.numpy())[:8]
    exact = pairhmm_ref.pairhmm_scalar_batch([hap] * 8, reads, quals)
    assert exact.max() < -65  # past the f32 range (log10 of MIN_ACCEPTED / 2^120)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-4)
    _, _, jf = pairhmm_raw_pallas_scaled(*_planes(jpk), lane_block=8, interpret=True)
    assert not np.any((np.asarray(jf)[:8] != 0) & (tf.numpy()[:8] == 0))


@pytest.mark.parametrize("const_quals", [None, (45, 44, 10)])
def test_wrapper_on_cpu_runs_twin_on_expanded_planes(const_quals):
    rng = np.random.default_rng(4)
    haps = [BASES[rng.integers(0, 4, int(rng.integers(10, 40)))] for _ in range(3)]
    reads = [BASES[rng.integers(0, 4, int(rng.integers(5, 30)))] for _ in range(4)]
    rq = [tuple(rng.integers(10, 50, len(r)).astype(np.uint8) for _ in range(4)) for r in reads]
    pk = tbatch.pack_pairs_indexed(haps, reads, rq, const_quals=const_quals)
    t = {k: torch.from_numpy(getattr(pk, k)) for k in
         ("hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen")}
    quals_u = None if pk.quals_u is None else torch.from_numpy(pk.quals_u)
    launches = pairhmm_cuda.LAUNCHES
    out = pairhmm_cuda.pairhmm_scaled(**t, const_quals=const_quals, quals_u=quals_u)
    assert pairhmm_cuda.LAUNCHES == launches  # CPU tensors never launch
    dense = tbatch.from_reference(pk.materialize())
    want = pairhmm_cuda.pairhmm_raw_scaled_reference(*_torch_planes(dense))
    for a, b in zip(pairhmm_cuda.unpack(out), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_validates_inputs():
    pk = tbatch.pack_pairs_indexed([BASES[:8]], [BASES[:4]], [(np.full(4, 30, np.uint8),) * 4])
    t = {k: torch.from_numpy(getattr(pk, k)) for k in
         ("hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen")}
    with pytest.raises(ValueError, match="exactly one"):
        pairhmm_cuda.pairhmm_scaled(**t)
    bad = dict(t, ridx=t["ridx"].to(torch.int64))
    with pytest.raises(ValueError, match="ridx"):
        pairhmm_cuda.pairhmm_scaled(**bad, quals_u=torch.from_numpy(pk.quals_u))
    short = dict(t, readq_u=t["readq_u"][:, :5].contiguous())
    with pytest.raises(ValueError, match="R % 8"):
        pairhmm_cuda.pairhmm_scaled(**short, const_quals=(45, 45, 10))


# The twin in the CUDA kernel's order (``pairhmm_raw_scaled_kernel_order``):
# it sums Y serially and the result row in column order, so it differs from
# the scan twin in the last bits only.  In-range lanes agree within 1e-6 in
# log10 (measured: under 5e-8), and within 1e-5 of the Pallas kernel (whose
# transition prep differs by ~1e-7); the flags are equal on every batch.
def _order_sources():
    return {"gatk_like_0": lambda: _gatk_like_packed(0)[1],
            "gatk_like_1": lambda: _gatk_like_packed(1)[1],
            "golden": lambda: _golden_packed()[1],
            "deep": lambda: _deep_packed()[1]}


@pytest.mark.parametrize("source", sorted(_order_sources()))
def test_kernel_order_twin_matches_scan_twin(source):
    tpk = _order_sources()[source]()
    planes = _torch_planes(tpk)
    km, ke, kf = pairhmm_cuda.pairhmm_raw_scaled_kernel_order(*planes)
    rm, re_, rf = pairhmm_cuda.pairhmm_raw_scaled_reference(*planes)
    got = pairhmm_cuda.log10_of(km.numpy(), ke.numpy())
    want = pairhmm_cuda.log10_of(rm.numpy(), re_.numpy())
    in_range = want > -64.0
    np.testing.assert_allclose(got[in_range], want[in_range], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(kf.numpy(), rf.numpy())
    if source == "deep":  # below the f32 range: against the exact f64 oracle
        _, _, hap, reads, quals = _deep_packed()
        exact = pairhmm_ref.pairhmm_scalar_batch([hap] * 8, reads, quals)
        np.testing.assert_allclose(got[:8], exact, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["gatk_like", "wide_quals", "die_and_refill"])
def test_kernel_order_twin_matches_pallas_interpret(case):
    """The kernel-order twin against the Pallas ``_scaled_kernel`` in
    interpret mode at small sizes: the same flags; in-range lanes within
    1e-5 in log10."""
    if case == "gatk_like":
        jpk, tpk = _gatk_like_packed(5, n=32, R=24, H=40)
        jplanes, n = _planes(jpk), jpk.n_real
    else:
        jplanes = dict(flag_cases())[case]
        n = jplanes[0].shape[1]
    jm, je, jf = pairhmm_raw_pallas_scaled(*jplanes, lane_block=8, interpret=True)
    km, ke, kf = pairhmm_cuda.pairhmm_raw_scaled_kernel_order(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in jplanes))
    np.testing.assert_array_equal(kf.numpy()[:n], np.asarray(jf)[:n])
    want = pairhmm_cuda.log10_of(jm, je)[:n]
    ok = (np.asarray(jm)[:n] > 0) & (want > -64.0)
    assert ok.any()
    np.testing.assert_allclose(pairhmm_cuda.log10_of(km.numpy(), ke.numpy())[:n][ok], want[ok],
                               rtol=0, atol=1e-5)


def _ragged_planes(seed, R, H, P):
    """Dense ragged planes (numpy), reads mutated windows of their lane's
    haplotype, with lengths set per lane below."""
    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, (H, P))]
    read = np.resize(hap, (R, P)).copy()
    mut = rng.random((R, P)) < 0.05
    read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    quals = [rng.integers(lo, hi, (R, P)).astype(np.uint8)
             for lo, hi in ((15, 45), (30, 46), (30, 46), (8, 12))]
    haplen = rng.integers(H // 2, H + 1, P).astype(np.int32)
    rslen = rng.integers(1, R + 1, P).astype(np.int32)
    return [hap, read, *quals, haplen, rslen]


@pytest.mark.parametrize("R", [20, 32])
def test_kernel_order_plain_matches_pairhmm_raw(R):
    """The plain instance (``scaled=False``, any R) against
    ``ops.pairhmm.pairhmm_raw(dtype="float32")``: relative 1e-5, since the
    two sum Y (scan vs serial) and the result row (tree vs column order) in
    different orders."""
    planes = [torch.from_numpy(a) for a in _ragged_planes(R, R, 40, 24)]
    got = pairhmm_cuda.pairhmm_raw_scaled_kernel_order(*planes, scaled=False)
    want = tops.pairhmm_raw(*planes, dtype="float32")
    assert got.dtype == torch.float32 and (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "plain"])
def test_kernel_order_lanes_side_by_side(scaled):
    """Lanes of different haplen and rslen in one batch, as a warp of four
    lanes sees them (rslen ending in different bands, 1-row and 1-column
    lanes): each lane's result is bit for bit that of the lane alone."""
    planes = _ragged_planes(11, 32, 40, 8)
    planes[6][:] = [1, 40, 17, 33, 8, 40, 2, 25]
    planes[7][:] = [1, 8, 9, 32, 17, 3, 24, 16]
    tp = [torch.from_numpy(a) for a in planes]
    together = pairhmm_cuda.pairhmm_raw_scaled_kernel_order(*tp, scaled=scaled)
    together = together if scaled else (together,)
    for p in range(8):
        alone = pairhmm_cuda.pairhmm_raw_scaled_kernel_order(
            *(a[..., p:p + 1] for a in tp), scaled=scaled)
        for a, b in zip(together, alone if scaled else (alone,)):
            assert torch.equal(a[p:p + 1], b), p


def test_band_steps_counts_warp_padding():
    """The row kernel's schedule: a warp runs, per band, the most steps any
    of its four lanes still in that band needs."""
    run, needed = pairhmm_cuda.band_steps([10] * 4, [16] * 4)
    assert run == needed == 4 * 2 * (10 + 7)
    # one long lane in a warp: the others wait through its bands
    run, needed = pairhmm_cuda.band_steps([10, 10, 10, 30], [8, 8, 8, 24])
    assert needed == 3 * 17 + 3 * 37
    assert run == 4 * 37 * 3
    # a fifth lane starts a second warp whose padding lanes need nothing
    run, needed = pairhmm_cuda.band_steps([10] * 5, [8] * 5)
    assert (run, needed) == (8 * 17, 5 * 17)
    # the plain instance stops at rslen: the last band's rows below it
    assert pairhmm_cuda.band_steps([10], [3], scaled=False) == (4 * 12, 12)
