"""The port's PairHMM API on the CPU (``device="cpu"``, the kernel's plain
twin) against the reference contracts ``tests/test_pairhmm.py`` pins for the
JAX package, and the slice against ``gkl_tpu.PairHMM`` with the Pallas
scaled kernel in interpret mode."""

import numpy as np
import pytest
import torch

import golden
import gkl_tpu
from gkl_tpu_torch import (HaplotypeData, PairHMM, PairHMMFpga,
                           PairHMMNativeArguments, PairHMMOMP, ReadData, api,
                           profiling)
from gkl_tpu_torch import batch as tbatch

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden_reads(cases):
    return ([ReadData(c.read, c.q, c.iq, c.dq, c.gcp) for c in cases],
            [HaplotypeData(c.hap) for c in cases])


def test_simple_case():
    """ACGT/ACGT with flat quals => -6.022797e-01 (PairHmmUnitTest.java:56-89)."""
    plus = np.full(4, ord("+"), np.uint8)
    read = ReadData(b"ACGT", plus, plus, plus, plus)
    out = PairHMM(device="cpu").compute_likelihoods([read], [HaplotypeData(b"ACGT")])
    assert out.shape == (1,)
    np.testing.assert_allclose(out[0], -6.022797e-01, atol=1e-5)


@pytest.mark.parametrize("use_double", [False, True])
def test_golden_file(use_double):
    """All 104 golden cases at 1e-5 in both precision modes, one pair per
    call as the reference test drives them."""
    cases = golden.load_pairhmm_cases()
    reads, haps = _golden_reads(cases)
    hmm = PairHMM(PairHMMNativeArguments(use_double_precision=use_double), device="cpu")
    got = np.array([hmm.compute_likelihoods([rd], [hp])[0] for rd, hp in zip(reads, haps)])
    np.testing.assert_allclose(got, [c.expected for c in cases], atol=1e-5)


@pytest.mark.parametrize("cls", [PairHMM, PairHMMOMP, PairHMMFpga])
def test_cross_product_order(cls):
    """Results are read-major over the reads x haps cross product."""
    reads, haps = _golden_reads(golden.load_pairhmm_cases()[:3])
    hmm = cls(device="cpu")
    out = hmm.compute_likelihoods(reads, haps)
    assert out.shape == (9,)
    singles = np.array([hmm.compute_likelihoods([rd], [hp])[0] for rd in reads for hp in haps])
    np.testing.assert_allclose(out, singles, rtol=0, atol=1e-12)
    buf = np.full(12, 7.0)
    assert hmm.compute_likelihoods(reads, haps, buf) is buf
    np.testing.assert_array_equal(buf[:9], out)


def _deep_rescue_batch():
    rng = np.random.default_rng(7)
    hap = BASES[rng.integers(0, 4, 48)]
    q50 = np.full(32, 50, np.uint8)
    deep_lanes = (17, 900, 3000)
    # every base differs from the hap prefix: 32 mismatch priors of 1e-5/3
    mism = BASES[(np.searchsorted(BASES, hap[:32]) + 1) % 4]
    reads = [ReadData((mism if i in deep_lanes else hap[:32]).copy(), q50, q50, q50, q50)
             for i in range(4096)]
    return reads, [HaplotypeData(hap)], deep_lanes


def test_rescue_is_lane_granular(monkeypatch):
    """3 deep lanes in a 4096-lane group recompute exactly 3 lanes in f64
    (the reference's per-pair double rescue, IntelPairHmm.cc:157-165)."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    reads, haps, deep_lanes = _deep_rescue_batch()
    profiling.METRICS.reset()
    out = PairHMM(device="cpu").compute_likelihoods(reads, haps)
    snap = profiling.METRICS.snapshot()
    assert snap["pairhmm_rescue"]["items"] == len(deep_lanes)
    assert snap["pairhmm"]["items"] == len(reads)
    f64 = PairHMM(PairHMMNativeArguments(use_double_precision=True),
                  device="cpu").compute_likelihoods([reads[i] for i in deep_lanes], haps)
    np.testing.assert_allclose(out[list(deep_lanes)], f64, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode,expected,exact", [
    pytest.param("host", 3, False, id="host-3"),
    pytest.param("device", 0, False, id="device-0"),
    pytest.param("host", 3, True, id="exact-host-3"),
    pytest.param("device", 3, True, id="exact-device-3"),
    pytest.param("flagged", 3, True, id="exact-flagged-3"),
])
def test_rescue_policy_modes(monkeypatch, mode, expected, exact):
    """GKL_TPU_RESCUE=host rescues every lane under the f32 range;
    =device trusts the scaled result wherever it is finite;
    GKL_TPU_EXACT_RESCUE=1 rescues every such lane whatever the mode says,
    as in gkl_tpu/api.py."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    monkeypatch.setenv("GKL_TPU_RESCUE", mode)
    if exact:
        monkeypatch.setenv("GKL_TPU_EXACT_RESCUE", "1")
    else:
        monkeypatch.delenv("GKL_TPU_EXACT_RESCUE", raising=False)
    reads, haps, deep_lanes = _deep_rescue_batch()
    profiling.METRICS.reset()
    out = PairHMM(device="cpu").compute_likelihoods(reads, haps)
    assert profiling.METRICS.snapshot().get("pairhmm_rescue", {}).get("items", 0) == expected
    assert np.isfinite(out).all() and (out[list(deep_lanes)] < -70).all()


def _interpret_jax_pairhmm(monkeypatch):
    """``gkl_tpu.PairHMM`` on its deduplicated path with the Pallas scaled
    kernel in interpret mode, as ``test_slice_parity_with_jax`` runs it."""
    from gkl_tpu import api as japi
    from gkl_tpu.ops import pairhmm_pallas

    def interp_scaled(*args, lane_block=128, **kw):
        return pairhmm_pallas.pairhmm_raw_pallas_scaled(*args, lane_block=8, interpret=True)

    monkeypatch.setattr(japi, "_scaled_inner_fn", lambda: interp_scaled)
    monkeypatch.setattr(gkl_tpu.PairHMM, "_use_pallas", classmethod(lambda cls, hap_len=0: True))


def test_slice_parity_with_jax(monkeypatch):
    """The same reads and haps through ``gkl_tpu.PairHMM`` (the Pallas scaled
    kernel in interpret mode, on the deduplicated path) and through the
    port agree at 1e-5, across mixed length buckets, with and without
    constant GOP planes."""
    cases = golden.load_pairhmm_cases()[:8]
    reads, _ = _golden_reads(cases)
    haps = [HaplotypeData(c.hap) for c in cases[:4]]
    gop = {len(c.read): np.full(len(c.read), 45, np.uint8) for c in cases}
    gcp = {len(c.read): np.full(len(c.read), 10, np.uint8) for c in cases}
    const_reads = [ReadData(c.read, c.q, gop[len(c.read)], gop[len(c.read)], gcp[len(c.read)])
                   for c in cases]
    assert api._const_quals_of(const_reads) == (45, 45, 10)

    _interpret_jax_pairhmm(monkeypatch)
    for rds in (reads, const_reads):
        j_reads = [gkl_tpu.ReadData(r.read_bases, r.read_quals, r.insertion_gop,
                                    r.deletion_gop, r.overall_gcp) for r in rds]
        j_haps = [gkl_tpu.HaplotypeData(h.haplotype_bases) for h in haps]
        pending = gkl_tpu.PairHMM().compute_likelihoods_async(j_reads, j_haps)
        assert {w[0] for w in pending._work} == {"scaled"}
        want = pending.result()
        got = PairHMM(device="cpu").compute_likelihoods(rds, haps)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _spy_rescues(monkeypatch, cls, seen):
    """Record the lanes each ``_f64_lanes`` call of ``cls`` recomputes."""
    real = cls._f64_lanes

    def spy(self, pk, lanes, *args, **kw):
        seen.extend(int(k) for k in lanes)
        return real(self, pk, lanes, *args, **kw)

    monkeypatch.setattr(cls, "_f64_lanes", spy)


def test_exact_rescue_parity_with_jax(monkeypatch):
    """With GKL_TPU_EXACT_RESCUE=1 (and GKL_TPU_RESCUE=device, which alone
    would rescue nothing) the port rescues the lanes ``gkl_tpu.PairHMM``
    rescues on the same reads, and their results are the same f64 values;
    the other lanes agree at 1e-5."""
    _interpret_jax_pairhmm(monkeypatch)
    monkeypatch.setenv("GKL_TPU_RESCUE", "device")
    monkeypatch.setenv("GKL_TPU_EXACT_RESCUE", "1")
    reads, haps, deep_lanes = _deep_rescue_batch()
    reads = reads[:8] + [reads[17], reads[900]] + reads[8:14] + [reads[3000]]
    deep = [8, 9, 16]
    j_seen, t_seen = [], []
    _spy_rescues(monkeypatch, gkl_tpu.PairHMM, j_seen)
    _spy_rescues(monkeypatch, PairHMM, t_seen)
    j_reads = [gkl_tpu.ReadData(r.read_bases, r.read_quals, r.insertion_gop,
                                r.deletion_gop, r.overall_gcp) for r in reads]
    want = gkl_tpu.PairHMM().compute_likelihoods(
        j_reads, [gkl_tpu.HaplotypeData(h.haplotype_bases) for h in haps])
    got = PairHMM(device="cpu").compute_likelihoods(reads, haps)
    assert sorted(t_seen) == sorted(j_seen) == deep
    np.testing.assert_array_equal(got[deep], want[deep])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _mixed_buckets():
    """8 golden cases whose reads and haplotypes fall in 4 length buckets
    each: 16 read-group x hap-group batches."""
    return _golden_reads(golden.load_pairhmm_cases()[::12][:8])


def _dispatched_kinds(monkeypatch):
    """Record the kind of each work item that ``PairHMM._dispatch_group``
    launches (a test clears the list to keep only ``result()``'s)."""
    kinds = []
    real = PairHMM._dispatch_group

    def spy(self, idxs, pk):
        live = real(self, idxs, pk)
        kinds.append(live[0])
        return live

    monkeypatch.setattr(PairHMM, "_dispatch_group", spy)
    return kinds


def test_async_inflight_budget_defers_groups(monkeypatch):
    """With the in-flight byte budget forced to 1 byte, every group after
    the first is ``"lazy"`` at dispatch and goes to the device from
    ``result()``, and the numbers equal the synchronous call's (the JAX
    package's ``tests/test_pairhmm.py`` contract, on the port)."""
    reads, haps = _mixed_buckets()
    hmm = PairHMM(device="cpu")
    sync = hmm.compute_likelihoods(reads, haps)
    monkeypatch.setattr(PairHMM, "_ASYNC_INFLIGHT_BYTES", 1)
    lazy = _dispatched_kinds(monkeypatch)
    pending = hmm.compute_likelihoods_async(reads, haps)
    lazy.clear()
    kinds = [w[0] for w in pending._work]
    assert len(kinds) > 2 and kinds[0] == "scaled"
    assert kinds[1:] == ["lazy"] * (len(kinds) - 1)
    np.testing.assert_array_equal(pending.result(), sync)
    assert lazy == ["scaled"] * (len(kinds) - 1)
    np.testing.assert_array_equal(pending.result(), sync)  # resolving twice


def test_async_inflight_budget_defers_long_haplotype_group(monkeypatch):
    """A deferred group whose haplotype bucket passes ``PALLAS_MAX_HAP``
    comes back from ``result()`` as an ``"f32"`` item on the column kernel's
    twin, with the synchronous call's numbers."""
    rng = np.random.default_rng(3)
    long_hap = BASES[rng.integers(0, 4, 2100)]
    haps = [HaplotypeData(long_hap[:40].copy()), HaplotypeData(long_hap)]
    reads = []
    for start in (5, 700, 1500):
        seq = long_hap[start:start + 24].copy()
        q = rng.integers(20, 40, 24).astype(np.uint8)
        reads.append(ReadData(seq, q, *(np.full(24, v, np.uint8) for v in (45, 45, 10))))
    hmm = PairHMM(device="cpu")
    sync = hmm.compute_likelihoods(reads, haps)
    monkeypatch.setattr(PairHMM, "_ASYNC_INFLIGHT_BYTES", 1)
    lazy = _dispatched_kinds(monkeypatch)
    pending = hmm.compute_likelihoods_async(reads, haps)
    lazy.clear()
    assert [w[0] for w in pending._work] == ["scaled", "lazy"]
    np.testing.assert_array_equal(pending.result(), sync)
    assert lazy == ["f32"]


def test_device_bytes_counts_the_ports_footprint(monkeypatch):
    """``device_bytes`` is what an engine without a mesh uploads through
    ``parallel.mesh.launch_lanes``, plus the three (H, P) f32 boundary
    planes and the (3, P) int32 output, for batches with the gap quals as
    planes and as constants; the default budget holds such a group."""
    from gkl_tpu_torch.parallel import mesh as mesh_mod

    uploads = []
    real = mesh_mod.launch_lanes

    def spy(mesh, n_lanes, inputs, kernel, **kw):
        assert mesh.size == 1
        uploads.append(sum(v.nbytes for v in inputs(0, slice(0, n_lanes)).values()))
        return real(mesh, n_lanes, inputs, kernel, **kw)

    monkeypatch.setattr(mesh_mod, "launch_lanes", spy)
    reads, haps = _golden_reads(golden.load_pairhmm_cases()[:3])
    rq = [(r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp) for r in reads]
    for const in (None, (45, 45, 10)):
        pk = tbatch.pack_pairs_indexed([h.haplotype_bases for h in haps],
                                       [r.read_bases for r in reads], rq, const_quals=const)
        H, P = pk.hap_u.shape[0], pk.ridx.shape[0]
        PairHMM(device="cpu")._dispatch_group(np.arange(pk.n_real), pk)
        assert pk.device_bytes() == uploads[-1] + 3 * 4 * H * P + 12 * P
        assert 0 < pk.device_bytes() < PairHMM._ASYNC_INFLIGHT_BYTES
    assert uploads[0] - uploads[1] == 3 * pk.readq_u.shape[1] * pk.readq_u.shape[2]


def test_const_quals_detection():
    n = 24
    mk = lambda v: np.full(n, v, np.uint8)  # noqa: E731
    seq = np.full(n, 65, np.uint8)
    const_reads = [ReadData(seq, mk(30), mk(45), mk(45), mk(10)) for _ in range(5)]
    assert api._const_quals_of(const_reads) == (45, 45, 10)
    assert api._const_quals_of(const_reads + [ReadData(seq, mk(30), mk(45), mk(44), mk(10))]) is None
    ragged = const_reads[:2]
    ragged[1].deletion_gop[7] = 9
    assert api._const_quals_of(ragged) is None


@pytest.mark.parametrize("cap", [0, 4, 10**6])
def test_thread_cap_on_one_device(cap):
    """The thread clamp maps onto local devices as the JAX package's does
    (gkl_tpu/api.py:273-296): 0 = all, N = at most N; on one device every
    cap gives the cap-1 engine and its likelihoods."""
    reads, haps = _golden_reads(golden.load_pairhmm_cases()[:6])
    want = PairHMM(PairHMMNativeArguments(max_number_of_threads=1),
                   device="cpu").compute_likelihoods(reads, haps)
    hmm = PairHMM(PairHMMNativeArguments(max_number_of_threads=cap), device="cpu")
    assert hmm.args.max_number_of_threads == cap
    np.testing.assert_array_equal(hmm.compute_likelihoods(reads, haps), want)


@pytest.mark.parametrize("cards, cap, spans", [(1, 0, False), (1, 4, False), (2, 1, False),
                                               (2, 0, True), (2, 4, True), (8, 2, True)])
def test_thread_cap_past_one_card(monkeypatch, cards, cap, spans):
    """A clamp that spans several visible cards builds a dp mesh over the
    first min(cap, cards) of them (0 = all), as gkl_tpu/api.py:273-296
    does; one card, or a cap of 1, builds the one-device engine."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    from gkl_tpu_torch import utils

    assert utils.available_parallelism("cuda") == cards
    assert utils.available_parallelism("cpu") == 1
    args = PairHMMNativeArguments(max_number_of_threads=cap)
    hmm = PairHMM(args)
    assert hmm.device.type == "cuda"
    if spans:
        n = cards if cap == 0 else min(cap, cards)
        assert hmm.mesh.devices == tuple(torch.device("cuda", i) for i in range(n))
    else:
        assert hmm.mesh is None


def test_extract_lanes_matches_materialize():
    rng = np.random.default_rng(5)
    haps = [BASES[rng.integers(0, 4, int(rng.integers(8, 40)))] for _ in range(3)]
    reads = [BASES[rng.integers(0, 4, 24)] for _ in range(5)]
    rq = [tuple(rng.integers(lo, 50, 24).astype(np.uint8) for lo in (10, 20, 20, 5))
          for _ in range(5)]
    for const in (None, (45, 46, 10)):
        pk = tbatch.pack_pairs_indexed(haps, reads, rq, const_quals=const)
        dense = pk.materialize()
        lanes = np.array([0, 4, 7, 14])
        hs, rs, qs = api._extract_lanes(pk, lanes)
        for i, k in enumerate(lanes):
            hl, rl = int(pk.haplen[k]), int(pk.rslen[k])
            np.testing.assert_array_equal(hs[i], dense.hap[:hl, k])
            np.testing.assert_array_equal(rs[i], dense.read[:rl, k])
            for got_q, want_q in zip(qs[i], (dense.q, dense.iq, dense.dq, dense.gcp)):
                np.testing.assert_array_equal(got_q, want_q[:rl, k])


def test_argument_checks():
    reads, haps = _golden_reads(golden.load_pairhmm_cases()[:1])
    # all devices of the CPU are one: the clamp builds the one-device engine
    capped = PairHMM(PairHMMNativeArguments(max_number_of_threads=0), device="cpu")
    np.testing.assert_array_equal(capped.compute_likelihoods(reads, haps),
                                  PairHMM(device="cpu").compute_likelihoods(reads, haps))
    with pytest.raises(ValueError):
        PairHMM(PairHMMNativeArguments(max_number_of_threads=-1), device="cpu")
    hmm = PairHMM(device="cpu")
    with pytest.raises(TypeError):
        hmm.compute_likelihoods(None, haps)
    with pytest.raises(ValueError):
        hmm.compute_likelihoods([], haps)
    with pytest.raises(ValueError):
        hmm.compute_likelihoods([ReadData(b"ACGT", b"++++", b"+++", b"++++", b"++++")], haps)
    assert PairHMM().device.type == "cuda"  # the default needs no card until it runs
