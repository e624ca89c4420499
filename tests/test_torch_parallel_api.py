"""``PairHMM(mesh=)``, ``SmithWaterman(mesh=)`` and ``PDHMM(mesh=)`` of the
port on meshes of CPU shards, against the port without a mesh (bit for bit)
and against ``gkl_tpu``'s APIs on ``gkl_tpu.parallel.global_mesh()``
(``tests/test_distributed.py:59-109``); the rescue policies on a mesh
(``:276-326``); the thread cap's mesh over local CUDA devices, with the
device count patched."""

import numpy as np
import pytest
import torch

import golden
import gkl_tpu
from gkl_tpu import parallel as jpar
from gkl_tpu.api_pdhmm import PDHMM as JPDHMM
from gkl_tpu.api_pdhmm import PDHaplotypeData as JPDHaplotypeData
from gkl_tpu.api_sw import OverhangStrategy as JOverhangStrategy
from gkl_tpu.api_sw import SmithWaterman as JSmithWaterman
from gkl_tpu.api_sw import SWParameters as JSWParameters
from gkl_tpu_torch import (PDHMM, HaplotypeData, PairHMM, PairHMMNativeArguments,
                           PDHaplotypeData, PDHMMNativeArguments, ReadData, SmithWaterman,
                           SWParameters, parallel)
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.api_pdhmm import KernelLevel
from gkl_tpu_torch.api_sw import OverhangStrategy
from gkl_tpu_torch.ops import pairhmm_cuda

BASES = np.frombuffer(b"ACGT", np.uint8)
# the port's f32 PairHMM lanes (the scaled twin) against the JAX package's
# (its jnp engine on a CPU mesh), in log10: two f32 engines, 1.9e-6 apart
# on the golden cases
TOL_F32 = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n):
    return parallel.data_parallel_mesh(devices=["cpu"] * n)


def _golden_reads(cases):
    return ([ReadData(c.read, c.q, c.iq, c.dq, c.gcp) for c in cases],
            [HaplotypeData(c.hap) for c in cases])


@pytest.mark.parametrize("n", [2, 8])
def test_pairhmm_api_with_mesh(n):
    """The golden cases through ``PairHMM(mesh=)``: bit for bit the port
    without a mesh, within 1e-5 of ``gkl_tpu.PairHMM(mesh=global_mesh())``
    (f32 lanes of two engines), golden at 1e-5."""
    cases = golden.load_pairhmm_cases()[:12]
    reads, haps = _golden_reads(cases)
    hmm = PairHMM(device="cpu", mesh=_cpu_mesh(n))
    assert hmm._lane_multiple == 8 * n
    sharded = hmm.compute_likelihoods(reads, haps)
    np.testing.assert_array_equal(sharded, PairHMM(device="cpu").compute_likelihoods(reads, haps))
    jreads = [gkl_tpu.ReadData(c.read, c.q, c.iq, c.dq, c.gcp) for c in cases]
    jhaps = [gkl_tpu.HaplotypeData(c.hap) for c in cases]
    want = gkl_tpu.PairHMM(mesh=jpar.global_mesh()).compute_likelihoods(jreads, jhaps)
    np.testing.assert_allclose(sharded, want, rtol=0, atol=TOL_F32)
    np.testing.assert_allclose(sharded.reshape(12, 12).diagonal(),
                               [c.expected for c in cases], atol=1e-5)


def test_pdhmm_api_with_mesh():
    """The PDHMM golden cases through ``PDHMM(mesh=)``: bit for bit the
    port without a mesh, within 1e-9 of ``gkl_tpu``'s PDHMM on its global
    mesh, golden at 1e-4."""
    cases = golden.load_pdhmm_cases("pdhmm_syn_199_68_51.txt")[:6]
    reads = [ReadData(c.read, c.q, c.iq, c.dq, c.gcp) for c in cases]
    haps = [PDHaplotypeData(c.hap, haplotype_pdbases=c.hap_pd) for c in cases]
    sharded = PDHMM(device="cpu", mesh=_cpu_mesh(4)).compute_likelihoods(reads, haps)
    np.testing.assert_array_equal(sharded, PDHMM(device="cpu").compute_likelihoods(reads, haps))
    jreads = [gkl_tpu.ReadData(c.read, c.q, c.iq, c.dq, c.gcp) for c in cases]
    jhaps = [JPDHaplotypeData(c.hap, haplotype_pdbases=c.hap_pd) for c in cases]
    want = JPDHMM(mesh=jpar.global_mesh()).compute_likelihoods(jreads, jhaps)
    np.testing.assert_allclose(sharded, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sharded.reshape(6, 6).diagonal(), [c.expected for c in cases],
                               atol=1e-4)


def _sw_pairs(seed=5, n=12):
    rng = np.random.default_rng(seed)
    refs, alts = [], []
    for _ in range(n):
        k = int(rng.integers(10, 40))
        r = BASES[rng.integers(0, 4, k)]
        a = r.copy()
        a[rng.integers(0, k)] = BASES[rng.integers(0, 4)]
        refs.append(r)
        alts.append(a)
    return refs, alts


@pytest.mark.parametrize("strategy", list(OverhangStrategy))
def test_sw_api_with_mesh(strategy):
    """``SmithWaterman(mesh=)``: the CIGARs and offsets of the port without
    a mesh and of ``gkl_tpu``'s aligner on its global mesh."""
    refs, alts = _sw_pairs()
    params = SWParameters(200, -150, -260, -11)
    sw = SmithWaterman(device="cpu", mesh=_cpu_mesh(4))
    assert sw._lane_multiple == 32
    got = sw.align_batch(refs, alts, params, strategy)
    single = SmithWaterman(device="cpu").align_batch(refs, alts, params, strategy)
    want = JSmithWaterman(mesh=jpar.global_mesh()).align_batch(
        refs, alts, JSWParameters(200, -150, -260, -11), JOverhangStrategy(int(strategy)))
    pairs = [(g.cigar, g.alignment_offset) for g in got]
    assert pairs == [(s.cigar, s.alignment_offset) for s in single]
    assert pairs == [(w.cigar, w.alignment_offset) for w in want]


@pytest.mark.parametrize("n", [2, 4])
def test_sw_mesh_walks_on_the_card(monkeypatch, n):
    """``SmithWaterman(mesh=)`` walks every lane's CIGAR where its slab's
    DP left the backtrack, as the engine without a mesh does: the
    ``sw_card_walk`` counter holds every lane aligned, the native
    per-lane walk (``_postprocess``) never runs, and the results are the
    engine's without a mesh."""
    from gkl_tpu_torch import profiling

    refs, alts = _sw_pairs(seed=9, n=20)
    params = SWParameters(200, -150, -260, -11)
    single = SmithWaterman(device="cpu").align_batch(refs, alts, params,
                                                     OverhangStrategy.SOFTCLIP)

    def refuse(*args):
        raise AssertionError("the mesh walked a lane on the host")
    monkeypatch.setattr(SmithWaterman, "_postprocess", refuse)
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    profiling.METRICS.reset()
    try:
        got = SmithWaterman(device="cpu", mesh=_cpu_mesh(n)).align_batch(
            refs, alts, params, OverhangStrategy.SOFTCLIP)
        walked = profiling.METRICS.snapshot()["sw_card_walk"]["items"]
    finally:
        profiling.METRICS.reset()
    assert walked == len(refs)
    assert ([(g.cigar, g.alignment_offset) for g in got]
            == [(s.cigar, s.alignment_offset) for s in single])


def test_api_mesh_deep_lane_rescue_policies(monkeypatch):
    """The three GKL_TPU_RESCUE policies on a mesh: each equals the same
    policy without a mesh, and agrees with the f64 engine to the policy's
    tolerance (device and flagged trust the scaled kernel's f32-class
    lanes: 1e-4; host recomputes every deep lane: 1e-9)."""
    rng = np.random.default_rng(3)
    hap = BASES[rng.integers(0, 4, 320)]
    reads = [ReadData(BASES[rng.integers(0, 4, 256)], np.full(256, 50, np.uint8),
                      np.full(256, 50, np.uint8), np.full(256, 50, np.uint8),
                      np.full(256, 10, np.uint8)) for _ in range(3)]
    haps = [HaplotypeData(hap)]
    f64 = PairHMM(PairHMMNativeArguments(use_double_precision=True),
                  device="cpu").compute_likelihoods(reads, haps)
    assert np.max(f64) < -200
    mesh = _cpu_mesh(2)
    for policy, tol in (("flagged", 1e-4), ("device", 1e-4), ("host", 1e-9)):
        monkeypatch.setenv("GKL_TPU_RESCUE", policy)
        no_mesh = PairHMM(device="cpu").compute_likelihoods(reads, haps)
        with_mesh = PairHMM(device="cpu", mesh=mesh).compute_likelihoods(reads, haps)
        np.testing.assert_array_equal(with_mesh, no_mesh, err_msg=policy)
        np.testing.assert_allclose(with_mesh, f64, rtol=0, atol=tol, err_msg=policy)


def _spy_packing(monkeypatch, seen):
    real = tbatch.pack_pairs_indexed

    def spy(*args, **kw):
        pk = real(*args, **kw)
        seen.append(pk)
        return pk

    monkeypatch.setattr(tbatch, "pack_pairs_indexed", spy)


@pytest.mark.parametrize("n_haps, full", [(2, True), (3, False)])
def test_pairhmm_mesh_packs_full_pattern_when_nh_divides(monkeypatch, n_haps, full):
    """On a mesh, a group packs full-pattern when its nh divides the padded
    lanes and the read columns split over the shards
    (``gkl_tpu/api.py:674-684``), compact otherwise; both give the
    single-device results bit for bit, lazy groups too."""
    rng = np.random.default_rng(4)
    haps = [HaplotypeData(BASES[rng.integers(0, 4, int(rng.integers(40, 49)))])
            for _ in range(n_haps)]
    # two read groups (buckets 32 and 64) of 5 reads: 10 or 15 pairs, 16 lanes
    reads = [ReadData(BASES[rng.integers(0, 4, n)],
                      *(rng.integers(lo, 45, n).astype(np.uint8) for lo in (10, 30, 30, 9)))
             for n in (30,) * 5 + (60,) * 5]
    seen = []
    _spy_packing(monkeypatch, seen)
    monkeypatch.setattr(PairHMM, "_ASYNC_INFLIGHT_BYTES", 1)  # later groups lazy
    got = PairHMM(device="cpu", mesh=_cpu_mesh(2)).compute_likelihoods(reads, haps)
    assert len(seen) == 2 and all((pk.pattern_nh is not None) == full for pk in seen)
    assert all(pk.ridx.shape[0] % 16 == 0 for pk in seen)
    np.testing.assert_array_equal(got, PairHMM(device="cpu").compute_likelihoods(reads, haps))


def test_raw_batch_on_mesh_routes_as_jax(monkeypatch):
    """``_raw_batch`` on a mesh: the rows kernel up to PALLAS_MAX_HAP and the
    column kernel past it, on each lane slab (``gkl_tpu/api.py:404-431``),
    bit for bit the single-device call."""
    rng = np.random.default_rng(2)
    P, R, H = 32, 16, 40
    hap = BASES[rng.integers(0, 4, (H, P))]
    read = hap[:R].copy()
    quals = [rng.integers(lo, 45, (R, P)).astype(np.uint8) for lo in (10, 30, 30, 9)]
    packed = tbatch.PackedPairs(hap, read, *quals, np.full(P, H, np.int32),
                                np.full(P, R, np.int32), 30)
    calls = {}
    for name in ("pairhmm_rows", "pairhmm_scaled"):
        real = getattr(pairhmm_cuda, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(pairhmm_cuda, name, counting)
    mesh_hmm = PairHMM(device="cpu", mesh=_cpu_mesh(4))
    got = mesh_hmm._raw_batch(packed)
    assert calls == {"pairhmm_rows": 4} and got.shape == (30,)
    np.testing.assert_array_equal(got, PairHMM(device="cpu")._raw_batch(packed))
    monkeypatch.setattr(PairHMM, "PALLAS_MAX_HAP", 16)
    from gkl_tpu_torch.ops import pairhmm_cols

    real_cols = pairhmm_cols.pairhmm_cols
    monkeypatch.setattr(pairhmm_cols, "pairhmm_cols",
                        lambda **kw: calls.__setitem__("cols", calls.get("cols", 0) + 1)
                        or real_cols(**kw))
    got = mesh_hmm._raw_batch(packed)
    assert calls["cols"] == 4
    np.testing.assert_array_equal(got, PairHMM(device="cpu")._raw_batch(packed))


@pytest.mark.parametrize("count, cap, n", [(4, 0, 4), (4, 2, 2), (4, 9, 4), (4, 1, None),
                                          (1, 0, None), (0, 0, None), (8, 3, 3)])
def test_mesh_from_thread_cap(monkeypatch, count, cap, n):
    """The thread cap over local CUDA devices (the count patched): 0 = all,
    N = at most N, a span of one needs no mesh; each device once, this
    process's own."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    hmm = PairHMM(device="cpu")
    hmm.device = torch.device("cuda")
    mesh = hmm._mesh_from_thread_cap(PairHMMNativeArguments(max_number_of_threads=cap))
    if n is None:
        assert mesh is None
    else:
        assert mesh.devices == tuple(torch.device("cuda", i) for i in range(n))
        assert mesh.processes == (0,) * n and not parallel.is_multiprocess(mesh)
    with pytest.raises(ValueError):
        hmm._mesh_from_thread_cap(PairHMMNativeArguments(max_number_of_threads=-1))


def test_initialize_rebuilds_an_auto_mesh_and_keeps_a_user_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    hmm = PairHMM(PairHMMNativeArguments(max_number_of_threads=0))
    assert hmm.mesh.size == 4 and hmm._lane_multiple == 32
    hmm.initialize(PairHMMNativeArguments(max_number_of_threads=2))
    assert hmm.mesh.size == 2 and hmm._lane_multiple == 16
    hmm.initialize(PairHMMNativeArguments(max_number_of_threads=1))
    assert hmm.mesh is None and hmm._lane_multiple == 8
    user = _cpu_mesh(3)
    mine = PairHMM(PairHMMNativeArguments(max_number_of_threads=0), device="cpu", mesh=user)
    for cap in (0, 1, 2):
        mine.initialize(PairHMMNativeArguments(max_number_of_threads=cap))
        assert mine.mesh is user and mine._lane_multiple == 24
    with pytest.raises(ValueError):
        mine.initialize(PairHMMNativeArguments(max_number_of_threads=-1))


def test_pdhmm_mesh_slices_count_each_device(monkeypatch):
    """PDHMM's memory slicing on a mesh holds its budget on each device:
    two shards on one device take the one-device slices; results equal the
    unsharded engine's; KernelLevel.PALLAS on a CPU mesh raises."""
    cases = golden.load_pdhmm_cases("pdhmm_syn_199_68_51.txt")[:8]
    reads = [ReadData(c.read, c.q, c.iq, c.dq, c.gcp) for c in cases]
    haps = [PDHaplotypeData(c.hap, haplotype_pdbases=c.hap_pd) for c in cases[:4]]
    # ~19 lanes a MiB: 16-lane slices of the 32 lanes on one device
    from gkl_tpu_torch.ops import pdhmm_cuda

    monkeypatch.setattr(pdhmm_cuda, "boundary_bytes_per_lane",
                        lambda R, H, dtype="float32": (1 << 20) // 20)
    args = PDHMMNativeArguments(max_memory_in_mb=1)
    sizes = {}
    for key, mesh in (("one", None), ("two_on_one", _cpu_mesh(2))):
        sizes[key] = []
        engine = PDHMM(args, device="cpu", mesh=mesh)
        real = engine._run_indexed

        def spy(h, *rest, _real=real, _key=key):
            sizes[_key].append(len(h))
            return _real(h, *rest)

        engine._run_indexed = spy
        out = engine.compute_likelihoods(reads, haps)
        if mesh is None:
            want = out
    np.testing.assert_array_equal(out, want)
    assert sizes["one"] == sizes["two_on_one"] == [16, 16]
    with pytest.raises(RuntimeError, match="PALLAS"):
        PDHMM(PDHMMNativeArguments(kernel_level=KernelLevel.PALLAS), device="cpu",
              mesh=_cpu_mesh(2)).compute_likelihoods(reads[:1], haps[:1])
