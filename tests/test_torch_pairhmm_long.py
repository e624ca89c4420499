"""The port's long-haplotype PairHMM route on the CPU against the JAX
package: the column kernel's twin against the Pallas cols and relay kernels
in interpret mode, the rows wrapper against the Pallas rows kernel,
``PairHMM._raw_batch`` against the JAX package's, and ``PairHMM`` routing
and rescuing groups past ``PALLAS_MAX_HAP`` as ``gkl_tpu.PairHMM`` does.
The CUDA kernels are held against these twins on the card in
``test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import golden
import gkl_tpu
from gkl_tpu import batch as jbatch
from gkl_tpu import context as jctx
from gkl_tpu.ops import pairhmm_pallas_cols as jcols
from gkl_tpu.ops.pairhmm_pallas import pairhmm_raw_pallas
from gkl_tpu_torch import HaplotypeData, PairHMM, ReadData, api, profiling
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.ops import pairhmm_cols, pairhmm_cuda, pairhmm_ref

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(R=24, H=48, P=8, seed=5):
    """Ragged dense planes, reads mutated hap prefixes (the JAX package's
    ``tests/test_pairhmm_pallas.py::_batch``)."""
    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, size=(H, P))]
    read = hap[:R].copy()
    mut = rng.random((R, P)) < 0.1
    read[mut] = BASES[rng.integers(0, 4, size=int(mut.sum()))]
    q = rng.integers(10, 40, size=(R, P)).astype(np.uint8)
    iq = rng.integers(30, 45, size=(R, P)).astype(np.uint8)
    dq = rng.integers(30, 45, size=(R, P)).astype(np.uint8)
    gcp = np.full((R, P), 10, np.uint8)
    haplen = rng.integers(8, H + 1, P).astype(np.int32)
    rslen = rng.integers(4, R + 1, P).astype(np.int32)
    return hap, read, q, iq, dq, gcp, haplen, rslen


def _deep_batch():
    """Uniform hap 'A' against read 'C' at Q42: every diagonal mismatches,
    raw ~7e-32, under MIN_ACCEPTED but above the relay's flush floor
    (``tests/test_pairhmm_pallas.py::test_cols_relay_deep_lanes``)."""
    R, H, P = 16, 16, 8
    planes = [np.full((H, P), ord("A"), np.uint8), np.full((R, P), ord("C"), np.uint8)]
    planes += [np.full((R, P), 42, np.uint8) for _ in range(4)]
    return (*planes, np.full(P, H, np.int32), np.full(P, R, np.int32))


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _indexed(args):
    """Dense planes as the indexed batch of the rows and column wrappers:
    ridx = hidx = 0..P-1 and the gap quals as planes."""
    hap, read, q, iq, dq, gcp, haplen, rslen = args
    lanes = np.arange(hap.shape[1], dtype=np.int32)
    names = ("hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen", "quals_u")
    return dict(zip(names, _t((hap, np.stack([read, q]), lanes, lanes, haplen, rslen,
                               np.stack([iq, dq, gcp])))))


def test_cols_twin_matches_pallas_cols():
    """One chunk: the twin against the plain cols kernel at the JAX
    package's own tolerance for cols vs jnp (closed-form vs exact tables,
    ~1.7e-7, plus another order of sums)."""
    args = _batch()
    want = np.asarray(jcols.pairhmm_raw_pallas_cols(*args, lane_block=8, interpret=True))
    got = pairhmm_cols.pairhmm_raw_cols(*_t(args)).numpy()
    assert (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("case,r_chunk", [("ragged", 8), ("ragged", 16), ("ragged", 24),
                                          ("deep", 8), ("deep", 16)])
def test_relay_twin_matches_pallas_relay(case, r_chunk):
    """The twin's read chunks against the Pallas relay at the same
    r_chunk, on ragged lanes and on all-mismatch deep lanes whose value
    must survive the chunk boundaries."""
    args = _batch() if case == "ragged" else _deep_batch()
    want = np.asarray(jcols.pairhmm_raw_pallas_cols_relay(
        *args, lane_block=8, r_chunk=r_chunk, interpret=True))
    got = pairhmm_cols.pairhmm_raw_cols(*_t(args), r_chunk=r_chunk).numpy()
    if case == "deep":
        assert (want < float(jctx.MIN_ACCEPTED)).all() and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("R,H,r_chunk", [(16, 12, 8), (20, 9, 8), (24, 30, 8), (40, 17, 16),
                                         (33, 5, 12)])
def test_twin_passes_do_not_change_the_result(R, H, r_chunk):
    """The twin in read chunks of a small pass height, R spanning 2-3 of
    them, is bit for bit the twin in one chunk: the kernel's passes carry
    the same f32 values its registers would, and the twin runs the
    kernel's order.  Ragged lanes, 'N' in reads and haplotypes."""
    rng = np.random.default_rng(R * H)
    P = 12
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    hap = acgtn[rng.integers(0, 5, size=(H, P))]
    read = hap[np.arange(R) % H].copy()
    mut = rng.random((R, P)) < 0.1
    read[mut] = acgtn[rng.integers(0, 5, size=int(mut.sum()))]
    quals = [rng.integers(lo, 45, size=(R, P)).astype(np.uint8) for lo in (10, 25, 25)]
    rslen = rng.integers(1, R + 1, P).astype(np.int32)
    rslen[:4] = [R, r_chunk, r_chunk + 1, 1]
    t = _t((hap, read, *quals, np.full((R, P), 10, np.uint8),
            rng.integers(1, H + 1, P).astype(np.int32), rslen))
    assert 2 <= -(-R // r_chunk) <= 3
    whole = pairhmm_cols.pairhmm_raw_cols(*t)
    assert torch.isfinite(whole).all() and (whole > 0).all()
    assert torch.equal(pairhmm_cols.pairhmm_raw_cols(*t, r_chunk=r_chunk), whole)


@pytest.mark.parametrize("lo,hi", [(1, 128), (129, 1024), (1025, 8192)])
def test_cols_geometry_covers_every_read_bucket(lo, hi):
    """Every read bucket gets one of the kernel's instances, a pass of 32
    strips of its rows, and enough passes to cover the bucket; reads of up
    to 128 rows run in one pass."""
    for R in range(lo, hi + 1):
        rows, pass_rows, passes = pairhmm_cols.cols_geometry(R)
        assert rows in pairhmm_cols.ROWS_PER_THREAD
        assert pass_rows == 32 * rows
        assert passes * pass_rows >= R > (passes - 1) * pass_rows
        if R <= 128:
            assert (rows, passes) == (4, 1)
    with pytest.raises(ValueError):
        pairhmm_cols.cols_geometry(0)


def test_relay_twin_one_chunk_is_cols_twin():
    """A chunk that covers the whole read is the plain cols sweep, bit for
    bit (the JAX package pins the same of its two kernels)."""
    t = _t(_batch())
    np.testing.assert_array_equal(pairhmm_cols.pairhmm_raw_cols(*t, r_chunk=24).numpy(),
                                  pairhmm_cols.pairhmm_raw_cols(*t).numpy())


@pytest.mark.parametrize("R,H,seed", [(1, 40, 1), (40, 8, 2), (33, 65, 3), (64, 17, 4)])
def test_cols_twin_matches_rows_twin(R, H, seed):
    """The column sweep against the row sweep (``ops.pairhmm.pairhmm_raw``,
    the rows kernel's twin) on ragged lanes, for reads shorter and longer
    than the haplotype: the same function, summed in another order."""
    from gkl_tpu_torch.ops import pairhmm as tops

    rng = np.random.default_rng(seed)
    P = 8
    hap = BASES[rng.integers(0, 4, size=(H, P))]
    read = hap[np.arange(R) % H].copy()
    mut = rng.random((R, P)) < 0.05
    read[mut] = BASES[rng.integers(0, 4, size=int(mut.sum()))]
    quals = [rng.integers(lo, 45, size=(R, P)).astype(np.uint8) for lo in (20, 30, 30)]
    t = _t((hap, read, *quals, np.full((R, P), 10, np.uint8),
            rng.integers(1, H + 1, P).astype(np.int32), rng.integers(1, R + 1, P).astype(np.int32)))
    want = tops.pairhmm_raw(*t, dtype="float32").numpy()
    got = pairhmm_cols.pairhmm_raw_cols(*t).numpy()
    assert (want >= jctx.MIN_ACCEPTED).all()
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_rows_wrapper_matches_pallas_rows():
    """``pairhmm_rows`` on CPU tensors of a dense batch (ridx = hidx =
    lanes, the gap quals as planes) against the Pallas rows kernel with the
    exact tables: the twin runs and nothing launches."""
    args = _batch(R=16, H=24, seed=0)
    want = np.asarray(pairhmm_raw_pallas(*args, lane_block=8, interpret=True, prep="table"))
    launches = pairhmm_cuda.ROWS_LAUNCHES
    got = pairhmm_cuda.pairhmm_rows(**_indexed(args))
    assert pairhmm_cuda.ROWS_LAUNCHES == launches
    assert got.dtype == torch.float32 and (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_cols_twin_golden():
    """The first 24 golden cases through the cols twin at 1e-5, lanes in the
    f32 range (the others go to the f64 rescue)."""
    cases = golden.load_pairhmm_cases()[:24]
    pk = tbatch.pack_pairs([c.hap for c in cases], [c.read for c in cases],
                           [(c.q, c.iq, c.dq, c.gcp) for c in cases])
    raw = pairhmm_cols.pairhmm_raw_cols(*_t((pk.hap, pk.read, pk.q, pk.iq, pk.dq, pk.gcp,
                                             pk.haplen, pk.rslen))).numpy()[: pk.n_real]
    ok = raw >= jctx.MIN_ACCEPTED
    assert ok.sum() >= 20
    got = pairhmm_cols.pairhmm_cols(**_indexed((pk.hap, pk.read, pk.q, pk.iq, pk.dq, pk.gcp,
                                                pk.haplen, pk.rslen)))
    np.testing.assert_array_equal(got.numpy()[: pk.n_real], raw)
    res = api.pairhmm_ops.pairhmm_log10_from_raw_f32(raw)
    np.testing.assert_allclose(res[ok], np.array([c.expected for c in cases])[ok], atol=1e-5)


def test_cols_wrapper_validates_inputs():
    t = _indexed(_batch())
    with pytest.raises(ValueError, match="quals_u"):
        pairhmm_cols.pairhmm_cols(**dict(t, quals_u=t["quals_u"].to(torch.int32)))
    with pytest.raises(ValueError, match="quals_u"):
        pairhmm_cols.pairhmm_cols(**dict(t, quals_u=t["quals_u"][:, :8].contiguous()))
    with pytest.raises(ValueError, match="one entry per lane"):
        pairhmm_cols.pairhmm_cols(**dict(t, haplen=t["haplen"][:4]))
    with pytest.raises(ValueError, match="exactly one"):
        pairhmm_cols.pairhmm_cols(**t, const_quals=(45, 45, 10))


@pytest.mark.parametrize("const_quals", [None, (45, 45, 10)], ids=["quals_planes", "const"])
def test_cols_wrapper_indexed_matches_twin(const_quals):
    """On CPU tensors the wrapper gathers each lane's columns of a
    deduplicated batch (pad lanes included) and runs the twin on them, bit
    for bit the twin on the batch's dense planes; nothing launches."""
    rng = np.random.default_rng(11)
    haps = [BASES[rng.integers(0, 4, n)] for n in (30, 41, 19)]
    reads = [BASES[rng.integers(0, 4, n)] for n in (12, 25, 7, 20, 16)]
    quals = [tuple(rng.integers(lo, 50, len(r)).astype(np.uint8) for lo in (10, 20, 20, 5))
             for r in reads]
    pk = tbatch.pack_pairs_indexed(haps, reads, quals, const_quals=const_quals)
    assert pk.hap_u.shape[1] > len(haps) and pk.ridx.shape[0] > pk.n_real
    args = {"hap_u": pk.hap_u, "readq_u": pk.readq_u, "ridx": pk.ridx, "hidx": pk.hidx,
            "haplen": pk.haplen, "rslen": pk.rslen}
    if const_quals is None:
        args["quals_u"] = pk.quals_u
    launches = pairhmm_cols.LAUNCHES
    got = pairhmm_cols.pairhmm_cols(**dict(zip(args, _t(args.values()))),
                                    const_quals=const_quals)
    assert pairhmm_cols.LAUNCHES == launches
    dense = pk.materialize()
    want = pairhmm_cols.pairhmm_raw_cols(*_t((dense.hap, dense.read, dense.q, dense.iq, dense.dq,
                                              dense.gcp, dense.haplen, dense.rslen)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("H,routed_to", [(24, "rows"), (40, "cols")])
def test_raw_batch_matches_jax(monkeypatch, H, routed_to):
    """``PairHMM._raw_batch`` on a dense batch against the JAX package's
    (its jnp engine on the CPU): haplotype buckets up to PALLAS_MAX_HAP (32
    here) take the rows wrapper, longer ones the column wrapper."""
    monkeypatch.setattr(PairHMM, "PALLAS_MAX_HAP", 32)
    called = []
    for mod, name in ((pairhmm_cuda, "pairhmm_rows"), (pairhmm_cols, "pairhmm_cols")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda real=real, name=name, **kw: (
            called.append(name), real(**kw))[1])
    args = _batch(R=16, H=H, seed=H)
    jpk = jbatch.PackedPairs(*args, n_real=6)
    want = np.asarray(gkl_tpu.PairHMM()._raw_batch(jpk, "float32"))
    got = PairHMM(device="cpu")._raw_batch(tbatch.from_reference(jpk))
    assert called == [f"pairhmm_{routed_to}"]
    assert got.shape == want.shape == (6,) and (want >= jctx.MIN_ACCEPTED).all()
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("H,route", [(24, "rows"), (40, "cols"), (40, "dp_mesh")])
def test_raw_batch_float64_matches_jax(monkeypatch, H, route):
    """``_raw_batch(packed, "float64")`` against the JAX package's (its jnp
    f64 engine) at rtol 1e-12, on either side of PALLAS_MAX_HAP (32 here,
    in both packages) and on a CPU dp mesh, where it runs unsharded on the
    mesh's first entry: the plain f64 engine, and no f32 kernel wrapper."""
    from gkl_tpu_torch import parallel

    monkeypatch.setattr(PairHMM, "PALLAS_MAX_HAP", 32)
    monkeypatch.setattr(gkl_tpu.PairHMM, "PALLAS_MAX_HAP", 32)
    for mod, name in ((pairhmm_cuda, "pairhmm_rows"), (pairhmm_cols, "pairhmm_cols")):
        monkeypatch.setattr(mod, name, lambda **kw: pytest.fail("an f32 wrapper ran"))
    args = _batch(R=16, H=H, seed=H + 1)
    jpk = jbatch.PackedPairs(*args, n_real=6)
    want = np.asarray(gkl_tpu.PairHMM()._raw_batch(jpk, "float64"))
    mesh = parallel.data_parallel_mesh(devices=["cpu"] * 2) if route == "dp_mesh" else None
    got = PairHMM(device="cpu", mesh=mesh)._raw_batch(tbatch.from_reference(jpk), "float64")
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (6,)
    assert (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_raw_batch_refuses_other_dtypes():
    args = _batch(R=8, H=16, seed=1)
    with pytest.raises(ValueError, match="float32 or float64"):
        PairHMM(device="cpu")._raw_batch(tbatch.PackedPairs(*args, n_real=8), "float16")


def _jax_reads(reads):
    return [gkl_tpu.ReadData(r.read_bases, r.read_quals, r.insertion_gop, r.deletion_gop,
                             r.overall_gcp) for r in reads]


def _routing_batch():
    """Haplotypes in buckets 16 (scaled) and 24 and 32 (past a threshold of
    16); reads in buckets 8 (the JAX cols kernel's at a COLS_MAX_READ of 8)
    and 16 (its relay's); every fourth read random with every qual at 90,
    so that some lanes of every group fall below MIN_ACCEPTED."""
    rng = np.random.default_rng(9)
    haps = [BASES[rng.integers(0, 4, n)] for n in (14, 22, 30)]
    reads = []
    for i, n in enumerate((6, 8, 12, 16, 7, 14, 16, 8)):
        if i % 4 == 3:
            q90 = np.full(n, 90, np.uint8)
            reads.append(ReadData(BASES[rng.integers(0, 4, n)], q90, q90, q90, q90))
            continue
        h = haps[1 + i % 2]
        seq = h[int(rng.integers(0, len(h) - n + 1)):][:n].copy()
        seq[rng.integers(0, n)] = BASES[rng.integers(0, 4)]
        reads.append(ReadData(seq, rng.integers(20, 40, n).astype(np.uint8),
                              *(rng.integers(30, 46, n).astype(np.uint8) for _ in range(2)),
                              np.full(n, 10, np.uint8)))
    return reads, [HaplotypeData(h) for h in haps]


def test_long_haplotype_routing_matches_jax(monkeypatch):
    """Thresholds shrunk (PALLAS_MAX_HAP 16 in both packages, the JAX
    package's COLS_MAX_READ 8), the JAX kernels in interpret mode: both
    build the same work kinds per group, give the same likelihoods lane by
    lane, rescue the same lanes, and the rescued lanes equal the f64
    oracle."""
    from gkl_tpu import api as japi
    from gkl_tpu import profiling as jprof
    from gkl_tpu.ops import pairhmm_pallas

    def interp_scaled(*args, lane_block=128, **kw):
        return pairhmm_pallas.pairhmm_raw_pallas_scaled(*args, lane_block=8, interpret=True)

    def interp(fn):
        return lambda *args, lane_block=128, **kw: fn(*args, lane_block=8, interpret=True, **kw)

    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    monkeypatch.setattr(japi, "_scaled_inner_fn", lambda: interp_scaled)
    monkeypatch.setattr(gkl_tpu.PairHMM, "_use_pallas",
                        classmethod(lambda cls, hap_len=0: hap_len <= 16))
    monkeypatch.setattr(gkl_tpu.PairHMM, "PALLAS_MAX_HAP", 16)
    monkeypatch.setattr(gkl_tpu.PairHMM, "COLS_MAX_READ", 8)
    for name in ("pairhmm_raw_pallas_cols", "pairhmm_raw_pallas_cols_relay"):
        monkeypatch.setattr(jcols, name, interp(getattr(jcols, name)))
    monkeypatch.setattr(PairHMM, "PALLAS_MAX_HAP", 16)
    routed = []
    real_cols = pairhmm_cols.pairhmm_cols
    monkeypatch.setattr(pairhmm_cols, "pairhmm_cols", lambda **kw: (
        routed.append(kw["readq_u"].shape[1]), real_cols(**kw))[1])

    reads, haps = _routing_batch()
    jprof.METRICS.reset()
    pending = gkl_tpu.PairHMM().compute_likelihoods_async(_jax_reads(reads), [
        gkl_tpu.HaplotypeData(h.haplotype_bases) for h in haps])
    j_kinds = sorted((w[0], len(w[1])) for w in pending._work)
    want = pending.result()
    j_rescued = jprof.METRICS.snapshot()["pairhmm_rescue"]["items"]

    profiling.METRICS.reset()
    pending = PairHMM(device="cpu").compute_likelihoods_async(reads, haps)
    assert sorted((w[0], len(w[1])) for w in pending._work) == j_kinds
    assert {k for k, _ in j_kinds} == {"scaled", "f32"}
    got = pending.result()
    rescue = profiling.METRICS.snapshot()["pairhmm_rescue"]
    assert rescue["items"] == j_rescued > 0
    # the column kernel took the groups of both JAX kernels' read ranges
    assert set(routed) == {8, 16}
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    pairs = [(h.haplotype_bases, r.read_bases,
              (r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp))
             for r in reads for h in haps]
    exact = pairhmm_ref.pairhmm_scalar_batch(*zip(*pairs))
    below = exact < -64.0  # deeper than any f32 raw at or above MIN_ACCEPTED
    assert below.any()
    np.testing.assert_allclose(got[below], exact[below], rtol=0, atol=1e-9)


def test_long_haplotype_rescue_matches_jax(monkeypatch):
    """16 reads of 100 bases, mutation rates 2% to 47%, against one
    haplotype of 2,300 bases, with no patching: the port routes the group
    to the column kernel and rescues the lanes below MIN_ACCEPTED as the
    JAX package does, so the deep lanes are the f64 oracle's values."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    from gkl_tpu import profiling as jprof

    rng = np.random.default_rng(2300)
    hap = BASES[rng.integers(0, 4, 2300)]
    reads = []
    for i, rate in enumerate(np.linspace(0.02, 0.47, 16)):
        start = int(rng.integers(0, 2200))
        seq = hap[start:start + 100].copy()
        mut = rng.random(100) < rate
        seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        reads.append(ReadData(seq, rng.integers(20, 41, 100).astype(np.uint8),
                              *(np.full(100, v, np.uint8) for v in (45, 45, 10))))
    haps = [HaplotypeData(hap)]

    jprof.METRICS.reset()
    want = gkl_tpu.PairHMM().compute_likelihoods(_jax_reads(reads),
                                                 [gkl_tpu.HaplotypeData(hap)])
    j_rescued = jprof.METRICS.snapshot()["pairhmm_rescue"]["items"]

    profiling.METRICS.reset()
    pending = PairHMM(device="cpu").compute_likelihoods_async(reads, haps)
    assert [w[0] for w in pending._work] == ["f32"]
    got = pending.result()
    assert profiling.METRICS.snapshot()["pairhmm_rescue"]["items"] == j_rescued == 8

    exact = pairhmm_ref.pairhmm_scalar_batch(
        [hap] * 16, [r.read_bases for r in reads],
        [(r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp) for r in reads])
    deep = exact < -64.0
    assert deep.sum() == 8
    np.testing.assert_allclose(got[deep], exact[deep], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
