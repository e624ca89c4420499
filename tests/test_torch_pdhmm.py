"""The port's PDHMM against the JAX package on the CPU: column states and
lane keys, the plain twin of the CUDA kernel against the jnp engine and the
Pallas kernels in interpret mode, the golden files, and the API."""

import numpy as np
import pytest
import torch

import chip_smoke
import golden
from gkl_tpu import api_pdhmm as japi
from gkl_tpu import batch as jbatch
from gkl_tpu.api import ReadData as JReadData
from gkl_tpu.ops import pdhmm as jpd
from gkl_tpu.ops import pdhmm_pallas
from gkl_tpu_torch import MIN_ACCEPTED, ReadData
from gkl_tpu_torch import api_pdhmm as tapi
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.context import pdhmm_context
from gkl_tpu_torch.ops import pdhmm as tpd
from gkl_tpu_torch.ops import pdhmm_cuda, pdhmm_ref

BASES = np.frombuffer(b"ACGT", np.uint8)
GOLDEN = ["pdhmm_syn_990_1_2.txt", "pdhmm_syn_199_68_51.txt", "pdhmm_syn_1412_129_223.txt"]
# log10 tolerances: the twin against the jnp engine in f32 on lanes at or
# above MIN_ACCEPTED (the scans round in another order) and in f64; the
# golden contract of the reference's PDHMM tests
TOL_F32 = 1e-5
TOL_F64 = 1e-9
TOL_GOLDEN = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events_batch(H, R, P, seed=0):
    """Reads are mutated haplotype windows; half the lanes carry a deletion
    event (DEL_START/DEL_END), a quarter a PD SNP; ragged lengths."""
    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, (H, P))]
    read = np.concatenate([hap] * (R // H + 1))[:R].copy()
    mut = rng.random((R, P)) < 0.1
    read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    q = rng.integers(20, 40, (R, P)).astype(np.uint8)
    iq = rng.integers(30, 45, (R, P)).astype(np.uint8)
    dq = rng.integers(30, 45, (R, P)).astype(np.uint8)
    gcp = np.full((R, P), 10, np.uint8)
    haplen = rng.integers(H // 2, H + 1, P).astype(np.int32)
    rslen = rng.integers(R // 2, R + 1, P).astype(np.int32)
    hap_pd = np.zeros((H, P), np.uint8)
    hap_pd[H // 4, ::2] = 2
    hap_pd[H // 4 + 3, ::2] = 4
    hap_pd[H // 2, 1::4] = 1 | 8
    states = jpd.column_states(hap_pd)
    return hap, hap_pd, states, read, q, iq, dq, gcp, haplen, rslen


def _golden_batch(name, n):
    cases = golden.load_pdhmm_cases(name)[:n]
    pk = jbatch.pack_pairs([c.hap for c in cases], [c.read for c in cases],
                           [(c.q, c.iq, c.dq, c.gcp) for c in cases], lane_multiple=8)
    H, P = pk.hap.shape
    hap_pd = np.zeros((H, P), np.uint8)
    for k, c in enumerate(cases):
        hap_pd[: len(c.hap), k] = c.hap_pd
    return (pk.hap, hap_pd, jpd.column_states(hap_pd), pk.read, pk.q, pk.iq, pk.dq,
            pk.gcp, pk.haplen, pk.rslen), len(cases)


def _twin(args, dtype="float32"):
    return tpd.pdhmm_raw(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
                         dtype=dtype).numpy()


def _assert_f32_agree(want, got, n, what):
    """In-range lanes within TOL_F32 in log10; the same lanes below
    MIN_ACCEPTED (those go to the host oracle whatever the engine gives)."""
    want, got = np.asarray(want)[:n], np.asarray(got)[:n]
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    below_w, below_g = want < MIN_ACCEPTED, got < MIN_ACCEPTED
    np.testing.assert_array_equal(below_g, below_w, err_msg=what)
    ok = ~below_w
    assert ok.any(), what
    np.testing.assert_allclose(np.log10(got[ok].astype(np.float64)),
                               np.log10(want[ok].astype(np.float64)),
                               rtol=0, atol=TOL_F32, err_msg=what)


def test_column_states_and_lane_keys_equal_jax():
    rng = np.random.default_rng(0)
    pd = rng.choice(np.array([0, 0, 0, 0, 1 | 16, 2, 4, 6], np.uint8), size=(40, 24))
    pd[:, :4] = 0
    np.testing.assert_array_equal(tpd.column_states(pd), jpd.column_states(pd))
    for p in range(pd.shape[1]):
        assert tpd.lane_event_key(pd[:, p]) == jpd.lane_event_key(pd[:, p])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_twin_matches_jnp(dtype):
    """The twin against the jnp engine on golden cases with PD events and a
    synthetic batch with deletion and SNP events: f32 in-range lanes within
    1e-5 in log10 with the same lanes below MIN_ACCEPTED; f64 within 1e-9."""
    for args, n in (_golden_batch("pdhmm_syn_990_1_2.txt", 48),
                    _golden_batch("pdhmm_syn_199_68_51.txt", 16),
                    (_events_batch(24, 32, 16, seed=1), 16)):
        want = np.asarray(jpd.pdhmm_raw(*args, dtype=dtype))
        got = _twin(args, dtype)
        assert got.dtype == np.dtype(dtype)
        if dtype == "float32":
            _assert_f32_agree(want, got, n, "twin vs jnp f32")
        else:
            ok = want[:n] > 0
            np.testing.assert_allclose(np.log10(got[:n][ok]), np.log10(want[:n][ok]),
                                       rtol=0, atol=TOL_F64)


def test_twin_matches_pallas_single():
    """Against the single-pass Pallas kernel (row 5) in interpret mode, with
    PD events."""
    args = _events_batch(24, 32, 16, seed=2)
    want = pdhmm_pallas.pdhmm_raw_pallas(*args, lane_block=8, interpret=True)
    _assert_f32_agree(want, _twin(args), 16, "twin vs pallas single")


def test_twin_matches_pallas_chunked():
    """Against the chunked Pallas kernel (row 6) in interpret mode: 48 read
    rows relayed in 16-row chunks with the six boundary planes."""
    args = _events_batch(16, 48, 8, seed=3)
    want = pdhmm_pallas.pdhmm_raw_pallas_chunked(*args, r_chunk=16, lane_block=8,
                                                 interpret=True)
    _assert_f32_agree(want, _twin(args), 8, "twin vs pallas chunked")


def test_wrapper_cpu_runs_twin_on_indexed_batch():
    """On CPU tensors the indexed wrapper runs the gather and the twin and
    launches nothing; packing equals the JAX package's."""
    rng = np.random.default_rng(4)
    uh = [BASES[rng.integers(0, 4, int(rng.integers(10, 30)))] for _ in range(3)]
    upd = [np.zeros(len(h), np.uint8) for h in uh]
    upd[1][3], upd[1][6] = 2, 4
    ur = [BASES[rng.integers(0, 4, int(rng.integers(8, 20)))] for _ in range(4)]
    uq = [tuple(rng.integers(10, 50, len(r)).astype(np.uint8) for _ in range(4)) for r in ur]
    ridx, hidx = [0, 1, 2, 3, 0, 2, 1], [0, 1, 2, 0, 1, 2, 2]
    pk = tbatch.pack_pdhmm_indexed(uh, upd, ur, uq, ridx, hidx)
    jpk = jbatch.pack_pdhmm_indexed(uh, upd, ur, uq, ridx, hidx, lane_multiple=8)
    for f in ("hap_u", "happd_u", "states_u", "readq_u", "ridx", "hidx", "haplen", "rslen"):
        np.testing.assert_array_equal(getattr(pk, f), np.asarray(getattr(jpk, f)))
    names = ("hap_u", "happd_u", "readq_u", "ridx", "hidx", "haplen", "rslen")
    launches = pdhmm_cuda.LAUNCHES
    got = pdhmm_cuda.pdhmm(**{k: torch.from_numpy(getattr(pk, k)) for k in names}).numpy()
    assert pdhmm_cuda.LAUNCHES == launches
    want = np.asarray(japi._pdhmm_indexed_jit(
        lambda *a: jpd.pdhmm_raw(*a, dtype="float32"))(
        jpk.hap_u, jpk.happd_u, jpk.states_u, jpk.readq_u, jpk.ridx, jpk.hidx,
        jpk.haplen, jpk.rslen))
    _assert_f32_agree(want, got, pk.n_real, "indexed wrapper vs jnp")


@pytest.mark.parametrize("use_double", [False, True])
@pytest.mark.parametrize("name", GOLDEN)
def test_golden(name, use_double):
    """PDHMM(device="cpu") passes the reference's golden files at 1e-4, in
    the f32 mode (twin plus oracle rescue) and the double mode (oracle)."""
    cases = golden.load_pdhmm_cases(name)
    hmm = tapi.PDHMM(tapi.PDHMMNativeArguments(use_double_precision=use_double), device="cpu")
    got = hmm._compute_pairs([c.hap for c in cases], [c.hap_pd for c in cases],
                             [c.read for c in cases],
                             [(c.q, c.iq, c.dq, c.gcp) for c in cases])
    np.testing.assert_allclose(got, [c.expected for c in cases], rtol=0, atol=TOL_GOLDEN)


def test_compute_pdhmm_matches_jax():
    """The flat-array path against the JAX compute_pdhmm (its CPU engine is
    the f64 oracle) at the golden contract."""
    cases = golden.load_pdhmm_cases("pdhmm_syn_199_68_51.txt")[:40]
    args = chip_smoke.flat_pdhmm(cases)
    want = japi.PDHMM().compute_pdhmm(*args)
    got = tapi.PDHMM(device="cpu").compute_pdhmm(*args)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_GOLDEN)


def _objects(seed, n_reads=6, n_haps=3):
    rng = np.random.default_rng(seed)
    haps, pds = [], []
    for i in range(n_haps):
        h = BASES[rng.integers(0, 4, int(rng.integers(30, 60)))]
        pd = np.zeros(len(h), np.uint8)
        if i:
            j = int(rng.integers(4, len(h) - 10))
            pd[j], pd[j + 3] = 2, 4
            pd[j + 6] = 1 | 16
        haps.append(h)
        pds.append(pd)
    reads = []
    for r in range(n_reads):
        L = int(rng.integers(20, 45))
        h = haps[r % n_haps]
        seq = np.resize(h[int(rng.integers(0, len(h) // 3)):], L).copy()
        mut = rng.random(L) < 0.03
        seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        q = rng.integers(20, 40, L)
        if r % 3 == 0:  # a deep read: 100 random bases at high quals
            seq = BASES[rng.integers(0, 4, 100)]
            q = rng.integers(30, 50, 100)
            L = 100
        reads.append((seq, q.astype(np.uint8), np.full(L, 45, np.uint8),
                      np.full(L, 45, np.uint8), np.full(L, 10, np.uint8)))
    return haps, pds, reads


@pytest.mark.parametrize("max_memory_in_mb", [512, 0])
def test_compute_likelihoods_matches_jax(max_memory_in_mb, monkeypatch):
    """The object path against the JAX compute_likelihoods, read-major,
    deep lanes rescued, PD lanes planned out of order; max_memory_in_mb=0
    cuts the batch into 8-lane slices."""
    haps, pds, reads = _objects(5)
    want = japi.PDHMM().compute_likelihoods(
        [JReadData(*r) for r in reads],
        [japi.PDHaplotypeData(h, haplotype_pdbases=p) for h, p in zip(haps, pds)])
    slices = []
    real = tapi.PDHMM._run_indexed
    monkeypatch.setattr(tapi.PDHMM, "_run_indexed",
                        lambda self, *a: slices.append(len(a[0])) or real(self, *a))
    hmm = tapi.PDHMM(tapi.PDHMMNativeArguments(max_memory_in_mb=max_memory_in_mb),
                     device="cpu")
    got = hmm.compute_likelihoods(
        [ReadData(*r) for r in reads],
        [tapi.PDHaplotypeData(h, haplotype_pdbases=p) for h, p in zip(haps, pds)])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_GOLDEN)
    assert got.min() < -30  # deep lanes went through the rescue
    assert sum(slices) == len(reads) * len(haps)
    assert len(slices) == (1 if max_memory_in_mb else 3)


def _sliced_launches(monkeypatch, read_len, max_memory_in_mb=1, n_reads=60):
    """60 reads of ``read_len`` bases against one 1,000-base haplotype under
    a ``max_memory_in_mb`` budget: the (H, R, P) of each kernel call, and
    the results checked against one unbudgeted call."""
    rng = np.random.default_rng(8)
    hap = BASES[rng.integers(0, 4, 1000)]
    hd = [tapi.PDHaplotypeData(hap, haplotype_pdbases=np.zeros(1000, np.uint8))]
    rd = []
    for _ in range(n_reads):
        start = int(rng.integers(0, 1000 - read_len))
        rd.append(ReadData(hap[start:start + read_len].copy(),
                           *(np.full(read_len, v, np.uint8) for v in (30, 45, 45, 10))))
    shapes = []
    real = pdhmm_cuda.pdhmm
    monkeypatch.setattr(pdhmm_cuda, "pdhmm", lambda **t: shapes.append(
        (t["hap_u"].shape[0], t["readq_u"].shape[1], t["ridx"].shape[0])) or real(**t))
    got = tapi.PDHMM(tapi.PDHMMNativeArguments(max_memory_in_mb=max_memory_in_mb),
                     device="cpu").compute_likelihoods(rd, hd)
    monkeypatch.setattr(pdhmm_cuda, "pdhmm", real)
    want = tapi.PDHMM(device="cpu").compute_likelihoods(rd, hd)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    return shapes


def test_memory_slices_bound_the_kernel_state(monkeypatch):
    """max_memory_in_mb bounds what the kernel allocates: reads that need
    two passes of the kernel take its six f32 pass-boundary planes along
    the haplotype axis (24 bytes per column and lane), so a long haplotype
    gets small slices, with the same results."""
    shapes = _sliced_launches(monkeypatch, read_len=300)
    assert len(shapes) == 2
    assert all(0 < pdhmm_cuda.boundary_bytes_per_lane(R, H) * P <= 1 << 20
               for H, R, P in shapes), shapes


def test_memory_slices_one_pass_reads_need_no_boundary(monkeypatch):
    """Reads that one pass of the kernel holds need no boundary planes:
    under the same budget the same long haplotype takes one slice."""
    shapes = _sliced_launches(monkeypatch, read_len=24)
    assert len(shapes) == 1
    assert all(pdhmm_cuda.boundary_bytes_per_lane(R, H) == 0 for H, R, _ in shapes), shapes


def test_rescue_is_every_lane_below_min_accepted(monkeypatch):
    """Exactly the lanes whose f32 result is below MIN_ACCEPTED go to the
    oracle, and their results are the oracle's."""
    haps, pds, reads = _objects(6)
    seen = []
    real = pdhmm_ref.pdhmm_scalar_batch
    monkeypatch.setattr(pdhmm_ref, "pdhmm_scalar_batch",
                        lambda *a, **kw: seen.append(len(a[0])) or real(*a, **kw))
    hmm = tapi.PDHMM(device="cpu")
    rd = [ReadData(*r) for r in reads]
    hd = [tapi.PDHaplotypeData(h, haplotype_pdbases=p) for h, p in zip(haps, pds)]
    raw = []
    real_run = tapi.PDHMM._run_indexed
    monkeypatch.setattr(tapi.PDHMM, "_run_indexed",
                        lambda self, *a: raw.append(real_run(self, *a)) or raw[-1])
    got = hmm.compute_likelihoods(rd, hd)
    below = int(np.sum(raw[0] < MIN_ACCEPTED))
    assert 0 < below < len(got) and seen == [below]
    pairs = [(h, p, r[0], r[1:]) for r in reads for h, p in zip(haps, pds)]
    exact = real(*zip(*pairs))
    # a lane half a decade under the f32 bound is below it in f32 too
    bound = float(np.log10(MIN_ACCEPTED) - pdhmm_context("float32").INITIAL_CONDITION_LOG10)
    deep = exact < bound - 0.5
    assert deep.any()
    np.testing.assert_allclose(got[deep], exact[deep], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, exact, rtol=0, atol=TOL_GOLDEN)


def test_nan_lane_raises_and_is_not_rescued(monkeypatch):
    """A NaN from the f32 engine (the kernel's mark of a malformed lane) is
    not taken for a lane below MIN_ACCEPTED: the oracle recomputes only the
    lanes really below it, and the NaN reaches the validity check, which
    raises."""
    haps, pds, reads = _objects(6)
    raw = []
    real_run = tapi.PDHMM._run_indexed

    def nan_lane(self, *a):
        out = real_run(self, *a).copy()
        out[0] = np.nan
        raw.append(out)
        return out

    monkeypatch.setattr(tapi.PDHMM, "_run_indexed", nan_lane)
    seen = []
    real = pdhmm_ref.pdhmm_scalar_batch
    monkeypatch.setattr(pdhmm_ref, "pdhmm_scalar_batch",
                        lambda *a, **kw: seen.append(len(a[0])) or real(*a, **kw))
    with pytest.raises(RuntimeError, match="invalid log10"):
        tapi.PDHMM(device="cpu").compute_likelihoods(
            [ReadData(*r) for r in reads],
            [tapi.PDHaplotypeData(h, haplotype_pdbases=p) for h, p in zip(haps, pds)])
    below = int(np.sum(raw[0] < MIN_ACCEPTED))
    assert below > 0 and seen == [below]


def test_size_checks_match_jax():
    """The same ValueErrors as the JAX size checks."""
    cases = golden.load_pdhmm_cases("pdhmm_syn_199_68_51.txt")[:4]
    hap, pd, read, q, iq, dq, g, hl, rl = chip_smoke.flat_pdhmm(cases)
    t = len(cases)
    bad = [
        dict(args=(hap, pd, read, q, iq, dq, g, hl, rl[:1])),
        dict(args=(hap.reshape(-1)[:-3], pd, read, q, iq, dq, g, hl, rl),
             kw=dict(batch_size=t, max_hap_length=hap.shape[1], max_read_length=read.shape[1])),
        dict(args=(hap, pd, read, q, iq, dq, g, np.zeros(t, np.int64), rl)),
        dict(args=(hap, pd, read, q[:, :-2], iq, dq, g, hl, rl), kw=dict(batch_size=t)),
        dict(args=(hap, pd[:, :-1], read, q, iq, dq, g, hl, rl), kw=dict(batch_size=t)),
        dict(args=(hap[:-1], pd, read, q, iq, dq, g, hl, rl), kw=dict(batch_size=t)),
        dict(args=(hap, pd, read, q, iq, dq, g, hl, rl),
             kw=dict(batch_size=t, max_read_length=read.shape[1] + 8)),
        dict(args=(hap, pd, read, q, iq, dq, g, hl + 100, rl)),
        dict(args=(hap, pd, read, q, iq, dq, g, hl, rl), kw=dict(batch_size=0)),
    ]
    for case in bad:
        msgs = []
        for hmm in (japi.PDHMM(), tapi.PDHMM(device="cpu")):
            with pytest.raises(ValueError) as e:
                hmm.compute_pdhmm(*case["args"], **case.get("kw", {}))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for hmm in (japi.PDHMM(), tapi.PDHMM(device="cpu")):
        with pytest.raises(ValueError):
            hmm.compute_likelihoods([], [])
    with pytest.raises(ValueError, match="haplotype_pdbases is required"):
        tapi.PDHaplotypeData(BASES)


def test_kernel_levels():
    """PALLAS raises on the CPU, where no kernel runs; SCALAR runs the f64
    oracle and equals the double mode; DISABLE runs one oracle thread."""
    haps, pds, reads = _objects(7, n_reads=2, n_haps=2)
    rd = [ReadData(*r) for r in reads]
    hd = [tapi.PDHaplotypeData(h, haplotype_pdbases=p) for h, p in zip(haps, pds)]
    args = tapi.PDHMMNativeArguments(kernel_level=tapi.KernelLevel.PALLAS)
    with pytest.raises(RuntimeError, match="PALLAS"):
        tapi.PDHMM(args, device="cpu").compute_likelihoods(rd, hd)
    scalar = tapi.PDHMM(tapi.PDHMMNativeArguments(kernel_level=tapi.KernelLevel.SCALAR),
                        device="cpu").compute_likelihoods(rd, hd)
    double = tapi.PDHMM(tapi.PDHMMNativeArguments(use_double_precision=True),
                        device="cpu").compute_likelihoods(rd, hd)
    np.testing.assert_array_equal(scalar, double)
    np.testing.assert_allclose(tapi.PDHMM(device="cpu").compute_likelihoods(rd, hd), scalar,
                               rtol=0, atol=TOL_GOLDEN)
    one = tapi.PDHMM(tapi.PDHMMNativeArguments(parallel_setting=tapi.ParallelSetting.DISABLE),
                     device="cpu")
    assert one._effective_threads() == 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pdhmm_context_bit_equal(dtype):
    from gkl_tpu import context as jctx

    j, t = jctx.pdhmm_context(dtype), pdhmm_context(dtype)
    for name in ("qual_to_error_prob", "match_to_match", "INITIAL_CONDITION",
                 "INITIAL_CONDITION_LOG10"):
        a, b = np.asarray(getattr(j, name)), np.asarray(getattr(t, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    iq, dq = np.arange(256), np.arange(256)[::-1]
    assert j.set_mm_prob(iq, dq).tobytes() == t.set_mm_prob(iq, dq).tobytes()


def test_oracles_equal_jax():
    """The port's Python oracle and native batch oracle (the JAX package's
    port's copy of the C++) equal the JAX package's, bit for bit."""
    from gkl_tpu.ops import pdhmm_ref as jref

    cases = golden.load_pdhmm_cases("pdhmm_syn_990_1_2.txt")[:40]
    args = ([c.hap for c in cases], [c.hap_pd for c in cases], [c.read for c in cases],
            [(c.q, c.iq, c.dq, c.gcp) for c in cases])
    np.testing.assert_array_equal(pdhmm_ref.pdhmm_scalar_batch(*args, threads=2),
                                  jref.pdhmm_scalar_batch(*args, threads=2))
    for c in cases[:6]:
        a = (c.hap, c.hap_pd, c.read, c.q, c.iq, c.dq, c.gcp)
        assert pdhmm_ref.pdhmm_scalar(*a) == jref.pdhmm_scalar(*a)
