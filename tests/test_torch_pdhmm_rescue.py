"""PDHMM's f64 rescue through the kernel's f64 instance, on the CPU.

``PDHMM(device="cpu")`` recomputes every lane whose f32 result falls below
``MIN_ACCEPTED`` by the card's own path (``batch.pack_pdhmm_lanes``,
``parallel.mesh.dispatch_pdhmm`` with ``ops.pdhmm_cuda.pdhmm_f64``), whose
CPU engine is the kernel's twin in its order of operations in f64.  Held
here to the host oracle (``native/pdhmm_oracle.cc``) at 1e-9 in log10: on
lanes below MIN_ACCEPTED, on long lanes of several f64 passes against
haplotypes past 2,048 bases, and on lanes whose f64 result is subnormal;
slices with no rescued lane launch nothing; the ``pdhmm_card_rescue``
counter and its metric's reader; the oracle modes keep the oracle.
Imports neither JAX nor the JAX package."""

import numpy as np
import pytest
import torch

import golden
from bench_port.harness import spec
from gkl_tpu_torch import (MIN_ACCEPTED, KernelLevel, PDHaplotypeData, PDHMM,
                           PDHMMNativeArguments, ReadData, parallel, profiling)
from gkl_tpu_torch import api_pdhmm
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.context import pdhmm_context
from gkl_tpu_torch.ops import pdhmm as tpd
from gkl_tpu_torch.ops import pdhmm_cuda, pdhmm_ref
from gkl_tpu_torch.parallel import mesh as tmesh

BASES = np.frombuffer(b"ACGT", np.uint8)
TOL_F64 = 1e-9
TOL_GOLDEN = 1e-4
PLANES = ("hap_u", "happd_u", "readq_u", "ridx", "hidx", "haplen", "rslen")


@pytest.fixture(autouse=True)
def _metrics(monkeypatch):
    """One torch thread, metrics on and cleared around each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    profiling.METRICS.reset()
    yield
    profiling.METRICS.reset()
    torch.set_num_threads(n)


def _region(seed, n_haps=3, hap_len=(40, 70), read_len=(20, 45), n_reads=6, deep_every=3,
            deep_len=100):
    """Haplotypes with PD events (a deletion and a PD SNP on all but the
    first), reads from their windows with 3% substitutions, and every
    ``deep_every``-th read (from the first) random at high qualities, far
    below MIN_ACCEPTED against every haplotype."""
    rng = np.random.default_rng(seed)
    haps = []
    for i in range(n_haps):
        h = BASES[rng.integers(0, 4, int(rng.integers(*hap_len)))]
        pd = np.zeros(len(h), np.uint8)
        if i:
            j = int(rng.integers(4, len(h) - 10))
            pd[j], pd[j + 3], pd[j + 6] = 2, 4, 1 | 16
        haps.append(PDHaplotypeData(h, haplotype_pdbases=pd))
    reads = []
    for r in range(n_reads):
        h = haps[r % n_haps].haplotype_bases
        if deep_every and r % deep_every == 0:
            seq, q = BASES[rng.integers(0, 4, deep_len)], rng.integers(30, 50, deep_len)
        else:
            n = int(rng.integers(*read_len))
            start = int(rng.integers(0, max(1, len(h) - n)))
            seq = np.resize(h[start:], n).copy()
            mut = rng.random(n) < 0.03
            seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
            q = rng.integers(20, 40, n)
        n = len(seq)
        reads.append(ReadData(seq, q.astype(np.uint8), np.full(n, 45, np.uint8),
                              np.full(n, 45, np.uint8), np.full(n, 10, np.uint8)))
    return reads, haps


def _spies(monkeypatch):
    """Record each f32 slice's raw results, each ``_rescue``'s lanes and
    each f64 launch's lane count, and refuse the host oracle."""
    seen = {"raw": [], "rescued": [], "f64": []}
    run, rescue, f64 = PDHMM._run_indexed, PDHMM._rescue, pdhmm_cuda.pdhmm_f64

    def run_spy(self, *a):
        seen["raw"].append(run(self, *a))
        return seen["raw"][-1]

    def rescue_spy(self, ridx, hidx, planes):
        seen["rescued"].append(list(zip(ridx.tolist(), hidx.tolist())))
        return rescue(self, ridx, hidx, planes)

    def no_oracle(*a, **kw):
        raise AssertionError("the f32 mode's rescue ran the host oracle")

    monkeypatch.setattr(PDHMM, "_run_indexed", run_spy)
    monkeypatch.setattr(PDHMM, "_rescue", rescue_spy)
    monkeypatch.setattr(pdhmm_cuda, "pdhmm_f64",
                        lambda **t: seen["f64"].append(int(t["ridx"].shape[0])) or f64(**t))
    monkeypatch.setattr(pdhmm_ref, "pdhmm_scalar_batch", no_oracle)
    return seen


# the host oracle, held before any test patches it
ORACLE = pdhmm_ref.pdhmm_scalar_batch


def _pair_lists(reads, haps):
    """The read-major cross product as the oracle's per-pair lists."""
    pairs = [(h, r) for r in reads for h in haps]
    return ([h.haplotype_bases for h, _ in pairs], [h.haplotype_pdbases for h, _ in pairs],
            [r.read_bases for _, r in pairs],
            [(r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp) for _, r in pairs])


def _below(seen) -> int:
    return sum(int(np.sum(raw < MIN_ACCEPTED)) for raw in seen["raw"])


def test_rescue_runs_the_f64_kernel_on_exactly_the_lanes_below_min_accepted(monkeypatch):
    """The lanes whose f32 result is below MIN_ACCEPTED, and no others, go
    through one f64 launch of their slice (never the host oracle); the
    ``pdhmm_card_rescue`` counter counts them as ``pdhmm_rescue`` does; the
    rescued lanes come within 1e-9 in log10 of the oracle, and the other
    lanes keep their f32 results."""
    reads, haps = _region(6)
    seen = _spies(monkeypatch)
    got = PDHMM(device="cpu").compute_likelihoods(reads, haps)
    raw = seen["raw"][0]
    assert len(seen["raw"]) == 1 and seen["f64"] == [tbatch.bucket_lanes(_below(seen))]
    below = np.nonzero(raw < MIN_ACCEPTED)[0]
    assert 0 < len(below) < len(got)
    snap = profiling.METRICS.snapshot()
    assert snap["pdhmm_card_rescue"] == {**snap["pdhmm_card_rescue"], "calls": 1,
                                         "items": len(below)}
    assert snap["pdhmm_rescue"]["items"] == len(below)
    exact = ORACLE(*_pair_lists(reads, haps))
    rescued = exact < float(np.log10(MIN_ACCEPTED)
                            - pdhmm_context("float32").INITIAL_CONDITION_LOG10) - 0.5
    assert rescued.sum() and len(seen["rescued"][0]) == len(below)
    np.testing.assert_allclose(got[rescued], exact[rescued], rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(got, exact, rtol=0, atol=TOL_GOLDEN)


def test_rescued_pairs_are_the_lanes_below_min_accepted(monkeypatch):
    """The (read, haplotype) pairs the rescue takes are those whose f32
    result in the slice is below MIN_ACCEPTED, lane for lane, in every
    slice of a cut budget."""
    reads, haps = _region(8, n_reads=12)
    seen = _spies(monkeypatch)
    real_slices = PDHMM._slices
    lanes = []

    def slices_spy(self, ridx, hidx, planes, dtype):
        if dtype == "float32":
            lanes.append((ridx, hidx))
        return real_slices(self, ridx, hidx, planes, dtype)

    monkeypatch.setattr(PDHMM, "_slices", slices_spy)
    monkeypatch.setattr(pdhmm_cuda, "boundary_bytes_per_lane",
                        lambda R, H, dtype="float32": (1 << 20) // 20)
    PDHMM(PDHMMNativeArguments(max_memory_in_mb=1), device="cpu").compute_likelihoods(
        reads, haps)
    ridx, hidx = lanes[0]
    want, start = [], 0
    for raw in seen["raw"]:
        ks = np.nonzero(raw < MIN_ACCEPTED)[0] + start
        if len(ks):
            want.append(list(zip(ridx[ks].tolist(), hidx[ks].tolist())))
        start += len(raw)
    assert len(seen["raw"]) == 3 and len(want) >= 2
    assert seen["rescued"] == want
    assert profiling.METRICS.snapshot()["pdhmm_card_rescue"]["items"] == _below(seen)


def test_rescue_of_multi_pass_lanes_past_2048_columns(monkeypatch):
    """Reads of 300-330 rows (three passes of the f64 instance's 128) and
    random reads of 300 rows against haplotypes of 2,100-2,200 bases: the
    rescued lanes within 1e-9 in log10 of the oracle."""
    reads, haps = _region(9, n_haps=2, hap_len=(2100, 2200), read_len=(300, 331), n_reads=2,
                          deep_every=2, deep_len=300)
    seen = _spies(monkeypatch)
    got = PDHMM(device="cpu").compute_likelihoods(reads, haps)
    rescued = [k for lanes in seen["rescued"] for k in lanes]
    assert len(rescued) >= 2 and seen["f64"]
    R = tbatch.bucket_length(300)
    H = tbatch.bucket_length(2200)
    assert H > 2048 and pdhmm_cuda.pdhmm_geometry(R, "float64") == (4, 128, 3)
    assert pdhmm_cuda.boundary_bytes_per_lane(R, H, "float64") == 48 * H
    exact = ORACLE(*_pair_lists(reads, haps))
    deep = got < -40
    assert deep.sum() >= len(rescued)
    np.testing.assert_allclose(got[deep], exact[deep], rtol=0, atol=TOL_F64)


def test_rescue_keeps_f64_subnormals(monkeypatch):
    """The golden file's deepest lanes, whose f64 raw result lies in the
    subnormal range (log10 likelihood under -615), and some shallower
    ones: the rescue keeps gradual underflow, within 1e-9 in log10 of the
    oracle and 1e-4 of the file."""
    cases = golden.load_pdhmm_cases("pdhmm_syn_1412_129_223.txt")
    expected = np.array([c.expected for c in cases])
    tiny = float(np.log10(np.finfo(np.float64).tiny)
                 - pdhmm_context("float64").INITIAL_CONDITION_LOG10)
    pick = list(np.argsort(expected)[:4]) + [0, 1, 2]
    cases = [cases[k] for k in pick]
    args = ([c.hap for c in cases], [c.hap_pd for c in cases], [c.read for c in cases],
            [(c.q, c.iq, c.dq, c.gcp) for c in cases])
    seen = _spies(monkeypatch)
    got = PDHMM(device="cpu")._compute_pairs(*args, on=True)
    assert seen["f64"] and sum(map(len, seen["rescued"])) == len(cases)
    assert (got < tiny).sum() >= 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ORACLE(*args), rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(got, [c.expected for c in cases], rtol=0, atol=TOL_GOLDEN)


@pytest.mark.parametrize("deep", [False, True], ids=["no_slice_rescues", "one_slice_rescues"])
def test_slices_without_rescued_lanes_launch_nothing(monkeypatch, deep):
    """Slices whose lanes all stay at or above MIN_ACCEPTED launch no f64
    kernel and record neither rescue counter; with one deep read, the last
    of 20 against one haplotype (two slices of 16 and 4 lanes), only its
    slice launches."""
    reads, haps = _region(10, n_haps=1, n_reads=20, deep_every=0)
    if deep:
        reads[-1] = _region(10, n_reads=1, deep_every=1)[0][0]
    seen = _spies(monkeypatch)
    monkeypatch.setattr(pdhmm_cuda, "boundary_bytes_per_lane",
                        lambda R, H, dtype="float32": (1 << 20) // 20)
    PDHMM(PDHMMNativeArguments(max_memory_in_mb=1), device="cpu").compute_likelihoods(
        reads, haps)
    snap = profiling.METRICS.snapshot()
    rescuing = [raw for raw in seen["raw"] if (raw < MIN_ACCEPTED).any()]
    assert len(seen["raw"]) == 2 and len(rescuing) == (1 if deep else 0)
    assert len(seen["f64"]) == len(seen["rescued"]) == len(rescuing)
    assert ("pdhmm_card_rescue" in snap) == ("pdhmm_rescue" in snap) == deep


def test_rescue_budget_counts_the_f64_boundary():
    """The rescue's slices count the f64 pass boundary (48 bytes a column):
    under a budget that holds one f32 slice, the same lanes take more f64
    slices, each within the budget."""
    reads, haps = _region(11, n_haps=2, hap_len=(1000, 1001), read_len=(300, 301),
                          n_reads=40, deep_every=0)
    engine = PDHMM(PDHMMNativeArguments(max_memory_in_mb=1), device="cpu")
    planes = api_pdhmm._Planes([h.haplotype_bases for h in haps],
                               [h.haplotype_pdbases for h in haps],
                               [r.read_bases for r in reads],
                               [(r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp)
                                for r in reads])
    ridx, hidx = np.repeat(np.arange(40), 2), np.tile(np.arange(2), 40)
    f32 = engine._slices(ridx, hidx, planes, "float32")
    f64 = engine._slices(ridx, hidx, planes, "float64")
    R, H = tbatch.bucket_length(300), tbatch.bucket_length(1000)
    per_lane = pdhmm_cuda.boundary_bytes_per_lane(R, H, "float64") + 5 * R + 2 * H + 16
    assert pdhmm_cuda.boundary_bytes_per_lane(R, H, "float64") == 2 * \
        pdhmm_cuda.boundary_bytes_per_lane(R, H)
    assert len(f64) > len(f32)
    assert all((sl.stop - sl.start) * per_lane <= 1 << 20 for sl in f64)
    assert sum(sl.stop - sl.start for sl in f64) == len(ridx)


@pytest.mark.parametrize("R", [1, 64, 65, 128, 129, 256, 512, 4608, 8192])
def test_f64_geometry(R):
    """The f64 instances: 2 rows a thread for reads of one 64-row pass, else
    4 rows (128 a pass) in as many passes as the read needs; the boundary
    planes only past one pass, 48 bytes a column."""
    rows, pass_rows, passes = pdhmm_cuda.pdhmm_geometry(R, "float64")
    assert rows == (2 if R <= 64 else 4) and pass_rows == 32 * rows
    assert passes == -(-R // pass_rows)
    assert pdhmm_cuda.boundary_bytes_per_lane(R, 1000, "float64") == (
        48 * 1000 if passes > 1 else 0)
    assert pdhmm_cuda.pdhmm_geometry(R) == pdhmm_cuda.pdhmm_geometry(R, "float32")


@pytest.mark.parametrize("P, passes, want", [(17, 40, 8), (4, 40, 8), (17, 3, 3), (17, 1, 1),
                                             (132, 40, 8), (264, 40, 4), (1412, 2, 1),
                                             (20000, 40, 1)])
def test_f64_lane_warps(P, passes, want):
    """A lane's warps in the f64 relay on a card of 132 SMs: up to 8 and no
    more than its passes, while the lanes' warps fit 8 an SM."""
    assert pdhmm_cuda.f64_lane_warps(P, passes, 132) == want


def test_f64_twin_in_kernel_order_equals_the_scan_twin():
    """On lanes in the normal range the f64 twin in the kernel's order and
    the f64 scan twin agree within 1e-12 in log10, and a lane alone is bit
    for bit the lane in the batch."""
    reads, haps = _region(12, n_reads=6, deep_every=3)
    h, pd, r, q = _pair_lists(reads, haps)
    lanes = np.arange(len(h))
    pk = tbatch.pack_pdhmm_indexed(h, pd, r, q, lanes, lanes)
    t = {k: torch.from_numpy(getattr(pk, k)) for k in PLANES}
    order = pdhmm_cuda.pdhmm_kernel_order(**t, dtype="float64").numpy()[:pk.n_real]
    scan = tpd.pdhmm_raw(*pdhmm_cuda.expand_indexed(*(t[k] for k in PLANES[:5])),
                         t["haplen"], t["rslen"], dtype="float64").numpy()[:pk.n_real]
    # lanes on both sides of the f32 rescue's bound, log10 1e-28 / 2^120
    bound = float(np.log10(MIN_ACCEPTED) - pdhmm_context("float32").INITIAL_CONDITION_LOG10)
    deep = np.log10(order) - pdhmm_context("float64").INITIAL_CONDITION_LOG10 < bound
    assert (order > 0).all() and deep.any() and not deep.all()
    np.testing.assert_allclose(np.log10(order), np.log10(scan), rtol=0, atol=1e-12)
    one = pdhmm_cuda.pdhmm_f64(**{k: (v[:1] if k in ("ridx", "hidx", "haplen", "rslen")
                                      else v) for k, v in t.items()})
    assert one.numpy().view(np.int64)[0] == order.view(np.int64)[0]


def test_dispatch_of_the_f64_kernel_on_a_cpu_mesh():
    """``dispatch_pdhmm`` with the f64 kernel on a CPU mesh of two entries:
    bit for bit the one-entry mesh."""
    reads, haps = _region(13, n_reads=6)
    h, pd, r, q = _pair_lists(reads, haps)
    lanes = np.arange(len(h))
    pk = tbatch.pack_pdhmm_lanes(h, pd, r, q, lanes, lanes, lane_multiple=16)[0]
    one = tmesh.dispatch_pdhmm(tmesh.engine_mesh(None, "cpu"), pk, pdhmm_cuda.pdhmm_f64).wait()
    two = tmesh.dispatch_pdhmm(parallel.data_parallel_mesh(devices=["cpu"] * 2), pk,
                               pdhmm_cuda.pdhmm_f64).wait()
    assert one.dtype == np.float64
    np.testing.assert_array_equal(one.view(np.int64), two.view(np.int64))


@pytest.mark.parametrize("mode", ["double", "scalar"])
def test_oracle_modes_keep_the_oracle(monkeypatch, mode):
    """``use_double_precision`` and ``KernelLevel.SCALAR`` run the host
    oracle alone: no f64 launch, no ``pdhmm_card_rescue``."""
    reads, haps = _region(14)
    f64, oracle = [], []
    real = pdhmm_cuda.pdhmm_f64
    monkeypatch.setattr(pdhmm_cuda, "pdhmm_f64", lambda **t: f64.append(1) or real(**t))
    monkeypatch.setattr(pdhmm_ref, "pdhmm_scalar_batch",
                        lambda *a, **kw: oracle.append(1) or ORACLE(*a, **kw))
    args = (PDHMMNativeArguments(use_double_precision=True) if mode == "double" else
            PDHMMNativeArguments(kernel_level=KernelLevel.SCALAR))
    got = PDHMM(args, device="cpu").compute_likelihoods(reads, haps)
    assert f64 == [] and oracle == [1]
    assert "pdhmm_card_rescue" not in profiling.METRICS.snapshot()
    np.testing.assert_array_equal(got, ORACLE(*_pair_lists(reads, haps)))


class _Run:
    def __init__(self, counters):
        self.counters = counters


@pytest.mark.parametrize("counters, want", [
    ({"pdhmm_rescue": {"items": 40}, "pdhmm_card_rescue": {"items": 40}}, 100.0),
    ({"pdhmm_rescue": {"items": 40}, "pdhmm_card_rescue": {"items": 10}}, 25.0),
    ({"pdhmm_rescue": {"items": 40}}, None),
    ({}, None),
    (None, None)])
def test_card_rescue_pct_reader(counters, want):
    """``pdhmm.card_rescue_pct``: ``pdhmm_card_rescue`` items over
    ``pdhmm_rescue``'s; nothing where the run holds no rescue or no such
    counter (the port before the card's rescue)."""
    reader = spec.metric_reader("pdhmm.card_rescue_pct")
    assert reader.read(_Run(counters)) == want


def test_card_rescue_pct_is_declared_for_the_long_cell():
    """The metric is the long cell's alone: the only cell whose PDHMM
    lanes fall below MIN_ACCEPTED."""
    metric = next(m for m in spec.benchmark()["per_layer"]
                  if m["name"] == "pdhmm.card_rescue_pct")
    assert metric["workloads"] == ["hc_long_region.region"]
    assert metric["layer"] == "api_pdhmm.PDHMM" and metric["moves"] == "reads_per_s"
