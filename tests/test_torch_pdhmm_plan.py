"""PDHMM's host path on the unique planes, on the CPU twin: the forward
fill of the column states against the JAX package's loop, the lane order
ranked once a unique haplotype against the pair-by-pair sort, each slice's
pack against ``batch.pack_pdhmm_indexed`` of the slice's planes found by
identity, the object path bit for bit the flat path, and the
``pdhmm_unique`` counter."""

import numpy as np
import pytest
import torch

from gkl_tpu.ops import pdhmm as jpd
from gkl_tpu_torch import PDHaplotypeData, PDHMM, PDHMMNativeArguments, ReadData, profiling
from gkl_tpu_torch import api_pdhmm
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.ops import pdhmm as tpd
from gkl_tpu_torch.ops import pdhmm_cuda

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _fresh_metrics():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.METRICS.reset()
    yield
    profiling.METRICS.reset()
    torch.set_num_threads(n)


def _pd_random(rng):
    return rng.integers(0, 256, (48, 16)).astype(np.uint8)


def _pd_start_and_end_in_one_byte(rng):
    pd = np.zeros((24, 6), np.uint8)
    pd[5, :3] = tpd.DEL_START | tpd.DEL_END
    pd[9, 3:] = tpd.DEL_START | tpd.DEL_END | tpd.SNP
    pd[12, 1] = tpd.DEL_START
    return pd


def _pd_adjacent_events(rng):
    pd = np.zeros((20, 5), np.uint8)
    pd[3:9, 0] = [tpd.DEL_START, tpd.DEL_END, tpd.DEL_START, tpd.DEL_START, tpd.DEL_END,
                  tpd.DEL_END]
    pd[4:8, 1] = tpd.DEL_END
    pd[4:8, 2] = tpd.DEL_START
    pd[6:10, 3] = [tpd.SNP | 8, tpd.DEL_START, tpd.SNP, tpd.DEL_END]
    return pd


def _pd_first_and_last_column(rng):
    pd = np.zeros((16, 4), np.uint8)
    pd[0, 0] = tpd.DEL_START
    pd[0, 1] = tpd.DEL_END
    pd[-1, 2] = tpd.DEL_START
    pd[-1, 3] = tpd.DEL_END
    pd[0, 3] = tpd.DEL_START
    return pd


def _pd_all_zero(rng):
    pd = np.zeros((32, 8), np.uint8)
    pd[7, 2] = tpd.SNP | 16  # a SNP only: no jump state
    return pd


def _pd_one_column(rng):
    return np.array([[0, tpd.DEL_START, tpd.DEL_END, tpd.DEL_START | tpd.DEL_END]], np.uint8)


@pytest.mark.parametrize("case", [_pd_random, _pd_start_and_end_in_one_byte,
                                  _pd_adjacent_events, _pd_first_and_last_column,
                                  _pd_all_zero, _pd_one_column])
def test_column_states_equal_the_jax_loop(case):
    """The forward fill equals ``gkl_tpu.ops.pdhmm.column_states``, the
    column-by-column loop."""
    pd = case(np.random.default_rng(0))
    want = jpd.column_states(pd)
    got = tpd.column_states(pd)
    assert got.dtype == np.uint8 and got.shape == pd.shape
    np.testing.assert_array_equal(got, want)


def _objects(seed=3, n_reads=10):
    """Reads and PD haplotypes of the object path: haplotypes 0 and 2 have
    equal bytes in two objects, haplotypes 1 and 3 no event, and reads 2
    and 7 are one object, as are reads 4 and 8's arrays."""
    rng = np.random.default_rng(seed)
    base = BASES[rng.integers(0, 4, 60)]
    pd_a = np.zeros(60, np.uint8)
    pd_a[20], pd_a[26] = tpd.DEL_START, tpd.DEL_END
    pd_b = np.zeros(44, np.uint8)
    pd_b[9] = tpd.SNP | 32
    haps = [PDHaplotypeData(base.copy(), haplotype_pdbases=pd_a.copy()),
            PDHaplotypeData(base[:52].copy(), haplotype_pdbases=np.zeros(52, np.uint8)),
            PDHaplotypeData(base.copy(), haplotype_pdbases=pd_a.copy()),
            PDHaplotypeData(base[8:].copy(), haplotype_pdbases=np.zeros(52, np.uint8)),
            PDHaplotypeData(base[:44].copy(), haplotype_pdbases=pd_b)]
    reads = []
    for _ in range(n_reads):
        n = int(rng.integers(12, 40))
        start = int(rng.integers(0, 60 - n))
        read = base[start:start + n].copy()
        read[rng.integers(0, n, 2)] = BASES[rng.integers(0, 4, 2)]
        reads.append(ReadData(read, rng.integers(10, 40, n).astype(np.uint8),
                              *(np.full(n, v, np.uint8) for v in (45, 45, 10))))
    reads[7] = reads[2]
    reads[8] = ReadData(reads[4].read_bases, reads[4].read_quals, reads[4].insertion_gop,
                        reads[4].deletion_gop, reads[4].overall_gcp)
    return reads, haps


def _pairs(reads, haps):
    """The read-major cross product as per-pair lists."""
    return ([h.haplotype_bases for _ in reads for h in haps],
            [h.haplotype_pdbases for _ in reads for h in haps],
            [r.read_bases for r in reads for _ in haps],
            [(r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp)
             for r in reads for _ in haps])


def _pair_order(haps, pds):
    """The lane order as the pair-by-pair sort gave it."""
    return sorted(range(len(haps)), key=lambda i: (
        tpd.lane_event_key(pds[i]), haps[i].tobytes(), pds[i].tobytes()))


def _identity_dedup(haps, pds, reads, quals):
    """A slice's unique planes found by the identity of their arrays, in
    the order of their first lane, and each lane's columns."""
    hmap, rmap = {}, {}
    uh, upd, ur, uq, ridx, hidx = [], [], [], [], [], []
    for h, pd, r, qs in zip(haps, pds, reads, quals):
        hk, rk = (id(h), id(pd)), (id(r),) + tuple(map(id, qs))
        if hk not in hmap:
            hmap[hk] = len(uh)
            uh.append(h)
            upd.append(pd)
        if rk not in rmap:
            rmap[rk] = len(ur)
            ur.append(r)
            uq.append(qs)
        hidx.append(hmap[hk])
        ridx.append(rmap[rk])
    return uh, upd, ur, uq, ridx, hidx


def _spy(monkeypatch):
    """Record each slice's lanes (``_run_indexed``'s indices into the
    call's planes) and packed batch."""
    seen = {"lanes": [], "packs": []}
    run, pack = PDHMM._run_indexed, tbatch.pack_pdhmm_lanes

    def run_spy(self, ridx, hidx, planes, *rest):
        seen["lanes"].append((ridx, hidx, planes))
        return run(self, ridx, hidx, planes, *rest)

    def pack_spy(*a, **kw):
        out = pack(*a, **kw)
        seen["packs"].append(out[0])
        return out
    monkeypatch.setattr(PDHMM, "_run_indexed", run_spy)
    monkeypatch.setattr(tbatch, "pack_pdhmm_lanes", pack_spy)
    return seen


def _small_slices(monkeypatch):
    """About 19 lanes a MiB: under ``max_memory_in_mb=1``, 16-lane slices."""
    monkeypatch.setattr(pdhmm_cuda, "boundary_bytes_per_lane",
                        lambda R, H, dtype="float32": (1 << 20) // 20)
    return PDHMMNativeArguments(max_memory_in_mb=1)


@pytest.mark.parametrize("budget", [512, 1])
def test_lane_order_equals_the_pair_sort(monkeypatch, budget):
    """The lanes, ranked once a unique haplotype and sorted stably, come in
    the order of the pair-by-pair sort, each lane on its own pair's read
    and haplotype planes."""
    reads, haps = _objects()
    args = _small_slices(monkeypatch) if budget == 1 else PDHMMNativeArguments()
    seen = _spy(monkeypatch)
    PDHMM(args, device="cpu").compute_likelihoods(reads, haps)
    h, pd, r, q = _pairs(reads, haps)
    order = _pair_order(h, pd)
    lanes = [(pl, int(ri), int(hi)) for ridx, hidx, pl in seen["lanes"]
             for ri, hi in zip(ridx, hidx)]
    assert len(lanes) == len(order) and len(seen["lanes"]) == (4 if budget == 1 else 1)
    for k, (pl, ri, hi) in zip(order, lanes):
        assert pl.haps[hi] is h[k] and pl.hap_pds[hi] is pd[k]
        assert pl.reads[ri] is r[k] and all(a is b for a, b in zip(pl.quals[ri], q[k]))


def test_slice_packs_equal_pack_of_the_identity_dedup(monkeypatch):
    """With at least two slices, each slice's batch is byte for byte
    ``batch.pack_pdhmm_indexed`` of its planes deduplicated by identity,
    pair by pair in lane order, and its lazy column states are the JAX
    package's."""
    reads, haps = _objects()
    seen = _spy(monkeypatch)
    PDHMM(_small_slices(monkeypatch), device="cpu").compute_likelihoods(reads, haps)
    h, pd, r, q = _pairs(reads, haps)
    order = _pair_order(h, pd)
    assert len(seen["packs"]) >= 2
    start = 0
    for pk in seen["packs"]:
        lanes = order[start:start + pk.n_real]
        start += pk.n_real
        want = tbatch.pack_pdhmm_indexed(*_identity_dedup(
            [h[k] for k in lanes], [pd[k] for k in lanes], [r[k] for k in lanes],
            [q[k] for k in lanes]))
        for f in ("hap_u", "happd_u", "readq_u", "ridx", "hidx", "haplen", "rslen"):
            np.testing.assert_array_equal(getattr(pk, f), getattr(want, f), err_msg=f)
            assert getattr(pk, f).dtype == getattr(want, f).dtype
        assert pk.n_real == want.n_real
        np.testing.assert_array_equal(pk.states_u, jpd.column_states(pk.happd_u))
    assert start == len(order)


@pytest.mark.parametrize("budget", [512, 1])
def test_object_path_is_bit_for_bit_the_flat_path(monkeypatch, budget):
    """``compute_likelihoods`` equals ``compute_pdhmm`` on the flattened
    read-major cross product, bit for bit, in one slice and in several."""
    reads, haps = _objects(seed=5, n_reads=12)
    args = _small_slices(monkeypatch) if budget == 1 else PDHMMNativeArguments()
    h, pd, r, q = _pairs(reads, haps)
    H, R = max(map(len, h)), max(map(len, r))

    def rows(seqs, width):
        out = np.zeros((len(seqs), width), np.uint8)
        for k, s in enumerate(seqs):
            out[k, :len(s)] = s
        return out
    flat = PDHMM(args, device="cpu").compute_pdhmm(
        rows(h, H), rows(pd, H), rows(r, R), *(rows([qs[k] for qs in q], R) for k in range(4)),
        [len(s) for s in h], [len(s) for s in r])
    got = PDHMM(args, device="cpu").compute_likelihoods(reads, haps)
    assert got.shape == flat.shape == (len(reads) * len(haps),)
    np.testing.assert_array_equal(got.view(np.int64), flat.view(np.int64))


@pytest.mark.parametrize("metrics", ["1", None])
def test_unique_planes_counter(monkeypatch, metrics):
    """Metrics on, ``pdhmm_unique`` counts each slice's unique read planes
    plus unique haplotype planes, and ``pdhmm_pack`` the slice's lanes; off,
    nothing is recorded."""
    if metrics:
        monkeypatch.setenv("GKL_TPU_METRICS", metrics)
    else:
        monkeypatch.delenv("GKL_TPU_METRICS", raising=False)
    reads, haps = _objects()
    PDHMM(_small_slices(monkeypatch), device="cpu").compute_likelihoods(reads, haps)
    snap = profiling.METRICS.snapshot()
    if not metrics:
        assert snap == {}
        return
    h, pd, r, q = _pairs(reads, haps)
    order = _pair_order(h, pd)
    slices = [order[s:s + 16] for s in range(0, len(order), 16)]
    unique = sum(len({id(r[k]) for k in lanes}) + len({id(h[k]) for k in lanes})
                 for lanes in slices)
    assert snap["pdhmm_unique"]["calls"] == len(slices) == 4
    assert snap["pdhmm_unique"]["items"] == unique
    assert snap["pdhmm_pack"]["items"] == len(order)
    # reads 2 and 7 are one object, 4 and 8 share their arrays; haplotypes
    # 0 and 2 are two objects with equal bytes
    assert unique < len(order)


def test_rescue_gathers_only_its_lanes(monkeypatch):
    """The f64 rescue takes the lanes below MIN_ACCEPTED alone, a launch a
    slice, their planes packed from the call's unique planes, and its
    results are theirs: bit for bit the f64 engine on the pairs packed one
    by one, within 1e-9 of the host oracle."""
    reads, haps = _objects()
    monkeypatch.setattr(api_pdhmm, "MIN_ACCEPTED", np.inf)
    calls = []
    real = pdhmm_cuda.pdhmm_f64
    monkeypatch.setattr(pdhmm_cuda, "pdhmm_f64",
                        lambda **t: calls.append(int(t["ridx"].shape[0])) or real(**t))
    got = PDHMM(_small_slices(monkeypatch), device="cpu").compute_likelihoods(reads, haps)
    h, pd, r, q = _pairs(reads, haps)
    assert calls == [16, 16, 16, 8]  # 2 lanes, padded to the lane multiple
    lanes = np.arange(len(h))
    pk = tbatch.pack_pdhmm_indexed(h, pd, r, q, lanes, lanes, lane_multiple=1)
    raw = real(**{k: torch.from_numpy(getattr(pk, k)) for k in (
        "hap_u", "happd_u", "readq_u", "ridx", "hidx", "haplen", "rslen")}).numpy()
    want = np.log10(raw) - api_pdhmm.pdhmm_context("float64").INITIAL_CONDITION_LOG10
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, api_pdhmm.pdhmm_ref.pdhmm_scalar_batch(h, pd, r, q),
                               rtol=0, atol=1e-9)
