"""The port's multi-device layer (``gkl_tpu_torch.parallel``) against the JAX
package's ``gkl_tpu.parallel`` on the CPU: full-pattern packing, the mesh
and slice helpers, and every sharded engine on meshes of 1-8 CPU shards,
against the JAX engine of the same name on as many virtual CPU devices (its
Pallas kernels in interpret mode, lane_block=8) and bit for bit against the
port's unsharded call.  The SW and PDHMM engines are in
``test_torch_parallel_sw_pdhmm.py``, the APIs' ``mesh=`` and the thread cap
in ``test_torch_parallel_api.py``."""

import numpy as np
import pytest
import torch

from gkl_tpu import batch as jbatch
from gkl_tpu import parallel as jpar
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch import parallel as tpar
from gkl_tpu_torch.ops import pairhmm_cuda
from gkl_tpu_torch.parallel import mesh as tmesh
from torch_parallel_cases import (BASES, ENGINES, SHARDS, assert_equal, assert_scaled_close,
                                  check_sharded_engine, dense_planes, meshes, unpacked)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("engine", sorted(e for e in ENGINES if e.startswith("pairhmm")))
def test_sharded_engine(engine, n):
    """The PairHMM engines (rows, scaled, column and plain) on 1-8 CPU
    shards: bit for bit the unsharded call, close to the JAX engine
    (``torch_parallel_cases.check_sharded_engine``)."""
    check_sharded_engine(engine, n)


def _indexed_inputs(seed=3, n_haps=2, n_reads=32):
    rng = np.random.default_rng(seed)
    haps = [BASES[rng.integers(0, 4, int(rng.integers(16, 25)))] for _ in range(n_haps)]
    reads = [BASES[rng.integers(0, 4, 16)] for _ in range(n_reads)]
    rquals = [(rng.integers(20, 40, 16).astype(np.uint8),
               rng.integers(30, 45, 16).astype(np.uint8),
               rng.integers(30, 45, 16).astype(np.uint8),
               np.full(16, 10, np.uint8)) for _ in range(n_reads)]
    return haps, reads, rquals


@pytest.mark.parametrize("const", [None, (45, 45, 10)])
@pytest.mark.parametrize("lane_multiple", [8, 16, 64])
def test_full_pattern_packing_matches_jax(lane_multiple, const):
    """``pack_pairs_indexed(..., full_pattern=True)`` equals the JAX
    package's array for array, ``pattern_nh`` included."""
    haps, reads, rquals = _indexed_inputs(n_haps=4, n_reads=13)
    want = jbatch.pack_pairs_indexed(haps, reads, rquals, lane_multiple=lane_multiple,
                                     const_quals=const, full_pattern=True)
    got = tbatch.pack_pairs_indexed(haps, reads, rquals, lane_multiple=lane_multiple,
                                    const_quals=const, full_pattern=True)
    assert got.pattern_nh == want.pattern_nh == 4
    for f in ("hap_u", "readq_u", "quals_u", "ridx", "hidx", "haplen", "rslen"):
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None
        else:
            np.testing.assert_array_equal(getattr(got, f), np.asarray(w), err_msg=f)
    assert got.n_real == want.n_real and got.const_quals == want.const_quals
    assert tbatch.from_reference(want).pattern_nh == 4
    np.testing.assert_array_equal(got.ridx, np.arange(got.ridx.shape[0]) // 4)
    compact = tbatch.pack_pairs_indexed(haps, reads, rquals, lane_multiple=lane_multiple,
                                        const_quals=const)
    assert compact.pattern_nh is None
    assert_equal([compact.materialize().read[:, :compact.n_real]],
                  [got.materialize().read[:, :got.n_real]])


def test_full_pattern_needs_nh_to_divide_the_lanes():
    haps, reads, rquals = _indexed_inputs(n_haps=3, n_reads=5)
    for pack in (jbatch.pack_pairs_indexed, tbatch.pack_pairs_indexed):
        with pytest.raises(ValueError, match="full_pattern"):
            pack(haps, reads, rquals, lane_multiple=8, full_pattern=True)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("const", [None, (45, 45, 10)])
def test_indexed_sharded_engine(n, const):
    """``pairhmm_scaled_indexed_sharded`` on a full-pattern batch: bit for
    bit the port's unsharded scaled kernel on the same batch, and the JAX
    engine's flags and results within 1e-5 in log10."""
    haps, reads, rquals = _indexed_inputs()
    jpk = jbatch.pack_pairs_indexed(haps, reads, rquals, lane_multiple=8 * 8,
                                    const_quals=const, full_pattern=True)
    tpk = tbatch.from_reference(jpk)
    jmesh, tm = meshes(n)
    got = tpar.pairhmm_scaled_indexed_sharded(tm, tpk)
    t = {k: torch.from_numpy(getattr(tpk, k)) for k in
         ("hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen")}
    whole = pairhmm_cuda.pairhmm_scaled(
        **t, const_quals=tpk.const_quals,
        quals_u=None if tpk.quals_u is None else torch.from_numpy(tpk.quals_u))
    np.testing.assert_array_equal(got, whole.numpy())
    with jmesh:
        want = np.asarray(jpar.pairhmm_scaled_indexed_sharded(jmesh, jpk, lane_block=8,
                                                              interpret=True))
    n_real = tpk.n_real
    assert_scaled_close(tuple(a[:n_real] for a in unpacked(got)),
                         (want[0][:n_real], want[1][:n_real], want[2][:n_real]))


def test_indexed_sharding_needs_full_pattern():
    haps, reads, rquals = _indexed_inputs()
    pk = tbatch.pack_pairs_indexed(haps, reads, rquals, lane_multiple=16)
    with pytest.raises(ValueError, match="full_pattern"):
        tpar.pairhmm_scaled_indexed_sharded(tpar.data_parallel_mesh(devices=["cpu"] * 2), pk)


def test_compact_indexed_slabs_equal_the_whole_batch():
    """A compact (not full-pattern) indexed batch on a mesh: each shard
    takes the unique columns its lanes use, and the result is the whole
    batch's bit for bit (the API's route when nh does not divide the
    lanes)."""
    haps, reads, rquals = _indexed_inputs(n_haps=3, n_reads=7)
    pk = tbatch.pack_pairs_indexed(haps, reads, rquals, lane_multiple=32)
    assert pk.pattern_nh is None
    got = tmesh.dispatch_pairhmm(tpar.data_parallel_mesh(devices=["cpu"] * 4), pk,
                                 pairhmm_cuda.pairhmm_scaled).wait()
    t = {k: torch.from_numpy(getattr(pk, k)) for k in
         ("hap_u", "readq_u", "quals_u", "ridx", "hidx", "haplen", "rslen")}
    np.testing.assert_array_equal(got, pairhmm_cuda.pairhmm_scaled(**t).numpy())


def _pdhmm_indexed(rng, n_haps=3, n_reads=5):
    haps = [BASES[rng.integers(0, 4, int(rng.integers(16, 25)))] for _ in range(n_haps)]
    pds = [np.zeros(len(h), np.uint8) for h in haps]
    reads = [BASES[rng.integers(0, 4, 16)] for _ in range(n_reads)]
    quals = [tuple(rng.integers(lo, 45, 16).astype(np.uint8) for lo in (20, 30, 30, 10))
             for _ in range(n_reads)]
    ridx = np.repeat(np.arange(n_reads), n_haps)
    hidx = np.tile(np.arange(n_haps), n_reads)
    return tbatch.pack_pdhmm_indexed(haps, pds, reads, quals, ridx, hidx, lane_multiple=8)


@pytest.mark.parametrize("kernel", ["pairhmm_scaled", "pdhmm"])
def test_one_entry_dispatch_passes_the_planes_whole(monkeypatch, kernel):
    """On a one-entry mesh (how an engine without a mesh launches) the
    packed planes reach the kernel as they are: no unique pass, the same
    arrays, and the kernel's result on the whole batch."""
    from gkl_tpu_torch.ops import pdhmm_cuda

    def refuse(*args):
        raise AssertionError("one slab needs no unique pass")
    monkeypatch.setattr(tmesh, "_compacted", refuse)
    seen = []
    real = tmesh.launch_lanes

    def spy(mesh, n_lanes, inputs, kern, **kw):
        seen.append(inputs(0, slice(0, n_lanes)))
        return real(mesh, n_lanes, inputs, kern, **kw)
    monkeypatch.setattr(tmesh, "launch_lanes", spy)
    one = tmesh.engine_mesh(None, "cpu")
    assert one.devices == (torch.device("cpu"),) and tmesh.engine_mesh(None, "cpu") is one
    if kernel == "pdhmm":
        pk = _pdhmm_indexed(np.random.default_rng(4))
        got = tmesh.dispatch_pdhmm(one, pk, pdhmm_cuda.pdhmm).wait()
        names = ("hap_u", "happd_u", "readq_u", "ridx", "hidx", "haplen", "rslen")
        want = pdhmm_cuda.pdhmm(**{k: torch.from_numpy(getattr(pk, k)) for k in names})
    else:
        haps, reads, rquals = _indexed_inputs(n_haps=3, n_reads=7)
        pk = tbatch.pack_pairs_indexed(haps, reads, rquals, lane_multiple=8)
        got = tmesh.dispatch_pairhmm(one, pk, pairhmm_cuda.pairhmm_scaled).wait()
        names = ("hap_u", "readq_u", "quals_u", "ridx", "hidx", "haplen", "rslen")
        want = pairhmm_cuda.pairhmm_scaled(**{k: torch.from_numpy(getattr(pk, k))
                                              for k in names})
    assert sorted(seen[0]) == sorted(names)
    assert all(seen[0][k] is getattr(pk, k) for k in names)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("n", [1, 3, 8])
def test_data_parallel_mesh_matches_jax(n):
    """``data_parallel_mesh`` over n given devices: the JAX mesh's size,
    axis names and shape; one process owns every entry."""
    want = jpar.data_parallel_mesh(n)
    got = tpar.data_parallel_mesh(devices=["cpu"] * n)
    assert (got.size, got.axis_names, dict(got.shape)) == (
        want.size, tuple(want.axis_names), dict(want.shape))
    assert got.processes == (0,) * n and not tpar.is_multiprocess(got)
    assert got.local_entries() == [(k, torch.device("cpu")) for k in range(n)]


def test_data_parallel_mesh_needs_a_card_or_devices(monkeypatch):
    """With no CUDA device and no ``devices=`` it raises (it never builds a
    CPU mesh on its own); with cards it takes them all, or the first
    ``n_devices``; ``cuda`` is normalised to the current card's index."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.data_parallel_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert tpar.data_parallel_mesh().devices == tuple(cuda)
    assert tpar.data_parallel_mesh(2).devices == tuple(cuda[:2])
    assert tpar.data_parallel_mesh(devices=["cuda", "cuda:0"]).devices == (cuda[0],) * 2


def test_mesh_entries_of_a_process_are_contiguous():
    with pytest.raises(ValueError, match="contiguous"):
        tmesh.Mesh((torch.device("cpu"),) * 3, (0, 1, 0))
    with pytest.raises(ValueError):
        tmesh.Mesh((), ())


@pytest.mark.parametrize("n_total", [64, 8, 1])
def test_host_local_slice_matches_jax(n_total):
    want = jpar.host_local_slice(n_total)
    got = tpar.host_local_slice(n_total)
    assert (got.start, got.stop) == (want.start, want.stop) == (0, n_total)


def test_initialize_single_process_noop():
    tpar.initialize(num_processes=1)
    tpar.initialize()
    assert not torch.distributed.is_initialized()


def test_global_arrays_round_trip():
    """``make_global_array`` cuts this process's block over its entries,
    ``replicate_to_host`` gives it back whole; as the JAX package's."""
    tm = tpar.global_mesh(local_devices=["cpu"] * 4)
    assert tm.size == 4 and tpar.global_mesh(local_devices=["cpu"] * 4) is tm
    shard = np.arange(16 * 4 * 4, dtype=np.float32).reshape(16, 4 * 4)
    arr = tpar.make_global_array(shard, tm, axis=-1)
    want = jpar.make_global_array(shard, jpar.global_mesh(), axis=-1)
    assert arr.shape == tuple(want.shape) == shard.shape
    assert [s.shape for s in arr.shards] == [(16, 4)] * 4
    np.testing.assert_array_equal(tpar.replicate_to_host(arr, tm), shard)
    rep = tpar.make_replicated_array(shard[:, :3], tm)
    assert len(rep.shards) == 4 and rep.axis is None
    np.testing.assert_array_equal(tpar.replicate_to_host(rep, tm), shard[:, :3])


def test_shard_pairs_cuts_lanes():
    planes = dense_planes()
    tm = tpar.data_parallel_mesh(devices=["cpu"] * 4)
    parts = tpar.shard_pairs(tm, tbatch.PackedPairs(*planes[:8], n_real=40))
    assert [p.n_real for p in parts] == [16, 16, 8, 0]
    for k, part in enumerate(parts):
        np.testing.assert_array_equal(part.hap.numpy(), planes[0][:, 16 * k:16 * (k + 1)])
        np.testing.assert_array_equal(part.rslen.numpy(), planes[7][16 * k:16 * (k + 1)])


def test_lane_split_enters_each_shard_device(monkeypatch):
    """Every CUDA shard's launch runs under ``torch.cuda.device`` of its own
    entry and on a stream of its own: the ctypes launchers take a stream
    but no device, so a shard on cuda:1 launched while cuda:0 is current
    would run on the wrong context.  The CUDA calls are faked on the CPU;
    the kernel records the device context it was called in."""
    entered, streams, calls = [], [], []

    class FakeDevice:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            entered.pop()

    class FakeStreamContext:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            streams.append(self.stream)

        def __exit__(self, *exc):
            streams.pop()

    class FakeEvent:
        def record(self, stream=None):
            pass

        def synchronize(self):
            pass

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "stream", FakeStreamContext)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(tmesh, "_shard_stream", lambda dev, k: ("stream", str(dev), k))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    real_to, real_empty = torch.Tensor.to, torch.empty
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **kw: real_to(self, "cpu"))
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **kw: real_empty(*a, **kw))

    def kernel(x):
        calls.append((entered[-1], streams[-1]))
        return x * 2

    mesh = tmesh.Mesh(tuple(torch.device(d) for d in ("cuda:0", "cuda:1", "cuda:1", "cuda:3")),
                      (0,) * 4)
    x = np.arange(16, dtype=np.int32)
    out = tmesh.launch_lanes(mesh, 16, lambda k, sl: {"x": x[sl]}, kernel).wait()
    np.testing.assert_array_equal(out, x * 2)
    assert calls == [(torch.device("cuda", d), ("stream", f"cuda:{d}", k))
                     for k, d in enumerate((0, 1, 1, 3))]
    assert entered == [] and streams == []


def test_lane_split_trace_and_uneven_lanes():
    """Lanes that do not split evenly raise; a CPU mesh records no trace
    (CUDA events exist only for CUDA shards)."""
    tm = tpar.data_parallel_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="split evenly"):
        tmesh.launch_lanes(tm, 16, lambda k, sl: {}, lambda: None)
    tmesh.TRACE = []
    try:
        out = tmesh.launch_lanes(tm, 6, lambda k, sl: {"x": np.arange(6)[sl]},
                                 lambda x: x + 1).wait()
        assert tmesh.TRACE == []
    finally:
        tmesh.TRACE = None
    np.testing.assert_array_equal(out, np.arange(1, 7))
