"""The sequence-parallel PairHMM of ``gkl_tpu_torch.parallel.mesh`` on the
CPU against the JAX package: ``pairhmm_raw_sp`` on an ``sp`` mesh of CPU
entries against the JAX ``pairhmm_raw_sp`` on a JAX CPU mesh and against
the plain engines, the seeded data of ``tests/test_parallel.py``."""

import numpy as np
import pytest
import torch

from gkl_tpu.ops import pairhmm as jpairhmm_ops
from gkl_tpu.parallel import mesh as jmesh
from gkl_tpu_torch.ops import pairhmm as tpairhmm_ops
from gkl_tpu_torch.parallel import mesh as tmesh

BASES = np.frombuffer(b"ACGT", np.uint8)
NSP = (2, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(H=48, R=12, P=8, seed=9, haplen_lo=20):
    """``tests/test_parallel.py::test_pairhmm_sp_column_split``'s data."""
    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, (H, P))]
    read = hap[:R].copy()
    mut = rng.random((R, P)) < 0.1
    read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    q = rng.integers(15, 40, (R, P)).astype(np.uint8)
    iq = rng.integers(30, 45, (R, P)).astype(np.uint8)
    dq = rng.integers(30, 45, (R, P)).astype(np.uint8)
    gcp = np.full((R, P), 10, np.uint8)
    haplen = rng.integers(haplen_lo, H + 1, P).astype(np.int32)
    rslen = rng.integers(4, R + 1, P).astype(np.int32)
    return hap, read, q, iq, dq, gcp, haplen, rslen


def _n_and_short_lanes():
    """'N' in haplotypes and reads, and lanes whose haplotype ends inside
    shard 0 at nsp = 4 (haplen < 12), one of a single column."""
    planes = _planes(seed=21, haplen_lo=2)
    hap, read, haplen = planes[0], planes[1], planes[6]
    hap[[3, 17, 30, 44], [0, 1, 2, 3]] = ord("N")
    read[[2, 7], [4, 5]] = ord("N")
    haplen[:3] = [5, 11, 1]
    return planes


def _sp(nsp, planes, dtype):
    mesh = tmesh.sequence_parallel_mesh(devices=["cpu"] * nsp)
    return tmesh.pairhmm_raw_sp(mesh, *planes, dtype=dtype)


@pytest.mark.parametrize("case", ["test_parallel_data", "n_bases_short_haplotypes"])
@pytest.mark.parametrize("nsp", NSP)
def test_sp_f64_matches_jax(nsp, case):
    """f64: the JAX ``pairhmm_raw_sp`` on a JAX CPU mesh of as many devices,
    the JAX plain engine and the port's, all at rtol 1e-12 (the Y scan is
    block-reassociated, so not bit for bit)."""
    planes = _planes() if case == "test_parallel_data" else _n_and_short_lanes()
    got = _sp(nsp, planes, "float64")
    assert got.dtype == torch.float64 and got.device.type == "cpu" and got.shape == (8,)
    got = got.numpy()
    want_sp = np.asarray(jmesh.pairhmm_raw_sp(jmesh.sequence_parallel_mesh(nsp), *planes,
                                              dtype="float64"))
    want = np.asarray(jpairhmm_ops.pairhmm_raw(*planes, dtype="float64"))
    assert (want > 0).all()
    np.testing.assert_allclose(got, want_sp, rtol=1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    one = tpairhmm_ops.pairhmm_raw(*(torch.from_numpy(a) for a in planes), dtype="float64")
    np.testing.assert_allclose(got, one.numpy(), rtol=1e-12)


@pytest.mark.parametrize("case", ["test_parallel_data", "n_bases_short_haplotypes"])
@pytest.mark.parametrize("nsp", NSP)
def test_sp_f32_within_golden_contract(nsp, case):
    """f32 in log10 within 1e-5 of the f64 reference (the raw values carry
    the dtypes' own initial constants, 2^120 and 2^1020)."""
    planes = _planes() if case == "test_parallel_data" else _n_and_short_lanes()
    got32 = _sp(nsp, planes, "float32")
    assert got32.dtype == torch.float32
    ref64 = np.asarray(jpairhmm_ops.pairhmm_raw(*planes, dtype="float64"))
    np.testing.assert_allclose(tpairhmm_ops.pairhmm_log10_from_raw_f32(got32.numpy()),
                               tpairhmm_ops.pairhmm_log10_from_raw_f64(ref64), atol=1e-5)


def test_sp_uneven_split_raises():
    with pytest.raises(ValueError, match="do not split"):
        _sp(5, _planes(), "float64")


@pytest.mark.parametrize("nsp", NSP)
def test_mesh_shape_keys_by_axis(nsp):
    assert tmesh.sequence_parallel_mesh(devices=["cpu"] * nsp).shape == {"sp": nsp}
    assert tmesh.data_parallel_mesh(devices=["cpu"] * nsp).shape == {"dp": nsp}
    assert jmesh.sequence_parallel_mesh(nsp).shape == {"sp": nsp}


def test_sp_refuses_another_process_entry(monkeypatch):
    """A mesh holding another rank's entry: one process cannot relay the
    carry to it."""
    monkeypatch.setattr(tmesh, "process_index", lambda: 0)
    mesh = tmesh.Mesh((torch.device("cpu"),) * 2, (0, 1), ("sp",))
    with pytest.raises(NotImplementedError):
        tmesh.pairhmm_raw_sp(mesh, *_planes(), dtype="float64")


def test_sp_mesh_needs_a_card_or_devices(monkeypatch):
    """Without a card and without ``devices=`` no mesh is built: it never
    falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.sequence_parallel_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.sequence_parallel_mesh(2)


def test_sp_names_stay_out_of_the_package_all():
    """As in the JAX package, the sp pair lives in ``parallel.mesh`` only."""
    from gkl_tpu import parallel as jpar
    from gkl_tpu_torch import parallel as tpar

    for pkg in (jpar, tpar):
        assert not {"sequence_parallel_mesh", "pairhmm_raw_sp"} & set(pkg.__all__)
