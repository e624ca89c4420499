"""The port's host utilities and observability against the JAX package:
the ``utils`` probes and ``path_to_test_resource``, ``profiling``
(``KernelMetrics.timed``/``report``, ``profile_csv``, ``trace``), and
``debug`` (``check_batch``, and ``debug_context``'s NaN checks where the
APIs take each f32 engine's output)."""

import os
import threading

import numpy as np
import pytest
import torch

from gkl_tpu import batch as jbatch
from gkl_tpu import debug as jdebug
from gkl_tpu import profiling as jprofiling
from gkl_tpu import utils as jutils
from gkl_tpu_torch import (PDHMM, HaplotypeData, PairHMM, PDHaplotypeData, ReadData, debug,
                           profiling, utils)
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.ops import pairhmm_cols, pairhmm_cuda, pdhmm_cuda

BASES = np.frombuffer(b"ACGT", np.uint8)
BAD_NAMES = ("../etc/passwd", "a/b.txt", ".hidden", "x;y")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- utils ------------------------------------------------------------------


def test_platform_probes(monkeypatch):
    """The card's answers: f64 at full range, f32 flushed to zero (the
    kernels' ``-ftz=true``; setting it is a no-op that reports it)."""
    assert utils.default_backend() == "cpu"  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert utils.default_backend() == "cuda"
    assert utils.cpu_devices() == (torch.device("cpu"),)
    assert utils.supports_native_float64() is True
    assert utils.get_flush_to_zero() is True
    assert utils.set_flush_to_zero(False) is True
    assert utils.get_flush_to_zero() is True


def test_path_to_test_resource_matches_jax():
    got = utils.path_to_test_resource("pairhmm-testdata.txt")
    assert got == jutils.path_to_test_resource("pairhmm-testdata.txt")
    assert os.path.exists(got)
    assert (utils.path_to_test_resource("a.bam", base_dir="/x")
            == jutils.path_to_test_resource("a.bam", base_dir="/x"))


@pytest.mark.parametrize("bad", BAD_NAMES)
def test_path_to_test_resource_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        jutils.path_to_test_resource(bad)
    with pytest.raises(ValueError):
        utils.path_to_test_resource(bad)


# -- profiling --------------------------------------------------------------


def test_kernel_metrics_report_matches_jax():
    """The same records give the JAX report's table to the character;
    ``timed`` records a call with its wall seconds and its counts."""
    ours, theirs = profiling.KernelMetrics(), jprofiling.KernelMetrics()
    for m in (ours, theirs):
        m.record("pairhmm", items=8, cells=4096, bytes_in=1 << 20, seconds=0.25)
        m.record("deflate", items=3, bytes_in=3 << 16, seconds=0.5)
        m.record("pairhmm", items=2, cells=1024, seconds=0.25)
    assert ours.report() == theirs.report()
    assert ours.snapshot() == theirs.snapshot()
    for m in (ours, theirs):
        with m.timed("sw", items=5, cells=100, bytes_in=7):
            pass
    a, b = ours.snapshot()["sw"], theirs.snapshot()["sw"]
    keys = ("calls", "items", "cells", "bytes_in")
    assert [a[k] for k in keys] == [b[k] for k in keys] == [1, 5, 100, 7]
    assert a["seconds"] >= 0 and set(a) == set(b)
    assert ours.report().splitlines()[0] == theirs.report().splitlines()[0]
    assert len(ours.report().splitlines()) == len(theirs.report().splitlines()) == 4


def test_profile_csv_sizes_match_jax():
    """The codec C++ is byte-identical, so each level's compressed size
    and ratio are the JAX package's (the times are the host's)."""
    rng = np.random.default_rng(0)
    data = bytes(BASES[rng.integers(0, 4, 1 << 16)])
    ours = profiling.profile_csv(data, levels=(1, 6)).splitlines()
    theirs = jprofiling.profile_csv(data, levels=(1, 6)).splitlines()
    assert ours[0] == theirs[0] == "level,ms,size,ratio" and len(ours) == len(theirs) == 3
    for a, b in zip(ours[1:], theirs[1:]):
        la, _, sa, ra = a.split(",")
        lb, _, sb, rb = b.split(",")
        assert (la, sa, ra) == (lb, sb, rb)


def test_trace_writes_a_file(tmp_path):
    """A trace around a twin call writes a ``*.pt.trace.json`` that names
    the profiled ops."""
    planes = [torch.from_numpy(a) for a in _dense(8, 16, 8)]
    lanes = torch.arange(8, dtype=torch.int32)
    with profiling.trace(str(tmp_path)):
        pairhmm_cuda.pairhmm_rows(planes[0], torch.stack(planes[1:3]), lanes, lanes,
                                  planes[6], planes[7], quals_u=torch.stack(planes[3:6]))
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and "aten::" in files[0].read_text()


# -- debug ------------------------------------------------------------------


def _dense(R, H, P, seed=3):
    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, (H, P))]
    read = hap[:R].copy()
    quals = [rng.integers(lo, 45, (R, P)).astype(np.uint8) for lo in (10, 30, 30)]
    return [hap, read, *quals, np.full((R, P), 10, np.uint8),
            rng.integers(R, H + 1, P).astype(np.int32),
            rng.integers(2, R + 1, P).astype(np.int32)]


def _check_batch_cases():
    good = _dense(8, 16, 8)
    cases = {"good": (good, 6)}

    def bad(name, i, value, n_real=6):
        planes = [a.copy() for a in good]
        planes[i] = value(planes[i])
        cases[name] = (planes, n_real)

    bad("haplen_zero", 6, lambda a: np.where(np.arange(8) == 2, 0, a).astype(np.int32))
    bad("haplen_past_h", 6, lambda a: np.where(np.arange(8) == 1, 17, a).astype(np.int32))
    bad("rslen_past_r", 7, lambda a: np.where(np.arange(8) == 5, 9, a).astype(np.int32))
    bad("q_wrong_shape", 2, lambda a: a[:, :7])
    bad("hap_not_uint8", 0, lambda a: a.astype(np.int32))
    bad("rslen_wrong_shape", 7, lambda a: a[:7])
    cases["n_real_zero"] = (good, 0)
    cases["n_real_past_p"] = (good, 9)
    return cases


@pytest.mark.parametrize("case", list(_check_batch_cases()))
def test_check_batch_matches_jax(case):
    """``check_batch`` accepts and rejects the batches the JAX one does."""
    planes, n_real = _check_batch_cases()[case]

    def verdict(mod, cls):
        try:
            mod.check_batch(cls(*planes, n_real=n_real))
        except AssertionError:
            return "rejected"
        return "accepted"

    want = verdict(jdebug, jbatch.PackedPairs)
    assert want == ("accepted" if case == "good" else "rejected")
    assert verdict(debug, tbatch.PackedPairs) == want


def test_debug_enabled_reads_env(monkeypatch):
    monkeypatch.delenv("GKL_TPU_DEBUG", raising=False)
    assert not debug.debug_enabled()
    monkeypatch.setenv("GKL_TPU_DEBUG", "1")
    assert debug.debug_enabled() and jdebug.debug_enabled()


def _reads_haps(n_reads=3, n_haps=2, hap_len=20, seed=7):
    """Reads that are windows of their haplotype: every lane in range."""
    rng = np.random.default_rng(seed)
    haps = [BASES[rng.integers(0, 4, hap_len)] for _ in range(n_haps)]
    reads = []
    for i in range(n_reads):
        seq = haps[i % n_haps][2:14].copy()
        reads.append(ReadData(seq, np.full(12, 30, np.uint8), np.full(12, 45, np.uint8),
                              np.full(12, 45, np.uint8), np.full(12, 10, np.uint8)))
    return reads, haps


def _nan_at(real, lane, index=None):
    """``real`` with lane ``lane`` of its output (or of its output's
    element ``index``) set to NaN."""
    def call(*args, **kw):
        out = real(*args, **kw)
        target = out if index is None else out[index]
        target = target.clone()
        target[lane] = float("nan")
        if index is None:
            return target
        return tuple(target if i == index else o for i, o in enumerate(out))
    return call


TWIN_OF = {"pairhmm_scaled": "pairhmm_raw_scaled_reference", "pairhmm_cols": "pairhmm_raw_cols",
           "raw_batch_rows": "pairhmm_raw", "pdhmm": "pdhmm_indexed_reference"}


def _run_engine(engine, monkeypatch, lane):
    """Run one API path on the CPU (6 real lanes of 8) with its engine's
    twin (``TWIN_OF``) patched to give NaN in ``lane``."""
    reads, haps = _reads_haps()
    if engine == "pairhmm_scaled":
        monkeypatch.setattr(pairhmm_cuda, "pairhmm_raw_scaled_reference", _nan_at(
            pairhmm_cuda.pairhmm_raw_scaled_reference, lane, index=0))
        PairHMM(device="cpu").compute_likelihoods(reads, [HaplotypeData(h) for h in haps])
        return
    if engine == "pairhmm_cols":
        monkeypatch.setattr(PairHMM, "PALLAS_MAX_HAP", 16)  # haplotype bucket 24 goes past
        monkeypatch.setattr(pairhmm_cols, "pairhmm_raw_cols",
                            _nan_at(pairhmm_cols.pairhmm_raw_cols, lane))
        PairHMM(device="cpu").compute_likelihoods(reads, [HaplotypeData(h) for h in haps])
        return
    if engine == "raw_batch_rows":
        monkeypatch.setattr(pairhmm_cuda, "pairhmm_raw", _nan_at(pairhmm_cuda.pairhmm_raw, lane))
        PairHMM(device="cpu")._raw_batch(tbatch.PackedPairs(*_dense(8, 16, 8), n_real=6))
        return
    monkeypatch.setattr(pdhmm_cuda, "pdhmm_indexed_reference",
                        _nan_at(pdhmm_cuda.pdhmm_indexed_reference, lane))
    PDHMM(device="cpu").compute_likelihoods(
        reads, [PDHaplotypeData(h, haplotype_pdbases=np.zeros_like(h)) for h in haps])


ENGINES = list(TWIN_OF)


@pytest.mark.parametrize("disable_jit", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_debug_context_raises_on_nan_in_a_real_lane(monkeypatch, engine, disable_jit):
    """Inside the scope, a NaN in a real lane of an f32 engine's output
    raises FloatingPointError naming the twin that gave it."""
    want = f"^{TWIN_OF[engine]} twin gave NaN in 1 real lanes, first \\[4\\]$"
    with pytest.raises(FloatingPointError, match=want):
        with debug.debug_context(disable_jit=disable_jit):
            _run_engine(engine, monkeypatch, lane=4)


@pytest.mark.parametrize("engine", ENGINES)
def test_debug_context_ignores_padding_lanes(monkeypatch, engine):
    """Padding lanes (6 and 7 of 8) may hold anything: a NaN there does not
    raise inside the scope."""
    with debug.debug_context():
        _run_engine(engine, monkeypatch, lane=7)


@pytest.mark.parametrize("engine", ENGINES)
def test_nothing_is_checked_outside_the_scope(monkeypatch, engine):
    """Outside the scope the same NaN raises no FloatingPointError: the
    PairHMM paths run on (the scaled path rescues the lane), and PDHMM's own
    validity check (pdhmm-serial.cc:432-442) raises as it always did."""
    if engine == "pdhmm":
        with pytest.raises(RuntimeError, match="invalid log10"):
            _run_engine(engine, monkeypatch, lane=4)
    else:
        _run_engine(engine, monkeypatch, lane=4)


def test_disable_jit_synchronises_after_each_launch(monkeypatch):
    """``after_launch`` (each wrapper calls it after its launch)
    synchronises the launch's card only inside
    ``debug_context(disable_jit=True)``, and only on the scope's thread."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    dev = torch.device("cuda", 0)
    debug.after_launch(dev)
    with debug.debug_context():
        debug.after_launch(dev)
    with debug.debug_context(disable_jit=True):
        debug.after_launch(dev)
        other = threading.Thread(target=debug.after_launch, args=(dev,))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
        assert debug.nan_checks()
    assert synced == [dev] and not debug.nan_checks()
