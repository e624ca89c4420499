"""``lane_multiple=`` on the port's ``PairHMM``, ``SmithWaterman`` and
``PDHMM``: the same seeded inputs at lane multiples 1, 3, 8 and 128 give
the port's outputs bit for bit, agree with ``gkl_tpu`` built with the same
``lane_multiple`` (its jnp engines on the CPU), and run on a CPU mesh; the
checks on the value and on the mesh, and ``initialize()`` keeping the
caller's value."""

import numpy as np
import pytest
import torch

import golden
import gkl_tpu
from gkl_tpu.api_pdhmm import PDHMM as JPDHMM
from gkl_tpu.api_pdhmm import KernelLevel as JKernelLevel
from gkl_tpu.api_pdhmm import PDHaplotypeData as JPDHaplotypeData
from gkl_tpu.api_pdhmm import PDHMMNativeArguments as JPDHMMNativeArguments
from gkl_tpu.api_sw import OverhangStrategy as JOverhangStrategy
from gkl_tpu.api_sw import SmithWaterman as JSmithWaterman
from gkl_tpu.api_sw import SWParameters as JSWParameters
from gkl_tpu_torch import (PDHMM, HaplotypeData, PairHMM, PairHMMNativeArguments,
                           PDHaplotypeData, PDHMMNativeArguments, ReadData, SmithWaterman,
                           SWParameters, api_sw, parallel)
from gkl_tpu_torch.api_sw import OverhangStrategy
from gkl_tpu_torch.ops import sw_cuda

BASES = np.frombuffer(b"ACGT", np.uint8)
LANE_MULTIPLES = [1, 3, 8, 128]
# log10: the port's f32 lanes against the JAX package's f32 jnp engine
TOL_F32 = 1e-5
TOL_F64 = 1e-9
SW_GATK = (200, -150, -260, -11)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n):
    return parallel.data_parallel_mesh(devices=["cpu"] * n)


def _pairhmm_inputs(seed=11):
    """13 reads of 32 bases, windows of haplotype 0 with a few
    substitutions; reads 2, 7 and 11 mismatch it at every base with quals of
    50 (deep lanes).  Haplotypes of 48, 48 and 70 bases: two groups of 26
    and 13 pair lanes, which pad to different counts at each multiple."""
    rng = np.random.default_rng(seed)
    haps = [BASES[rng.integers(0, 4, n)] for n in (48, 48, 70)]
    reads = []
    for i in range(13):
        start = int(rng.integers(0, 16))
        read = haps[0][start:start + 32].copy()
        q = rng.integers(20, 40, 32).astype(np.uint8)
        gop = rng.integers(30, 46, 32).astype(np.uint8)
        gcp = np.full(32, 10, np.uint8)
        if i in (2, 7, 11):
            read = BASES[(np.searchsorted(BASES, read) + 1) % 4]
            q = gop = gcp = np.full(32, 50, np.uint8)
        else:
            k = rng.integers(0, 32, 2)
            read[k] = BASES[rng.integers(0, 4, 2)]
        reads.append((read, q, gop, gop.copy(), gcp))
    return haps, reads


def _spy_rescues(monkeypatch, cls, seen):
    """Record the f64 values of each ``_f64_lanes`` call of ``cls``."""
    real = cls._f64_lanes

    def spy(self, *args, **kw):
        out = real(self, *args, **kw)
        seen.extend(np.asarray(out, np.float64).tolist())
        return out

    monkeypatch.setattr(cls, "_f64_lanes", spy)


def _port_pairhmm(lane_multiple, mesh=None):
    haps, reads = _pairhmm_inputs()
    hmm = PairHMM(lane_multiple=lane_multiple, device="cpu", mesh=mesh)
    return hmm.compute_likelihoods([ReadData(*r) for r in reads], [HaplotypeData(h) for h in haps])


@pytest.mark.parametrize("exact", [False, True])
def test_pairhmm_outputs_do_not_depend_on_the_lane_multiple(monkeypatch, exact):
    """The real lanes' results, rescued lanes included, and the lanes
    rescued are bit for bit the same at every lane multiple, under the
    default rescue policy and under GKL_TPU_EXACT_RESCUE=1."""
    if exact:
        monkeypatch.setenv("GKL_TPU_EXACT_RESCUE", "1")
    else:
        monkeypatch.delenv("GKL_TPU_EXACT_RESCUE", raising=False)
    outs, rescued = [], []
    for lm in LANE_MULTIPLES:
        seen = []
        with monkeypatch.context() as m:
            _spy_rescues(m, PairHMM, seen)
            outs.append(_port_pairhmm(lm))
        rescued.append(sorted(seen))
    for out, lanes in zip(outs[1:], rescued[1:]):
        np.testing.assert_array_equal(out, outs[0])
        assert lanes == rescued[0]
    assert np.isfinite(outs[0]).all() and len(rescued[0]) >= 3


@pytest.mark.parametrize("lane_multiple", LANE_MULTIPLES)
def test_pairhmm_lane_multiple_matches_jax(monkeypatch, lane_multiple):
    """``PairHMM(lane_multiple=)`` against ``gkl_tpu.PairHMM`` with the same
    multiple (its f32 jnp engine, every lane below MIN_ACCEPTED rescued):
    1e-5 in log10, and with GKL_TPU_EXACT_RESCUE=1, the JAX route's rule,
    the same lanes rescued to the same f64 values."""
    monkeypatch.setenv("GKL_TPU_EXACT_RESCUE", "1")
    haps, reads = _pairhmm_inputs()
    j_seen, t_seen = [], []
    _spy_rescues(monkeypatch, gkl_tpu.PairHMM, j_seen)
    _spy_rescues(monkeypatch, PairHMM, t_seen)
    want = gkl_tpu.PairHMM(lane_multiple=lane_multiple).compute_likelihoods(
        [gkl_tpu.ReadData(*r) for r in reads], [gkl_tpu.HaplotypeData(h) for h in haps])
    got = _port_pairhmm(lane_multiple)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)
    assert len(t_seen) >= 3
    assert sorted(t_seen) == sorted(j_seen)


def test_pairhmm_lane_multiple_on_a_mesh():
    """On a CPU mesh of two entries ``lane_multiple=16`` gives the outputs
    of one device; a multiple that does not split over the mesh, and one
    below 1, raise ``ValueError``."""
    want = _port_pairhmm(8)
    np.testing.assert_array_equal(_port_pairhmm(16, mesh=_cpu_mesh(2)), want)
    for bad in (3, 0):
        with pytest.raises(ValueError, match="lane_multiple"):
            PairHMM(lane_multiple=bad, device="cpu", mesh=_cpu_mesh(2))
    for bad in (0, -8):
        with pytest.raises(ValueError, match="lane_multiple"):
            PairHMM(lane_multiple=bad, device="cpu")


def test_pairhmm_initialize_keeps_the_callers_lane_multiple(monkeypatch):
    """``initialize()`` keeps a caller's multiple through every mesh the
    thread cap builds or drops, recomputes only the default, and refuses a
    cap whose mesh the multiple does not split over, before anything
    changes."""
    hmm = PairHMM(lane_multiple=3, device="cpu")
    hmm.initialize(PairHMMNativeArguments(max_number_of_threads=0))
    assert hmm._lane_multiple == 3 and hmm.mesh is None

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    hmm = PairHMM(PairHMMNativeArguments(max_number_of_threads=0), lane_multiple=64)
    assert hmm.mesh.size == 4 and hmm._lane_multiple == 64
    hmm.initialize(PairHMMNativeArguments(max_number_of_threads=2))
    assert hmm.mesh.size == 2 and hmm._lane_multiple == 64
    hmm.initialize(PairHMMNativeArguments(max_number_of_threads=1))
    assert hmm.mesh is None and hmm._lane_multiple == 64
    default = PairHMM(PairHMMNativeArguments(max_number_of_threads=0))
    assert default._lane_multiple == 32
    default.initialize(PairHMMNativeArguments(max_number_of_threads=2))
    assert default._lane_multiple == 16

    with pytest.raises(ValueError, match="lane_multiple"):
        PairHMM(PairHMMNativeArguments(max_number_of_threads=0), lane_multiple=6)
    odd = PairHMM(lane_multiple=6)
    args = odd.args
    with pytest.raises(ValueError, match="lane_multiple"):
        odd.initialize(PairHMMNativeArguments(max_number_of_threads=0))
    assert odd.mesh is None and odd._lane_multiple == 6 and odd.args is args
    odd.initialize(PairHMMNativeArguments(max_number_of_threads=2))
    assert odd.mesh.size == 2 and odd._lane_multiple == 6


def _sw_pairs(seed=5, n=13):
    """Pairs of 10-70 bases, each alt its ref with a substitution and a
    deletion: two length buckets."""
    rng = np.random.default_rng(seed)
    refs, alts = [], []
    for _ in range(n):
        k = int(rng.integers(10, 70))
        r = BASES[rng.integers(0, 4, k)]
        a = r.copy()
        a[rng.integers(0, k)] = BASES[rng.integers(0, 4)]
        cut = int(rng.integers(1, k - 2))
        refs.append(r)
        alts.append(np.concatenate([a[:cut], a[cut + 2:]]))
    return refs, alts


def _sw_results(sw, refs, alts, strategy):
    return [(r.cigar, r.alignment_offset)
            for r in sw.align_batch(refs, alts, SWParameters(*SW_GATK), strategy)]


@pytest.mark.parametrize("lane_multiple", LANE_MULTIPLES)
def test_sw_lane_multiple_matches_jax(lane_multiple):
    """``SmithWaterman(lane_multiple=)``: the CIGARs and offsets of the port
    at the default multiple and of ``gkl_tpu``'s aligner built with the
    same multiple, for two overhang strategies."""
    refs, alts = _sw_pairs()
    for strategy in (OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL):
        got = _sw_results(SmithWaterman(lane_multiple=lane_multiple, device="cpu"),
                          refs, alts, strategy)
        assert got == _sw_results(SmithWaterman(device="cpu"), refs, alts, strategy)
        want = JSmithWaterman(lane_multiple=lane_multiple).align_batch(
            refs, alts, JSWParameters(*SW_GATK), JOverhangStrategy(int(strategy)))
        assert got == [(w.cigar, w.alignment_offset) for w in want]


@pytest.mark.parametrize("lane_multiple", [1, 3, 8])
def test_sw_budget_chunks_in_lane_multiples(monkeypatch, lane_multiple):
    """With the backtrack budget cut to 8 lanes of the largest bucket, every
    launch pads to a multiple of ``lane_multiple`` and stays within the
    budget, and the results are the unchunked ones."""
    refs, alts = _sw_pairs()
    want = _sw_results(SmithWaterman(device="cpu"), refs, alts, OverhangStrategy.SOFTCLIP)
    monkeypatch.setattr(api_sw, "SW_BT_BUDGET", 8 * (128 // 2) * 128)
    shapes = []
    real = sw_cuda.sw_forward

    def spy(ref, alt, *args, **kw):
        shapes.append((ref.shape[0], alt.shape[0], ref.shape[1]))
        return real(ref, alt, *args, **kw)

    monkeypatch.setattr(sw_cuda, "sw_forward", spy)
    sw = SmithWaterman(lane_multiple=lane_multiple, device="cpu")
    assert _sw_results(sw, refs, alts, OverhangStrategy.SOFTCLIP) == want
    assert len(shapes) > 1
    for N, M, P in shapes:
        assert P % lane_multiple == 0 and P * (N // 2) * M <= api_sw.SW_BT_BUDGET


def test_sw_lane_multiple_on_a_mesh():
    refs, alts = _sw_pairs()
    want = _sw_results(SmithWaterman(device="cpu"), refs, alts, OverhangStrategy.SOFTCLIP)
    sw = SmithWaterman(lane_multiple=16, device="cpu", mesh=_cpu_mesh(2))
    assert _sw_results(sw, refs, alts, OverhangStrategy.SOFTCLIP) == want
    for bad in (3, 0):
        with pytest.raises(ValueError, match="lane_multiple"):
            SmithWaterman(lane_multiple=bad, device="cpu", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="lane_multiple"):
        SmithWaterman(lane_multiple=0, device="cpu")


def _pdhmm_inputs():
    cases = golden.load_pdhmm_cases("pdhmm_syn_199_68_51.txt")[:6]
    reads = [(c.read, c.q, c.iq, c.dq, c.gcp) for c in cases]
    return [(c.hap, c.hap_pd) for c in cases], reads


def _port_pdhmm(lane_multiple, args=None, mesh=None):
    haps, reads = _pdhmm_inputs()
    hmm = PDHMM(args, lane_multiple=lane_multiple, device="cpu", mesh=mesh)
    return hmm.compute_likelihoods([ReadData(*r) for r in reads],
                                   [PDHaplotypeData(h, haplotype_pdbases=p) for h, p in haps])


def test_pdhmm_outputs_do_not_depend_on_the_lane_multiple(monkeypatch):
    """Bit for bit the same results at every multiple, in slices of the
    whole batch and, with no memory budget, in slices of exactly
    ``lane_multiple`` lanes."""
    want = _port_pdhmm(8)
    slices = []
    real = PDHMM._run_indexed

    def spy(self, haps, *args):
        slices.append(len(haps))
        return real(self, haps, *args)

    monkeypatch.setattr(PDHMM, "_run_indexed", spy)
    for lm in LANE_MULTIPLES:
        np.testing.assert_array_equal(_port_pdhmm(lm), want)
        slices.clear()
        np.testing.assert_array_equal(
            _port_pdhmm(lm, PDHMMNativeArguments(max_memory_in_mb=0)), want)
        assert max(slices) == lm if lm < len(want) else slices == [len(want)]


@pytest.mark.parametrize("lane_multiple", LANE_MULTIPLES)
def test_pdhmm_lane_multiple_matches_jax(lane_multiple):
    """``PDHMM(lane_multiple=)`` against ``gkl_tpu``'s PDHMM with the same
    multiple: in f32 its jnp engine (``KernelLevel.SCALAR``, packed at that
    multiple, lanes below MIN_ACCEPTED rescued) at 1e-5, in f64 at 1e-9."""
    haps, reads = _pdhmm_inputs()
    jreads = [gkl_tpu.ReadData(*r) for r in reads]
    jhaps = [JPDHaplotypeData(h, haplotype_pdbases=p) for h, p in haps]
    want = JPDHMM(JPDHMMNativeArguments(kernel_level=JKernelLevel.SCALAR),
                  lane_multiple=lane_multiple).compute_likelihoods(jreads, jhaps)
    np.testing.assert_allclose(_port_pdhmm(lane_multiple), want, rtol=0, atol=TOL_F32)
    want64 = JPDHMM(JPDHMMNativeArguments(use_double_precision=True),
                    lane_multiple=lane_multiple).compute_likelihoods(jreads, jhaps)
    got64 = _port_pdhmm(lane_multiple, PDHMMNativeArguments(use_double_precision=True))
    np.testing.assert_allclose(got64, want64, rtol=0, atol=TOL_F64)


def test_pdhmm_lane_multiple_on_a_mesh():
    np.testing.assert_array_equal(_port_pdhmm(16, mesh=_cpu_mesh(2)), _port_pdhmm(8))
    for bad in (3, 0):
        with pytest.raises(ValueError, match="lane_multiple"):
            PDHMM(lane_multiple=bad, device="cpu", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="lane_multiple"):
        PDHMM(lane_multiple=-1, device="cpu")
