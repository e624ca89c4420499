"""The port's CUDA kernel on the card.  Every test here is marked ``gpu``
and skips without a CUDA device.  The file imports neither JAX nor
``gkl_tpu``, so it also runs where JAX is absent: there, run it with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`` (the
suite's conftest configures JAX)."""

import numpy as np
import pytest
import torch

import golden
from torch_cases import flag_cases
from gkl_tpu_torch import (HaplotypeData, PairHMM, PairHMMNativeArguments,
                           ReadData, cuda_build, native_lib)
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.ops import pairhmm_cuda, pairhmm_ref

BASES = np.frombuffer(b"ACGT", np.uint8)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _indexed_batch(seed, n_reads=12, n_haps=5, deep_every=4):
    """Reads are mutated hap windows; every ``deep_every``-th read is a
    deep lane (low quals, 25% mutations)."""
    rng = np.random.default_rng(seed)
    haps = [BASES[rng.integers(0, 4, int(rng.integers(40, 200)))] for _ in range(n_haps)]
    reads, quals = [], []
    for i in range(n_reads):
        hap = haps[i % n_haps]
        rl = int(rng.integers(20, 150))
        read = np.resize(hap[int(rng.integers(0, len(hap) // 2)):], rl).copy()
        rate, qlo = (0.25, 4) if i % deep_every == 0 else (0.02, 18)
        mut = rng.random(rl) < rate
        read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        reads.append(read)
        quals.append((rng.integers(qlo, qlo + 28, rl).astype(np.uint8),
                      rng.integers(30, 46, rl).astype(np.uint8),
                      rng.integers(30, 46, rl).astype(np.uint8),
                      rng.integers(5, 15, rl).astype(np.uint8)))
    return haps, reads, quals


@pytest.mark.parametrize("const_quals", [None, (45, 45, 10)])
def test_kernel_matches_twin(cuda_device, const_quals):
    """Kernel against its twin on the same card tensors: in-range lanes at
    1e-5 in log10; every lane the twin flags, the kernel flags too."""
    haps, reads, quals = _indexed_batch(0)
    pk = tbatch.pack_pairs_indexed(haps, reads, quals, const_quals=const_quals)
    names = ("hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen")
    dev = {k: torch.from_numpy(getattr(pk, k)).to(cuda_device) for k in names}
    quals_u = None if pk.quals_u is None else torch.from_numpy(pk.quals_u).to(cuda_device)
    launches = pairhmm_cuda.LAUNCHES
    out = pairhmm_cuda.pairhmm_scaled(**dev, const_quals=const_quals, quals_u=quals_u)
    assert pairhmm_cuda.LAUNCHES == launches + 1
    km, ke, kf = (t.cpu().numpy()[: pk.n_real] for t in pairhmm_cuda.unpack(out))
    planes = pairhmm_cuda.expand_indexed_planes(
        dev["hap_u"], dev["readq_u"], dev["ridx"], dev["hidx"],
        const_quals=const_quals, quals_u=quals_u)
    tm, te, tf = (t.cpu().numpy()[: pk.n_real] for t in
                  pairhmm_cuda.pairhmm_raw_scaled_reference(*planes, dev["haplen"], dev["rslen"]))
    k_res, t_res = pairhmm_cuda.log10_of(km, ke), pairhmm_cuda.log10_of(tm, te)
    in_range = t_res > -64.0
    assert in_range.any() and (~in_range).any()
    np.testing.assert_allclose(k_res[in_range], t_res[in_range], rtol=0, atol=1e-5)
    assert not np.any((tf != 0) & (kf == 0))


@pytest.mark.parametrize("name,planes", flag_cases(), ids=[c[0] for c in flag_cases()])
def test_kernel_flags_cover_twin(cuda_device, name, planes):
    """On batches with flagged and unflagged lanes (and the die-and-refill
    lane only the mid-chunk sample catches), the kernel flags every lane
    its twin flags; results agree at 1e-5 where positive and in range."""
    hap, read, q, iq, dq, gcp, haplen, rslen = (torch.from_numpy(a).to(cuda_device)
                                                for a in planes)
    lanes = torch.arange(hap.shape[1], dtype=torch.int32, device=cuda_device)
    out = pairhmm_cuda.pairhmm_scaled(hap, torch.stack([read, q]).contiguous(), lanes, lanes,
                                      haplen, rslen,
                                      quals_u=torch.stack([iq, dq, gcp]).contiguous())
    km, ke, kf = (t.cpu().numpy() for t in pairhmm_cuda.unpack(out))
    tm, te, tf = (t.cpu().numpy() for t in pairhmm_cuda.pairhmm_raw_scaled_reference(
        hap, read, q, iq, dq, gcp, haplen, rslen))
    assert tf.any()
    assert not np.any((tf != 0) & (kf == 0))
    want = pairhmm_cuda.log10_of(tm, te)
    ok = (tm > 0) & (want > -64.0)
    np.testing.assert_allclose(pairhmm_cuda.log10_of(km, ke)[ok], want[ok], rtol=0, atol=1e-5)


def test_api_on_card_matches_oracle(cuda_device):
    """PairHMM on CUDA: the kernel runs (its counter moves) and the results,
    rescue included, match the exact f64 oracle at 1e-4."""
    haps, reads, quals = _indexed_batch(1)
    rd = [ReadData(r, *q) for r, q in zip(reads, quals)]
    launches = pairhmm_cuda.LAUNCHES
    got = PairHMM(device=cuda_device).compute_likelihoods(rd, [HaplotypeData(h) for h in haps])
    assert pairhmm_cuda.LAUNCHES > launches
    pairs = [(h, r, q) for r, q in zip(reads, quals) for h in haps]
    want = pairhmm_ref.pairhmm_scalar_batch(*zip(*pairs))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("use_double", [False, True])
def test_golden_on_card(cuda_device, use_double):
    cases = golden.load_pairhmm_cases()
    hmm = PairHMM(PairHMMNativeArguments(use_double_precision=use_double), device=cuda_device)
    got = np.array([hmm.compute_likelihoods([ReadData(c.read, c.q, c.iq, c.dq, c.gcp)],
                                            [HaplotypeData(c.hap)])[0] for c in cases])
    np.testing.assert_allclose(got, [c.expected for c in cases], atol=1e-5)


def test_wrapper_refuses_cuda_without_kernel(cuda_device, monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: with no
    kernel to build it raises, and never falls back to the twin."""
    def no_kernel():
        raise native_lib.BuildError("no kernel built")

    monkeypatch.setattr(cuda_build, "load", no_kernel)
    pk = tbatch.pack_pairs_indexed([BASES[:8]], [BASES[:4]], [(np.full(4, 30, np.uint8),) * 4],
                                   const_quals=(45, 45, 10))
    dev = {k: torch.from_numpy(getattr(pk, k)).to(cuda_device) for k in
           ("hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen")}
    launches = pairhmm_cuda.LAUNCHES
    with pytest.raises(native_lib.BuildError):
        pairhmm_cuda.pairhmm_scaled(**dev, const_quals=(45, 45, 10))
    assert pairhmm_cuda.LAUNCHES == launches


def test_kernel_flags_malformed_lanes(cuda_device):
    """A lane whose index or length is out of range gets no result (NaN
    mantissa, flag -1) instead of reading out of bounds."""
    pk = tbatch.pack_pairs_indexed([BASES[:8]], [BASES[:4]], [(np.full(4, 30, np.uint8),) * 4],
                                   const_quals=(45, 45, 10))
    dev = {k: torch.from_numpy(getattr(pk, k)).to(cuda_device) for k in
           ("hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen")}
    dev["ridx"][1] = 1000
    dev["haplen"][2] = 9
    mant, _, flag = (t.cpu().numpy() for t in pairhmm_cuda.unpack(
        pairhmm_cuda.pairhmm_scaled(**dev, const_quals=(45, 45, 10))))
    assert np.isfinite(mant[0]) and flag[0] >= 0
    assert np.isnan(mant[1:3]).all() and (flag[1:3] == -1).all()
