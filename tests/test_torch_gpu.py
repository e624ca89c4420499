"""The port's CUDA kernels on the card.  Every test here is marked ``gpu``
and skips without a CUDA device.  The file imports neither JAX nor
``gkl_tpu``, so it also runs where JAX is absent: there, run it with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`` (the
suite's conftest configures JAX)."""

import numpy as np
import pytest
import torch

import chip_smoke
import golden
import torch_sw_walk_cases as walk_cases
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


def _sw_batch(N, M, P, seed):
    """Alts are mutated windows of their lane's reference; ragged lengths
    up to N and M."""
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, (N, P))]
    alt = np.resize(ref, (M, P)).copy()
    mut = rng.random((M, P)) < 0.1
    alt[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    reflen = rng.integers(N // 2, N + 1, P).astype(np.int32)
    altlen = rng.integers(M // 2, M + 1, P).astype(np.int32)
    return ref, alt, reflen, altlen


@pytest.mark.parametrize("indel_boundary", [False, True])
@pytest.mark.parametrize("N,M,P", [(64, 96, 64), (64, 320, 40), (2112, 48, 16)],
                         ids=["tall", "alt_slab_regime", "past_2048_rows"])
def test_sw_kernel_matches_twin(cuda_device, N, M, P, indel_boundary):
    """The SW kernel equals its twin bit for bit on the region the host walk
    reads, in the regimes of both TPU kernels it replaces: M past 256 (the
    alt-slab kernel) and N past one 2048-row relay segment."""
    from gkl_tpu_torch.ops import sw as sw_ops
    from gkl_tpu_torch.ops import sw_cuda

    args = [torch.from_numpy(a).to(cuda_device) for a in _sw_batch(N, M, P, seed=N + M)]
    launches = sw_cuda.LAUNCHES
    got = sw_cuda.sw_forward(*args, 200, -150, -260, -11, indel_boundary=indel_boundary)
    assert sw_cuda.LAUNCHES == launches + 1
    want = sw_ops.sw_forward(*args, 200, -150, -260, -11, indel_boundary=indel_boundary,
                             pack_bt=True)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert sw_cuda.in_range_mismatches(got, want, args[2], args[3]) == 0


SW_GATK = (200, -150, -260, -11)


def _sw_lengths(batch, reflen=(), altlen=()):
    """``batch`` with the first lanes' reference and alt lengths set."""
    ref, alt, rl, al = batch
    rl, al = rl.copy(), al.copy()
    rl[:len(reflen)] = reflen
    al[:len(altlen)] = altlen
    return ref, alt, rl, al


def _force_sw_rows(monkeypatch, rows):
    """Launch the SW kernel's instance of ``rows`` rows a thread at any N."""
    from gkl_tpu_torch.ops import sw_cuda

    monkeypatch.setattr(sw_cuda, "sw_geometry", lambda N: (rows, 32 * rows, -(-N // (32 * rows))))


def _sw_kernel_equals_twin(dev, arrays, indel_boundary, params=SW_GATK):
    """One launch of the SW kernel against its twin on the same card
    tensors: 0 in-range mismatches.  Returns the kernel's result."""
    from gkl_tpu_torch.ops import sw as sw_ops
    from gkl_tpu_torch.ops import sw_cuda

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    launches = sw_cuda.LAUNCHES
    got = sw_cuda.sw_forward(*args, *params, indel_boundary=indel_boundary)
    assert sw_cuda.LAUNCHES == launches + 1
    want = sw_ops.sw_forward(*args, *params, indel_boundary=indel_boundary, pack_bt=True)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert sw_cuda.in_range_mismatches(got, want, args[2], args[3]) == 0
    return got


@pytest.mark.parametrize("indel_boundary", [False, True])
@pytest.mark.parametrize("rows", [2, 4, 8])
def test_sw_kernel_instances_at_pass_edges(cuda_device, monkeypatch, rows, indel_boundary):
    """Every instance of the warp-wavefront SW kernel equals the twin with
    reflen on either side of its first and second pass edges (32 * rows
    +- 1, 64 * rows +- 1), a lane over every row, and lanes of 1 row."""
    _force_sw_rows(monkeypatch, rows)
    e = 32 * rows
    N = 3 * e + 8
    _sw_kernel_equals_twin(cuda_device, _sw_lengths(
        _sw_batch(N, 40, 16, seed=rows), reflen=[e - 1, e, e + 1, 2 * e - 1, 2 * e, 2 * e + 1,
                                                  N, 1, 1]), indel_boundary)


@pytest.mark.parametrize("indel_boundary", [False, True])
def test_sw_kernel_one_row_and_one_column_lanes(cuda_device, indel_boundary):
    """Lanes of 1 reference row, of 1 alt column and of both, beside lanes
    past one pass (the 8-row instance at N = 600)."""
    _sw_kernel_equals_twin(cuda_device, _sw_lengths(
        _sw_batch(600, 64, 12, seed=31), reflen=[1, 1, 1, 600, 257], altlen=[1, 64, 7, 1, 1]),
        indel_boundary)


@pytest.mark.parametrize("indel_boundary", [False, True])
@pytest.mark.parametrize("M", [8, 24])
def test_sw_kernel_alt_rungs_not_multiples_of_16(cuda_device, M, indel_boundary):
    """N past one pass with the ladder's rungs M = 8 and M = 24: each bt
    word of 8 columns lands whole, and so does the last partial one."""
    _sw_kernel_equals_twin(cuda_device, _sw_lengths(
        _sw_batch(600, M, 24, seed=M), altlen=[M, M - 1, 1, 5, M // 2 + 1]), indel_boundary)


@pytest.mark.parametrize("indel_boundary", [False, True])
def test_sw_kernel_lengths_10x_apart(cuda_device, indel_boundary):
    """Lanes whose lengths differ 10x in one block (4 warps, a lane each):
    each runs its own reflen x altlen."""
    ref, alt, rl, al = _sw_batch(480, 320, 16, seed=41)
    rl[1::2], al[1::2] = 48, 32
    rl[0::2], al[0::2] = 480, 320
    _sw_kernel_equals_twin(cuda_device, (ref, alt, rl, al), indel_boundary)


@pytest.mark.parametrize("case", ["32767_ref_x_1000_alt", "1000_ref_x_32767_alt"])
def test_sw_kernel_at_the_length_limit(cuda_device, case):
    """A pair at the 32,767-base limit beside shorter lanes, in one launch
    (128 passes of the 8-row instance, or 32,767 columns a pass)."""
    from gkl_tpu_torch import batch as tbatch

    rng = np.random.default_rng(51)
    n, m = (32767, 1000) if case.startswith("32767") else (1000, 32767)
    N, M = tbatch.bucket_length(n), tbatch.bucket_length(m)
    ref = BASES[rng.integers(0, 4, (N, 8))]
    alt = np.resize(ref[100:], (M, 8)).copy()
    mut = rng.random((M, 8)) < 0.03
    alt[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    rl = np.array([n, 300, 1, n // 2, 77, n, 2, 999], np.int32)
    al = np.array([m, 64, 9, m // 3, 1, m // 2, 640, m], np.int32)
    _sw_kernel_equals_twin(cuda_device, (ref, alt, rl, al), indel_boundary=False)


@pytest.mark.parametrize("indel_boundary", [False, True])
def test_sw_kernel_malformed_lanes_beside_good_ones(cuda_device, indel_boundary):
    """Lanes with a length out of range write nothing (their outputs stay
    zero), and the good lanes of their blocks equal the twin."""
    from gkl_tpu_torch.ops import sw as sw_ops
    from gkl_tpu_torch.ops import sw_cuda

    ref, alt, rl, al = (torch.from_numpy(a).to(cuda_device)
                        for a in _sw_batch(200, 48, 1056, seed=61))
    bad = torch.tensor([1, 6, 1030, 1055], device=cuda_device)
    rl[1], al[6], rl[1030], al[1055] = 0, 49, 201, -3
    got = sw_cuda.sw_forward(ref, alt, rl, al, *SW_GATK, indel_boundary=indel_boundary)
    good = torch.ones(1056, dtype=torch.bool, device=cuda_device)
    good[bad] = False
    assert not got[0][bad].any() and not got[1][:, bad].any() and not got[2][bad].any()
    want = sw_ops.sw_forward(ref[:, good], alt[:, good], rl[good], al[good], *SW_GATK,
                             indel_boundary=indel_boundary, pack_bt=True)
    assert sw_cuda.in_range_mismatches((got[0][good], got[1][:, good], got[2][good]), want,
                                       rl[good], al[good]) == 0


def test_sw_api_on_card_matches_scalar(cuda_device):
    """SmithWaterman on CUDA: the kernel runs and every strategy's CIGAR and
    offset equal the native scalar aligner's."""
    from gkl_tpu_torch import api_sw
    from gkl_tpu_torch.ops import sw_cuda

    rng = np.random.default_rng(3)
    refs = [BASES[rng.integers(0, 4, int(rng.integers(20, 400)))] for _ in range(40)]
    alts = []
    for r in refs:
        a = np.resize(r[int(rng.integers(0, len(r) // 2)):], int(rng.integers(10, 300))).copy()
        mut = rng.random(len(a)) < 0.05
        a[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        alts.append(a)
    params = api_sw.SWParameters(200, -150, -260, -11)
    sw = api_sw.SmithWaterman(device=cuda_device)
    for strategy in api_sw.OverhangStrategy:
        launches = sw_cuda.LAUNCHES
        got = sw.align_batch(refs, alts, params, strategy)
        assert sw_cuda.LAUNCHES > launches
        want = api_sw.sw_align_scalar_batch(refs, alts, params, int(strategy))
        assert [(g.cigar, g.alignment_offset) for g in got] == \
            [(w.cigar, w.alignment_offset) for w in want]


def _walk_three_ways(dev, arrays, strategy):
    """The walk kernel on card tensors against its twin on the same
    tensors (every lane: count, offset, runs) and the native runtime's walk
    (CIGAR, offset and run count of every lane in range); one launch."""
    from gkl_tpu_torch.ops import sw as sw_ops
    from gkl_tpu_torch.ops import sw_cuda

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    launches = sw_cuda.WALK_LAUNCHES
    got = sw_cuda.sw_walk(*args, strategy)
    assert sw_cuda.WALK_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    want = sw_ops.sw_walk(*args, strategy)
    assert sw_cuda.walk_mismatches(got, want) == 0
    native = walk_cases.native_walk(arrays, strategy)
    for (cigar, offset, runs), w in zip(walk_cases.walked(got), native):
        if w is None:
            assert (offset, runs) == (0, 0)
        else:
            assert (cigar, offset, runs) == (w[0], w[1], walk_cases.cigar_runs(w[0]))
    return got


@pytest.mark.parametrize("strategy", [9, 10, 11, 12])
@pytest.mark.parametrize("case", walk_cases.WALK_CASES)
def test_sw_walk_kernel_matches_twin_and_native(cuda_device, case, strategy):
    """The walk kernel equals its twin and ``sw_postprocess_packed`` on the
    CPU tests' random packed backtracks: ties, n = 1, m = 1, padded lanes,
    both nibble parities, runs past 255, no step walked."""
    _walk_three_ways(cuda_device, walk_cases.walk_case(case, seed=len(case) + strategy),
                     strategy)


@pytest.mark.parametrize("strategy", [9, 10])
def test_sw_walk_kernel_on_5kb_lanes(cuda_device, strategy):
    """A 5-kb x 5-kb forward launch (HiFi reads against long haplotypes,
    beside short lanes) walked by the kernel, the twin and the native
    runtime alike."""
    from gkl_tpu_torch.ops import sw_cuda

    rng = np.random.default_rng(strategy)
    N = M = 5120
    ref = BASES[rng.integers(0, 4, (N, 8))]
    alt = np.resize(ref[60:], (M, 8)).copy()
    mut = rng.random((M, 8)) < 0.01
    alt[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    alt[2000:2003] = alt[2005:2008]               # a few indel-like runs
    rl = np.array([5120, 5000, 4999, 300, 5120, 1, 4096, 2500], np.int32)
    al = np.array([5060, 4900, 5120, 150, 1, 4800, 4000, 5120], np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in (ref, alt, rl, al)]
    fwd = sw_cuda.sw_forward(*args, *SW_GATK, indel_boundary=strategy == 10)
    arrays = tuple(t.cpu().numpy() for t in fwd) + (rl, al)
    got = _walk_three_ways(cuda_device, arrays, strategy)
    assert int(got[0].max()) > 2


def _bench_regions():
    """One region of each benchmark configuration from its generator, as
    (name, refs, alts): each read against one of the two haplotypes the
    sample's reads come from; the deep region cut to 512 reads and the
    long one to 64 short reads and 3 HiFi reads, for the CPU's twin."""
    from bench_port.harness import spec

    out = []
    for cell, n_haps, keep in (("hc_wgs30x.region", 3, None), ("hc_deep_panel.region", 8, 512),
                               ("hc_long_region.region", 4, 64)):
        c = spec.load_cell(cell)
        rng = np.random.default_rng(19)
        raw = c.generator().region(rng, c.config, c.config["max_assembly_region_size"], n_haps)
        reads = [seq for seq, _, _ in raw["reads"]]
        short = [k for k, r in enumerate(reads) if len(r) <= 300]
        long = [k for k, r in enumerate(reads) if len(r) > 300]
        pick = short[:keep] + long[:3] if keep else list(range(len(reads)))
        refs = [raw["haps"][k % 2] for k in pick]
        out.append((cell.split(".")[0], refs, [reads[k] for k in pick]))
    return out


def test_sw_api_on_card_matches_cpu_on_bench_regions(cuda_device, monkeypatch):
    """``SmithWaterman()`` on CUDA against ``SmithWaterman(device="cpu")``
    (the twins) on regions drawn by ``bench_port/gen`` for all three
    configurations: the same CIGARs and offsets; one walk launch a forward
    launch, and no tensor as large as a launch's backtrack copied to the
    host."""
    from gkl_tpu_torch import api_sw
    from gkl_tpu_torch.ops import sw_cuda

    bt_bytes, copied = [], []
    real_forward = sw_cuda.sw_forward

    def forward(*a, **kw):
        out = real_forward(*a, **kw)
        bt_bytes.append(out[0].numel())
        return out

    def to_host(t):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            copied.append(t.numel() * t.element_size())

    real_copy, real_cpu, real_to = torch.Tensor.copy_, torch.Tensor.cpu, torch.Tensor.to

    def copy_(self, src, *a, **kw):
        if self.device.type == "cpu":
            to_host(src)
        return real_copy(self, src, *a, **kw)

    def cpu(self, *a, **kw):
        to_host(self)
        return real_cpu(self, *a, **kw)

    def to(self, *a, **kw):
        out = real_to(self, *a, **kw)
        if out.device.type == "cpu":
            to_host(self)
        return out

    params = api_sw.SWParameters(10, -15, -30, -5)
    for name, refs, alts in _bench_regions():
        want = api_sw.SmithWaterman(device="cpu").align_batch(refs, alts, params,
                                                              api_sw.OverhangStrategy.SOFTCLIP)
        bt_bytes.clear()
        copied.clear()
        fwd, walks = sw_cuda.LAUNCHES, sw_cuda.WALK_LAUNCHES
        with monkeypatch.context() as mp:
            mp.setattr(sw_cuda, "sw_forward", forward)
            mp.setattr(torch.Tensor, "copy_", copy_)
            mp.setattr(torch.Tensor, "cpu", cpu)
            mp.setattr(torch.Tensor, "to", to)
            got = api_sw.SmithWaterman(device=cuda_device).align_batch(
                refs, alts, params, api_sw.OverhangStrategy.SOFTCLIP)
        assert [(g.cigar, g.alignment_offset) for g in got] == \
            [(w.cigar, w.alignment_offset) for w in want], name
        launches = sw_cuda.LAUNCHES - fwd
        assert launches == len(bt_bytes) > 0 and sw_cuda.WALK_LAUNCHES - walks == launches, name
        assert copied and max(copied) < min(bt_bytes), (name, copied, bt_bytes)


def _pdhmm_batch(R, H, P, seed):
    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, (H, P))]
    read = np.resize(hap, (R, P)).copy()
    mut = rng.random((R, P)) < 0.05
    read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    read[:, ::8] = BASES[rng.integers(0, 4, (R, len(range(0, P, 8))))]  # deep lanes
    pd = np.zeros((H, P), np.uint8)
    pd[H // 4, ::2], pd[H // 4 + 3, ::2], pd[H // 2, 1::4] = 2, 4, 1 | 8
    quals = [rng.integers(18, 46, (R, P)), rng.integers(30, 46, (R, P)),
             rng.integers(30, 46, (R, P)), np.full((R, P), 10)]
    lanes = np.arange(P, dtype=np.int32)
    arrays = dict(hap_u=hap, happd_u=pd,
                  readq_u=np.stack([read] + [q.astype(np.uint8) for q in quals]),
                  ridx=lanes, hidx=lanes,
                  haplen=rng.integers(H // 2, H + 1, P).astype(np.int32),
                  rslen=rng.integers(R // 2, R + 1, P).astype(np.int32))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}


@pytest.mark.parametrize("R,H,P", [(160, 192, 128), (640, 704, 32)],
                         ids=["single_pass_regime", "chunked_regime"])
def test_pdhmm_kernel_matches_twin(cuda_device, R, H, P):
    """The PDHMM kernel against its twin, with PD events, in the regimes of
    both TPU kernels it replaces (reads past the chunked kernel's 512 rows):
    the same lanes below MIN_ACCEPTED, the others at 1e-5 in log10."""
    from gkl_tpu_torch.context import MIN_ACCEPTED
    from gkl_tpu_torch.ops import pdhmm_cuda

    t = {k: v.to(cuda_device) for k, v in _pdhmm_batch(R, H, P, seed=R).items()}
    launches = pdhmm_cuda.LAUNCHES
    got = pdhmm_cuda.pdhmm(**t).cpu().numpy()
    assert pdhmm_cuda.LAUNCHES == launches + 1
    want = pdhmm_cuda.pdhmm_indexed_reference(**t).cpu().numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    below = want < MIN_ACCEPTED
    np.testing.assert_array_equal(got < MIN_ACCEPTED, below)
    assert below.any() and (~below).any()
    np.testing.assert_allclose(np.log10(got[~below].astype(np.float64)),
                               np.log10(want[~below].astype(np.float64)), rtol=0, atol=1e-5)


def _force_pdhmm_rows(monkeypatch, rows):
    """Launch the PDHMM kernel's instance of ``rows`` rows a thread at any R
    (and allocate the pass boundary as that instance needs it)."""
    from gkl_tpu_torch.ops import pdhmm_cuda

    monkeypatch.setattr(pdhmm_cuda, "pdhmm_geometry",
                        lambda R, dtype="float32": (rows, 32 * rows, -(-R // (32 * rows))))


def _pdhmm_lanes(t, rslen=(), haplen=(), events=()):
    """``_pdhmm_batch`` tensors with the first lanes' lengths set and PD
    bytes ``(column, byte, lanes)`` written into every lane's haplotype."""
    t = {k: v.clone() for k, v in t.items()}
    t["rslen"][:len(rslen)] = torch.tensor(rslen, dtype=torch.int32)
    t["haplen"][:len(haplen)] = torch.tensor(haplen, dtype=torch.int32)
    for col, byte, lanes in events:
        t["happd_u"][col, lanes] = byte
    return t


def _pdhmm_kernel_bit_equal(dev, t, dtype="float32"):
    """One launch of the PDHMM kernel's ``dtype`` instance against the twin
    in its order on the same card tensors: every lane's result equal bit
    for bit.  Returns the kernel's result."""
    from gkl_tpu_torch.ops import pdhmm_cuda

    t = {k: v.to(dev) for k, v in t.items()}
    f64 = dtype == "float64"
    kernel, counter = (pdhmm_cuda.pdhmm_f64, "F64_LAUNCHES") if f64 else (pdhmm_cuda.pdhmm,
                                                                          "LAUNCHES")
    launches = getattr(pdhmm_cuda, counter)
    got = kernel(**t)
    assert getattr(pdhmm_cuda, counter) == launches + 1
    want = pdhmm_cuda.pdhmm_kernel_order(**t, dtype=dtype)
    bits = np.int64 if f64 else np.int32
    np.testing.assert_array_equal(got.cpu().numpy().view(bits), want.cpu().numpy().view(bits))
    return got


# PD events at the edges of the 32-column fetch windows, adjacent deletion
# pairs among them, and PD SNPs
_PDHMM_EDGE_EVENTS = [(0, 2, slice(0, None, 3)), (2, 4, slice(0, None, 3)),
                      (31, 2, slice(1, None, 3)), (32, 4, slice(1, None, 3)),
                      (33, 2 | 4, slice(1, None, 3)), (34, 4, slice(1, None, 3)),
                      (63, 1 | 16, slice(2, None, 3)), (64, 1 | 8, slice(2, None, 3)),
                      (65, 2, slice(None, None, 2)), (95, 4, slice(None, None, 2))]


@pytest.mark.parametrize("rows", [2, 4, 8])
def test_pdhmm_kernel_instances_at_pass_edges(cuda_device, monkeypatch, rows):
    """Every instance of the warp-wavefront PDHMM kernel equals the twin in
    its order bit for bit, with rslen on either side of its first and second
    pass edges (32 * rows +- 1, 64 * rows +- 1), over three passes, and
    lanes of 1 row, with PD events at the fetch windows' edges."""
    _force_pdhmm_rows(monkeypatch, rows)
    e = 32 * rows
    R = 3 * e
    _pdhmm_kernel_bit_equal(cuda_device, _pdhmm_lanes(
        _pdhmm_batch(R, 96, 24, seed=rows),
        rslen=[e - 1, e, e + 1, 2 * e - 1, 2 * e, 2 * e + 1, R, R - 1, 1, 1],
        haplen=[96, 96, 95, 64, 65, 33, 96, 32, 96, 1], events=_PDHMM_EDGE_EVENTS))


@pytest.mark.parametrize("rows", [2, 4])
def test_pdhmm_f64_instances_at_pass_edges(cuda_device, monkeypatch, rows):
    """Every f64 instance (the rescue's) equals the twin in its order in
    f64 bit for bit, at the f32 test's pass edges, lengths and PD events."""
    _force_pdhmm_rows(monkeypatch, rows)
    e = 32 * rows
    R = 3 * e
    _pdhmm_kernel_bit_equal(cuda_device, _pdhmm_lanes(
        _pdhmm_batch(R, 96, 24, seed=rows),
        rslen=[e - 1, e, e + 1, 2 * e - 1, 2 * e, 2 * e + 1, R, R - 1, 1, 1],
        haplen=[96, 96, 95, 64, 65, 33, 96, 32, 96, 1], events=_PDHMM_EDGE_EVENTS),
        dtype="float64")


@pytest.mark.parametrize("lane_warps", [1, 2, 3, 8])
def test_pdhmm_f64_relay_at_every_lane_warps(cuda_device, monkeypatch, lane_warps):
    """The f64 instance's relay (a lane's passes on ``lane_warps`` warps,
    each trailing the one before through the boundary row) equals the twin
    in its order bit for bit: lanes of 1 to 7 passes of 128 rows beside
    each other, with PD events at the fetch windows' edges and haplotypes
    ending at them."""
    from gkl_tpu_torch.ops import pdhmm_cuda

    monkeypatch.setattr(pdhmm_cuda, "f64_lane_warps", lambda P, passes, sms: lane_warps)
    t = _pdhmm_lanes(_pdhmm_batch(896, 200, 16, seed=75),
                     rslen=[896, 895, 769, 768, 640, 129, 128, 1, 300, 500],
                     haplen=[200, 31, 32, 33, 64, 200, 96, 200, 1, 65],
                     events=_PDHMM_EDGE_EVENTS)
    _pdhmm_kernel_bit_equal(cuda_device, t, dtype="float64")


def test_pdhmm_f64_keeps_subnormals(cuda_device):
    """The 1,412 cases of the deepest golden file (every one below
    MIN_ACCEPTED in f32, some with an f64 raw in the subnormal range)
    through the picked f64 instance: bit for bit the twin in its order,
    within 1e-9 in log10 of the host oracle and 1e-4 of the file."""
    from gkl_tpu_torch.context import pdhmm_context
    from gkl_tpu_torch.ops import pdhmm_ref

    cases = golden.load_pdhmm_cases("pdhmm_syn_1412_129_223.txt")
    args = ([c.hap for c in cases], [c.hap_pd for c in cases], [c.read for c in cases],
            [(c.q, c.iq, c.dq, c.gcp) for c in cases])
    lanes = np.arange(len(cases))
    pk = tbatch.pack_pdhmm_indexed(*args, lanes, lanes)
    names = ("hap_u", "happd_u", "readq_u", "ridx", "hidx", "haplen", "rslen")
    raw = _pdhmm_kernel_bit_equal(cuda_device, {k: torch.from_numpy(getattr(pk, k))
                                                for k in names}, dtype="float64")
    raw = raw.cpu().numpy()[:pk.n_real]
    assert ((raw > 0) & (raw < np.finfo(np.float64).tiny)).any()
    got = np.log10(raw) - pdhmm_context("float64").INITIAL_CONDITION_LOG10
    np.testing.assert_allclose(got, pdhmm_ref.pdhmm_scalar_batch(*args), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, [c.expected for c in cases], rtol=0, atol=1e-4)


def test_pdhmm_f64_malformed_lanes_are_nan(cuda_device):
    """The f64 instance gives NaN to lanes with an index or a length out of
    range, and the good lanes beside them equal the twin bit for bit."""
    from gkl_tpu_torch.ops import pdhmm_cuda

    t = {k: v.to(cuda_device) for k, v in _pdhmm_batch(200, 64, 40, seed=74).items()}
    bad = torch.tensor([1, 6, 9, 39], device=cuda_device)
    t["rslen"][1], t["haplen"][6], t["ridx"][9], t["hidx"][39] = 0, 65, 40, -1
    got = pdhmm_cuda.pdhmm_f64(**t)
    good = torch.ones(40, dtype=torch.bool, device=cuda_device)
    good[bad] = False
    assert torch.isnan(got[bad]).all()
    want = pdhmm_cuda.pdhmm_kernel_order(**{k: v[good] if k in (
        "ridx", "hidx", "haplen", "rslen") else v for k, v in t.items()}, dtype="float64")
    np.testing.assert_array_equal(got[good].cpu().numpy().view(np.int64),
                                  want.cpu().numpy().view(np.int64))


def test_pdhmm_rescue_on_card_is_the_oracle(cuda_device, monkeypatch):
    """One region of the benchmark's long cell through ``PDHMM()`` on the
    card: its rescue runs the f64 instance, a launch a rescue and never the
    host oracle, on exactly the lanes whose f32 result is below
    MIN_ACCEPTED, counted by ``pdhmm_card_rescue``; each rescued lane
    within 1e-9 in log10 of the host oracle."""
    from gkl_tpu_torch import api_pdhmm, profiling
    from gkl_tpu_torch.context import MIN_ACCEPTED
    from gkl_tpu_torch.ops import pdhmm_cuda, pdhmm_ref

    raws = []
    real_run = api_pdhmm.PDHMM._run_indexed
    monkeypatch.setattr(api_pdhmm.PDHMM, "_run_indexed",
                        lambda self, *a: raws.append(real_run(self, *a)) or raws[-1])
    oracle = []
    real_oracle = pdhmm_ref.pdhmm_scalar_batch
    monkeypatch.setattr(pdhmm_ref, "pdhmm_scalar_batch",
                        lambda *a, **kw: oracle.append(1) or real_oracle(*a, **kw))
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    profiling.METRICS.reset()
    launches = pdhmm_cuda.F64_LAUNCHES
    out, rescues = chip_smoke.long_cell_rescue()
    launches = pdhmm_cuda.F64_LAUNCHES - launches
    snap = profiling.METRICS.snapshot()
    profiling.METRICS.reset()
    assert oracle == [] and launches == len(rescues) > 0
    below = [int(np.sum(r < MIN_ACCEPTED)) for r in raws]
    assert [len(r) for r, _, _ in rescues] == [b for b in below if b]
    n = sum(below)
    assert snap["pdhmm_card_rescue"]["items"] == snap["pdhmm_rescue"]["items"] == n
    for ridx, hidx, planes in rescues:
        exact = real_oracle(*planes.pairs(ridx, hidx))
        got = api_pdhmm.PDHMM(device=cuda_device)._rescue(ridx, hidx, planes)
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-9)
    assert np.isfinite(out).all()


def test_pdhmm_kernel_events_at_fetch_edges(cuda_device):
    """The picked instance (8 rows a thread, 2 passes) with PD events at
    the fetch windows' edges and at each lane's last column, and lanes with
    haplotypes ending at those edges."""
    t = _pdhmm_lanes(_pdhmm_batch(300, 130, 40, seed=71),
                     rslen=[300, 257, 256, 255, 300, 300, 300],
                     haplen=[130, 32, 33, 64, 65, 96, 97], events=_PDHMM_EDGE_EVENTS)
    lanes = torch.arange(40)
    t["happd_u"][t["haplen"].long() - 1, lanes] |= 4
    _pdhmm_kernel_bit_equal(cuda_device, t)


def test_pdhmm_kernel_one_row_and_one_column_lanes(cuda_device):
    """Lanes of 1 read row, of 1 haplotype column and of both, beside lanes
    past one pass."""
    _pdhmm_kernel_bit_equal(cuda_device, _pdhmm_lanes(
        _pdhmm_batch(320, 64, 12, seed=72), rslen=[1, 1, 1, 320, 257, 2],
        haplen=[1, 64, 7, 1, 1, 1], events=[(0, 2 | 4, slice(None))]))


def test_pdhmm_kernel_malformed_lanes_beside_good_ones(cuda_device):
    """Lanes with an index or a length out of range get NaN, and the good
    lanes of their blocks equal the twin in its order bit for bit."""
    from gkl_tpu_torch.ops import pdhmm_cuda

    t = {k: v.to(cuda_device) for k, v in _pdhmm_batch(300, 64, 1056, seed=73).items()}
    bad = torch.tensor([1, 6, 9, 1030, 1055], device=cuda_device)
    t["rslen"][1], t["haplen"][6], t["ridx"][9], t["hidx"][1030], t["rslen"][1055] = \
        0, 65, 1056, -1, 301
    got = pdhmm_cuda.pdhmm(**t)
    good = torch.ones(1056, dtype=torch.bool, device=cuda_device)
    good[bad] = False
    assert torch.isnan(got[bad]).all()
    want = pdhmm_cuda.pdhmm_kernel_order(**{k: v[good] if k in (
        "ridx", "hidx", "haplen", "rslen") else v for k, v in t.items()})
    np.testing.assert_array_equal(got[good].cpu().numpy().view(np.int32),
                                  want.cpu().numpy().view(np.int32))


@pytest.mark.parametrize("use_double", [False, True])
def test_pdhmm_golden_on_card(cuda_device, use_double):
    from gkl_tpu_torch import PDHMM, PDHMMNativeArguments

    cases = golden.load_pdhmm_cases("pdhmm_syn_199_68_51.txt")
    hmm = PDHMM(PDHMMNativeArguments(use_double_precision=use_double), device=cuda_device)
    got = hmm._compute_pairs([c.hap for c in cases], [c.hap_pd for c in cases],
                             [c.read for c in cases],
                             [(c.q, c.iq, c.dq, c.gcp) for c in cases])
    np.testing.assert_allclose(got, [c.expected for c in cases], rtol=0, atol=1e-4)


def test_pdhmm_object_path_on_card_is_the_flat_path(cuda_device, monkeypatch):
    """On the card, ``compute_likelihoods`` under a 1 MB budget (reads of
    two kernel passes against 1,000-base haplotypes: several slices) is bit
    for bit ``compute_pdhmm`` on the flattened read-major cross product, and
    neither path computes the column states: the kernel derives them, so
    ``PackedPDHMMIndexed.states_u`` stays unread."""
    from gkl_tpu_torch import PDHMM, PDHaplotypeData, PDHMMNativeArguments
    from gkl_tpu_torch.ops import pdhmm as pdhmm_ops
    from gkl_tpu_torch.ops import pdhmm_cuda

    rng = np.random.default_rng(17)
    base = BASES[rng.integers(0, 4, 1000)]
    haps = []
    for k in range(4):
        pd = np.zeros(1000, np.uint8)
        if k:
            at = 100 * k
            pd[at], pd[at + 5 * k] = 2, 4
            pd[at + 300] = 1 | 16
        haps.append(PDHaplotypeData(base.copy(), haplotype_pdbases=pd))
    reads = []
    for _ in range(60):
        n = int(rng.integers(260, 301))
        start = int(rng.integers(0, 1000 - n))
        read = base[start:start + n].copy()
        read[rng.integers(0, n, 3)] = BASES[rng.integers(0, 4, 3)]
        reads.append(ReadData(read, rng.integers(10, 40, n).astype(np.uint8),
                              *(np.full(n, v, np.uint8) for v in (45, 45, 10))))
    calls = []
    real = pdhmm_ops.column_states
    monkeypatch.setattr(pdhmm_ops, "column_states", lambda pd: calls.append(1) or real(pd))
    args = PDHMMNativeArguments(max_memory_in_mb=1)
    launches = pdhmm_cuda.LAUNCHES
    got = PDHMM(args, device=cuda_device).compute_likelihoods(reads, haps)
    assert pdhmm_cuda.LAUNCHES - launches >= 2

    def rows(seqs, width):
        out = np.zeros((len(seqs), width), np.uint8)
        for k, s in enumerate(seqs):
            out[k, :len(s)] = s
        return out
    pairs = [(r, h) for r in reads for h in haps]
    flat = PDHMM(args, device=cuda_device).compute_pdhmm(
        rows([h.haplotype_bases for _, h in pairs], 1000),
        rows([h.haplotype_pdbases for _, h in pairs], 1000),
        *(rows([getattr(r, f) for r, _ in pairs], 300) for f in (
            "read_bases", "read_quals", "insertion_gop", "deletion_gop", "overall_gcp")),
        [1000] * len(pairs), [len(r.read_bases) for r, _ in pairs])
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got.view(np.int64), flat.view(np.int64))
    assert calls == []


def test_pdhmm_pallas_level_runs_on_card(cuda_device):
    """KernelLevel.PALLAS runs the kernel on a CUDA device."""
    from gkl_tpu_torch import PDHMM, KernelLevel, PDHaplotypeData, PDHMMNativeArguments
    from gkl_tpu_torch.ops import pdhmm_cuda

    hap = np.resize(BASES, 40)
    rd = [ReadData(hap[3:30], np.full(27, 30, np.uint8), *(np.full(27, v, np.uint8)
                                                           for v in (45, 45, 10)))]
    launches = pdhmm_cuda.LAUNCHES
    got = PDHMM(PDHMMNativeArguments(kernel_level=KernelLevel.PALLAS),
                device=cuda_device).compute_likelihoods(
        rd, [PDHaplotypeData(hap, haplotype_pdbases=np.zeros(40, np.uint8))])
    assert pdhmm_cuda.LAUNCHES == launches + 1 and np.isfinite(got).all()


@pytest.mark.parametrize("kernel", ["sw_forward", "sw_walk", "pdhmm", "pairhmm_rows",
                                    "pairhmm_cols", "pdhmm_f64"])
def test_new_wrappers_refuse_cuda_without_kernel(cuda_device, monkeypatch, kernel):
    """With no kernel to build, the SW, PDHMM (f32 and f64), rows and cols
    wrappers raise on CUDA tensors and never fall back to their twins."""
    from gkl_tpu_torch.ops import pairhmm_cols, pdhmm_cuda, sw_cuda

    def no_kernel():
        raise native_lib.BuildError("no kernel built")

    monkeypatch.setattr(cuda_build, "load", no_kernel)
    if kernel == "sw_forward":
        args = [torch.from_numpy(a).to(cuda_device) for a in _sw_batch(8, 8, 8, seed=0)]
        with pytest.raises(native_lib.BuildError):
            sw_cuda.sw_forward(*args, 1, -1, -2, -1, indel_boundary=False)
    elif kernel == "sw_walk":
        args = [torch.from_numpy(a).to(cuda_device) for a in walk_cases.walk_case("random")]
        with pytest.raises(native_lib.BuildError):
            sw_cuda.sw_walk(*args, 9)
    elif kernel in ("pdhmm", "pdhmm_f64"):
        t = {k: v.to(cuda_device) for k, v in _pdhmm_batch(8, 8, 8, seed=0).items()}
        with pytest.raises(native_lib.BuildError):
            getattr(pdhmm_cuda, kernel)(**t)
    elif kernel == "pairhmm_rows":
        with pytest.raises(native_lib.BuildError):
            pairhmm_cuda.pairhmm_rows(**chip_smoke.indexed_args(_dense_batch(8, 16, 8, seed=0)))
    else:
        with pytest.raises(native_lib.BuildError):
            pairhmm_cols.pairhmm_cols(**chip_smoke.indexed_args(_dense_batch(8, 16, 8, seed=0)))


def _dense_batch(R, H, P, seed):
    """Ragged dense planes on the card, every sixth lane a random read."""
    return chip_smoke.dense_batch(R, H, P, seed, mut=0.02, deep_every=6)


def _assert_raw_agree(got, want):
    """The same lanes below MIN_ACCEPTED (save lanes within 1e-5 of it in
    log10), the others within 1e-5 in log10, and lanes on both sides."""
    _, below = chip_smoke.compare_raw(got, want, "kernel vs twin", near=1e-5)
    assert 0 < below < got.shape[0]


def _set_lanes(planes, lanes, rslen=None, haplen=None):
    """Lengths given for some lanes; the deep lanes (every sixth, from
    lane 0) are best left alone, so that some lanes stay below
    MIN_ACCEPTED."""
    for i, values in ((7, rslen), (6, haplen)):
        if values is not None:
            planes[i][torch.tensor(lanes, device=planes[i].device)] = torch.tensor(
                values, dtype=torch.int32, device=planes[i].device)
    return planes


def _cols_case(case):
    """Dense card planes for the column kernel: the regimes of both TPU
    kernels it replaces, and the edges of its warp wavefront."""
    if case == "cols_regime":
        return _dense_batch(96, 320, 40, seed=96)
    if case == "relay_regime":
        return _dense_batch(200, 300, 24, seed=200)
    if case == "pass_edge_4_rows":  # one pass of 128 rows
        return _set_lanes(_dense_batch(128, 180, 16, seed=1), [0, 1, 2, 3],
                          rslen=[128, 127, 97, 1])
    if case == "pass_edge_8_rows":  # one pass of 256 rows
        return _set_lanes(_dense_batch(256, 350, 16, seed=2), [0, 1, 2], rslen=[256, 255, 129])
    if case == "pass_edges_16_rows":  # three passes of 512 rows
        return _set_lanes(_dense_batch(1056, 1420, 16, seed=3), [0, 1, 2, 3, 4, 5],
                          rslen=[512, 513, 1024, 1025, 1056, 511])
    if case == "one_row_one_column":
        return _set_lanes(_dense_batch(128, 180, 24, seed=4), [1, 2, 3], rslen=[1, 40, 1],
                          haplen=[60, 1, 1])
    if case == "lengths_10x":  # the odd lanes 10x shorter in both lengths
        odd = list(range(1, 16, 2))
        return _set_lanes(_dense_batch(640, 860, 16, seed=5), odd, rslen=[60] * 8,
                          haplen=[85] * 8)
    # 'N' in reads and haplotypes
    planes = _dense_batch(96, 128, 24, seed=6)
    planes[1][5, :8] = planes[1][40:44, 3] = ord("N")
    planes[0][10, 4:12] = planes[0][50:60, 3] = ord("N")
    return planes


@pytest.mark.parametrize("case", [
    "cols_regime", "relay_regime", "pass_edge_4_rows", "pass_edge_8_rows", "pass_edges_16_rows",
    "one_row_one_column", "lengths_10x", "n_bases"])
def test_cols_kernel_matches_twin(cuda_device, case):
    """The column kernel against its twin on the same card tensors, ragged
    lengths and deep lanes included, on reads in the ranges of both TPU
    kernels it replaces (up to 128 rows, and longer), at rslen on and just
    past its pass edges, a 1-row read and a 1-column haplotype, lanes whose
    lengths differ 10x in one launch, and 'N' bases, with the gap quals as
    planes and as constants."""
    from gkl_tpu_torch.ops import pairhmm_cols

    planes = _cols_case(case)
    t = chip_smoke.indexed_args(planes)
    launches = pairhmm_cols.LAUNCHES
    got = pairhmm_cols.pairhmm_cols(**t)
    assert pairhmm_cols.LAUNCHES == launches + 1
    _assert_raw_agree(got, pairhmm_cols.pairhmm_raw_cols(*planes))
    del t["quals_u"]
    got = pairhmm_cols.pairhmm_cols(**t, const_quals=(45, 45, 10))
    planes = pairhmm_cuda.expand_indexed_planes(t["hap_u"], t["readq_u"], t["ridx"], t["hidx"],
                                                const_quals=(45, 45, 10))
    _assert_raw_agree(got, pairhmm_cols.pairhmm_raw_cols(*planes, t["haplen"], t["rslen"]))


def test_cols_kernel_malformed_lanes_beside_good_ones(cuda_device):
    """Lanes with an out-of-range length or index get NaN, and the other
    lanes of their blocks (1,056 lanes: blocks of four warps, a lane each)
    keep their results bit for bit."""
    from gkl_tpu_torch.ops import pairhmm_cols

    t = chip_smoke.indexed_args(_dense_batch(32, 48, 1056, seed=7))
    good = pairhmm_cols.pairhmm_cols(**t)
    bad = dict(t, haplen=t["haplen"].clone(), rslen=t["rslen"].clone(), ridx=t["ridx"].clone())
    bad["haplen"][1] = 49
    bad["rslen"][6] = 0
    bad["ridx"][1030] = 1056
    got = pairhmm_cols.pairhmm_cols(**bad)
    nan = torch.zeros(1056, dtype=torch.bool, device=cuda_device)
    nan[[1, 6, 1030]] = True
    assert torch.isnan(got[nan]).all()
    assert torch.equal(got[~nan], good[~nan]) and torch.isfinite(good).all()


@pytest.mark.parametrize("const_quals", [None, (45, 45, 10)])
def test_rows_kernel_matches_twin(cuda_device, const_quals):
    """The rows kernel (the plain instance of the scaled kernel) against
    ``pairhmm_raw`` on the same card tensors, with a read bucket that is not
    a multiple of 8 and the gap quals as planes or as constants."""
    from gkl_tpu_torch.ops import pairhmm as tops

    t = chip_smoke.indexed_args(_dense_batch(124, 176, 48, seed=4))
    if const_quals is not None:
        del t["quals_u"]
        t["const_quals"] = const_quals
    launches = pairhmm_cuda.ROWS_LAUNCHES
    got = pairhmm_cuda.pairhmm_rows(**t)
    assert pairhmm_cuda.ROWS_LAUNCHES == launches + 1
    planes = pairhmm_cuda.expand_indexed_planes(
        t["hap_u"], t["readq_u"], t["ridx"], t["hidx"], const_quals=const_quals,
        quals_u=t.get("quals_u"))
    _assert_raw_agree(got, tops.pairhmm_raw(*planes, t["haplen"], t["rslen"], dtype="float32"))


def test_api_long_haplotype_on_card(cuda_device):
    """PairHMM on CUDA with haplotypes past PALLAS_MAX_HAP: the column
    kernel runs on every group, reads of up to 128 rows and longer, and the
    scaled kernel does not; the results, rescue included, match the exact
    f64 oracle at 1e-4."""
    from gkl_tpu_torch.ops import pairhmm_cols

    rng = np.random.default_rng(21)
    haps = [BASES[rng.integers(0, 4, n)] for n in (2100, 2400)]
    rd = []
    for i, n in enumerate((90, 120, 150, 140, 100, 60)):
        h = haps[i % 2]
        seq = h[int(rng.integers(0, len(h) - n)):][:n].copy()
        rate = 0.3 if i == 3 else 0.02
        mut = rng.random(n) < rate
        seq[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
        rd.append(ReadData(seq, rng.integers(18, 46, n).astype(np.uint8),
                           *(np.full(n, v, np.uint8) for v in (45, 45, 10))))
    cols, scaled = pairhmm_cols.LAUNCHES, pairhmm_cuda.LAUNCHES
    got = PairHMM(device=cuda_device).compute_likelihoods(rd, [HaplotypeData(h) for h in haps])
    # read buckets 64, 96, 128 and 160 x 2 hap buckets
    assert pairhmm_cols.LAUNCHES - cols == 8 and pairhmm_cuda.LAUNCHES == scaled
    want = pairhmm_ref.pairhmm_scalar_batch(
        [h for _ in rd for h in haps], [r.read_bases for r in rd for _ in haps],
        [(r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp) for r in rd for _ in haps])
    assert (want < -64).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_long_wrappers_validate_inputs(cuda_device):
    """The rows and cols wrappers raise on a wrong dtype, a tensor on
    another device or planes of mismatched shape."""
    from gkl_tpu_torch.ops import pairhmm_cols

    t = chip_smoke.indexed_args(_dense_batch(16, 24, 8, seed=1))
    with pytest.raises(ValueError, match="quals_u"):
        pairhmm_cols.pairhmm_cols(**dict(t, quals_u=t["quals_u"].to(torch.int32)))
    with pytest.raises(ValueError, match="rslen"):
        pairhmm_cols.pairhmm_cols(**dict(t, rslen=t["rslen"].cpu()))
    with pytest.raises(ValueError, match="quals_u"):
        pairhmm_cols.pairhmm_cols(**dict(t, quals_u=t["quals_u"][:, :8].contiguous()))
    with pytest.raises(ValueError, match="ridx"):
        pairhmm_cuda.pairhmm_rows(**dict(t, ridx=t["ridx"].to(torch.int64)))
    with pytest.raises(ValueError, match="readq_u"):
        pairhmm_cuda.pairhmm_rows(**dict(t, readq_u=t["readq_u"].cpu()))
    with pytest.raises(ValueError, match="quals_u"):
        pairhmm_cuda.pairhmm_rows(**dict(t, quals_u=t["quals_u"][:, :8].contiguous()))


def _row_kernel(t, scaled):
    """Launch the scaled or the plain instance of the row kernel on the
    indexed batch ``t``; returns its raw output (the (3, P) int32 tensor, or
    the (P,) f32 raw forward)."""
    if scaled:
        return pairhmm_cuda.pairhmm_scaled(**t)
    return pairhmm_cuda.pairhmm_rows(**t)


def _assert_bit_equal_to_kernel_order(out, t, scaled):
    """The row kernel's output equals the kernel-order twin's on the same
    card tensors in every bit (mantissa, exp2 and flag, or the f32 result)."""
    twin = chip_smoke.twin_in_kernel_order(t, scaled=scaled)
    if scaled:
        chip_smoke.lanes_not_bit_equal(out, twin, "test")
    else:
        assert torch.equal(out.view(torch.int32), twin.view(torch.int32))


def _band_case(case):
    """Dense card planes for the row kernel: ragged lengths with deep
    lanes, a lane count that is not a multiple of four, and a warp whose
    lanes end in different bands and columns."""
    if case == "ragged":
        return _dense_batch(96, 128, 40, seed=8)
    if case == "p_not_multiple_of_4":
        return _dense_batch(64, 96, 13, seed=9)
    if case == "one_lane":
        return _dense_batch(40, 48, 1, seed=10)
    # two warps: rslen in bands 0-11 and 1-row, 1-column lanes side by side
    return _set_lanes(_dense_batch(96, 100, 8, seed=12), list(range(8)),
                      rslen=[1, 8, 9, 96, 17, 40, 88, 3], haplen=[1, 100, 64, 7, 33, 2, 99, 50])


@pytest.mark.parametrize("const_quals", [None, (45, 45, 10)])
@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "rows"])
@pytest.mark.parametrize("case", ["ragged", "p_not_multiple_of_4", "one_lane",
                                  "lengths_across_bands"])
def test_row_kernel_bit_equal_to_kernel_order_twin(cuda_device, case, scaled, const_quals):
    """Both instances of the band-wavefront row kernel against the twin in
    the kernel's order, bit for bit, with the gap quals as planes and as
    constants: ragged lengths, P = 13 and P = 1 (warps with lanes past P),
    and lanes of one warp whose rslen ends in different bands."""
    t = chip_smoke.indexed_args(_band_case(case))
    if const_quals is not None:
        del t["quals_u"]
        t["const_quals"] = const_quals
    launches = pairhmm_cuda.LAUNCHES, pairhmm_cuda.ROWS_LAUNCHES
    out = _row_kernel(t, scaled)
    assert (pairhmm_cuda.LAUNCHES, pairhmm_cuda.ROWS_LAUNCHES) == (
        launches[0] + scaled, launches[1] + (not scaled))
    _assert_bit_equal_to_kernel_order(out, t, scaled)


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "rows"])
def test_row_kernel_malformed_lanes_beside_good_ones(cuda_device, scaled):
    """Lanes with an out-of-range length or index share warps with good
    lanes (four lanes a warp): they get a NaN mantissa (and flag -1), and
    the good lanes keep their results bit for bit."""
    t = chip_smoke.indexed_args(_dense_batch(48, 64, 12, seed=13))
    good = _row_kernel(t, scaled)
    bad = dict(t, haplen=t["haplen"].clone(), rslen=t["rslen"].clone(), ridx=t["ridx"].clone())
    bad["haplen"][1] = 65
    bad["rslen"][6] = 0
    bad["ridx"][9] = 12
    got = _row_kernel(bad, scaled)
    nan = torch.zeros(12, dtype=torch.bool, device=cuda_device)
    nan[[1, 6, 9]] = True
    if scaled:
        mant, _, flag = pairhmm_cuda.unpack(got)
        assert torch.isnan(mant[nan]).all() and (flag[nan] == -1).all()
        assert torch.equal(got[:, ~nan], good[:, ~nan])
    else:
        assert torch.isnan(got[nan]).all() and torch.equal(got[~nan], good[~nan])
    _assert_bit_equal_to_kernel_order(good, t, scaled)


def test_validation_run_on_card(cuda_device):
    """validation.run with the three engines on the card: the corpus BAM
    the port writes, streamed through region_bam, passes the three oracle
    legs, and every kernel of the path launches."""
    from gkl_tpu_torch import validation
    from gkl_tpu_torch.ops import pdhmm_cuda, sw_cuda

    before = pairhmm_cuda.LAUNCHES, sw_cuda.LAUNCHES, pdhmm_cuda.LAUNCHES
    stats = validation.run(n_reads=1024, sample_stride=16, seed=0, device=cuda_device)
    after = pairhmm_cuda.LAUNCHES, sw_cuda.LAUNCHES, pdhmm_cuda.LAUNCHES
    assert all(a > b for a, b in zip(after, before))
    assert (stats["n_reads"], stats["n_deep_lanes"]) == (1024, 16)
    assert stats["pairhmm_max_err"] < 1e-4 and stats["pdhmm_max_err"] < 1e-4
    assert stats["n_sw_checked"] == 64


@pytest.mark.parametrize("level", [1, 6, 9])
def test_recompress_round_trip(cuda_device, tmp_path, level):
    """pipeline.bam_recompress of the test BAM keeps every record's name,
    bases, qualities and raw bytes, and ends in the BGZF EOF block (on the
    GPU machine, where the JAX package that the CPU tests compare with is
    absent)."""
    import os

    from gkl_tpu_torch import bam, pipeline
    from gkl_tpu_torch.compression import bgzf

    src = os.path.join(chip_smoke.DATA, "HiSeq.1mb.1RG.2k_lines.bam")
    _, want = bam.read_bam(src, keep_raw=True)
    dst = str(tmp_path / "out.bam")
    assert pipeline.bam_recompress(src, dst, level=level, window_blocks=2) == len(want)
    assert (tmp_path / "out.bam").read_bytes().endswith(bgzf.EOF_BLOCK)
    _, got = bam.read_bam(dst, keep_raw=True)
    assert [(r.name, r.raw) for r in got] == [(r.name, r.raw) for r in want]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.seq, b.seq)
        np.testing.assert_array_equal(a.qual, b.qual)


def _two_shards_on(device):
    from gkl_tpu_torch import parallel

    return parallel.data_parallel_mesh(devices=[device, device])


def test_mesh_apis_on_one_card_equal_one_device(cuda_device):
    """PairHMM, SmithWaterman and PDHMM on a two-shard mesh of one card
    equal the one-device engines bit for bit (CIGARs and offsets equal),
    each kernel launching once a shard for each launch of the engine."""
    from gkl_tpu_torch import PDHMM, PDHaplotypeData, SmithWaterman, SWParameters
    from gkl_tpu_torch.api_sw import OverhangStrategy
    from gkl_tpu_torch.ops import pdhmm_cuda, sw_cuda

    mesh = _two_shards_on(cuda_device)
    haps, reads, quals = _indexed_batch(1, n_reads=40)
    rd = [ReadData(r, *q) for r, q in zip(reads, quals)]
    hd = [HaplotypeData(h) for h in haps]
    one = PairHMM(device=cuda_device).compute_likelihoods(rd, hd)
    before = pairhmm_cuda.LAUNCHES
    mine = PairHMM(mesh=mesh).compute_likelihoods(rd, hd)
    assert pairhmm_cuda.LAUNCHES - before >= 2
    np.testing.assert_array_equal(mine, one)
    pd = np.zeros(max(len(h) for h in haps), np.uint8)
    pd[10], pd[14] = 2, 4
    pdd = [PDHaplotypeData(h, haplotype_pdbases=pd[:len(h)]) for h in haps[:3]]
    before = pdhmm_cuda.LAUNCHES
    np.testing.assert_array_equal(PDHMM(mesh=mesh).compute_likelihoods(rd, pdd),
                                  PDHMM(device=cuda_device).compute_likelihoods(rd, pdd))
    assert pdhmm_cuda.LAUNCHES - before == 3  # two shards, then one device
    params = SWParameters(200, -150, -260, -11)
    refs = [haps[k % len(haps)] for k in range(len(reads))]
    before = sw_cuda.LAUNCHES
    got = SmithWaterman(mesh=mesh).align_batch(refs, reads, params, OverhangStrategy.SOFTCLIP)
    assert sw_cuda.LAUNCHES - before >= 2
    want = SmithWaterman(device=cuda_device).align_batch(refs, reads, params,
                                                         OverhangStrategy.SOFTCLIP)
    assert [(g.cigar, g.alignment_offset) for g in got] == \
        [(w.cigar, w.alignment_offset) for w in want]


def test_sharded_engines_on_one_card_equal_the_wrappers(cuda_device):
    """Every sharded engine of ``parallel`` on two shards of one card: bit
    for bit its wrapper on the whole batch (SW on the region the walk
    reads)."""
    import torch_distributed_worker as w

    from gkl_tpu_torch import parallel
    from gkl_tpu_torch.ops import pairhmm_cols, pdhmm_cuda, sw_cuda

    mesh = _two_shards_on(cuda_device)
    planes, pd = w.dense_batch(64, 96, 512, seed=3)
    packed = tbatch.PackedPairs(*planes, n_real=512)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in (*planes, pd)]
    lanes = torch.arange(512, dtype=torch.int32, device=cuda_device)
    whole = dict(hap_u=t[0], readq_u=torch.stack([t[1], t[2]]), ridx=lanes, hidx=lanes,
                 haplen=t[6], rslen=t[7], quals_u=torch.stack(t[3:6]))
    np.testing.assert_array_equal(parallel.pairhmm_raw_pallas_sharded(mesh, packed),
                                  pairhmm_cuda.pairhmm_rows(**whole).cpu().numpy())
    np.testing.assert_array_equal(parallel.pairhmm_raw_pallas_cols_sharded(mesh, packed),
                                  pairhmm_cols.pairhmm_cols(**whole).cpu().numpy())
    m, e, f = parallel.pairhmm_raw_pallas_scaled_sharded(mesh, packed)
    want = pairhmm_cuda.pairhmm_scaled(**whole).cpu().numpy()
    np.testing.assert_array_equal(np.stack([m.view(np.int32), e, f]), want)
    np.testing.assert_array_equal(
        parallel.pdhmm_raw_pallas_sharded(mesh, packed, pd),
        pdhmm_cuda.pdhmm(t[0], t[8], torch.stack(t[1:6]), lanes, lanes, t[6],
                         t[7]).cpu().numpy())
    ref, alt, reflen, altlen = w.sw_batch(96, 64, 512, seed=4)
    got = parallel.sw_forward_pallas_sharded(mesh, ref, alt, reflen, altlen, _sw_params())
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
            for a in (ref, alt, reflen, altlen)]
    want = sw_cuda.sw_forward(*args, *w.GATK, indel_boundary=False)
    assert sw_cuda.in_range_mismatches(tuple(torch.from_numpy(np.ascontiguousarray(x))
                                             for x in got),
                                       tuple(x.cpu() for x in want), args[2], args[3]) == 0


def _sw_params():
    from gkl_tpu_torch import SWParameters

    return SWParameters(200, -150, -260, -11)


def test_two_processes_on_card(cuda_device):
    """The two-process run on the card (``tests/torch_distributed_worker.py``,
    kind ``cuda``: each rank on cuda:<rank % cards>, gloo between them):
    every leg bit for bit, and the plain engine's lanes within 1e-6."""
    from test_torch_distributed import parse_lanes, run_workers
    from torch_distributed_worker import LEGS

    for rc, out, err in run_workers("cuda", timeout=600):
        assert rc == 0, err[-3000:]
        for leg in LEGS:
            assert f"{leg} ok" in out, (leg, out[-2000:])
        got, ref = parse_lanes(out)
        np.testing.assert_allclose(got, ref, rtol=1e-6)
