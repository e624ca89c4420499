"""The PDHMM kernel's twin in its own order of operations
(``ops/pdhmm_cuda.pdhmm_kernel_order``, what ``csrc/pdhmm.cu`` equals bit
for bit on the card) against the scan twin, the JAX package's jnp engine and
its two Pallas kernels in interpret mode, and against itself lane by lane;
the kernel's geometry at the pass edges."""

import numpy as np
import pytest
import torch

from gkl_tpu.ops import pdhmm as jpd
from gkl_tpu.ops import pdhmm_pallas
from gkl_tpu_torch.ops import pdhmm_cuda
from test_torch_pdhmm import _assert_f32_agree, _events_batch, _golden_batch, _twin

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _indexed(args):
    """Dense planes (hap, hap_pd, states, read, q, iq, dq, gcp, haplen,
    rslen) as the indexed batch of ``pdhmm_cuda.pdhmm``: a unique read and
    haplotype per lane."""
    hap, hap_pd, _, read, q, iq, dq, gcp, haplen, rslen = (np.asarray(a) for a in args)
    lanes = np.arange(hap.shape[1], dtype=np.int32)
    arrays = dict(hap_u=hap, happd_u=hap_pd, readq_u=np.stack([read, q, iq, dq, gcp]),
                  ridx=lanes, hidx=lanes, haplen=haplen.astype(np.int32),
                  rslen=rslen.astype(np.int32))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}


def _kernel_order(args):
    return pdhmm_cuda.pdhmm_kernel_order(**_indexed(args)).numpy()


@pytest.mark.parametrize("case", ["golden_990", "golden_199", "events"])
def test_kernel_order_matches_scan_twin_and_jnp(case):
    """Against the scan twin and the jnp f32 engine on golden cases with PD
    events and on a batch with deletion and SNP events: the same lanes below
    MIN_ACCEPTED, the others within 1e-5 in log10."""
    args, n = {"golden_990": lambda: _golden_batch("pdhmm_syn_990_1_2.txt", 48),
               "golden_199": lambda: _golden_batch("pdhmm_syn_199_68_51.txt", 16),
               "events": lambda: (_events_batch(24, 32, 16, seed=1), 16)}[case]()
    got = _kernel_order(args)
    assert got.dtype == np.float32
    _assert_f32_agree(_twin(args), got, n, "kernel order vs scan twin")
    _assert_f32_agree(np.asarray(jpd.pdhmm_raw(*args, dtype="float32")), got, n,
                      "kernel order vs jnp f32")


def test_kernel_order_matches_pallas_single():
    """Against the single-pass Pallas kernel in interpret mode, with PD
    events."""
    args = _events_batch(24, 32, 16, seed=2)
    want = pdhmm_pallas.pdhmm_raw_pallas(*args, lane_block=8, interpret=True)
    _assert_f32_agree(want, _kernel_order(args), 16, "kernel order vs pallas single")


def test_kernel_order_matches_pallas_chunked():
    """Against the chunked Pallas kernel in interpret mode: 48 read rows
    relayed in 16-row chunks with the six boundary planes."""
    args = _events_batch(16, 48, 8, seed=3)
    want = pdhmm_pallas.pdhmm_raw_pallas_chunked(*args, r_chunk=16, lane_block=8,
                                                 interpret=True)
    _assert_f32_agree(want, _kernel_order(args), 8, "kernel order vs pallas chunked")


# lane -> (name, haplen, rslen, {column: PD byte}); None stands for the
# lane's last column
_LANES = [
    ("pd_snps", 40, 36, {6: 1 | 8, 7: 1 | 16, 20: 1 | 32 | 64}),
    ("deletion_pair", 40, 36, {5: 2, 9: 4}),
    ("adjacent_events", 40, 36, {5: 2, 6: 4, 7: 2 | 4, 8: 4, 9: 2, 10: 4}),
    ("events_at_both_ends", 37, 30, {0: 2, 2: 4, None: 4}),
    ("one_row", 40, 1, {3: 2, 6: 4, 8: 1 | 8}),
    ("one_column", 1, 36, {0: 2 | 4}),
    ("one_row_one_column", 1, 1, {}),
    ("deep_read", 40, 36, {12: 2, 15: 4}),
]


def _lanes_batch(seed=21):
    """Dense planes of one lane per ``_LANES`` entry: reads are mutated
    haplotype windows with a few 'N' bases, the deep read random at high
    quals (below MIN_ACCEPTED)."""
    rng = np.random.default_rng(seed)
    H, R, P = 40, 36, len(_LANES)
    hap = BASES[rng.integers(0, 4, (H, P))]
    read = hap[2:2 + R].copy()
    mut = rng.random((R, P)) < 0.06
    read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    read[rng.random((R, P)) < 0.02] = ord("N")
    q = rng.integers(18, 46, (R, P)).astype(np.uint8)
    iq = rng.integers(30, 46, (R, P)).astype(np.uint8)
    dq = rng.integers(30, 46, (R, P)).astype(np.uint8)
    gcp = np.full((R, P), 10, np.uint8)
    hap_pd = np.zeros((H, P), np.uint8)
    haplen = np.zeros(P, np.int32)
    rslen = np.zeros(P, np.int32)
    for p, (name, hl, rl, events) in enumerate(_LANES):
        haplen[p], rslen[p] = hl, rl
        for col, byte in events.items():
            hap_pd[hl - 1 if col is None else col, p] = byte
        if name == "deep_read":
            read[:, p] = BASES[rng.integers(0, 4, R)]
            q[:, p] = iq[:, p] = dq[:, p] = gcp[:, p] = 70
    states = jpd.column_states(hap_pd)
    return hap, hap_pd, states, read, q, iq, dq, gcp, haplen, rslen


def test_kernel_order_lane_alone_equals_lane_in_batch():
    """Each lane computed alone, on planes cut to its own lengths, is bit
    for bit the same lane in the batch: PD SNPs, a DEL_START/DEL_END pair,
    adjacent events, events at column 0 and at haplen-1, 1-row and
    1-column lanes, and a deep lane below MIN_ACCEPTED."""
    args = _lanes_batch()
    batch = _kernel_order(args)
    hap, hap_pd, states, read, q, iq, dq, gcp, haplen, rslen = args
    for p, (name, hl, rl, _) in enumerate(_LANES):
        alone = _kernel_order((hap[:hl, p:p + 1], hap_pd[:hl, p:p + 1], states[:hl, p:p + 1],
                               *(a[:rl, p:p + 1] for a in (read, q, iq, dq, gcp)),
                               haplen[p:p + 1], rslen[p:p + 1]))
        assert alone.view(np.int32)[0] == batch.view(np.int32)[p], name
    # the lanes cover both sides of MIN_ACCEPTED, and agree with the scan twin
    from gkl_tpu_torch import MIN_ACCEPTED

    below = batch < MIN_ACCEPTED
    assert below.any() and not below.all()
    _assert_f32_agree(_twin(args), batch, len(_LANES), "lanes vs scan twin")


@pytest.mark.parametrize("R,want", [
    (1, (2, 64, 1)), (63, (2, 64, 1)), (64, (2, 64, 1)), (65, (4, 128, 1)),
    (128, (4, 128, 1)), (129, (8, 256, 1)), (256, (8, 256, 1)), (257, (8, 256, 2)),
    (512, (8, 256, 2)), (513, (8, 256, 3)), (8192, (8, 256, 32))])
def test_pdhmm_geometry_at_pass_edges(R, want):
    """The smallest instance whose one pass holds the read bucket, else 8
    rows a thread; the pass boundary's bytes per lane only past one pass."""
    assert pdhmm_cuda.pdhmm_geometry(R) == want
    assert pdhmm_cuda.boundary_bytes_per_lane(R, 448) == (24 * 448 if want[2] > 1 else 0)


def test_pdhmm_geometry_refuses_empty_bucket():
    with pytest.raises(ValueError):
        pdhmm_cuda.pdhmm_geometry(0)
