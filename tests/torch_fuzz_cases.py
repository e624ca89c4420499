"""The seeded draws of ``tests/test_kernel_fuzz.py`` without JAX, and the run
of each CUDA kernel against its kernel-order twin on them.

``test_torch_kernel_fuzz.py`` holds the port's twins against the JAX
package's jnp engines on these draws on the CPU; its ``gpu`` test and
``chip_smoke.py`` phase 16e call :func:`kernel_lanes_differ` on the card.
The draws are the fuzz file's: its seeds, shapes and length
distributions, and its three named regression inputs."""

import numpy as np
import torch

BASES4 = np.frombuffer(b"ACGT", np.uint8)
BASES5 = np.frombuffer(b"ACGTN", np.uint8)
SW_SCORES = (200, -150, -260, -11)
P = 16

# (seed, R, H) of test_pairhmm_kernels_agree
PAIRHMM_DRAWS = [(0, 8, 16), (1, 16, 8), (2, 24, 32), (3, 32, 48)]
# (seed, R, H, r_chunk) of test_pairhmm_cols_relay_fuzz (seeds 300+)
COLS_RELAY_DRAWS = [(0, 24, 16, 8), (1, 16, 40, 8), (2, 40, 24, 16), (3, 33, 17, 8)]
# (seed, R, H) of test_pdhmm_kernels_agree (seeds 100+)
PDHMM_DRAWS = [(0, 8, 16), (1, 16, 24), (2, 32, 32)]
# (seed, R, H, r_chunk) of test_pdhmm_chunked_fuzz (seeds 300+)
PDHMM_CHUNKED_DRAWS = [(0, 24, 16, 8), (1, 40, 24, 16), (2, 32, 32, 8)]
# (seed, N, M, indel_boundary) of test_sw_kernels_agree (seeds 200+)
SW_DRAWS = [(0, 8, 16, False), (1, 16, 8, True), (2, 40, 24, False)]
# (seed, N, M, seg, indel_boundary) of test_sw_relay_fuzz (seeds 400+)
SW_RELAY_DRAWS = [(0, 32, 16, 8, False), (1, 48, 24, 16, True)]


def pairhmm_batch(rng, R, H, P=P):
    """Dense planes (hap, read, q, iq, dq, gcp, haplen, rslen): 'N' in
    reads and haplotypes, half the lanes a read that is the hap prefix,
    quals 1-59, GCP 5-29 (``test_kernel_fuzz._pairhmm_batch``)."""
    hap = BASES5[rng.integers(0, 5, (H, P))]
    read = BASES5[rng.integers(0, 5, (R, P))]
    k = min(R, H)
    read[:k, ::2] = hap[:k, ::2]
    q = rng.integers(1, 60, (R, P)).astype(np.uint8)
    iq = rng.integers(1, 60, (R, P)).astype(np.uint8)
    dq = rng.integers(1, 60, (R, P)).astype(np.uint8)
    gcp = rng.integers(5, 30, (R, P)).astype(np.uint8)
    haplen = rng.integers(2, H + 1, P).astype(np.int32)
    rslen = rng.integers(2, R + 1, P).astype(np.int32)
    return [hap, read, q, iq, dq, gcp, haplen, rslen]


def pd_bytes(rng, H, P=P):
    """A DEL_START/DEL_END pair and a SNP byte on every lane."""
    hap_pd = np.zeros((H, P), np.uint8)
    for p in range(P):
        j = int(rng.integers(0, max(1, H - 6)))
        hap_pd[j, p] = 2
        hap_pd[j + int(rng.integers(1, 4)), p] = 4
        s = int(rng.integers(0, H))
        hap_pd[s, p] |= 1 | int(rng.choice([8, 16, 32, 64]))
    return hap_pd


def pairhmm_draw(seed, R, H):
    return pairhmm_batch(np.random.default_rng(seed), R, H)


def cols_relay_draw(seed, R, H, r_chunk):
    """The relay fuzz's draw with its edge lanes: a 1-row read, a 1-column
    haplotype, a read of one chunk and one a row past a chunk."""
    planes = pairhmm_batch(np.random.default_rng(300 + seed), R, H)
    rslen, haplen = planes[7], planes[6]
    rslen[0] = 1
    haplen[1] = 1
    rslen[2] = min(R, r_chunk)
    rslen[3] = min(R, r_chunk + 1)
    return planes


def pdhmm_draw(seed, R, H, base=100):
    """Dense PairHMM planes and the (H, P) PD bytes of a PDHMM fuzz draw
    (``base`` 100 for the kernel fuzz, 300 for the chunked one)."""
    rng = np.random.default_rng(base + seed)
    planes = pairhmm_batch(rng, R, H)
    return planes, pd_bytes(rng, H)


def sw_draw(seed, N, M, base=200):
    """(ref, alt, reflen, altlen) of an SW fuzz draw (``base`` 200, or 400
    for the relay fuzz): alt matches ref on the even lanes."""
    rng = np.random.default_rng(base + seed)
    ref = BASES4[rng.integers(0, 4, (N, P))]
    alt = BASES4[rng.integers(0, 4, (M, P))]
    k = min(N, M)
    alt[:k, ::2] = ref[:k, ::2]
    reflen = rng.integers(1, N + 1, P).astype(np.int32)
    altlen = rng.integers(1, M + 1, P).astype(np.int32)
    return ref, alt, reflen, altlen


def short_haplen_long_read():
    """Haplotypes of 1-9 bases in a bucket of 24, reads of 30-48 rows:
    padded columns must not dominate the scaled kernel's rescale."""
    rng = np.random.default_rng(99)
    R, H = 48, 24
    hap = BASES5[rng.integers(0, 5, (H, P))]
    read = BASES5[rng.integers(0, 5, (R, P))]
    q = rng.integers(0, 64, (R, P)).astype(np.uint8)
    iq = rng.integers(0, 64, (R, P)).astype(np.uint8)
    dq = rng.integers(0, 64, (R, P)).astype(np.uint8)
    gcp = rng.integers(0, 40, (R, P)).astype(np.uint8)
    haplen = rng.integers(1, 10, P).astype(np.int32)
    rslen = rng.integers(30, R + 1, P).astype(np.int32)
    return [hap, read, q, iq, dq, gcp, haplen, rslen]


def scan_coefficient_underflow():
    """GCP 39 everywhere on 5-column haplotypes: span coefficients of the Y
    scan underflow f32 while their contributions still dominate."""
    rng = np.random.default_rng(31337)
    R, H = 32, 8
    hap = BASES5[rng.integers(0, 5, (H, P))]
    read = BASES5[rng.integers(0, 5, (R, P))]
    read[:5] = hap[:5]
    q = rng.integers(0, 64, (R, P)).astype(np.uint8)
    iq = rng.integers(0, 64, (R, P)).astype(np.uint8)
    dq = rng.integers(0, 64, (R, P)).astype(np.uint8)
    gcp = np.full((R, P), 39, np.uint8)
    haplen = np.full(P, 5, np.int32)
    rslen = np.full(P, R, np.int32)
    return [hap, read, q, iq, dq, gcp, haplen, rslen]


def growing_pad_tail():
    """All-'A' pairs whose 120 rows past rslen grow the DP state hundreds
    of binades above the result."""
    R, H, n = 128, 128, 8
    hap = np.full((H, n), ord("A"), np.uint8)
    read = np.full((R, n), ord("A"), np.uint8)
    quals = [np.full((R, n), v, np.uint8) for v in (10, 10, 6, 1)]
    return [hap, read, *quals, np.full(n, H, np.int32), np.full(n, 8, np.int32)]


def pairhmm_cases():
    """(name, dense planes) of every PairHMM draw and regression input."""
    cases = [(f"draw{s}_R{R}_H{H}", pairhmm_draw(s, R, H)) for s, R, H in PAIRHMM_DRAWS]
    cases += [(f"relay{s}_R{R}_H{H}", cols_relay_draw(s, R, H, c))
              for s, R, H, c in COLS_RELAY_DRAWS]
    return cases + [("short_haplen_long_read", short_haplen_long_read()),
                    ("scan_coefficient_underflow", scan_coefficient_underflow()),
                    ("growing_pad_tail", growing_pad_tail())]


def pdhmm_cases():
    """(name, dense planes, PD bytes) of every PDHMM draw, and the scan
    underflow input with no PD event."""
    cases = [(f"draw{s}_R{R}_H{H}", *pdhmm_draw(s, R, H)) for s, R, H in PDHMM_DRAWS]
    cases += [(f"chunked{s}_R{R}_H{H}", *pdhmm_draw(s, R, H, base=300))
              for s, R, H, _ in PDHMM_CHUNKED_DRAWS]
    planes = scan_coefficient_underflow()
    return cases + [("scan_coefficient_underflow", planes, np.zeros_like(planes[0]))]


def sw_cases():
    """(name, (ref, alt, reflen, altlen), indel_boundary) of every SW draw."""
    cases = [(f"draw{s}_N{N}_M{M}", sw_draw(s, N, M), ib) for s, N, M, ib in SW_DRAWS]
    return cases + [(f"relay{s}_N{N}_M{M}", sw_draw(s, N, M, base=400), ib)
                    for s, N, M, _, ib in SW_RELAY_DRAWS]


def _on(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def kernel_lanes_differ(device) -> dict:
    """Every CUDA kernel on every draw against its kernel-order twin on the
    same card tensors: ``{"kernel/case": lanes whose output differs in any
    bit}`` (SW: in-range cells that differ).  The scaled kernel runs on the
    draws whose read bucket is a multiple of 8; the PDHMM draws run through
    the f32 and the f64 instances; the twins run on the card."""
    from gkl_tpu_torch.ops import pairhmm_cols, pairhmm_cuda, pdhmm_cuda, sw_cuda
    from gkl_tpu_torch.ops import sw as sw_ops

    def bits(t):
        return t.view(torch.int32)

    out = {}
    for name, planes in pairhmm_cases():
        hap, read, q, iq, dq, gcp, haplen, rslen = dense = _on(planes, device)
        lanes = torch.arange(hap.shape[1], dtype=torch.int32, device=device)
        t = dict(hap_u=hap, readq_u=torch.stack([read, q]).contiguous(), ridx=lanes,
                 hidx=lanes, haplen=haplen, rslen=rslen,
                 quals_u=torch.stack([iq, dq, gcp]).contiguous())
        if read.shape[0] % 8 == 0:
            k = pairhmm_cuda.pairhmm_scaled(**t)
            m, e, f = pairhmm_cuda.pairhmm_raw_scaled_kernel_order(*dense)
            twin = torch.stack([bits(m), e, f])
            out[f"pairhmm_scaled/{name}"] = int((k != twin).any(dim=0).sum())
        k = pairhmm_cuda.pairhmm_rows(**t)
        twin = pairhmm_cuda.pairhmm_raw_scaled_kernel_order(*dense, scaled=False)
        out[f"pairhmm_rows/{name}"] = int((bits(k) != bits(twin)).sum())
        k = pairhmm_cols.pairhmm_cols(**t)
        twin = pairhmm_cols.pairhmm_raw_cols(*dense)
        out[f"pairhmm_cols/{name}"] = int((bits(k) != bits(twin)).sum())
    for name, planes, hap_pd in pdhmm_cases():
        hap, read, q, iq, dq, gcp, haplen, rslen = _on(planes, device)
        lanes = torch.arange(hap.shape[1], dtype=torch.int32, device=device)
        t = dict(hap_u=hap, happd_u=_on([hap_pd], device)[0],
                 readq_u=torch.stack([read, q, iq, dq, gcp]).contiguous(), ridx=lanes,
                 hidx=lanes, haplen=haplen, rslen=rslen)
        k = pdhmm_cuda.pdhmm(**t)
        out[f"pdhmm/{name}"] = int((bits(k) != bits(pdhmm_cuda.pdhmm_kernel_order(**t))).sum())
        k = pdhmm_cuda.pdhmm_f64(**t)
        twin = pdhmm_cuda.pdhmm_kernel_order(**t, dtype="float64")
        out[f"pdhmm_f64/{name}"] = int((k.view(torch.int64) != twin.view(torch.int64)).sum())
    for name, arrays, ib in sw_cases():
        ref, alt, reflen, altlen = _on(arrays, device)
        k = sw_cuda.sw_forward(ref, alt, reflen, altlen, *SW_SCORES, indel_boundary=ib)
        twin = sw_ops.sw_forward(ref, alt, reflen, altlen, *SW_SCORES, indel_boundary=ib,
                                 pack_bt=True)
        out[f"sw_forward/{name}"] = sw_cuda.in_range_mismatches(k, twin, reflen, altlen)
    return out
