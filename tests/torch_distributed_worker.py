"""Worker of the port's two-process runs (``tests/test_torch_distributed.py``
on the CPU, ``chip_smoke.py`` phase 15c and ``tests/test_torch_gpu.py`` on
the card).

Usage: python torch_distributed_worker.py <host:port> <num_processes> <rank> [cpu|cuda]

The process joins a gloo group through ``gkl_tpu_torch.parallel.initialize``
and builds the global dp mesh: two CPU entries a process (``cpu``: the
kernels' plain twins), or one entry on ``cuda:<rank % device count>``
(``cuda``: the CUDA kernels).  Every process draws the same seeded batches,
feeds its ``host_local_slice`` through each ``*_global`` entry (and the
indexed engine and the three APIs through the mesh) and holds its lanes to
the single-process call on the whole batch, bit for bit.  It prints one
``<LEG> ok`` line per leg, and ``RESULT``/``REF`` JSON lines with its lanes
of the plain PairHMM engine (the twin) and of the twin on the whole batch,
for the caller to compare.  The ``cuda``
shapes are ``chip_smoke.py``'s: phase 2's PairHMM batch (R=128, H=224,
P=2,048), 8a's PDHMM batch (R=256, H=448, P=8,192) and 7a's SW batch
(N=448, M=256, P=10,240).
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BASES = np.frombuffer(b"ACGT", np.uint8)
GATK = (200, -150, -260, -11)
# (R, H, P) of the PairHMM and PDHMM legs, (N, M, P) of the SW legs
SHAPES = {"cpu": {"pairhmm": (16, 24, 32), "pdhmm": (24, 40, 32), "sw": (24, 16, 32)},
          "cuda": {"pairhmm": (128, 224, 2048), "pdhmm": (256, 448, 8192),
                   "sw": (448, 256, 10240)}}
LEGS = ("SCALED_BITPARITY", "ROWS_BITPARITY", "INDEXED_BITPARITY", "PDHMM_BITPARITY",
        "PDHMM_CHUNKED_BITPARITY", "SW_BITPARITY", "SW_RELAY_BITPARITY", "API_GLOBAL")


def dense_batch(R, H, P, seed):
    """Ragged dense PairHMM planes: reads mutated hap windows, every 16th
    lane a random read; and (H, P) PD bytes with a deletion on every other
    lane and a PD SNP on every fourth."""
    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, (H, P))]
    haplen = rng.integers(3 * H // 4, H + 1, P).astype(np.int32)
    rslen = rng.integers(R // 2, R + 1, P).astype(np.int32)
    read = hap[:R].copy()
    mut = rng.random((R, P)) < 0.05
    read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    read[:, ::16] = BASES[rng.integers(0, 4, (R, len(range(0, P, 16))))]
    q = rng.integers(18, 46, (R, P)).astype(np.uint8)
    iq, dq = (rng.integers(30, 46, (R, P)).astype(np.uint8) for _ in range(2))
    gcp = np.full((R, P), 10, np.uint8)
    pd = np.zeros((H, P), np.uint8)
    pd[H // 4, ::2] = 2
    pd[H // 4 + 4, ::2] = 4
    pd[H // 2, 1::4] = 1 | 16
    return (hap, read, q, iq, dq, gcp, haplen, rslen), pd


def sw_batch(N, M, P, seed):
    """(ref (N, P), alt (M, P), reflen, altlen): alts are mutated reference
    windows, with ragged lengths."""
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, (N, P))]
    alt = np.ones((M, P), np.uint8)
    alt[:min(N, M)] = ref[:min(N, M)]
    mut = rng.random((M, P)) < 0.05
    alt[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    reflen = rng.integers(N // 2, N + 1, P).astype(np.int32)
    altlen = rng.integers(M // 2, M + 1, P).astype(np.int32)
    return ref, alt, reflen, altlen


def _equal(what, got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        g, w = np.ascontiguousarray(g), np.ascontiguousarray(w)
        if g.shape != w.shape or not np.array_equal(g.view(np.uint8), w.view(np.uint8)):
            raise AssertionError(f"{what}: this process's lanes differ from the whole batch's")


def _api_inputs(rng):
    from gkl_tpu_torch import HaplotypeData, PDHaplotypeData, ReadData

    reads = [ReadData(BASES[rng.integers(0, 4, 20)], rng.integers(18, 41, 20).astype(np.uint8),
                      np.full(20, 45, np.uint8), np.full(20, 45, np.uint8),
                      np.full(20, 10, np.uint8)) for _ in range(6)]
    haps = [BASES[rng.integers(0, 4, 32)] for _ in range(3)]
    pd = np.zeros(32, np.uint8)
    pd[8], pd[12] = 2, 4
    return (reads, [HaplotypeData(h) for h in haps],
            [PDHaplotypeData(h, haplotype_pdbases=pd) for h in haps[:2]], haps)


def run(coordinator: str, nproc: int, rank: int, kind: str) -> None:
    from gkl_tpu_torch import PDHMM, PairHMM, SmithWaterman, SWParameters, parallel
    from gkl_tpu_torch import batch as tbatch
    from gkl_tpu_torch.api_sw import OverhangStrategy
    from gkl_tpu_torch.ops import pairhmm as pairhmm_ops
    from gkl_tpu_torch.ops import pairhmm_cuda, pdhmm_cuda, sw_cuda

    parallel.initialize(coordinator, nproc, rank)
    if kind == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        local = [dev]
    else:
        dev = torch.device("cpu")
        local = [dev, dev]
    mesh = parallel.global_mesh(local_devices=local)
    assert mesh.size == len(local) * nproc and parallel.is_multiprocess(mesh), mesh
    shapes = SHAPES[kind]

    def on_dev(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    # PairHMM: the scaled and rows kernels on this process's lanes
    R, H, P = shapes["pairhmm"]
    planes, _ = dense_batch(R, H, P, seed=0)
    sl = parallel.host_local_slice(P)
    local_pk = tbatch.PackedPairs(*(a[..., sl] for a in planes), n_real=sl.stop - sl.start)
    hap, read, q, iq, dq, gcp, haplen, rslen = on_dev(*planes)
    lanes = torch.arange(P, dtype=torch.int32, device=dev)
    whole = dict(hap_u=hap, readq_u=torch.stack([read, q]), ridx=lanes, hidx=lanes,
                 haplen=haplen, rslen=rslen, quals_u=torch.stack([iq, dq, gcp]))
    mine = parallel.pairhmm_raw_global(mesh, local_pk, engine="jnp")
    ref = pairhmm_ops.pairhmm_raw(hap, read, q, iq, dq, gcp, haplen, rslen).cpu().numpy()[sl]
    print("RESULT", json.dumps([float(v) for v in mine]))
    print("REF", json.dumps([float(v) for v in ref]))
    scaled = pairhmm_cuda.pairhmm_scaled(**whole).cpu().numpy()[:, sl]
    _equal("scaled", parallel.pairhmm_scaled_global(mesh, local_pk),
           (scaled[0].view(np.float32), scaled[1], scaled[2]))
    print("SCALED_BITPARITY ok", flush=True)
    _equal("rows", parallel.pairhmm_raw_global(mesh, local_pk, engine="pallas"),
           pairhmm_cuda.pairhmm_rows(**whole).cpu().numpy()[sl])
    print("ROWS_BITPARITY ok", flush=True)

    # the deduplicated batch on the multi-process mesh: each process feeds
    # its read slab, and every process gets every lane back
    rng = np.random.default_rng(11)
    n_reads = P // 4 - 3
    reads_u = [BASES[rng.integers(0, 4, R)] for _ in range(n_reads)]
    rquals = [tuple(rng.integers(lo, 45, R).astype(np.uint8) for lo in (20, 30, 30, 9))
              for _ in range(n_reads)]
    haps_u = [BASES[rng.integers(0, 4, H - k)] for k in range(4)]
    for const in (None, (45, 45, 10)):
        pk = tbatch.pack_pairs_indexed(haps_u, reads_u, rquals, lane_multiple=8 * mesh.size,
                                       const_quals=const, full_pattern=True)
        t = dict(zip(("hap_u", "readq_u", "ridx", "hidx", "haplen", "rslen"),
                     on_dev(pk.hap_u, pk.readq_u, pk.ridx, pk.hidx, pk.haplen, pk.rslen)))
        if const is None:
            t["quals_u"] = on_dev(pk.quals_u)[0]
        _equal("indexed", parallel.pairhmm_scaled_indexed_sharded(mesh, pk),
               pairhmm_cuda.pairhmm_scaled(**t, const_quals=const).cpu().numpy())
    print("INDEXED_BITPARITY ok", flush=True)

    # PDHMM: the kernel, and the JAX package's chunked entry (the same kernel)
    R, H, P = shapes["pdhmm"]
    planes, pd = dense_batch(R, H, P, seed=1)
    sl = parallel.host_local_slice(P)
    local_pk = tbatch.PackedPairs(*(a[..., sl] for a in planes), n_real=sl.stop - sl.start)
    hap, read, q, iq, dq, gcp, haplen, rslen, pd_t = on_dev(*planes, pd)
    lanes = torch.arange(P, dtype=torch.int32, device=dev)
    want = pdhmm_cuda.pdhmm(hap, pd_t, torch.stack([read, q, iq, dq, gcp]), lanes, lanes,
                            haplen, rslen).cpu().numpy()[sl]
    _equal("pdhmm", parallel.pdhmm_raw_global(mesh, local_pk, pd[:, sl]), want)
    print("PDHMM_BITPARITY ok", flush=True)
    _equal("pdhmm chunked", parallel.pdhmm_chunked_global(mesh, local_pk, pd[:, sl]), want)
    print("PDHMM_CHUNKED_BITPARITY ok", flush=True)

    # SW: each process fetches only its own backtrack
    N, M, P = shapes["sw"]
    ref, alt, reflen, altlen = sw_batch(N, M, P, seed=2)
    sl = parallel.host_local_slice(P)
    whole_sw = sw_cuda.sw_forward(*on_dev(ref, alt, reflen, altlen), *GATK, indel_boundary=False)
    want = (whole_sw[0][sl].cpu().numpy(), whole_sw[1][:, sl].cpu().numpy(),
            whole_sw[2][sl].cpu().numpy())
    del whole_sw
    params = SWParameters(*GATK)
    for leg, entry in (("SW_BITPARITY", parallel.sw_forward_global),
                       ("SW_RELAY_BITPARITY", parallel.sw_relay_global)):
        _equal(leg, entry(mesh, ref[:, sl], alt[:, sl], reflen[sl], altlen[sl], params), want)
        print(f"{leg} ok", flush=True)

    # the three APIs on the global mesh against one process alone
    reads, haps, pd_haps, hap_seqs = _api_inputs(np.random.default_rng(7))
    _equal("PairHMM api", PairHMM(mesh=mesh).compute_likelihoods(reads, haps),
           PairHMM(device=dev).compute_likelihoods(reads, haps))
    _equal("PDHMM api", PDHMM(mesh=mesh).compute_likelihoods(reads, pd_haps),
           PDHMM(device=dev).compute_likelihoods(reads, pd_haps))
    refs = [hap_seqs[k % 3] for k in range(len(reads))]
    alts = [r.read_bases for r in reads]
    got = SmithWaterman(mesh=mesh).align_batch(refs, alts, params, OverhangStrategy.SOFTCLIP)
    want = SmithWaterman(device=dev).align_batch(refs, alts, params, OverhangStrategy.SOFTCLIP)
    if [(g.cigar, g.alignment_offset) for g in got] != [(w.cigar, w.alignment_offset)
                                                         for w in want]:
        raise AssertionError("SmithWaterman api: the mesh's CIGARs differ")
    print("API_GLOBAL ok", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
        sys.argv[4] if len(sys.argv) > 4 else "cpu")
