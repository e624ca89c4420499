"""Host modules of the PyTorch port against the JAX package: context tables,
batch planning, BGZF/BAM reading, the native f64 oracle, and the rule that
the port never imports JAX."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gkl_tpu import bam as jbam
from gkl_tpu import batch as jbatch
from gkl_tpu import context as jctx
from gkl_tpu_torch import bam as tbam
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.compression import bgzf as tbgzf
from gkl_tpu_torch import context as tctx
from gkl_tpu_torch.ops import pairhmm_ref as tref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAM = os.path.join(ROOT, "tests", "data", "HiSeq.1mb.1RG.2k_lines.bam")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_context_tables_bit_equal(dtype):
    j, t = jctx.pairhmm_context(dtype), tctx.pairhmm_context(dtype)
    for name in ("ph2pr", "match_to_match"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    for name in ("INITIAL_CONSTANT", "LOG10_INITIAL_CONSTANT"):
        assert getattr(j, name).tobytes() == getattr(t, name).tobytes()
    assert jctx.MIN_ACCEPTED.tobytes() == tctx.MIN_ACCEPTED.tobytes()


def test_bucket_ladder_equal():
    for n in range(1, 3000):
        assert tbatch.bucket_length(n) == jbatch.bucket_length(n)
    for n in range(1, 300):
        assert tbatch.bucket_lanes(n, 8) == jbatch.bucket_lanes(n, 8)


def _random_pairs(seed, n_reads=5, n_haps=3):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    haps = [bases[rng.integers(0, 5, int(rng.integers(8, 60)))] for _ in range(n_haps)]
    reads, quals = [], []
    for _ in range(n_reads):
        n = int(rng.integers(4, 50))
        reads.append(bases[rng.integers(0, 5, n)])
        quals.append(tuple(rng.integers(lo, 60, n).astype(np.uint8) for lo in (6, 20, 20, 5)))
    return haps, reads, quals


def _assert_fields_equal(a, b, fields):
    for f in fields:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None or vb is None:
            assert va is None and vb is None, f
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_pairs_equal(seed):
    haps, reads, quals = _random_pairs(seed)
    pairs = [(h, r, q) for h in haps for r, q in zip(reads, quals)]
    args = ([p[0] for p in pairs], [p[1] for p in pairs], [p[2] for p in pairs])
    j = jbatch.pack_pairs(*args, lane_multiple=8)
    t = tbatch.pack_pairs(*args, lane_multiple=8)
    fields = ("hap", "read", "q", "iq", "dq", "gcp", "haplen", "rslen", "n_real")
    _assert_fields_equal(j, t, fields)
    _assert_fields_equal(tbatch.from_reference(j), t, fields)
    assert (jbatch.group_by_bucket(args[0], args[1])
            == tbatch.group_by_bucket(args[0], args[1]))


@pytest.mark.parametrize("const_quals", [None, (45, 46, 10)])
def test_pack_pairs_indexed_equal(const_quals):
    haps, reads, quals = _random_pairs(2, n_reads=7, n_haps=4)
    j = jbatch.pack_pairs_indexed(haps, reads, quals, lane_multiple=8,
                                  const_quals=const_quals)
    t = tbatch.pack_pairs_indexed(haps, reads, quals, lane_multiple=8,
                                  const_quals=const_quals)
    fields = ("hap_u", "readq_u", "quals_u", "ridx", "hidx", "haplen", "rslen", "n_real")
    _assert_fields_equal(j, t, fields)
    assert j.const_quals == t.const_quals
    carried = tbatch.from_reference(j)
    _assert_fields_equal(carried, t, fields)
    assert carried.const_quals == t.const_quals
    _assert_fields_equal(j.materialize(), t.materialize(),
                         ("hap", "read", "q", "iq", "dq", "gcp", "haplen", "rslen"))


def test_bgzf_decompress_matches_gzip():
    with open(BAM, "rb") as fh:
        data = fh.read()
    assert bytes(tbgzf.decompress(data, threads=2)) == gzip.decompress(data)
    streamed = b"".join(tbgzf.iter_decompressed(BAM, threads=2, read_size=50_000))
    assert streamed == gzip.decompress(data)


def test_bgzf_corrupt_block_raises():
    with open(BAM, "rb") as fh:
        data = bytearray(fh.read())
    data[-40] ^= 0xFF  # inside the last data member's payload or trailer
    with pytest.raises(ValueError):
        tbgzf.decompress(bytes(data))
    with pytest.raises(ValueError, match="truncated"):
        tbgzf.split_blocks(bytes(data[:-5]))


def test_read_bam_matches_reference():
    jh, jrecs = jbam.read_bam(BAM)
    th, trecs = tbam.read_bam(BAM, threads=2)
    assert (jh.text, jh.ref_names, jh.ref_lengths) == (th.text, th.ref_names, th.ref_lengths)
    assert len(jrecs) == len(trecs) > 0
    for a, b in zip(jrecs, trecs):
        assert (a.name, a.flag, a.ref_id, a.pos, a.mapq, a.cigar) == \
               (b.name, b.flag, b.ref_id, b.pos, b.mapq, b.cigar)
        np.testing.assert_array_equal(a.seq, b.seq)
        np.testing.assert_array_equal(a.qual, b.qual)
    _, limited = tbam.read_bam(BAM, limit=5)
    assert [r.name for r in limited] == [r.name for r in trecs[:5]]


@pytest.mark.parametrize("limit", [None, 37])
def test_read_bam_streaming_matches_whole_file(limit):
    _, whole = tbam.read_bam(BAM, limit=limit)
    header, it = tbam.read_bam_streaming(BAM, limit=limit, read_size=20_000)
    streamed = list(it)
    assert header.ref_names
    assert [r.name for r in streamed] == [r.name for r in whole]
    for a, b in zip(whole, streamed):
        np.testing.assert_array_equal(a.seq, b.seq)


def test_native_oracle_matches_python():
    """The threaded native f64 oracle, built from the port's copy of the
    JAX package's C++, is bit-identical to the per-pair Python oracle."""
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    haps, reads, quals = [], [], []
    for _ in range(12):
        hl, rl = int(rng.integers(4, 50)), int(rng.integers(3, 40))
        haps.append(bases[rng.integers(0, 5, hl)])
        reads.append(bases[rng.integers(0, 5, rl)])
        quals.append((rng.integers(6, 60, rl).astype(np.uint8),
                      rng.integers(20, 50, rl).astype(np.uint8),
                      rng.integers(20, 50, rl).astype(np.uint8),
                      np.full(rl, 10, np.uint8)))
    got = tref.pairhmm_scalar_batch(haps, reads, quals, threads=3)
    want = np.array([tref.pairhmm_scalar(haps[k], reads[k], *quals[k])
                     for k in range(len(haps))])
    np.testing.assert_array_equal(got, want)


def test_port_imports_no_jax():
    """The port runs where JAX is not installed: importing it, its SW and
    PDHMM APIs, their kernel wrappers, the codec, BAM and validation modules,
    debug, profiling, utils, the mesh and the pipelines must load neither
    jax nor gkl_tpu (a fresh interpreter, since this test process
    already holds jax)."""
    code = ("import sys, gkl_tpu_torch, gkl_tpu_torch.cuda_build, gkl_tpu_torch.api_sw, "
            "gkl_tpu_torch.api_pdhmm, gkl_tpu_torch.ops.sw_cuda, "
            "gkl_tpu_torch.ops.pdhmm_cuda, gkl_tpu_torch.compression, "
            "gkl_tpu_torch.compression.bgzf, gkl_tpu_torch.bam, gkl_tpu_torch.validation, "
            "gkl_tpu_torch.debug, gkl_tpu_torch.profiling, gkl_tpu_torch.utils, "
            "gkl_tpu_torch.parallel.mesh; "
            "from gkl_tpu_torch.pipeline import bam_recompress, region_stream, sw_align_stream; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gkl_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
