"""The port's BAM write side (``encode_record``, ``encode_header``,
``write_bam``, ``write_bam_streaming``, ``keep_raw`` readers and
``pipeline.bam_recompress``) byte for byte against the JAX package's on the
same records."""

import dataclasses
import os

import numpy as np
import pytest

from gkl_tpu import bam as jbam
from gkl_tpu import pipeline as jpipeline
from gkl_tpu_torch import bam as tbam
from gkl_tpu_torch import pipeline as tpipeline
from gkl_tpu_torch.compression import bgzf as tbgzf

BAM = os.path.join(os.path.dirname(__file__), "data", "HiSeq.1mb.1RG.2k_lines.bam")


@pytest.fixture(scope="module")
def source():
    """The test BAM read by both packages with raw bytes kept."""
    return tbam.read_bam(BAM, keep_raw=True), jbam.read_bam(BAM, keep_raw=True)


def _synthesized(seed, n=40):
    """Records built in Python (no raw bytes): IUPAC and '=' bases, empty
    sequences, every CIGAR op, unmapped flags, a quality plane shorter than
    the sequence (written as 0xff)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"=ACMGRSVTWYHKDBNacgtX", np.uint8)
    recs = []
    for k in range(n):
        ln = 0 if k % 13 == 0 else int(rng.integers(1, 180))
        seq = bases[rng.integers(0, len(bases), ln)]
        qual = rng.integers(0, 60, ln if k % 7 else max(ln - 1, 0)).astype(np.uint8)
        cigar = [(int(rng.integers(1, 50)), op) for op in
                 rng.choice(list("MIDNSHP=X"), int(rng.integers(0, 5)))]
        fields = dict(name=f"syn{seed}_{k}", flag=int(rng.choice([0, 4, 16, 0x100, 0x800])),
                      ref_id=int(rng.integers(-1, 3)), pos=int(rng.integers(-1, 10**6)),
                      mapq=int(rng.integers(0, 256)), cigar=cigar, seq=seq, qual=qual)
        recs.append((tbam.BamRecord(**fields), jbam.BamRecord(**fields)))
    return recs


def test_encode_record_matches_jax_on_bam_records(source):
    (th, trecs), (jh, jrecs) = source
    assert len(trecs) == len(jrecs) > 0
    for t, j in zip(trecs, jrecs):
        assert t.raw == j.raw and t.raw is not None
        assert tbam.encode_record(t) == jbam.encode_record(j) == t.raw
        # without raw bytes: encoded from the decoded fields
        assert tbam.encode_record(dataclasses.replace(t, raw=None)) == \
            jbam.encode_record(dataclasses.replace(j, raw=None))
        assert (t.is_unmapped, t.cigar_string()) == (j.is_unmapped, j.cigar_string())


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_record_matches_jax_synthesized(seed):
    for t, j in _synthesized(seed):
        assert tbam.encode_record(t) == jbam.encode_record(j)
        assert (t.is_unmapped, t.cigar_string()) == (j.is_unmapped, j.cigar_string())


def test_encode_header_matches_jax(source):
    (th, _), (jh, _) = source
    assert tbam.encode_header(th) == jbam.encode_header(jh)
    fields = dict(text="@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000\n@SQ\tSN:chrM\tLN:16569\n",
                  ref_names=["chr1", "chrM"], ref_lengths=[1000, 16569])
    encoded = tbam.encode_header(tbam.BamHeader(**fields))
    assert encoded == jbam.encode_header(jbam.BamHeader(**fields))
    header, off = tbam.parse_header(encoded)
    assert (header.text, header.ref_names, header.ref_lengths, off) == (
        fields["text"], fields["ref_names"], fields["ref_lengths"], len(encoded))


@pytest.mark.parametrize("level", [1, 6])
def test_write_bam_matches_jax(tmp_path, source, level):
    """Files from the test BAM's records plus synthesized ones are the JAX
    package's bytes, and read back to the same records."""
    (th, trecs), (jh, jrecs) = source
    syn = _synthesized(2)
    tpath, jpath = tmp_path / "t.bam", tmp_path / "j.bam"
    tbam.write_bam(str(tpath), th, trecs + [t for t, _ in syn], level=level, threads=2)
    jbam.write_bam(str(jpath), jh, jrecs + [j for _, j in syn], level=level, threads=2)
    assert tpath.read_bytes() == jpath.read_bytes()
    _, back = tbam.read_bam(str(tpath), keep_raw=True)
    assert [r.raw for r in back[: len(trecs)]] == [r.raw for r in trecs]
    assert [r.name for r in back[len(trecs):]] == [t.name for t, _ in syn]


@pytest.mark.parametrize("window_blocks", [1, 64])
def test_write_bam_streaming_matches_jax(tmp_path, source, window_blocks):
    """The streaming writer cuts the same maximal blocks as the JAX
    package's (and as the whole-file writer), whatever the window."""
    (th, trecs), (jh, jrecs) = source
    tpath, jpath, whole = tmp_path / "t.bam", tmp_path / "j.bam", tmp_path / "w.bam"
    n = tbam.write_bam_streaming(str(tpath), th, iter(trecs), level=5,
                                 window_blocks=window_blocks)
    assert n == jbam.write_bam_streaming(str(jpath), jh, iter(jrecs), level=5,
                                         window_blocks=window_blocks) == len(trecs)
    data = tpath.read_bytes()
    assert data == jpath.read_bytes()
    assert data.endswith(tbgzf.EOF_BLOCK)
    members = tbgzf.split_blocks(data)
    assert all(len(tbgzf.decompress_block(m)) == tbgzf.MAX_BLOCK_DATA for m in members[:-2])
    tbam.write_bam(str(whole), th, trecs, level=5)
    assert whole.read_bytes() == data


def test_keep_raw_bytes_equal(source):
    """keep_raw cuts each record's bytes where the JAX package does, in the
    whole-file and the streaming reader; without it raw stays None."""
    (_, trecs), (_, jrecs) = source
    _, streamed = tbam.read_bam_streaming(BAM, read_size=20_000, keep_raw=True)
    assert [r.raw for r in streamed] == [r.raw for r in jrecs]
    for r in trecs:
        (bs,) = np.frombuffer(r.raw[:4], "<i4")
        assert len(r.raw) == 4 + bs
    _, limited = tbam.read_bam(BAM, limit=9, keep_raw=True)
    assert [r.raw for r in limited] == [r.raw for r in jrecs[:9]]
    _, plain = tbam.read_bam(BAM, limit=3)
    assert all(r.raw is None for r in plain)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_bam_recompress_matches_jax(tmp_path, source, level):
    (_, trecs), _ = source
    tpath, jpath = tmp_path / "t.bam", tmp_path / "j.bam"
    n = tpipeline.bam_recompress(BAM, str(tpath), level=level, threads=2, window_blocks=4)
    assert n == jpipeline.bam_recompress(BAM, str(jpath), level=level, threads=2,
                                         window_blocks=4) == len(trecs)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert tpath.read_bytes().endswith(tbgzf.EOF_BLOCK)
    _, back = tbam.read_bam(str(tpath), keep_raw=True)
    assert len(back) == len(trecs)
    for a, b in zip(trecs, back):
        assert (a.name, a.raw, a.flag, a.pos, a.cigar) == (b.name, b.raw, b.flag, b.pos, b.cigar)
        np.testing.assert_array_equal(a.seq, b.seq)
        np.testing.assert_array_equal(a.qual, b.qual)
    assert tpipeline.bam_recompress(BAM, str(tpath), level=level, limit=10) == 10
