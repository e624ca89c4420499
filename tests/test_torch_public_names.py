"""The public names of ``gkl_tpu`` the port gained last, each against the
JAX package on the same inputs: ``bam.SEQ_NIBBLE``, ``try_parse_header``,
``complete_records_end`` and ``parse_records_native`` (the test BAM and the
corrupt records of ``tests/test_pipeline.py``), ``bgzf.iter_decompressed``
on a path or an open file, ``ops.pdhmm.pdhmm_raw``'s dynamic-range boost,
``PairHmmContext.set_mm_prob`` and ``PackedPairs.device_bytes``."""

import io
import os
import pathlib
import re
import struct

import numpy as np
import pytest
import torch

import golden
from gkl_tpu import batch as jbatch
from gkl_tpu import bam as jbam
from gkl_tpu import context as jctx
from gkl_tpu.compression import bgzf as jbgzf
from gkl_tpu.ops import pdhmm as jpd
from gkl_tpu_torch import bam, context
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch.compression import bgzf
from gkl_tpu_torch.ops import pdhmm as tpd

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BAM = os.path.join(DATA, "HiSeq.1mb.1RG.2k_lines.bam")
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def payload():
    with open(BAM, "rb") as fh:
        return bytes(jbgzf.decompress(fh.read()))


def _fields(rec):
    return (rec.name, rec.flag, rec.ref_id, rec.pos, rec.mapq, rec.cigar,
            rec.seq.tobytes(), rec.qual.tobytes(), rec.raw)


def test_seq_nibble_is_the_reference_table():
    assert bam.SEQ_NIBBLE.dtype == jbam.SEQ_NIBBLE.dtype == np.uint8
    np.testing.assert_array_equal(bam.SEQ_NIBBLE, jbam.SEQ_NIBBLE)


@pytest.mark.parametrize("keep_raw", [False, True])
@pytest.mark.parametrize("limit", [None, 0, 3, 400])
def test_parse_records_native_matches_jax(payload, limit, keep_raw):
    """The port's native scanner gives the JAX package's records, field for
    field (raw bytes too with ``keep_raw``), as a list, and
    ``parse_records`` the same."""
    _, off = jbam.parse_header(payload)
    want = jbam.parse_records_native(payload, off, limit=limit, keep_raw=keep_raw)
    got = bam.parse_records_native(payload, off, limit=limit, keep_raw=keep_raw)
    assert isinstance(got, list)
    assert len(got) == len(want) == (1677 if limit is None else limit)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert [_fields(r) for r in bam.parse_records(payload, off, limit=limit,
                                                  keep_raw=keep_raw)] == [_fields(r) for r in got]


def _mk_record(name=b"r1", n_cigar=0, l_seq=4, block_size=None):
    """One BAM alignment record with controllable, possibly corrupt, sizes,
    built as ``tests/test_pipeline.py::_mk_record`` builds it."""
    body = struct.pack("<iiBBHHHiiii", 0, 100, len(name) + 1, 30, 0, n_cigar, 0, l_seq, -1, -1, 0)
    body += name + b"\x00"
    body += b"\x00\x00\x00\x00" * n_cigar
    body += b"\x12" * ((l_seq + 1) // 2)
    body += b"\x20" * l_seq
    bs = len(body) if block_size is None else block_size
    return struct.pack("<i", bs) + body


def test_corrupt_records_raise_like_jax():
    good = _mk_record()
    got, want = bam.parse_records_native(good, 0), jbam.parse_records_native(good, 0)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert got[0].seq.tobytes() == b"AC" * 2
    bad_seq = bytearray(good)
    struct.pack_into("<i", bad_seq, 4 + 16, 10_000)  # l_seq past the block
    for bad in (bytes(bad_seq), _mk_record(block_size=-4), good[:-3]):
        with pytest.raises(ValueError):
            jbam.parse_records_native(bad, 0)
        with pytest.raises(ValueError):
            bam.parse_records_native(bad, 0)


def test_try_parse_header_matches_jax(payload):
    """Every prefix of the test BAM's header region: None while the buffer
    is too short, then the same header and first-record offset."""
    _, off = jbam.parse_header(payload)
    for cut in sorted({0, 4, 11, 12, 13, 100, off - 5, off - 4, off - 1, off, off + 7,
                       len(payload)}):
        buf = bytearray(payload[:cut])
        want, got = jbam.try_parse_header(buf), bam.try_parse_header(buf)
        assert (got is None) == (want is None), cut
        if want is not None:
            assert got[1] == want[1] == off
            assert (got[0].text, got[0].ref_names, got[0].ref_lengths) == (
                want[0].text, want[0].ref_names, want[0].ref_lengths)


@pytest.mark.parametrize("bad", [
    pytest.param(b"BAM\x01" + (-5).to_bytes(4, "little", signed=True) + b"\x00" * 64,
                 id="negative-l_text"),
    pytest.param(b"BAM\x02" + b"\x00" * 64, id="magic"),
    pytest.param(b"BAM\x01" + (0).to_bytes(4, "little") + (-1).to_bytes(4, "little", signed=True)
                 + b"\x00" * 8, id="negative-n_ref"),
    pytest.param(b"BAM\x01" + (0).to_bytes(4, "little") + (1).to_bytes(4, "little")
                 + (0).to_bytes(4, "little") + b"\x00" * 8, id="empty-ref-name"),
])
def test_try_parse_header_rejects_like_jax(bad):
    with pytest.raises(ValueError) as want:
        jbam.try_parse_header(bytearray(bad))
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        bam.try_parse_header(bytearray(bad))


def test_complete_records_end_matches_jax(payload):
    """Cuts inside and between records of the test BAM give the same end of
    the last complete record; a block size below 32 raises in both."""
    _, off = jbam.parse_header(payload)
    first = off + 4 + struct.unpack_from("<i", payload, off)[0]
    for cut in (off, off + 3, off + 40, first - 1, first, first + 5, 20_000, len(payload)):
        buf = payload[:cut]
        assert bam.complete_records_end(buf, off) == jbam.complete_records_end(buf, off)
    assert bam.complete_records_end(payload, off) == len(payload)
    bad = _mk_record(block_size=16) + _mk_record()
    with pytest.raises(ValueError):
        jbam.complete_records_end(bad, 0)
    with pytest.raises(ValueError):
        bam.complete_records_end(bad, 0)


@pytest.mark.parametrize("source", ["str", "bytes", "path", "file"])
def test_iter_decompressed_takes_a_path_or_an_open_file(source):
    """Chunks of 32 KiB reads from a ``str``, ``bytes`` or
    ``pathlib.Path`` path or an open file join to the bytes of the JAX
    package's; an open file is left open, positioned at its end."""
    want = b"".join(jbgzf.iter_decompressed(BAM, read_size=1 << 15))
    fh = open(BAM, "rb")
    arg = {"str": BAM, "bytes": os.fsencode(BAM), "path": pathlib.Path(BAM), "file": fh}[source]
    try:
        chunks = list(bgzf.iter_decompressed(arg, read_size=1 << 15))
        assert len(chunks) > 1
        assert b"".join(chunks) == want
        assert not fh.closed
        if source == "file":
            assert fh.read() == b""
    finally:
        fh.close()


def test_iter_decompressed_on_an_in_memory_stream():
    with open(BAM, "rb") as f:
        data = f.read()
    stream = io.BytesIO(data)
    assert b"".join(bgzf.iter_decompressed(stream, read_size=1 << 14)) == bytes(
        jbgzf.decompress(data))
    assert not stream.closed
    with pytest.raises(ValueError, match="truncated"):
        list(bgzf.iter_decompressed(io.BytesIO(data[:-9])))


def _boost_batch():
    """``tests/test_pdhmm.py::test_dynamic_range_boost_is_exact``'s deep
    golden cases, packed the same way."""
    cases = [c for c in golden.load_pdhmm_cases("pdhmm_syn_1412_129_223.txt")
             if -560 < c.expected < -350][:8]
    assert len(cases) >= 2
    packed = tbatch.pack_pairs([c.hap for c in cases], [c.read for c in cases],
                               [(c.q, c.iq, c.dq, c.gcp) for c in cases], lane_multiple=8)
    H, P = packed.hap.shape
    hap_pd = np.zeros((H, P), np.uint8)
    for k, c in enumerate(cases):
        hap_pd[:len(c.hap), k] = c.hap_pd
    return packed, hap_pd


def test_pdhmm_raw_boost_matches_jax():
    """A 2^100 boost at each lane's middle row changes the f64 result only
    by the boost (1e-9 in log10), and the boosted raw values are the JAX
    package's at 1e-12 relative; with no ``boost_row`` a boost is ignored."""
    packed, hap_pd = _boost_batch()
    states = tpd.column_states(hap_pd)
    boost_row = np.maximum(packed.rslen // 2, 1).astype(np.int32)
    planes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        packed.hap, hap_pd, states, packed.read, packed.q, packed.iq, packed.dq, packed.gcp,
        packed.haplen, packed.rslen)]
    base = tpd.pdhmm_raw(*planes).numpy()
    boosted = tpd.pdhmm_raw(*planes, torch.from_numpy(boost_row), 100.0).numpy()
    np.testing.assert_allclose(np.log10(boosted) - 100 * np.log10(2.0), np.log10(base),
                               rtol=0, atol=1e-9)
    want = np.asarray(jpd.pdhmm_raw(
        packed.hap, hap_pd, jpd.column_states(hap_pd), packed.read, packed.q, packed.iq,
        packed.dq, packed.gcp, packed.haplen, packed.rslen, boost_row, 100.0))
    np.testing.assert_allclose(boosted, want, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tpd.pdhmm_raw(*planes, None, 100.0).numpy(), base)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pairhmm_context_set_mm_prob_matches_jax(dtype):
    """Every (insertion, deletion) pair of quals 0-127 (PairHMM masks to
    127) and a band past MAX_QUAL, where the direct formula applies."""
    iq, dq = np.meshgrid(np.r_[0:128, 250:256], np.r_[0:128, 250:256])
    got = context.pairhmm_context(dtype).set_mm_prob(iq, dq)
    want = jctx.pairhmm_context(dtype).set_mm_prob(iq, dq)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lane_multiple", [1, 3, 8, 128])
def test_packed_pairs_device_bytes_matches_jax(lane_multiple):
    """The dense batch's footprint is the JAX package's for the same packed
    batch, at several lane multiples and length buckets; the indexed batch
    keeps the port's own count."""
    rng = np.random.default_rng(3)
    for n, hl, rl in ((5, 40, 24), (13, 300, 101), (2, 2100, 151)):
        haps = [BASES[rng.integers(0, 4, hl)] for _ in range(n)]
        reads = [BASES[rng.integers(0, 4, rl)] for _ in range(n)]
        quals = [tuple(np.full(rl, v, np.uint8) for v in (30, 45, 45, 10)) for _ in range(n)]
        got = tbatch.pack_pairs(haps, reads, quals, lane_multiple=lane_multiple)
        want = jbatch.pack_pairs(haps, reads, quals, lane_multiple=lane_multiple)
        assert got.device_bytes() == want.device_bytes() > 0
        pk = tbatch.pack_pairs_indexed(haps[:1], reads, [q for q in quals],
                                       lane_multiple=lane_multiple)
        H, P = pk.hap_u.shape[0], pk.ridx.shape[0]
        assert pk.device_bytes() == (pk.hap_u.nbytes + pk.readq_u.nbytes + pk.quals_u.nbytes
                                     + 16 * P + 12 * H * P + 12 * P)
