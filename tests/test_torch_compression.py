"""The port's DEFLATE codec API and BGZF writer (``gkl_tpu_torch.compression``)
against the contracts ``tests/test_compression.py`` pins for the JAX package
(round trips at every level, zlib in both directions, level, factory and
input validation, the batch codec, BGZF), and byte for byte against
``gkl_tpu.compression`` on the same inputs."""

import gzip
import os
import zlib

import numpy as np
import pytest

from gkl_tpu import compression as jcomp
from gkl_tpu.compression import bgzf as jbgzf
from gkl_tpu_torch import compression as tcomp
from gkl_tpu_torch.compression import bgzf as tbgzf

BAM = os.path.join(os.path.dirname(__file__), "data", "HiSeq.1mb.1RG.2k_lines.bam")


def _dna(n, seed=0):
    rng = np.random.default_rng(seed)
    return bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)])


CORPUS = _dna(1 << 18)


@pytest.fixture(scope="module")
def bam_payload():
    with open(BAM, "rb") as fh:
        return bytes(tbgzf.decompress(fh.read()))


@pytest.mark.parametrize("level", range(0, 10))
def test_roundtrip_ours_to_ours(level):
    d = tcomp.Deflater(level, nowrap=True)
    d.set_input(CORPUS)
    d.finish()
    out = bytearray(len(CORPUS) + (len(CORPUS) >> 1) + 1024)
    n = d.deflate(out)
    assert d.finished()
    i = tcomp.Inflater(nowrap=True)
    i.set_input(bytes(out[:n]))
    dec = bytearray(len(CORPUS))
    assert i.inflate(dec) == len(CORPUS)
    assert bytes(dec) == CORPUS


@pytest.mark.parametrize("level", range(0, 10))
def test_ours_to_zlib(level):
    """The port's stream inflates with the independent zlib oracle."""
    assert zlib.decompress(tcomp.raw_deflate(CORPUS, level, nowrap=True),
                           -zlib.MAX_WBITS) == CORPUS


@pytest.mark.parametrize("level", [1, 5, 9])
def test_zlib_to_ours(level):
    c = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS)
    assert tcomp.raw_inflate(c.compress(CORPUS) + c.flush(), nowrap=True) == CORPUS


def test_zlib_wrapped_roundtrip():
    data = CORPUS[: 1 << 16]
    compressed = tcomp.raw_deflate(data, 6, nowrap=False)
    assert zlib.decompress(compressed) == data
    assert tcomp.raw_inflate(compressed, nowrap=False) == data


def test_level_validation():
    for level, nowrap in ((10, True), (-2, True), (1, False), (2, False)):
        with pytest.raises(ValueError):
            tcomp.Deflater(level, nowrap)
        with pytest.raises(ValueError):
            jcomp.Deflater(level, nowrap)
    tcomp.Deflater(1, True)
    tcomp.Deflater(tcomp.DEFAULT_COMPRESSION, False)
    with pytest.raises(ValueError):
        tcomp.Inflater(False)


def test_factory_fallback():
    """Configurations the accelerated codec refuses fall back to zlib's,
    as in the JAX package and IntelDeflaterFactory.java:55-67."""
    d = tcomp.make_deflater(1, nowrap=False)
    assert not isinstance(d, tcomp.Deflater)
    d.set_input(CORPUS[:4096])
    d.finish()
    out = bytearray(8192)
    n = d.deflate(out)
    assert d.finished()
    assert zlib.decompress(bytes(out[:n])) == CORPUS[:4096]
    j = jcomp.make_deflater(1, nowrap=False)
    j.set_input(CORPUS[:4096])
    jout = bytearray(8192)
    assert bytes(jout[: j.deflate(jout)]) == bytes(out[:n])
    i = tcomp.make_inflater(nowrap=False)
    dec = bytearray(4096)
    i.set_input(bytes(out[:n]))
    assert i.inflate(dec) == 4096 and bytes(dec) == CORPUS[:4096]
    assert isinstance(tcomp.make_deflater(6, True), tcomp.Deflater)
    assert isinstance(tcomp.make_inflater(True), tcomp.Inflater)


def test_input_validation():
    d = tcomp.Deflater(6, True)
    with pytest.raises(TypeError):
        d.set_input(None)
    with pytest.raises(IndexError):
        d.set_input(b"abc", off=-1)
    with pytest.raises(IndexError):
        d.set_input(b"abc", off=2, length=2)
    d.set_input(b"abc")
    with pytest.raises(ValueError):
        d.deflate(bytearray(8), off=1)
    with pytest.raises(IndexError):
        d.deflate(bytearray(8), length=0)
    with pytest.raises(ValueError, match="too small"):
        d.deflate(bytearray(1))
    i = tcomp.Inflater(True)
    with pytest.raises(TypeError):
        i.inflate(bytearray(8))


def test_inflater_undersized_buffer_keeps_remainder():
    data = CORPUS[:10000]
    i = tcomp.Inflater(nowrap=True)
    i.set_input(tcomp.raw_deflate(data, 6, nowrap=True))
    out, buf = bytearray(), bytearray(3000)
    while not i.finished():
        out += buf[: i.inflate(buf)]
    assert bytes(out) == data


@pytest.mark.parametrize("threads", [1, 4])
def test_batch_blocks(threads):
    blocks = [_dna(1000 + 37 * k, seed=k) for k in range(64)]
    compressed = tcomp.deflate_blocks(blocks, level=4, threads=threads)
    assert compressed == jcomp.deflate_blocks(blocks, level=4, threads=threads)
    assert tcomp.inflate_blocks(compressed, threads=threads, max_block=1 << 14) == blocks
    assert zlib.decompress(compressed[3], -zlib.MAX_WBITS) == blocks[3]
    # a block past max_block fails the batch and inflates alone
    assert tcomp.inflate_blocks(compressed, threads=threads, max_block=1024) == blocks
    assert tcomp.deflate_blocks([]) == [] and tcomp.inflate_blocks([]) == []


def test_batch_corrupt_block():
    """A malformed block fails the packed batch (None, buffer released) and
    raises from the block-by-block path; the batch without it decodes."""
    blocks = [_dna(5000 + 777 * k, seed=20 + k) for k in range(6)]
    compressed = tcomp.deflate_blocks(blocks, level=1)
    bad = list(compressed)
    bad[2] = b"\x07\xff" + bad[2][:40]
    assert tcomp.inflate_blocks_packed(bad, threads=1) is None
    with pytest.raises(RuntimeError):
        tcomp.inflate_blocks(bad, threads=1)
    good = compressed[:2] + compressed[3:]
    out, lens, stride, crcs = tcomp.inflate_blocks_packed(good, threads=2, crcs=True)
    for k, b in enumerate(blocks[:2] + blocks[3:]):
        assert bytes(out[k * stride : k * stride + lens[k]]) == b
        assert int(crcs[k]) == zlib.crc32(b)
    tcomp.release_blocks_buffer(out)
    # the pool hands the released buffer out again for the same size
    again = tcomp.inflate_blocks_packed(good, threads=2)[0]
    assert again is out
    tcomp.release_blocks_buffer(again)


def test_bgzf_roundtrip_synthetic():
    data = CORPUS[:200_000]
    stream = tbgzf.compress(data, level=5)
    assert stream.endswith(tbgzf.EOF_BLOCK)
    assert tbgzf.decompress(stream) == data
    assert gzip.decompress(stream) == data
    members = tbgzf.split_blocks(stream)
    assert len(members) == -(-len(data) // tbgzf.MAX_BLOCK_DATA) + 1
    assert b"".join(tbgzf.decompress_block(m) for m in members) == data
    assert tbgzf.compress(b"") == jbgzf.compress(b"")


@pytest.mark.parametrize("level", range(-1, 10))
def test_raw_deflate_bytes_equal_jax(level, bam_payload):
    """The same bytes as the JAX package at every level, raw and
    zlib-wrapped, on BAM payload, random bytes and DNA."""
    rng = np.random.default_rng(level + 1)
    for data in (bam_payload[: 65 << 10], bytes(rng.integers(0, 256, 65 << 10, np.uint8)),
                 CORPUS[: 65 << 10], b"", b"A"):
        for nowrap in (True, False):
            assert tcomp.raw_deflate(data, level, nowrap) == \
                jcomp.raw_deflate(data, level, nowrap), (len(data), nowrap)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_bgzf_compress_bytes_equal_jax(level, bam_payload):
    stream = tbgzf.compress(bam_payload, level=level, threads=4)
    assert stream == jbgzf.compress(bam_payload, level=level, threads=4)
    assert tbgzf.compress(bam_payload, level=level, append_eof=False) == \
        stream[: -len(tbgzf.EOF_BLOCK)]
    assert tbgzf.decompress(stream) == bam_payload
    assert tbgzf.EOF_BLOCK == jbgzf.EOF_BLOCK and tbgzf.MAX_BLOCK_DATA == jbgzf.MAX_BLOCK_DATA
    for member in tbgzf.split_blocks(stream)[:3]:
        assert tbgzf.decompress_block(member) == jbgzf.decompress_block(member)
