"""BGZF (blocked gzip) reader and writer — counterpart of
``gkl_tpu/compression/bgzf.py``.

BAM files are streams of gzip members carrying a ``BC`` extra subfield with
the compressed block size (SAM spec §4.1).  Members are split here and
inflated in parallel by the block codec of this package, which also
computes each block's CRC32 while the payload is cache-hot; every block's
CRC32 and size are verified.  :func:`compress` cuts a payload into blocks of
:data:`MAX_BLOCK_DATA` bytes, deflates them in parallel and frames each as
htsjdk's BlockCompressedOutputStream does.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from . import deflate_blocks, inflate_blocks_packed, release_blocks_buffer

MAX_BLOCK_DATA = 65280  # uncompressed payload cap per BGZF block (htsjdk)
# the canonical 28-byte BGZF EOF marker block
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_MAX_BLOCK = 1 << 16


def split_blocks_partial(data) -> tuple[list[bytes], int]:
    """Split a BGZF byte stream into its complete gzip members; returns
    (members, bytes consumed).  A truncated tail is left unconsumed for the
    caller to carry into the next read."""
    blocks = []
    pos = 0
    n = len(data)
    while pos + 18 <= n:  # minimum bytes to locate the BC subfield
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError(f"not a BGZF stream at offset {pos}")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        if pos + 12 + xlen > n:
            break
        extra = data[pos + 12 : pos + 12 + xlen]
        bsize = None
        e = 0
        while e + 4 <= len(extra):
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from("<H", extra, e + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
                break
            e += 4 + slen
        if bsize is None:
            raise ValueError(f"gzip member without BC subfield at offset {pos}")
        if pos + bsize > n:
            break
        blocks.append(bytes(data[pos : pos + bsize]))
        pos += bsize
    return blocks, pos


def split_blocks(data: bytes) -> list[bytes]:
    """Split a whole BGZF byte stream into its gzip members."""
    blocks, consumed = split_blocks_partial(data)
    if consumed != len(data):
        raise ValueError(
            f"truncated BGZF stream: member at offset {consumed} is incomplete")
    return blocks


def inflate_members(members: list[bytes], threads: int | None = None) -> bytearray:
    """Inflate BGZF members in parallel, verify each block's CRC32 and size
    against its gzip trailer, and join the payloads."""
    if not members:
        return bytearray()
    n = len(members)
    cdatas = []
    meta = np.empty((n, 2), np.int64)  # crc, isize
    for i, b in enumerate(members):
        xlen = struct.unpack_from("<H", b, 10)[0]
        cdatas.append(b[12 + xlen : -8])
        meta[i] = struct.unpack_from("<II", b, len(b) - 8)
    res = inflate_blocks_packed(cdatas, threads=threads, max_block=_MAX_BLOCK, crcs=True)
    if res is None:
        raise ValueError("BGZF block corrupt")
    out, out_lens, stride, out_crcs = res
    if (not np.array_equal(out_lens.astype(np.int64), meta[:, 1])
            or not np.array_equal(out_crcs.astype(np.int64), meta[:, 0])):
        release_blocks_buffer(out)
        raise ValueError("BGZF block corrupt")
    buf = bytearray(int(out_lens.sum()))
    mv = memoryview(buf)
    o = 0
    for i in range(n):
        ln = int(out_lens[i])
        mv[o : o + ln] = out[i * stride : i * stride + ln]
        o += ln
    release_blocks_buffer(out)
    return buf


def decompress_block(block: bytes) -> bytes:
    """Decompress one BGZF block, verified against its trailer."""
    return bytes(inflate_members([block]))


def decompress(data: bytes, threads: int | None = None) -> bytearray:
    """Decompress a whole BGZF stream (parallel across blocks)."""
    return inflate_members(split_blocks(data), threads)


def iter_decompressed(path_or_file, threads: int | None = None,
                      read_size: int = 4 << 20):
    """Stream-decompress a BGZF file in bounded memory: reads ``read_size``
    compressed bytes at a time, inflates each batch of complete members and
    yields the decompressed chunks.  ``path_or_file`` is a path (``str``,
    ``bytes`` or ``os.PathLike``), which it opens and closes, or an open
    binary file, which it reads and leaves open."""
    opened = isinstance(path_or_file, (str, bytes, os.PathLike))
    fh = open(path_or_file, "rb") if opened else path_or_file
    try:
        rem = b""
        while True:
            data = fh.read(read_size)
            if not data:
                break
            rem += data
            blocks, consumed = split_blocks_partial(rem)
            rem = rem[consumed:]
            if blocks:
                yield inflate_members(blocks, threads)
        if rem:
            raise ValueError("truncated BGZF stream (incomplete trailing member)")
    finally:
        if opened:
            fh.close()


def _frame(cdata: bytes, raw: bytes) -> bytes:
    """One gzip member with the BC subfield around a raw DEFLATE block."""
    bsize = len(cdata) + 12 + 6 + 8
    if bsize > 65536:
        raise ValueError("BGZF block too large")
    header = (
        b"\x1f\x8b\x08\x04"  # magic, deflate, FEXTRA
        + b"\x00\x00\x00\x00"  # mtime
        + b"\x00\xff"  # xfl, os=unknown
        + struct.pack("<H", 6)  # xlen
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    footer = struct.pack("<II", zlib.crc32(raw) & 0xFFFFFFFF, len(raw))
    return header + cdata + footer


def compress(data: bytes, level: int = 6, threads: int | None = None,
             append_eof: bool = True) -> bytes:
    """Compress bytes into a BGZF stream (parallel across blocks)."""
    chunks = [data[i : i + MAX_BLOCK_DATA] for i in range(0, len(data), MAX_BLOCK_DATA)] or [b""]
    cdatas = deflate_blocks(chunks, level=level, nowrap=True, threads=threads)
    out = bytearray()
    for raw, cdata in zip(chunks, cdatas):
        out += _frame(cdata, raw)
    if append_eof:
        out += EOF_BLOCK
    return bytes(out)
