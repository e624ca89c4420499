"""BGZF block split and inflate — counterpart of the read side of
``gkl_tpu/compression/`` (``bgzf.py`` and the batch inflater).

BAM files are streams of gzip members carrying a ``BC`` extra subfield with
the compressed block size (SAM spec §4.1).  Members are split here and
inflated in parallel by the host native codec (``gkl_tpu_torch/native/codec.cc``,
a byte-identical copy of ``gkl_tpu/native/codec.cc``), which also computes
each block's CRC32 while the payload
is cache-hot.  Every block's CRC32 and size are verified.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import native_lib, utils

_MAX_BLOCK = 1 << 16


def _codec():
    lib = native_lib.load("gkl_codec")
    if not hasattr(lib, "_inflate_ready"):
        lib.gkl_inflate_batch2.restype = None
        lib.gkl_inflate_batch2.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int, ctypes.c_int,
        ]
        lib._inflate_ready = True
    return lib


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
    lib = _codec()
    n = len(members)
    cdatas = []
    meta = np.empty((n, 2), np.int64)  # crc, isize
    for i, b in enumerate(members):
        xlen = struct.unpack_from("<H", b, 10)[0]
        cdatas.append(b[12 + xlen : -8])
        meta[i] = struct.unpack_from("<II", b, len(b) - 8)
    ins = (ctypes.c_char_p * n)(*cdatas)
    lens = np.array([len(c) for c in cdatas], np.int32)
    out = np.empty(n * _MAX_BLOCK, np.uint8)
    out_lens = np.empty(n, np.int32)
    out_crcs = np.empty(n, np.uint32)
    lib.gkl_inflate_batch2(
        ctypes.cast(ins, ctypes.POINTER(ctypes.c_char_p)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(_MAX_BLOCK),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        1, threads or utils.default_host_threads())
    if (not np.array_equal(out_lens.astype(np.int64), meta[:, 1])
            or not np.array_equal(out_crcs.astype(np.int64), meta[:, 0])):
        raise ValueError("BGZF block corrupt")
    buf = bytearray(int(out_lens.sum()))
    mv = memoryview(buf)
    o = 0
    for i in range(n):
        ln = int(out_lens[i])
        mv[o : o + ln] = out[i * _MAX_BLOCK : i * _MAX_BLOCK + ln]
        o += ln
    return buf


def decompress(data: bytes, threads: int | None = None) -> bytearray:
    """Decompress a whole BGZF stream (parallel across blocks)."""
    return inflate_members(split_blocks(data), threads)


def iter_decompressed(path: str, threads: int | None = None,
                      read_size: int = 4 << 20):
    """Stream-decompress a BGZF file in bounded memory: reads ``read_size``
    compressed bytes at a time, inflates each batch of complete members and
    yields the decompressed chunks."""
    with open(path, "rb") as fh:
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
