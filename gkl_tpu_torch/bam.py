"""BAM reader (SAM spec §4.2) — counterpart of the read side of ``gkl_tpu/bam.py``.

BGZF blocks are inflated by the parallel native codec (``compression.py``)
and alignment records are decoded by the native record scanner
(``gkl_tpu_torch/native/bam_scan.cc``, a byte-identical copy of
``gkl_tpu/native/bam_scan.cc``) into numpy arrays ready
for the batch planner.  Only the fields the kernels need are decoded: name,
flag, position, cigar, sequence and qualities.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np

from . import compression, native_lib

CIGAR_OPS = "MIDNSHP=X"

FLAG_UNMAPPED = 0x4
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


@dataclasses.dataclass
class BamHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]


@dataclasses.dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int  # 0-based leftmost coordinate
    mapq: int
    cigar: list[tuple[int, str]]  # (length, op)
    seq: np.ndarray  # uint8 ASCII bases
    qual: np.ndarray  # uint8 phred (no +33 offset)


def parse_header(payload) -> tuple[BamHeader, int]:
    """Parse the BAM header; returns (header, offset of first record)."""
    if bytes(payload[:4]) != b"BAM\x01":
        raise ValueError("not a BAM payload (missing BAM\\1 magic)")
    l_text = struct.unpack_from("<i", payload, 4)[0]
    if l_text < 0:
        raise ValueError("corrupt BAM header (negative l_text)")
    text = bytes(payload[8 : 8 + l_text]).rstrip(b"\x00").decode("utf-8", "replace")
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", payload, off)
    off += 4
    names, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", payload, off)
        off += 4
        names.append(bytes(payload[off : off + l_name - 1]).decode("ascii"))
        off += l_name
        (l_ref,) = struct.unpack_from("<i", payload, off)
        off += 4
        lengths.append(l_ref)
    return BamHeader(text, names, lengths), off


def _try_parse_header(payload) -> tuple[BamHeader, int] | None:
    """parse_header, or None while the buffer is still too short."""
    n = len(payload)
    if n < 12:
        return None
    if bytes(payload[:4]) != b"BAM\x01":
        raise ValueError("not a BAM payload (missing BAM\\1 magic)")
    (l_text,) = struct.unpack_from("<i", payload, 4)
    if l_text < 0:
        raise ValueError("corrupt BAM header (negative l_text)")
    off = 8 + l_text
    if off + 4 > n:
        return None
    (n_ref,) = struct.unpack_from("<i", payload, off)
    if n_ref < 0:
        raise ValueError("corrupt BAM header (negative n_ref)")
    probe = off + 4
    for _ in range(n_ref):
        if probe + 4 > n:
            return None
        (l_name,) = struct.unpack_from("<i", payload, probe)
        if l_name < 1:
            raise ValueError("corrupt BAM header (non-positive ref name length)")
        probe += 4 + l_name + 4
    if probe > n:
        return None
    return parse_header(bytes(memoryview(payload)[:probe]))


def _scanner():
    lib = native_lib.load("gkl_bam")
    if not hasattr(lib, "_bam_ready"):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gkl_bam_count.restype = ctypes.c_int
        lib.gkl_bam_count.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, i64p, i64p, i64p]
        lib.gkl_bam_scan.restype = ctypes.c_int64
        lib.gkl_bam_scan.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64,
                                     i32p, i32p, i32p, i32p, i32p,
                                     i64p, u8p, i64p, u8p,
                                     i64p, i32p, u8p, i64p, i32p]
        lib._bam_ready = True
    return lib


def parse_records(payload, offset: int, limit: int | None = None) -> list[BamRecord]:
    """Decode the alignment records of a decompressed BAM payload with the
    native two-pass scanner: fixed fields, unpacked sequences and quals in
    flat buffers.  Each record's seq/qual are views into shared buffers."""
    if limit is not None and limit <= 0:
        return []
    lib = _scanner()
    buf = np.frombuffer(payload, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n_rec, seq_bytes, name_bytes = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    maxr = limit if limit is not None else 0  # <= 0 = unlimited (C side)
    rc = lib.gkl_bam_count(buf.ctypes.data_as(u8p), len(buf), offset, maxr,
                           ctypes.byref(n_rec), ctypes.byref(seq_bytes),
                           ctypes.byref(name_bytes))
    if rc != 0:
        raise ValueError("truncated BAM record")
    n = n_rec.value
    ref_id, pos, flag, mapq, l_seq, n_cigar, name_len = (
        np.empty(n, np.int32) for _ in range(7))
    seq_off, qual_off, name_off, cigar_off = (np.empty(n, np.int64) for _ in range(4))
    seq_buf = np.empty(seq_bytes.value, np.uint8)
    qual_buf = np.empty(seq_bytes.value, np.uint8)
    name_buf = np.empty(max(1, name_bytes.value), np.uint8)
    wrote = lib.gkl_bam_scan(
        buf.ctypes.data_as(u8p), len(buf), offset, maxr,
        ref_id.ctypes.data_as(i32p), pos.ctypes.data_as(i32p),
        flag.ctypes.data_as(i32p), mapq.ctypes.data_as(i32p),
        l_seq.ctypes.data_as(i32p),
        seq_off.ctypes.data_as(i64p), seq_buf.ctypes.data_as(u8p),
        qual_off.ctypes.data_as(i64p), qual_buf.ctypes.data_as(u8p),
        name_off.ctypes.data_as(i64p), name_len.ctypes.data_as(i32p),
        name_buf.ctypes.data_as(u8p),
        cigar_off.ctypes.data_as(i64p), n_cigar.ctypes.data_as(i32p),
    )
    if wrote != n:
        raise ValueError("BAM scan inconsistency")
    records = []
    for k in range(n):
        s0, ls, co = seq_off[k], l_seq[k], cigar_off[k]
        cigar = []
        for ci in range(n_cigar[k]):
            (c,) = struct.unpack_from("<I", payload, co + 4 * ci)
            cigar.append((c >> 4, CIGAR_OPS[c & 0xF]))
        name = bytes(name_buf[name_off[k] : name_off[k] + name_len[k]]).decode("ascii")
        records.append(BamRecord(
            name, int(flag[k]), int(ref_id[k]), int(pos[k]), int(mapq[k]),
            cigar, seq_buf[s0 : s0 + ls], qual_buf[s0 : s0 + ls],
        ))
    return records


def read_bam(path: str, limit: int | None = None,
             threads: int | None = None) -> tuple[BamHeader, list[BamRecord]]:
    """Read a whole BAM file: (header, records)."""
    with open(path, "rb") as fh:
        data = fh.read()
    payload = compression.decompress(data, threads=threads)
    header, off = parse_header(payload)
    return header, parse_records(payload, off, limit=limit)


def _complete_records_end(buf, start: int) -> int:
    """Offset just past the last complete alignment record in ``buf``."""
    off = start
    n = len(buf)
    while off + 4 <= n:
        bs = int.from_bytes(buf[off : off + 4], "little", signed=True)
        if bs < 32:
            raise ValueError("truncated BAM record")
        if off + 4 + bs > n:
            break
        off += 4 + bs
    return off


def read_bam_streaming(path: str, limit: int | None = None,
                       threads: int | None = None, read_size: int = 4 << 20):
    """Streaming form of :func:`read_bam`: returns (header, record iterator)
    with host memory bounded by ``read_size`` of compressed input plus one
    decode window; records may span BGZF blocks, so a rolling buffer
    carries partial tails."""
    gen = compression.iter_decompressed(path, threads=threads, read_size=read_size)
    buf = bytearray()
    header = None
    off = 0
    for chunk in gen:
        buf += chunk
        parsed = _try_parse_header(buf)
        if parsed is not None:
            header, off = parsed
            break
    if header is None:
        raise ValueError("truncated BAM header")

    def records():
        nonlocal buf, off
        count = 0

        def drain():
            nonlocal buf, off, count
            end = _complete_records_end(buf, off)
            if end > off:
                want = None if limit is None else limit - count
                recs = parse_records(bytes(memoryview(buf)[off:end]), 0, limit=want)
                count += len(recs)
                del buf[:end]
                off = 0
                yield from recs

        yield from drain()
        if limit is not None and count >= limit:
            return
        for chunk in gen:
            buf += chunk
            yield from drain()
            if limit is not None and count >= limit:
                return
        if off < len(buf):
            raise ValueError("truncated BAM record at end of stream")

    return header, records()
