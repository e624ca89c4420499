"""BAM reader and writer (SAM spec §4.2) — counterpart of ``gkl_tpu/bam.py``.

BGZF blocks are inflated by the parallel native codec (``compression/``)
and alignment records are decoded by the native record scanner
(``gkl_tpu_torch/native/bam_scan.cc``, a byte-identical copy of
``gkl_tpu/native/bam_scan.cc``) into numpy arrays ready
for the batch planner.  Only the fields the kernels need are decoded: name,
flag, position, cigar, sequence and qualities.  Readers invoked with
``keep_raw=True`` also keep each record's original bytes, so rewrite paths
(``pipeline.bam_recompress``) carry tags, mate fields and bin verbatim.

The writer (:func:`write_bam`, :func:`write_bam_streaming`) encodes records
and deflates maximal BGZF blocks on the parallel codec: the htsjdk
SAMFileWriter + IntelDeflater path (DeflaterIntegrationTest.java:27-99)
without the JVM.  Its files are byte for byte the JAX package's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np

from . import native_lib
from .compression import bgzf

# 4-bit seq nibble -> ASCII base (SAM spec: =ACMGRSVTWYHKDBN)
SEQ_NIBBLE = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
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
    # the record's original bytes (4-byte size prefix + block), kept only
    # when the reader is asked to (keep_raw=True): tags, mate fields and
    # bin, which the decoded fields above do not carry
    raw: bytes | None = None

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for n, op in self.cigar) or "*"


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


def try_parse_header(payload) -> tuple[BamHeader, int] | None:
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


def parse_records_native(payload, offset: int, limit: int | None = None,
                         keep_raw: bool = False) -> list[BamRecord]:
    """Decode the alignment records of a decompressed BAM payload with the
    native two-pass scanner (``native/bam_scan.cc``): fixed fields,
    unpacked sequences and quals in flat buffers.  Each record's seq/qual
    are views into shared buffers; with ``keep_raw`` each record also keeps
    its original bytes.  ``limit <= 0`` gives ``[]``; a truncated or
    corrupt record raises ``ValueError``.  Unlike the JAX package's, it
    never returns None: a scanner that fails to build raises, as every
    native load of this package does."""
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
        raw = None
        if keep_raw:
            # the record spans [prefix, prefix + 4 + block_size); its cigar
            # sits at prefix + 4 + 32 + l_read_name, and l_read_name counts
            # the NUL that the scanner's name length leaves out
            prefix = int(co) - 32 - (int(name_len[k]) + 1) - 4
            (bs,) = struct.unpack_from("<i", payload, prefix)
            raw = bytes(payload[prefix : prefix + 4 + bs])
        records.append(BamRecord(
            name, int(flag[k]), int(ref_id[k]), int(pos[k]), int(mapq[k]),
            cigar, seq_buf[s0 : s0 + ls], qual_buf[s0 : s0 + ls], raw,
        ))
    return records


# the JAX package's pure-Python record parser: here the native scanner
# serves both names, and returns a list
parse_records = parse_records_native


def read_bam(path: str, limit: int | None = None, threads: int | None = None,
             keep_raw: bool = False) -> tuple[BamHeader, list[BamRecord]]:
    """Read a whole BAM file: (header, records)."""
    with open(path, "rb") as fh:
        data = fh.read()
    payload = bgzf.decompress(data, threads=threads)
    header, off = parse_header(payload)
    return header, parse_records(payload, off, limit=limit, keep_raw=keep_raw)


def complete_records_end(buf, start: int) -> int:
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


class RecordDecoder:
    """Decompressed BAM bytes in, records out: :meth:`feed` takes the next
    decompressed chunk and returns the records it completes (the header
    first goes to :attr:`header`); records may span chunks, so a rolling
    buffer carries partial tails.  At most ``limit`` records come out, then
    :attr:`done` is true; :meth:`finish` checks that the stream ended
    whole."""

    def __init__(self, limit: int | None = None, keep_raw: bool = False):
        self.limit, self.keep_raw = limit, keep_raw
        self.header: BamHeader | None = None
        self.count = 0
        self._buf = bytearray()
        self._off = 0

    @property
    def done(self) -> bool:
        return self.limit is not None and self.count >= self.limit

    def feed(self, chunk) -> list[BamRecord]:
        self._buf += chunk
        if self.header is None:
            parsed = try_parse_header(self._buf)
            if parsed is None:
                return []
            self.header, self._off = parsed
        end = complete_records_end(self._buf, self._off)
        if end <= self._off:
            return []
        want = None if self.limit is None else self.limit - self.count
        recs = parse_records(bytes(memoryview(self._buf)[self._off:end]), 0, limit=want,
                             keep_raw=self.keep_raw)
        self.count += len(recs)
        del self._buf[:end]
        self._off = 0
        return recs

    def finish(self) -> None:
        if self.header is None:
            raise ValueError("truncated BAM header")
        if self._off < len(self._buf):
            raise ValueError("truncated BAM record at end of stream")


def read_bam_streaming(path: str, limit: int | None = None,
                       threads: int | None = None, read_size: int = 4 << 20,
                       keep_raw: bool = False):
    """Streaming form of :func:`read_bam`: returns (header, record iterator)
    with host memory bounded by ``read_size`` of compressed input plus one
    decode window (:class:`RecordDecoder`)."""
    gen = bgzf.iter_decompressed(path, threads=threads, read_size=read_size)
    dec = RecordDecoder(limit, keep_raw)
    first: list[BamRecord] = []
    for chunk in gen:
        first = dec.feed(chunk)
        if dec.header is not None:
            break
    if dec.header is None:
        raise ValueError("truncated BAM header")

    def records():
        yield from first
        if dec.done:
            return
        for chunk in gen:
            yield from dec.feed(chunk)
            if dec.done:
                return
        dec.finish()

    return dec.header, records()


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

_SEQ_CODE = {b: i for i, b in enumerate(SEQ_NIBBLE.tobytes())}
_CIGAR_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}


def encode_record(rec: BamRecord) -> bytes:
    """Serialize one alignment record to its BAM byte layout.

    A record that carries its original bytes (a ``keep_raw=True`` reader's)
    is emitted verbatim; one built in Python encodes from the decoded
    fields, with no tags, bin 0 and the mate fields unset."""
    if rec.raw is not None:
        return rec.raw
    name = rec.name.encode("ascii") + b"\x00"
    l_seq = len(rec.seq)
    packed = bytearray((l_seq + 1) // 2)
    for i, base in enumerate(bytes(rec.seq)):
        code = _SEQ_CODE.get(base, 15)
        if i % 2 == 0:
            packed[i // 2] = code << 4
        else:
            packed[i // 2] |= code
    body = struct.pack(
        "<iiBBHHHiiii",
        rec.ref_id, rec.pos, len(name), rec.mapq,
        0,  # bin
        len(rec.cigar), rec.flag, l_seq,
        -1, -1, 0,  # next_refID, next_pos, tlen
    )
    cigar = b"".join(struct.pack("<I", (n << 4) | _CIGAR_CODE[op]) for n, op in rec.cigar)
    qual = bytes(rec.qual) if len(rec.qual) == l_seq else b"\xff" * l_seq
    block = body + name + cigar + bytes(packed) + qual
    return struct.pack("<i", len(block)) + block


def encode_header(header: BamHeader) -> bytes:
    """The BAM header's bytes: magic, text, reference dictionary."""
    text = header.text.encode("utf-8")
    out = bytearray(b"BAM\x01")
    out += struct.pack("<i", len(text))
    out += text
    out += struct.pack("<i", len(header.ref_names))
    for name, length in zip(header.ref_names, header.ref_lengths):
        nb = name.encode("ascii") + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    return bytes(out)


def write_bam(path: str, header: BamHeader, records, level: int = 6,
              threads: int | None = None) -> None:
    """Write records to a BAM file, BGZF-compressed on the parallel codec."""
    payload = encode_header(header) + b"".join(encode_record(r) for r in records)
    with open(path, "wb") as fh:
        fh.write(bgzf.compress(payload, level=level, threads=threads))


def write_bam_streaming(path: str, header: BamHeader, records, level: int = 6,
                        threads: int | None = None, window_blocks: int = 64) -> int:
    """Streaming BAM writer in bounded memory: encoded records accumulate
    until ``window_blocks`` full BGZF blocks are ready, then that window
    deflates across the native thread pool and goes to disk.  Only maximal
    blocks are written until the records end; then the tail block and
    :data:`bgzf.EOF_BLOCK`.  Returns the number of records written."""
    window_bytes = window_blocks * bgzf.MAX_BLOCK_DATA
    n_written = 0
    with open(path, "wb") as fh:
        buf = bytearray(encode_header(header))

        def flush(final: bool) -> None:
            cut = len(buf) if final else (len(buf) // bgzf.MAX_BLOCK_DATA) * bgzf.MAX_BLOCK_DATA
            if cut > 0:
                fh.write(bgzf.compress(bytes(buf[:cut]), level=level, threads=threads,
                                       append_eof=False))
                del buf[:cut]
            if final:
                fh.write(bgzf.EOF_BLOCK)

        for rec in records:
            buf += encode_record(rec)
            n_written += 1
            if len(buf) >= window_bytes:
                flush(False)
        flush(True)
    return n_written
