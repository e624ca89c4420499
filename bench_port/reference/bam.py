"""A plain BAM writer: records encoded as the SAM/BAM specification sets
out (section 4.2), the payload cut into BGZF blocks of at most 65,280
bytes, each a gzip member with the BC extra field, deflated by Python's
zlib at the given level (htsjdk's default is 5), and the 28-byte EOF
block."""

from __future__ import annotations

import struct
import zlib

import numpy as np

BLOCK_DATA = 0xFF00
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_SEQ_CODE = np.zeros(256, np.uint8)
for _k, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _SEQ_CODE[_c] = _k
_CIGAR_M = 0


def reg2bin(beg: int, end: int) -> int:
    """The BAI bin of a 0-based [beg, end) interval (SAM spec 5.3)."""
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


def encode_record(name: str, pos: int, seq: np.ndarray, qual: np.ndarray, *, ref_id: int = 0,
                  flag: int = 0, mapq: int = 60) -> bytes:
    """One mapped record with the CIGAR ``len(seq)M``."""
    seq = np.asarray(seq, np.uint8)
    n = len(seq)
    codes = _SEQ_CODE[seq]
    if n % 2:
        codes = np.append(codes, 0)
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    rname = name.encode("ascii") + b"\0"
    body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(rname), mapq, reg2bin(pos, pos + n), 1,
                       flag, n, -1, -1, 0)
    body += rname + struct.pack("<I", (n << 4) | _CIGAR_M) + packed
    body += np.asarray(qual, np.uint8).tobytes()
    return struct.pack("<i", len(body)) + body


def encode_header(text: str, refs: list[tuple[str, int]]) -> bytes:
    out = b"BAM\1" + struct.pack("<i", len(text)) + text.encode("ascii")
    out += struct.pack("<i", len(refs))
    for name, length in refs:
        raw = name.encode("ascii") + b"\0"
        out += struct.pack("<i", len(raw)) + raw + struct.pack("<i", length)
    return out


def bgzf_block(data: bytes, level: int) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = comp.compress(data) + comp.flush()
    header = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, ord("B"), ord("C"),
                         2, len(payload) + 25)
    return header + payload + struct.pack("<II", zlib.crc32(data), len(data))


def write_bam(path: str, header: bytes, records, level: int = 5) -> int:
    """Write the header and encoded records as BGZF; returns bytes written."""
    payload = header + b"".join(records)
    written = 0
    with open(path, "wb") as f:
        for s in range(0, len(payload), BLOCK_DATA):
            written += f.write(bgzf_block(payload[s:s + BLOCK_DATA], level))
        written += f.write(EOF_BLOCK)
    return written
