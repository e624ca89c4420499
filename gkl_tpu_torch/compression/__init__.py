"""DEFLATE block codec — counterpart of ``gkl_tpu/compression/__init__.py``.

* :class:`Deflater` / :class:`Inflater` mirror ``IntelDeflater`` /
  ``IntelInflater`` (compression/IntelDeflater.java:80-233,
  IntelInflater.java:85-219): single-shot whole-block semantics, the
  level-1/2-requires-nowrap rule, and the inflater's nowrap-only rule.
* :func:`make_deflater` / :func:`make_inflater` mirror the factories'
  configuration fallback (IntelDeflaterFactory.java:55-67): a
  configuration the accelerated codec refuses falls back to Python
  ``zlib``.
* :func:`deflate_blocks` / :func:`inflate_blocks` are the multi-threaded
  batch stage of the BAM streams (a block-parallel C++ pool in place of the
  reference's per-call JNI).

Everything runs on the port's copy of the native codec
(``gkl_tpu_torch/native/codec.cc``, ``deflate_fast.cc``,
``inflate_fast.cc``), which is always built: a failed build raises, and
there is no pure-Python codec behind it.  For the same input, level and
framing its output is byte for byte the JAX package's.
"""

from __future__ import annotations

import ctypes
import threading
import zlib

import numpy as np

from .. import native_lib, utils

DEFAULT_COMPRESSION = -1

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U32P = ctypes.POINTER(ctypes.c_uint32)


def _codec() -> ctypes.CDLL:
    lib = native_lib.load("gkl_codec")
    if not hasattr(lib, "_codec_ready"):
        lib.gkl_deflate.restype = ctypes.c_int
        lib.gkl_deflate.argtypes = [_U8P, ctypes.c_int, _U8P, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
        lib.gkl_inflate.restype = ctypes.c_int
        lib.gkl_inflate.argtypes = [_U8P, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int]
        lib.gkl_deflate_bound.restype = ctypes.c_int
        lib.gkl_deflate_bound.argtypes = [ctypes.c_int]
        lib.gkl_deflate_batch.restype = None
        lib.gkl_deflate_batch.argtypes = [_U8P, _I64P, _I32P, ctypes.c_int, _U8P,
                                          ctypes.c_int64, _I32P, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int]
        lib.gkl_inflate_batch2.restype = None
        lib.gkl_inflate_batch2.argtypes = [ctypes.POINTER(ctypes.c_char_p), _I32P,
                                           ctypes.c_int, _U8P, ctypes.c_int64, _I32P,
                                           _U32P, ctypes.c_int, ctypes.c_int]
        lib._codec_ready = True
    return lib


def _ptr(a: np.ndarray, kind=_U8P):
    return a.ctypes.data_as(kind)


def raw_deflate(data: bytes, level: int, nowrap: bool = True) -> bytes:
    """One-shot DEFLATE of a whole block (raw, or zlib-wrapped without
    ``nowrap``)."""
    lib = _codec()
    buf = np.frombuffer(data, np.uint8) if data else np.zeros(0, np.uint8)
    cap = lib.gkl_deflate_bound(len(buf))
    out = np.empty(cap, np.uint8)
    n = lib.gkl_deflate(_ptr(buf) if len(buf) else None, len(buf), _ptr(out), cap,
                        level, 1 if nowrap else 0)
    if n < 0:
        raise RuntimeError("deflate failed")
    return out[:n].tobytes()


def raw_inflate(data: bytes, nowrap: bool = True, initial_size: int | None = None) -> bytes:
    """One-shot INFLATE of a whole block; the output buffer grows fourfold
    up to eight times before the stream counts as corrupt."""
    lib = _codec()
    cap = initial_size or max(4 * len(data), 1 << 16)
    buf = np.frombuffer(data, np.uint8)
    for _ in range(8):
        out = np.empty(cap, np.uint8)
        n = lib.gkl_inflate(_ptr(buf), len(buf), _ptr(out), cap, 1 if nowrap else 0)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 4
    raise RuntimeError("inflate failed")


def _check_range(b, off: int, length: int | None) -> int:
    if b is None:
        raise TypeError("Input buffer is null")
    length = len(b) - off if length is None else length
    if off < 0 or length < 0 or off > len(b) - length:
        raise IndexError("Offset/length out of range")
    return length


class Deflater:
    """Single-shot block deflater (IntelDeflater semantics).

    Levels 1-2 require nowrap (the reference routes them to ISA-L which only
    emits raw DEFLATE, IntelDeflater.java:95-97).
    """

    def __init__(self, level: int = DEFAULT_COMPRESSION, nowrap: bool = True):
        if (level < 0 or level > 9) and level != DEFAULT_COMPRESSION:
            raise ValueError("Illegal compression level")
        if level in (1, 2) and not nowrap:
            raise ValueError("Compression configuration requested not supported")
        self.level = level
        self.nowrap = nowrap
        self._input: bytes | None = None
        self._end_of_stream = False
        self._finished = False

    def reset(self) -> None:
        self._input = None
        self._end_of_stream = False
        self._finished = False

    def set_input(self, b, off: int = 0, length: int | None = None) -> None:
        length = _check_range(b, off, length)
        self._input = bytes(b[off : off + length])
        self._finished = False

    def finish(self) -> None:
        self._end_of_stream = True

    def deflate(self, out, off: int = 0, length: int | None = None) -> int:
        if out is None:
            raise TypeError("Output buffer is null")
        if off != 0:
            raise ValueError("The only accepted offset value is 0")
        length = len(out) if length is None else length
        if length <= 0:
            raise IndexError("Length value is less or equal than zero")
        if not self._input:
            raise TypeError("Input buffer is null")
        compressed = raw_deflate(self._input, self.level, self.nowrap)
        if len(compressed) > length:
            raise ValueError(f"Output buffer too small: need {len(compressed)}, have {length}")
        out[: len(compressed)] = compressed
        if self._end_of_stream:
            self._finished = True
        return len(compressed)

    def finished(self) -> bool:
        return self._finished

    def end(self) -> None:
        self._input = None


class Inflater:
    """Single-shot block inflater (IntelInflater semantics: nowrap only)."""

    def __init__(self, nowrap: bool = True):
        if not nowrap:
            raise ValueError("ZLIB format is not supported at this time with GKL TPU")
        self.nowrap = nowrap
        self._input: bytes | None = None
        self._pending: bytes | None = None  # decompressed-but-undelivered tail

    def reset(self) -> None:
        self._input = None
        self._pending = None

    def set_input(self, b, off: int = 0, length: int | None = None) -> None:
        length = _check_range(b, off, length)
        self._input = bytes(b[off : off + length])
        self._pending = None

    def inflate(self, out, off: int = 0, length: int | None = None) -> int:
        """Fill ``out``; an undersized buffer keeps the remainder as state
        for the next call (java.util.zip semantics: ``finished()`` stays
        False until it is drained)."""
        if out is None:
            raise TypeError("Output buffer is null")
        length = (len(out) - off) if length is None else length
        if off < 0 or length < 0 or off > len(out) - length:
            raise IndexError("Offset/length out of range")
        if self._pending is None:
            if not self._input:
                raise TypeError("Input buffer is null")
            self._pending = raw_inflate(self._input, self.nowrap,
                                        initial_size=max(length, 1 << 16))
        n = min(len(self._pending), length)
        out[off : off + n] = self._pending[:n]
        self._pending = self._pending[n:]
        return n

    def finished(self) -> bool:
        return self._pending is not None and len(self._pending) == 0

    def end(self) -> None:
        self._input = None


class _ZlibDeflater:
    """java.util.zip's deflater, for the configurations :class:`Deflater`
    refuses (what ``make_deflater`` falls back to)."""

    def __init__(self, level: int, nowrap: bool):
        self.level, self.nowrap = level, nowrap
        self._data: bytes | None = None
        self._finished = False

    def set_input(self, b, off=0, length=None):
        length = len(b) - off if length is None else length
        self._data = bytes(b[off : off + length])

    def finish(self):
        pass

    def deflate(self, out, off=0, length=None):
        c = zlib.compressobj(self.level, zlib.DEFLATED,
                             -zlib.MAX_WBITS if self.nowrap else zlib.MAX_WBITS)
        comp = c.compress(self._data) + c.flush()
        out[: len(comp)] = comp
        self._finished = True
        return len(comp)

    def finished(self):
        return self._finished

    def end(self):
        pass

    def reset(self):
        self._finished = False


class _ZlibInflater:
    """java.util.zip's inflater for zlib-wrapped streams (what
    ``make_inflater`` falls back to without nowrap)."""

    def __init__(self):
        self._data: bytes | None = None
        self._finished = False

    def set_input(self, b, off=0, length=None):
        length = len(b) - off if length is None else length
        self._data = bytes(b[off : off + length])

    def inflate(self, out, off=0, length=None):
        dec = zlib.decompress(self._data, zlib.MAX_WBITS)
        length = (len(out) - off) if length is None else length
        n = min(len(dec), length)
        out[off : off + n] = dec[:n]
        self._finished = True
        return n

    def finished(self):
        return self._finished

    def end(self):
        pass

    def reset(self):
        self._finished = False


def make_deflater(level: int = DEFAULT_COMPRESSION, nowrap: bool = True):
    """Factory with java.util.zip fallback (IntelDeflaterFactory.java:55-67):
    a configuration :class:`Deflater` refuses gets zlib's deflater."""
    try:
        return Deflater(level, nowrap)
    except ValueError:
        return _ZlibDeflater(level, nowrap)


def make_inflater(nowrap: bool = True):
    """Factory with fallback (IntelInflaterFactory.java:49-55): zlib-wrapped
    streams get zlib's inflater."""
    return Inflater(True) if nowrap else _ZlibInflater()


# ---------------------------------------------------------------------------
# Batch (multi-threaded) block codec — the pipeline stage
# ---------------------------------------------------------------------------


def deflate_blocks(blocks: list[bytes], level: int = 6, nowrap: bool = True,
                   threads: int | None = None) -> list[bytes]:
    """Compress many independent blocks in parallel (C++ thread pool)."""
    if not blocks:
        return []
    lib = _codec()
    n = len(blocks)
    packed = np.frombuffer(b"".join(blocks) or b"\0", np.uint8)
    lens = np.array([len(b) for b in blocks], np.int32)
    offsets = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    stride = lib.gkl_deflate_bound(int(lens.max()))
    out = np.empty(n * stride, np.uint8)
    out_lens = np.empty(n, np.int32)
    lib.gkl_deflate_batch(_ptr(packed), _ptr(offsets, _I64P), _ptr(lens, _I32P), n,
                          _ptr(out), stride, _ptr(out_lens, _I32P), level,
                          1 if nowrap else 0, threads or utils.default_host_threads())
    if np.any(out_lens < 0):
        raise RuntimeError("batch deflate failed")
    return [out[i * stride : i * stride + out_lens[i]].tobytes() for i in range(n)]


class _BufferPool:
    """Strided output buffers of :func:`inflate_blocks_packed` for reuse:
    the BGZF reader asks for the same size once per chunk, and a fresh
    buffer pays its first-touch page faults every time.  At most two
    buffers a size and 64 MB in all."""

    MAX_PER_SIZE = 2
    MAX_BYTES = 1 << 26

    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict[int, list[np.ndarray]] = {}
        self._bytes = 0

    def get(self, nbytes: int) -> np.ndarray:
        with self._lock:
            free = self._free.get(nbytes)
            if free:
                self._bytes -= nbytes
                return free.pop()
        return np.empty(nbytes, np.uint8)

    def put(self, out) -> None:
        if not isinstance(out, np.ndarray) or out.dtype != np.uint8 \
                or out.base is not None or not out.flags.c_contiguous:
            return
        with self._lock:
            free = self._free.setdefault(out.nbytes, [])
            if len(free) < self.MAX_PER_SIZE and self._bytes + out.nbytes <= self.MAX_BYTES:
                free.append(out)
                self._bytes += out.nbytes


_POOL = _BufferPool()


def release_blocks_buffer(out) -> None:
    """Return a strided buffer obtained from :func:`inflate_blocks_packed`
    to the reuse pool.  Only call once every view into it is dead; callers
    that skip this are merely slower."""
    _POOL.put(out)


def inflate_blocks_packed(blocks: list[bytes], nowrap: bool = True,
                          threads: int | None = None,
                          max_block: int = 1 << 16, crcs: bool = False):
    """Decompress many independent blocks in parallel into ONE strided
    buffer — the zero-assembly entry the BGZF reader consumes.

    Returns ``(out, out_lens, stride, out_crcs)``: block ``i``'s payload is
    ``out[i*stride : i*stride + out_lens[i]]``.  Inputs are passed by
    pointer, and with ``crcs=True`` each block's CRC32 is computed by the
    worker threads while the payload is cache-hot.  Returns None when there
    are no blocks or any block fails (corrupt, or larger than
    ``max_block``)."""
    if not blocks:
        return None
    lib = _codec()
    n = len(blocks)
    ins = (ctypes.c_char_p * n)(*blocks)
    lens = np.array([len(b) for b in blocks], np.int32)
    out = _POOL.get(n * max_block)
    out_lens = np.empty(n, np.int32)
    out_crcs = np.empty(n, np.uint32) if crcs else None
    lib.gkl_inflate_batch2(ctypes.cast(ins, ctypes.POINTER(ctypes.c_char_p)),
                           _ptr(lens, _I32P), n, _ptr(out), max_block,
                           _ptr(out_lens, _I32P), _ptr(out_crcs, _U32P) if crcs else None,
                           1 if nowrap else 0, threads or utils.default_host_threads())
    if np.any(out_lens < 0):
        release_blocks_buffer(out)
        return None
    return out, out_lens, max_block, out_crcs


def inflate_blocks(blocks: list[bytes], nowrap: bool = True, threads: int | None = None,
                   max_block: int = 1 << 16) -> list[bytes]:
    """Decompress many independent blocks in parallel.  When the batch
    fails, the blocks inflate one by one with growing buffers, so a block
    past ``max_block`` still decodes and a corrupt one raises."""
    res = inflate_blocks_packed(blocks, nowrap, threads, max_block)
    if res is None:
        return [raw_inflate(b, nowrap) for b in blocks]
    out, out_lens, stride, _ = res
    payloads = [out[i * stride : i * stride + out_lens[i]].tobytes()
                for i in range(len(blocks))]
    release_blocks_buffer(out)
    return payloads
