"""Smith-Waterman public API — counterpart of ``gkl_tpu/api_sw.py``.

Parity with IntelSmithWaterman (``smithwaterman/IntelSmithWaterman.java:44-191``):
``align`` validates like the Java layer (null/empty, MAX_SW_SEQUENCE_LENGTH
= 32767, MAXIMUM_SW_MATCH_VALUE = 65536) and returns (cigar, offset).  The
O(n*m) score and backtrack DP runs lane-batched on ``SmithWaterman.device``
(the CUDA kernel ``csrc/sw_forward.cu``; its plain twin when the caller asks
for ``device="cpu"``), or on each lane slab of a ``mesh``, and so do the
O(n+m) maximum selection and CIGAR walk (``csrc/sw_walk.cu``, or its twin),
which read the backtrack where the DP left it: only each lane's merged runs
and offset come to the host, where one native call a slab writes the CIGAR
strings (``native/sw_cigar.cc``, the port's own).  Pairs whose backtrack
exceeds the device budget even at the minimum lane padding go to the
threaded scalar aligner of the native runtime
``gkl_tpu_torch/native/sw_runtime.cc``, a byte-identical copy of the JAX
package's ``gkl_tpu/native/sw_runtime.cc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import time
from typing import Sequence

import numpy as np
import torch

from . import batch as batch_mod
from . import native_lib, profiling, utils
from .api import _as_u8
from .ops import sw as sw_ops
from .ops import sw_cuda
from .parallel import mesh as mesh_mod

MAX_SW_SEQUENCE_LENGTH = 32 * 1024 - 1
MAXIMUM_SW_MATCH_VALUE = 64 * 1024
# shape-bucket cap per align_batch call: heterogeneous batches merge down to
# this many (N, M) launches (merge_shape_groups)
SW_MAX_SHAPE_GROUPS = 4
# backtrack bytes per launch: lanes * N/2 * M.  Groups above it split into
# lane chunks; a pair above it at the minimum lane padding goes to the
# threaded scalar aligner
SW_BT_BUDGET = 1 << 30
# run rows of every lane in the first copy of a walk's output to the host; a
# chunk with a longer CIGAR copies again, up to its longest
SW_RUNS_FIRST_COPY = 8
# host memory of the scalar pool: each worker holds one n*m-byte backtrack
# vector, so concurrency clamps to BUDGET / max(n*m)
SW_SCALAR_POOL_BUDGET = 2 << 30


class OverhangStrategy(enum.IntEnum):
    SOFTCLIP = 9
    INDEL = 10
    LEADING_INDEL = 11
    IGNORE = 12


@dataclasses.dataclass
class SWParameters:
    match_value: int
    mismatch_penalty: int
    gap_open_penalty: int
    gap_extend_penalty: int


@dataclasses.dataclass
class SWAlignerResult:
    cigar: str
    alignment_offset: int


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _runtime() -> ctypes.CDLL:
    lib = native_lib.load("gkl_sw_runtime")
    if not hasattr(lib, "_sw_ready"):
        c_int = ctypes.c_int
        lib.sw_postprocess_packed.restype = c_int
        lib.sw_postprocess_packed.argtypes = [
            _U8P, c_int, c_int, ctypes.c_long, _I32P, _I32P,
            c_int, ctypes.c_char_p, c_int, _I32P, _I32P,
        ]
        # plain addresses: a chunk's call costs microseconds, not per-pointer casts
        lib.sw_format_runs.restype = ctypes.c_long
        lib.sw_format_runs.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                       ctypes.c_void_p, c_int, ctypes.c_void_p, ctypes.c_long]
        lib.sw_align_scalar_batch.restype = None
        lib.sw_align_scalar_batch.argtypes = [
            _U8P, _I64P, _I32P, _U8P, _I64P, _I32P,
            c_int, c_int, c_int, c_int, c_int, c_int,
            ctypes.c_char_p, ctypes.c_int64, _I32P, _I32P, c_int,
        ]
        lib._sw_ready = True
    return lib


def merge_shape_groups(groups: dict, max_groups: int = SW_MAX_SHAPE_GROUPS):
    """Merge (N, M) shape buckets down to ``max_groups`` launches.

    Each launch costs a dispatch, a synchronise and a copy; merging two
    buckets costs only padded cells.  Greedy: always merge the adjacent
    pair whose padded-cell increase is smallest.  A merged key
    ``(max N, max M)`` can pass its neighbours, so the list is sorted again
    after each merge and equal keys joined, which keeps the "adjacent"
    pairs of the next step the nearest shapes.  Returns the sorted
    ``[((N, M), idxs), ...]``; per-lane lengths keep results exact under
    any padding."""
    def coalesce(items):
        out = []
        for key, idxs in sorted(items, key=lambda kv: kv[0]):
            if out and out[-1][0] == key:
                out[-1] = (key, out[-1][1] + idxs)
            else:
                out.append((key, list(idxs)))
        return out

    items = coalesce(groups.items())
    while len(items) > max_groups:
        best_i, best_extra = 0, None
        for i in range(len(items) - 1):
            (n1, m1), i1 = items[i]
            (n2, m2), i2 = items[i + 1]
            extra = (max(n1, n2) * max(m1, m2) * (len(i1) + len(i2))
                     - n1 * m1 * len(i1) - n2 * m2 * len(i2))
            if best_extra is None or extra < best_extra:
                best_i, best_extra = i, extra
        (n1, m1), i1 = items[best_i]
        (n2, m2), i2 = items[best_i + 1]
        items[best_i:best_i + 2] = [((max(n1, n2), max(m1, m2)), i1 + i2)]
        items = coalesce(items)
    return items


def sw_align_scalar_batch(refs, alts, p: SWParameters, strategy,
                          threads: int | None = None) -> list[SWAlignerResult]:
    """Pairs through the native runtime's threaded scalar aligner (the
    reference's OpenMP-over-pairs analogue), full 32767 range."""
    n = len(refs)
    if n == 0:
        return []
    lib = _runtime()
    pool = threads or utils.default_host_threads()
    # each worker holds an n*m-byte backtrack vector: clamp concurrency so
    # peak host memory stays bounded
    max_pair_bytes = max(len(r) * len(a) for r, a in zip(refs, alts))
    pool = max(1, min(pool, SW_SCALAR_POOL_BUDGET // max(1, max_pair_bytes)))
    ref_buf = np.concatenate([np.ascontiguousarray(r, np.uint8) for r in refs])
    alt_buf = np.concatenate([np.ascontiguousarray(a, np.uint8) for a in alts])
    ref_len = np.array([len(r) for r in refs], np.int32)
    alt_len = np.array([len(a) for a in alts], np.int32)
    ref_off = np.zeros(n, np.int64)
    alt_off = np.zeros(n, np.int64)
    np.cumsum(ref_len[:-1], out=ref_off[1:])
    np.cumsum(alt_len[:-1], out=alt_off[1:])
    stride = int(2 * (ref_len.max() + alt_len.max()) + 16)  # worst-case CIGAR
    cigars = ctypes.create_string_buffer(n * stride)
    offsets = np.zeros(n, np.int32)
    scores = np.zeros(n, np.int32)
    lib.sw_align_scalar_batch(
        ref_buf.ctypes.data_as(_U8P), ref_off.ctypes.data_as(_I64P),
        ref_len.ctypes.data_as(_I32P),
        alt_buf.ctypes.data_as(_U8P), alt_off.ctypes.data_as(_I64P),
        alt_len.ctypes.data_as(_I32P),
        n, int(p.match_value), int(p.mismatch_penalty), int(p.gap_open_penalty),
        int(p.gap_extend_penalty), int(strategy),
        cigars, stride, offsets.ctypes.data_as(_I32P), scores.ctypes.data_as(_I32P),
        min(n, pool),
    )
    base = ctypes.addressof(cigars)
    return [SWAlignerResult(ctypes.string_at(base + k * stride).decode("ascii"),
                            int(offsets[k])) for k in range(n)]


def format_cigars(runs: np.ndarray, counts: np.ndarray) -> list[str]:
    """CIGAR strings of walked lanes, in one native call
    (``native/sw_cigar.cc``): ``runs`` (rows, lanes) int32, a view with
    unit lane stride, holds lane ``c``'s merged runs in CIGAR order in
    ``runs[:counts[c], c]`` as ``count << 4 | op`` (``ops.sw.sw_walk``'s
    rows)."""
    lanes = len(counts)
    if lanes == 0:
        return []
    counts = np.ascontiguousarray(counts, np.int32)
    if runs.dtype != np.int32 or runs.strides[1] != 4 or runs.shape[1] < lanes:
        raise ValueError("runs must be an int32 (rows, lanes) view with unit lane stride")
    cap = 12 * int(counts.sum()) + lanes + 1  # a run: <= 10 digits and its letter
    buf = ctypes.create_string_buffer(cap)
    n = _runtime().sw_format_runs(runs.ctypes.data, runs.strides[0] // 4, runs.shape[0],
                                  counts.ctypes.data, lanes, ctypes.addressof(buf), cap)
    if n < lanes:
        raise RuntimeError(f"sw_format_runs failed ({n}): a lane counts more runs than "
                           f"the rows hold, or the buffer was too small")
    return ctypes.string_at(buf, n - 1).decode("ascii").split("\0")


class SmithWaterman:
    """Smith-Waterman aligner (IntelSmithWaterman).

    ``device`` runs the DP: CUDA by default, the plain twin for
    ``device="cpu"``.  ``lane_multiple``: each launch's lanes pad to a
    multiple of it, and the backtrack budget counts lanes in its units;
    None means ``batch.LANE_MULTIPLE * mesh.size`` (8 without a mesh), and a
    value below 1 or one that does not split evenly over the mesh raises
    ``ValueError``.  ``mesh``: an optional ``parallel.Mesh``; the DP and
    the walk then shard lane-wise over it, each slab on its entry's device.
    ``threads`` caps the native
    scalar-aligner pool (default: ``GKL_TPU_THREADS`` or all cores, at most
    16)."""

    def __init__(self, *, lane_multiple: int | None = None,
                 device: str | torch.device = "cuda", threads: int | None = None,
                 mesh: mesh_mod.Mesh | None = None):
        if threads is not None and threads < 1:
            raise ValueError("threads must be >= 1")
        self._lane_multiple = batch_mod.resolve_lane_multiple(lane_multiple,
                                                              mesh.size if mesh else 1)
        self.device = torch.device(device)
        self.mesh = mesh
        self._threads = threads
        self._native = _runtime()

    def close(self) -> None:
        pass

    @staticmethod
    def _device_eligible(rlen: int, alen: int,
                         lane_multiple: int = batch_mod.LANE_MULTIPLE) -> bool:
        """On the device when the pair's backtrack at the minimum lane
        padding (``lane_multiple`` lanes) fits SW_BT_BUDGET (the analogue
        of the reference's on-demand matrix growth, PairWiseSW.h:454-501)."""
        N = batch_mod.bucket_length(rlen)
        M = batch_mod.bucket_length(alen)
        return lane_multiple * (N // 2) * M <= SW_BT_BUDGET

    def align(self, ref, alt, parameters: SWParameters, strategy) -> SWAlignerResult:
        return self.align_batch([ref], [alt], parameters, strategy)[0]

    def align_batch(self, refs: Sequence, alts: Sequence, parameters: SWParameters,
                    strategy) -> list[SWAlignerResult]:
        on = profiling.metrics_enabled()
        with profiling.span("sw_pack", on):
            if parameters is None:
                raise TypeError("Parameter structure is null.")
            if strategy is None:
                raise TypeError("OverhangStrategy is null.")
            strategy = OverhangStrategy(strategy)
            if any(x is None for x in refs) or any(x is None for x in alts):
                raise TypeError("Sequence is null.")
            refs = [_as_u8(r) for r in refs]
            alts = [_as_u8(a) for a in alts]
            for r, a in zip(refs, alts):
                if len(r) <= 0 or len(a) <= 0:
                    raise ValueError("Cannot align empty sequences")
                if len(r) > MAX_SW_SEQUENCE_LENGTH or len(a) > MAX_SW_SEQUENCE_LENGTH:
                    raise ValueError(
                        f"Sequences exceed maximum length of {MAX_SW_SEQUENCE_LENGTH} bytes")
            if parameters.match_value > MAXIMUM_SW_MATCH_VALUE:
                raise ValueError(
                    f"Match value parameter exceeds maximum value of {MAXIMUM_SW_MATCH_VALUE}")

            t0 = time.perf_counter()  # the ``smithwaterman`` counter's start
            out: list[SWAlignerResult | None] = [None] * len(refs)
            groups: dict[tuple[int, int], list[int]] = {}
            scalar_idx = []
            for k in range(len(refs)):
                if self._device_eligible(len(refs[k]), len(alts[k]), self._lane_multiple):
                    key = (batch_mod.bucket_length(len(refs[k])),
                           batch_mod.bucket_length(len(alts[k])))
                    groups.setdefault(key, []).append(k)
                else:
                    scalar_idx.append(k)
            merged = merge_shape_groups(groups)

        lm = self._lane_multiple
        for (N, M), idxs in merged:
            # lane chunks within the backtrack budget, in lane-padding units;
            # a lane's walked runs count against it too
            lane_bytes = (N // 2) * M + 4 * (2 + sw_ops.walk_capacity(N, M))
            max_lanes = max(lm, (SW_BT_BUDGET // lane_bytes) // lm * lm)
            for s0 in range(0, len(idxs), max_lanes):
                chunk = idxs[s0:s0 + max_lanes]
                for k, res in zip(chunk, self._align_device(
                        N, M, [refs[k] for k in chunk], [alts[k] for k in chunk],
                        parameters, strategy, on)):
                    out[k] = res

        if scalar_idx:
            with profiling.span("sw_scalar", on, items=len(scalar_idx)):
                for k, res in zip(scalar_idx, sw_align_scalar_batch(
                        [refs[k] for k in scalar_idx], [alts[k] for k in scalar_idx],
                        parameters, strategy, self._threads)):
                    out[k] = res

        if on:
            profiling.METRICS.record(
                "smithwaterman", items=len(refs),
                cells=sum(len(r) * len(a) for r, a in zip(refs, alts)),
                seconds=time.perf_counter() - t0)
        return out  # type: ignore[return-value]

    def _align_device(self, N, M, refs, alts, p: SWParameters, strategy, on: bool):
        """One lane chunk: pack it, then run the DP and the walk on the
        device and bring each lane's runs, count and offset to the host
        (``_align_walked``)."""
        with profiling.span("sw_pack", on, items=len(refs)):
            P = batch_mod.bucket_lanes(len(refs), self._lane_multiple)
            ref_a = np.zeros((N, P), np.uint8)
            alt_a = np.ones((M, P), np.uint8)  # pad bases never match the ref's 0
            reflen = np.ones(P, np.int32)
            altlen = np.ones(P, np.int32)
            for c, (r, a) in enumerate(zip(refs, alts)):
                ref_a[:len(r), c] = r
                alt_a[:len(a), c] = a
                reflen[c] = len(r)
                altlen[c] = len(a)
            indel = strategy in (OverhangStrategy.INDEL, OverhangStrategy.LEADING_INDEL)
        return self._align_walked(ref_a, alt_a, reflen, altlen, p, indel, strategy,
                                  len(refs), on)

    def _align_walked(self, ref_a, alt_a, reflen, altlen, p: SWParameters, indel: bool,
                      strategy, n_lanes: int, on: bool) -> list[SWAlignerResult]:
        """The DP and the walk on each of this process's lane slabs, one
        launch each on the slab's device (``device`` without a mesh); the
        backtrack stays there, and the runs of the first ``n_lanes`` lanes
        come to the host.  Each slab fetches only its runs' first rows
        rather than going through ``launch_lanes``, which copies whole
        outputs.  On a multi-process mesh every process's results are
        gathered in rank (= lane) order."""
        mesh = mesh_mod.engine_mesh(self.mesh, self.device)
        local = mesh.local_entries()
        cuts = mesh_mod.lane_slices(ref_a.shape[1], mesh.size)
        walks = []
        with profiling.span("sw_dispatch", on, items=n_lanes):
            for k, dev in local:
                sl = cuts[k]
                args = [torch.from_numpy(np.ascontiguousarray(x[..., sl])).to(dev)
                        for x in (ref_a, alt_a, reflen, altlen)]
                bt, lastrow, lastcol = sw_cuda.sw_forward(
                    *args, p.match_value, p.mismatch_penalty, p.gap_open_penalty,
                    p.gap_extend_penalty, indel_boundary=indel)
                walk = sw_cuda.sw_walk(bt, lastrow, lastcol, args[2], args[3], strategy)
                walks.append((max(0, min(n_lanes, sl.stop) - sl.start), walk))
        if on:
            profiling.METRICS.record("sw_card_walk", items=n_lanes)
        with profiling.span("sw_wait", on, items=n_lanes):
            for dev in {dev for _, dev in local if dev.type == "cuda"}:
                torch.cuda.current_stream(dev).synchronize()
        with profiling.span("sw_bt_copy", on) as copy:
            hosts = []
            for n, walk in walks:
                rows = min(2 + SW_RUNS_FIRST_COPY, walk.shape[0])
                host = walk[:rows].cpu().numpy()
                longest = int(host[0, :n].max(initial=0))
                if 2 + longest > rows:
                    host = walk[:2 + longest].cpu().numpy()
                hosts.append((n, host))
            copy.items = sum(host.nbytes for _, host in hosts)
        with profiling.span("sw_host_walk", on, items=n_lanes):
            res = []
            for n, host in hosts:
                cigars = format_cigars(host[2:, :n], host[0, :n])
                res += map(SWAlignerResult, cigars, host[1, :n].tolist())
            if mesh_mod.is_multiprocess(mesh):
                parts = [None] * mesh_mod.process_count()
                torch.distributed.all_gather_object(parts, res)
                res = [r for part in parts for r in part]
        return res

    def _postprocess(self, bt_packed, n, m, lastrow, lastcol, strategy) -> SWAlignerResult:
        """Maximum selection and CIGAR walk of one lane on the native
        runtime; ``bt_packed`` is its (N//2, M) row-pair packed backtrack.
        No path of the API calls it: it is the native reference that the
        walk's tests hold the kernel and its twin to."""
        cap = 2 * (n + m) + 16  # worst case: 2 chars per length-1 run
        buf = ctypes.create_string_buffer(cap)
        offset = ctypes.c_int32()
        score = ctypes.c_int32()
        self._native.sw_postprocess_packed(
            bt_packed.ctypes.data_as(_U8P), n, m, bt_packed.shape[1],
            lastrow.ctypes.data_as(_I32P), lastcol.ctypes.data_as(_I32P),
            int(strategy), buf, cap, ctypes.byref(offset), ctypes.byref(score))
        return SWAlignerResult(buf.value.decode("ascii"), int(offset.value))
