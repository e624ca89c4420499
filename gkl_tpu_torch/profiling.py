"""Observability: per-kernel metrics, traces and CSV profiles — counterpart
of ``gkl_tpu/profiling.py``.

* :class:`KernelMetrics` — process-wide counters (calls, items, cells,
  bytes in, wall seconds) per kernel, queryable and printable as a table,
  and every CUDA kernel launch counted by kernel;
* :func:`span` — one stage of a public call, timed into :data:`METRICS`
  and, while a ``torch.profiler`` runs, marked in its trace;
* :func:`trace` — a context manager around ``torch.profiler`` that writes
  a TensorBoard trace of the enclosed region;
* :func:`profile_csv` — the DeflaterProfile.java:27-98 equivalent: per-level
  compression time and size of a corpus, as CSV.

The public APIs record into :data:`METRICS` when ``GKL_TPU_METRICS=1``
(off by default: a counter update per call is noise for small batches).
Whole calls: ``pairhmm``, ``smithwaterman`` and ``pdhmm`` (items = pairs
or alignments).  Their stages, each a :func:`span`:

* PairHMM: ``pairhmm_pack`` (validation, length grouping, packing, the
  in-flight budget), ``pairhmm_dispatch`` (uploads, launch, the enqueued
  copy back), ``pairhmm_wait``, ``pairhmm_finalize`` (log10, the rescue
  choice, the scatter) with ``pairhmm_rescue`` inside it (items = lanes
  recomputed on the f64 oracle);
* SW: ``sw_pack`` (validation, the shape merge, each lane chunk's
  packing), ``sw_dispatch`` (upload, the DP launch and the walk's),
  ``sw_wait``, ``sw_bt_copy`` (items = bytes brought to the host: the
  walked runs, counts and offsets; on a mesh the backtrack slabs),
  ``sw_host_walk`` (items = lanes written out as CIGAR strings; on a mesh
  walked on the host), ``sw_scalar`` (items = pairs on the host's scalar
  aligner); and a counter, no span: ``sw_card_walk``, the lanes the
  device walked where the DP left the backtrack;
* PDHMM: ``pdhmm_plan`` (the cross product as indices into the unique
  planes, the lane order, the slices), ``pdhmm_pack`` (a slice's unique
  planes and packing), ``pdhmm_wait`` (upload, kernel and the copy back),
  ``pdhmm_finalize`` (log10, the validity check, the un-permute) with
  ``pdhmm_rescue`` inside it (items = lanes below MIN_ACCEPTED; their
  packing, upload, f64 launch, wait and log); and two counters, no span:
  ``pdhmm_unique``, a slice's unique read planes plus unique haplotype
  planes packed (its ``pdhmm_pack`` items are the slice's lanes), and
  ``pdhmm_card_rescue``, the lanes the kernel's f64 instance recomputed
  (its plain twin on the CPU), where the double-precision mode and
  ``KernelLevel.SCALAR`` record nothing;
* the streaming pipelines: ``pipeline_wait`` and ``pipeline_dispatch`` on
  the caller's thread, ``pipeline_inflate`` and ``pipeline_decode`` on
  the producer's.

Launches are counted whatever the switch, as ``launch.<kernel>`` (calls =
launches) in :meth:`KernelMetrics.snapshot`: ``pairhmm_scaled``,
``pairhmm_rows``, ``pairhmm_cols``, ``sw_forward``, ``sw_walk``,
``pdhmm`` and ``pdhmm_f64``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import torch


@dataclasses.dataclass
class _Counter:
    calls: int = 0
    items: int = 0  # pairs / blocks
    cells: int = 0  # DP cells (0 for codecs)
    bytes_in: int = 0
    seconds: float = 0.0


class KernelMetrics:
    """Thread-safe metric registry, keyed by kernel name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, _Counter] = {}
        self._launches: dict[str, int] = {}

    def record(self, kernel: str, *, items: int = 0, cells: int = 0,
               bytes_in: int = 0, seconds: float = 0.0) -> None:
        with self._lock:
            c = self._counters.setdefault(kernel, _Counter())
            c.calls += 1
            c.items += items
            c.cells += cells
            c.bytes_in += bytes_in
            c.seconds += seconds

    @contextlib.contextmanager
    def timed(self, kernel: str, *, items: int = 0, cells: int = 0, bytes_in: int = 0):
        """Record one call of ``kernel`` with the enclosed block's wall
        seconds (host clock: a block that only enqueues card work must end
        in a synchronise to time it)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(kernel, items=items, cells=cells, bytes_in=bytes_in,
                        seconds=time.perf_counter() - t0)

    def launch(self, kernel: str) -> None:
        """Count one launch of the CUDA kernel ``kernel``."""
        with self._lock:
            self._launches[kernel] = self._launches.get(kernel, 0) + 1

    def launches(self, kernel: str) -> int:
        with self._lock:
            return self._launches.get(kernel, 0)

    def snapshot(self) -> dict[str, dict]:
        """Every counter, and each kernel's launches as ``launch.<kernel>``
        with ``calls`` = launches."""
        with self._lock:
            counters = dict(self._counters)
            counters.update((f"launch.{k}", _Counter(calls=n))
                            for k, n in self._launches.items() if n)
            return {
                k: {
                    "calls": c.calls,
                    "items": c.items,
                    "cells": c.cells,
                    "bytes_in": c.bytes_in,
                    "seconds": c.seconds,
                    "cells_per_sec": c.cells / c.seconds if c.seconds else 0.0,
                    "bytes_per_sec": c.bytes_in / c.seconds if c.seconds else 0.0,
                }
                for k, c in counters.items()
            }

    def reset(self) -> None:
        """Clear every counter, the launch counts included."""
        with self._lock:
            self._counters.clear()
            self._launches.clear()

    def report(self) -> str:
        """The counters as a table, one row per kernel in name order."""
        rows = [f"{'kernel':<20} {'calls':>8} {'items':>10} {'Gcells':>10} {'MB':>10} "
                f"{'sec':>9} {'Gcells/s':>9}"]
        for k, v in sorted(self.snapshot().items()):
            rows.append(
                f"{k:<20} {v['calls']:>8} {v['items']:>10} {v['cells']/1e9:>10.3f} "
                f"{v['bytes_in']/1e6:>10.2f} {v['seconds']:>9.3f} {v['cells_per_sec']/1e9:>9.2f}"
            )
        return "\n".join(rows)


METRICS = KernelMetrics()


def metrics_enabled() -> bool:
    return os.environ.get("GKL_TPU_METRICS") == "1"


class _Span:
    """One entered stage: its counter's record on exit, and the profiler's
    mark while a profiler runs.  ``items`` and ``cells`` may be set inside
    the block, once they are known."""

    __slots__ = ("name", "items", "cells", "t0", "mark")

    def __init__(self, name: str, items: int, cells: int):
        self.name, self.items, self.cells = name, items, cells
        self.mark = None

    def __enter__(self):
        if torch.autograd.profiler._is_profiler_enabled:
            self.mark = torch.profiler.record_function("gkl." + self.name)
            self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        METRICS.record(self.name, items=self.items, cells=self.cells,
                       seconds=time.perf_counter() - self.t0)
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


class _Off:
    """The stage of a call made with the switch off: records nothing, and
    nothing reads what a block sets on it."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, on: bool, items: int = 0, cells: int = 0):
    """A context manager around one stage of a call.  ``on`` is the
    public call's :func:`metrics_enabled`, read once per call; off, the
    stage costs this branch.  On, the stage's host-clock seconds and
    ``items``/``cells`` go to :data:`METRICS` under ``name``, and while a
    ``torch.profiler`` runs it is also a ``record_function`` named
    ``gkl.<name>``, a ``user_annotation`` on the profiler's clock whose
    parent is the span that encloses it on the same thread.  ``name`` is
    a fixed string: no ids or shapes.  A span covers a whole stage of a
    call, a lane chunk or a group, never one lane or read."""
    return _Span(name, items, cells) if on else _OFF


def launch_counts(module: str, **names: str):
    """A module ``__getattr__`` for ``module`` under which each ``names``
    key reads the launch count of the kernel it names (``LAUNCHES`` of
    ``ops.sw_cuda`` is ``METRICS.launches("sw_forward")``), so that the
    modules' old counters stay readable; :meth:`KernelMetrics.reset`
    clears them."""
    def __getattr__(attr: str):
        if attr in names:
            return METRICS.launches(names[attr])
        raise AttributeError(f"module {module!r} has no attribute {attr!r}")
    return __getattr__


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (the counterpart of ``jax.profiler.start_trace``): host
    activity, and the card's kernels and copies when PyTorch sees a card.
    The trace is written when the region ends, as a ``*.pt.trace.json``
    that TensorBoard's profiler plugin (and chrome://tracing) reads."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def profile_csv(data: bytes, levels=range(0, 10), nowrap: bool = True) -> str:
    """Per-level DEFLATE time and size profile (DeflaterProfile.java:27-98)
    on the host codec.  Returns CSV text: level, ms, compressed size,
    ratio."""
    from . import compression

    lines = ["level,ms,size,ratio"]
    for level in levels:
        t0 = time.perf_counter()
        out = compression.raw_deflate(data, level, nowrap)
        ms = (time.perf_counter() - t0) * 1e3
        lines.append(f"{level},{ms:.2f},{len(out)},{len(out)/max(1,len(data)):.4f}")
    return "\n".join(lines)
