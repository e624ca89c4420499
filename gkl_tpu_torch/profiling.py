"""Observability: per-kernel metrics, traces and CSV profiles — counterpart
of ``gkl_tpu/profiling.py``.

* :class:`KernelMetrics` — process-wide counters (calls, items, cells,
  bytes in, wall seconds) per kernel, queryable and printable as a table;
* :func:`trace` — a context manager around ``torch.profiler`` that writes
  a TensorBoard trace of the enclosed region;
* :func:`profile_csv` — the DeflaterProfile.java:27-98 equivalent: per-level
  compression time and size of a corpus, as CSV.

The public APIs record into :data:`METRICS` when ``GKL_TPU_METRICS=1``
(off by default: a counter update per call is noise for small batches).
Counters: ``pairhmm``, ``pairhmm_rescue``, ``smithwaterman``,
``sw_bt_copy`` (items = backtrack bytes brought to the host),
``sw_host_walk`` (items = lanes walked), ``pdhmm``, ``pdhmm_rescue``
(items = lanes recomputed on the f64 oracle), and the pipeline stages
``pipeline_wait``, ``pipeline_dispatch``, ``pipeline_resolve``,
``pipeline_sw`` and ``pipeline_pdhmm``.
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

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
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
                for k, c in self._counters.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()

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
