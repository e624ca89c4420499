"""Per-kernel counters — counterpart of ``gkl_tpu/profiling.py`` (counters only).

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

import dataclasses
import os
import threading


@dataclasses.dataclass
class _Counter:
    calls: int = 0
    items: int = 0  # pairs / blocks
    cells: int = 0  # DP cells
    seconds: float = 0.0


class KernelMetrics:
    """Thread-safe metric registry, keyed by kernel name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, _Counter] = {}

    def record(self, kernel: str, *, items: int = 0, cells: int = 0,
               seconds: float = 0.0) -> None:
        with self._lock:
            c = self._counters.setdefault(kernel, _Counter())
            c.calls += 1
            c.items += items
            c.cells += cells
            c.seconds += seconds

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                k: {
                    "calls": c.calls,
                    "items": c.items,
                    "cells": c.cells,
                    "seconds": c.seconds,
                    "cells_per_sec": c.cells / c.seconds if c.seconds else 0.0,
                }
                for k, c in self._counters.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


METRICS = KernelMetrics()


def metrics_enabled() -> bool:
    return os.environ.get("GKL_TPU_METRICS") == "1"
