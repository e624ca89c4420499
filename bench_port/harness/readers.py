"""What a per-layer metric's reader (``layer_metrics/<name>.py``) reads.

``Run`` holds the measured window's spans (the benchmark's host-clock
spans around every call into the port), the port's ``profiling.METRICS``
counters over the same regions (``GKL_TPU_METRICS=1`` in a traced run),
the reads of those regions, and the profiled slice's trace summary.  Each
helper returns None where the run holds nothing to read."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Run:
    reads: int
    spans: list
    counters: dict
    trace: object | None


def span_us_per_read(run: Run, call: str):
    """Microseconds a read spent inside spans of ``call``."""
    spans = [s for s in run.spans if s.name == call]
    if not spans or not run.reads:
        return None
    return sum(s.t1 - s.t0 for s in spans) * 1e6 / run.reads


def counter_us_per_read(run: Run, counter: str):
    """Microseconds a read spent in the port's ``counter`` (0 where the
    counters were on and it never fired)."""
    if not run.counters or not run.reads:
        return None
    return run.counters.get(counter, {}).get("seconds", 0.0) * 1e6 / run.reads


def roofline_pct(run: Run, call: str):
    """The least time of ``call``'s work in the slice over the device time
    of the kernels launched inside its spans, in percent."""
    if run.trace is None or not run.trace.kernel_s.get(call):
        return None
    return 100.0 * run.trace.least_s.get(call, 0.0) / run.trace.kernel_s[call]


def idle_pct(run: Run):
    """The share of the slice in which the card ran no kernel and no copy."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
