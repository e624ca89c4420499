"""A profiled slice of the benchmark's work and what its trace says.

The slice runs under ``torch.profiler`` (CPU and CUDA activities) inside
one ``record_function`` named :data:`SLICE`, so the profiler's start, stop
and export lie outside it.  From the exported Chrome trace:

* ``window_s``: the slice's length; ``busy_s``: the union of the card's
  kernel, copy and memset intervals inside it;
* ``kernel_s[call]``: the device time of every kernel whose launch (the
  runtime or driver call with the kernel's correlation id; the kernel's
  own start where the trace holds no launch) lies inside a span of that
  call, whatever the kernel's name;
* the breakdown: the device operations that took most time, and the
  card's idle gaps summed by what the host was doing at their middle (the
  call span, and the innermost CPU operation on the caller's thread).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os

import torch

from . import drive

SLICE = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict        # call name -> device seconds of the kernels it launched
    least_s: dict         # call name -> least seconds of its work (roofline)
    device_ops: list      # [[name, seconds], ...]
    idle_gaps: list       # [[what the host was doing, seconds], ...]
    kernels: int = 0      # kernels in the trace
    by_launch: int = 0    # of them, attributed by their launch event


def profile(loop_fn, spans: drive.Spans, tmpdir: str):
    """Run ``loop_fn()`` under the profiler; returns (its result, Summary or
    None when the trace holds no slice)."""
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(SLICE):
            result = loop_fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(tmpdir, "slice.pt.trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return result, summarize(events, spans)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Nested:
    """Nested events (one thread's CPU operations, or the call spans) for
    asking which is the innermost that contains a time: of those that do,
    the one that started last."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.events]
        self.reach = []  # the latest end among events 0..k
        for e in self.events:
            self.reach.append(max(self.reach[-1] if self.reach else e["ts"], e["ts"] + e["dur"]))

    def at(self, t):
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0 and self.reach[k] >= t:
            if self.events[k]["ts"] + self.events[k]["dur"] >= t:
                return self.events[k]
            k -= 1
        return None


def summarize(events, spans: drive.Spans) -> Summary | None:
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    marks = [e for e in xs if e.get("cat") == "user_annotation"]
    slices = [e for e in marks if e.get("name") == SLICE]
    if not slices:
        return None
    s0 = float(slices[0]["ts"])
    s1 = s0 + float(slices[0]["dur"])
    tid = slices[0].get("tid")
    calls = sorted((e for e in marks if e.get("name") in drive.CALLS), key=lambda e: e["ts"])
    call_starts = [e["ts"] for e in calls]
    launches = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]

    kernel_s: dict = collections.defaultdict(float)
    kernels = by_launch = 0
    for e in device:
        if e["cat"] != "kernel":
            continue
        corr = e.get("args", {}).get("correlation")
        kernels += 1
        by_launch += corr in launches
        t = launches.get(corr, e["ts"])
        k = bisect.bisect_right(call_starts, t) - 1
        if k >= 0 and t <= calls[k]["ts"] + calls[k]["dur"]:
            kernel_s[calls[k]["name"]] += e["dur"] * 1e-6

    busy = _union([[max(s0, e["ts"]), min(s1, e["ts"] + e["dur"])] for e in device
                   if e["ts"] < s1 and e["ts"] + e["dur"] > s0])
    busy_s = sum(b - a for a, b in busy) * 1e-6

    by_op: dict = collections.defaultdict(float)
    for e in device:
        by_op[e["name"][:120]] += e["dur"] * 1e-6
    ops = _Nested([e for e in xs if e.get("cat") == "cpu_op" and e.get("tid") == tid])
    spans_at = _Nested(calls)
    gaps: dict = collections.defaultdict(float)
    edges = [s0] + [t for ab in busy for t in ab] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        call = spans_at.at(mid)
        op = ops.at(mid)
        label = f"{call['name'] if call else 'between calls'}: {op['name'] if op else 'host'}"
        gaps[label] += (b - a) * 1e-6

    least_s: dict = collections.defaultdict(float)
    for s in spans.items:
        least_s[s.name] += s.least_s

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Summary(window_s=(s1 - s0) * 1e-6, busy_s=busy_s, kernel_s=dict(kernel_s),
                   least_s=dict(least_s), device_ops=top(by_op), idle_gaps=top(gaps),
                   kernels=kernels, by_launch=by_launch)
