"""The port's stages below each call: readers of their counters and of the
launch counts, and a profiled slice's idle gaps labelled by the stage.

The port (``gkl_tpu_torch.profiling.span``, ``GKL_TPU_METRICS=1``) records
each stage of a call into its ``METRICS`` counters under the stage's name,
counts every kernel launch as ``launch.<kernel>``, and while a profiler
runs marks each stage in the trace as a ``user_annotation`` named
``gkl.<stage>``, on the clock of the card's events.  A program without
stage spans gives the readers here nothing to read: they return None."""

from __future__ import annotations

import collections

from . import drive, trace

MARK = "gkl."
# each call's stages that no other stage of it holds
CALL_STAGES = {
    "pairhmm": ("pairhmm_pack", "pairhmm_dispatch", "pairhmm_wait", "pairhmm_finalize"),
    "sw": ("sw_pack", "sw_dispatch", "sw_wait", "sw_bt_copy", "sw_host_walk", "sw_scalar"),
    "pdhmm": ("pdhmm_plan", "pdhmm_pack", "pdhmm_wait", "pdhmm_finalize"),
}
# a program that records these also counts its launches
_STAGED = ("pairhmm_pack", "sw_pack", "pdhmm_plan")


def stage_us_per_read(run, *counters: str):
    """Microseconds a read spent in the port's ``counters``, summed; None
    where none of them is in the run's counters."""
    if not run.counters or not run.reads:
        return None
    found = [run.counters[c]["seconds"] for c in counters if c in run.counters]
    return sum(found) * 1e6 / run.reads if found else None


def launches_per_kread(run):
    """Kernel launches per 1,000 reads, over every ``launch.*`` count; None
    where the program records no stages (and so counts no launches)."""
    if not run.counters or not run.reads or not any(c in run.counters for c in _STAGED):
        return None
    launches = sum(v["calls"] for k, v in run.counters.items() if k.startswith("launch."))
    return launches * 1e3 / run.reads


def stage_gaps(events) -> dict:
    """The card's idle gaps in the slice, summed by what the caller's
    thread was doing at their middle: ``<call or between calls>:
    <innermost gkl.* stage>: <innermost CPU operation or host>``, or, in
    no stage, the two-part label of ``trace.summarize``.  The gaps are
    those of ``trace.summarize``, every label kept; ``trace.summarize``
    itself labels by the call and the operation only."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    marks = [e for e in xs if e.get("cat") == "user_annotation"]
    slices = [e for e in marks if e.get("name") == trace.SLICE]
    if not slices:
        return {}
    s0 = float(slices[0]["ts"])
    s1 = s0 + float(slices[0]["dur"])
    tid = slices[0].get("tid")
    busy = trace._union([[max(s0, e["ts"]), min(s1, e["ts"] + e["dur"])] for e in xs
                         if e.get("cat") in trace.DEVICE_CATS
                         and e["ts"] < s1 and e["ts"] + e["dur"] > s0])
    calls = trace._Nested([e for e in marks if e.get("name") in drive.CALLS])
    stages = trace._Nested([e for e in marks if e.get("tid") == tid
                            and e.get("name", "").startswith(MARK)])
    ops = trace._Nested([e for e in xs if e.get("cat") == "cpu_op" and e.get("tid") == tid])
    gaps: dict = collections.defaultdict(float)
    edges = [s0] + [t for ab in busy for t in ab] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        call, stage, op = calls.at(mid), stages.at(mid), ops.at(mid)
        parts = [call["name"] if call else "between calls"]
        parts += [stage["name"]] if stage else []
        parts += [op["name"] if op else "host"]
        gaps[": ".join(parts)] += (b - a) * 1e-6
    return dict(gaps)


def unnamed_share(gaps: dict) -> dict:
    """Of the idle seconds inside call spans, those in no stage: labelled
    ``<call>: host``."""
    inside = {k: v for k, v in gaps.items() if k.split(": ")[0] in drive.CALLS}
    unnamed = {k: v for k, v in inside.items() if k.split(": ")[1:] == ["host"]}
    total = sum(inside.values())
    return {"idle_in_calls_s": total, "unnamed_s": sum(unnamed.values()),
            "unnamed_pct": 100.0 * sum(unnamed.values()) / total if total else None,
            "unnamed": unnamed}
