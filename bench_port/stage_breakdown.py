"""One cell's calls split by the port's stages, on the card.

    python3 bench_port/stage_breakdown.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card the cell asks for.  With the
port's METRICS counters on (``GKL_TPU_METRICS=1``), the cell's session
(``harness/session.py``: its pool, engines and warm-up) runs a window of
``--seconds`` and then a slice of further regions under ``torch.profiler``,
as ``run.py --trace 1`` does; no check runs.  Prints one JSON line: for the
window, each call's microseconds a read by the benchmark's spans and by
each of its stages, the share of each call that its stages cover, every
counter's calls and microseconds a read, and the spans entered a region;
for the slice, the card's idle seconds, every idle gap labelled by
``harness/stages.stage_gaps`` (``<call or between calls>: <innermost gkl.*
stage>: <innermost CPU operation or host>``), and the idle seconds inside
calls that no stage names.  A program without stage spans reads empty
stages and the two-part labels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import run  # noqa: E402


def slice_events(s, seconds: float) -> list:
    """The exported trace of regions run on from the window under the
    profiler for about ``seconds``, inside the benchmark's slice mark."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    from bench_port.harness import drive, trace

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    spans, s.spans = s.spans, drive.Spans(annotate=True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            with record_function(trace.SLICE):
                drive.closed_loop(s.call, s.reads_of, s.next, seconds, min_regions=1)
                s._sync()
    finally:
        s.spans = spans
    with tempfile.TemporaryDirectory(prefix="stage_breakdown_") as tmp:
        path = os.path.join(tmp, "slice.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    return events.get("traceEvents", []) if isinstance(events, dict) else events


def breakdown(loop, spans, counters, events) -> dict:
    from bench_port.harness import stages

    done = loop.completed()
    last = max(d.t1 for d in done)
    reads = sum(d.reads for d in done)
    window = [s for s in spans if loop.t_start <= s.t0 and s.t1 <= last]
    out = {"regions": len(done), "reads": reads, "calls": {}}
    for call, names in stages.CALL_STAGES.items():
        call_s = sum(s.t1 - s.t0 for s in window if s.name == call)
        stage_s = {n: counters[n]["seconds"] for n in names if n in counters}
        out["calls"][call] = {
            "call_us_per_read": call_s * 1e6 / reads,
            "stages_us_per_read": {n: v * 1e6 / reads for n, v in stage_s.items()},
            "covered_pct": 100.0 * sum(stage_s.values()) / call_s if call_s else None}
    out["counters"] = {k: {"calls": v["calls"], "us_per_read": v["seconds"] * 1e6 / reads}
                       for k, v in sorted(counters.items())}
    # every counter but the launch counts and the three whole calls is a span
    entered = sum(v["calls"] for k, v in counters.items() if not k.startswith("launch.")
                  and k not in ("pairhmm", "smithwaterman", "pdhmm"))
    out["spans_per_region"] = entered / len(done)
    gaps = stages.stage_gaps(events)
    out["idle_s"] = sum(gaps.values())
    out["gaps"] = dict(sorted(gaps.items(), key=lambda kv: -kv[1]))
    out["unnamed"] = stages.unnamed_share(gaps)
    return out


def measure(cell, seed: int, seconds: float, device) -> dict:
    """The breakdown of one window and one slice of ``cell`` at ``seed``."""
    from bench_port.harness import session as session_mod
    from gkl_tpu_torch import profiling

    os.environ["GKL_TPU_METRICS"] = "1"
    session_mod.pin_threads(cell.config)
    session_mod.build_port(device)
    s = session_mod.Session(cell, seed, device)
    try:
        s.warm_up()
        counters: dict = {}
        profiling.METRICS.reset()

        def on_done(d, t_end):
            # the counters of the regions that the window counts
            if d.t1 <= t_end:
                counters.clear()
                counters.update(profiling.METRICS.snapshot())

        loop = s.window(seconds, on_done)
        if loop.error is not None or not loop.completed():
            raise RuntimeError(f"the window failed:\n{loop.error}")
        events = slice_events(s, cell.mix["trace_slice_seconds"])
        window_spans = list(s.spans.items)
    finally:
        s.close()
    return breakdown(loop, window_spans, counters, events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.pin_environment()
    import torch

    from bench_port.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"error: {args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(measure(cell, args.seed, args.seconds, "cuda:0")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
