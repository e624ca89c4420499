"""Run one cell of the port's benchmark once and print its result.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``gkl_tpu_torch/``, on a machine
with the CUDA cards the cell asks for (``BENCHMARK.json``).  Set-up builds
or loads the port's libraries (under ``build/`` in the checkout), draws the
cell's pool of regions from the seed, builds the engines and warms them up;
then one caller drives region after region through the port for
``--seconds``.  With ``--trace 1`` the port's METRICS counters are on, a
slice of further regions runs under ``torch.profiler``, and the line
carries the per-layer metrics; otherwise the end-to-end ones.  Last, a
sample of the outputs is checked against the plain reference
(``bench_port/reference``) and each number compared is printed beside its
limit, as the last lines of standard error and under ``checks`` in the
result: the last line of standard output, one JSON object.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_DIR, "build")
# program settings that would change the path under test
PROGRAM_SETTINGS = ("GKL_TPU_LIBRARY_PATH", "GKL_TPU_RESCUE", "GKL_TPU_EXACT_RESCUE",
                    "GKL_TPU_METRICS", "GKL_TPU_THREADS")
FORBIDDEN_MODULES = {"jax", "jaxlib", "flax", "gkl_tpu"}


def pin_environment() -> None:
    """Every build and kernel cache at a fixed place inside the checkout, and
    the program at its defaults."""
    os.environ["GKL_TPU_CACHE_DIR"] = os.path.join(BUILD_DIR, "gkl_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD_DIR, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD_DIR, "triton")
    for name in PROGRAM_SETTINGS:
        os.environ.pop(name, None)
    if REPO_DIR not in sys.path:
        sys.path.insert(0, REPO_DIR)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN_MODULES)


def end_to_end(loop, t_process: float) -> dict:
    import numpy as np

    done = loop.completed()
    return {
        "reads_per_s": sum(d.reads for d in done) / (max(d.t1 for d in done) - loop.t_start),
        "region_p95_ms": float(np.percentile([(d.t1 - d.t0) * 1e3 for d in done], 95)),
        "setup_s": loop.t_start - t_process,
    }


def per_layer(cell, loop, spans, counters, summary) -> dict:
    from bench_port.harness import readers, spec

    done = loop.completed()
    last = max(d.t1 for d in done)
    run = readers.Run(reads=sum(d.reads for d in done),
                      spans=[s for s in spans if loop.t_start <= s.t0 and s.t1 <= last],
                      counters=counters, trace=summary)
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = value
    return out


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_process: float):
    """Set up, measure, check.  Returns (result dict, check lines)."""
    import torch

    from bench_port.harness import check
    from bench_port.harness import session as session_mod

    session_mod.pin_threads(cell.config)
    if traced:
        os.environ["GKL_TPU_METRICS"] = "1"
    from gkl_tpu_torch import profiling

    cuda = torch.device(device).type == "cuda"
    phases = {"start": time.perf_counter() - t_process}
    built = session_mod.build_port(device)
    phases["build"] = time.perf_counter() - t_process
    s = session_mod.Session(cell, seed, device)
    try:
        phases["pool"] = time.perf_counter() - t_process
        s.warm_up()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        counters: dict = {}
        profiling.METRICS.reset()

        def on_done(d, t_end):
            if traced and d.t1 <= t_end:
                counters.clear()
                counters.update(profiling.METRICS.snapshot())

        # the pool and the rest of set-up's objects are the benchmark's: kept
        # out of the full collections that the program's own garbage sets off
        gc.collect()
        gc.freeze()
        try:
            loop = s.window(seconds, on_done)
            phases["window"] = time.perf_counter() - t_process
            done = list(loop.done)
            summary, error = None, loop.error
            if traced and error is None:
                sliced, summary = s.profiled_slice(cell.mix["trace_slice_seconds"])
                done += sliced.done
                error = sliced.error
                phases["slice"] = time.perf_counter() - t_process
        finally:
            gc.unfreeze()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        window_spans = list(s.spans.items)
        s.engines = None
        if cuda:
            torch.cuda.empty_cache()
        numbers, counts = s.check(done) if done else ({}, {})
        phases["check"] = time.perf_counter() - t_process
    finally:
        s.close()
    if not loop.completed():
        raise RuntimeError("no region completed inside the window"
                           + (f":\n{loop.error}" if loop.error else ""))
    if traced:
        metrics = per_layer(cell, loop, window_spans, counters, summary)
    else:
        values = end_to_end(loop, t_process)
        metrics = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 1, "memory_peak_bytes": int(peak)}
    if traced and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    checks = {k: {"value": v if math.isfinite(v) else repr(v), "limit": cell.limits.get(k)}
              for k, v in numbers.items()}
    correct = check.verdict(numbers, cell.limits, error)
    result = {"correct": correct, "attempted": len(done) + (error is not None),
              "failed": int(error is not None),
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
              "device": dev}
    if traced and summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    # whether this run built the port's libraries (a checkout's first run),
    # and the seconds that loading or building them took within setup_s
    result["setup"] = {"built": built, "build_s": phases["build"] - phases["start"]}
    result["compared"] = counts
    result["checks"] = checks
    calls = [d.t1 - d.t0 for d in loop.done]
    lines = ([f"error: {error.strip()}"] if error else []) + [
        "seconds since start: " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()),
        f"window: {len(calls)} regions, the first {calls[:3]} s, median "
        f"{statistics.median(calls) if calls else 0.0} s"] + (
        [f"trace: {summary.kernels} kernels, {summary.by_launch} attributed by their launch"]
        if summary is not None else []) + [
        f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_environment()
    import torch

    from bench_port.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                             T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
