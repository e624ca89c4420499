"""The readers of the port's stage spans and launch counts, the idle gaps
labelled by stage, and the stage breakdown of a tiny run."""

from __future__ import annotations

import pytest

from bench_port import run, stage_breakdown
from bench_port.harness import drive, readers, spec, stages, trace
from bench_port.tests.conftest import tiny_cell

SEED = 2 ** 31 + 4099


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _events():
    return [
        _x("user_annotation", trace.SLICE, 0, 1000),
        _x("user_annotation", "pairhmm", 10, 400),
        _x("user_annotation", "pdhmm", 500, 400),
        _x("user_annotation", "gkl.pdhmm_pack", 520, 200),
        # a stage on another thread names nothing on the caller's
        _x("user_annotation", "gkl.pipeline_decode", 0, 1000, tid=2),
        _x("cpu_op", "aten::copy_", 650, 70),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 300, 5, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 590, 5, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 700, 5, correlation=4),
        _x("kernel", "k_a", 100, 50, correlation=1),
        _x("kernel", "k_b", 400, 5, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoH", 440, 20, correlation=10),
        _x("kernel", "k_c", 600, 10, correlation=3),
        _x("kernel", "k_d", 730, 30, correlation=4),
    ]


def _spans():
    spans = drive.Spans()
    spans.items = [drive.Span("pairhmm", 0, 0, 10, 2e-6), drive.Span("pdhmm", 0, 0, 10, 1e-6)]
    return spans


def test_gap_in_a_stage_gets_the_three_part_label():
    """A gap whose middle lies in ``gkl.pdhmm_pack`` is labelled by it (and
    by the CPU operation under it); gaps in no stage keep
    ``trace.summarize``'s two-part labels, and the gaps are its gaps."""
    events = _events()
    old = trace.summarize(events, _spans())
    assert old.busy_s == pytest.approx(115e-6)
    assert old.kernel_s == pytest.approx({"pairhmm": 55e-6, "pdhmm": 40e-6})
    assert dict(old.idle_gaps) == pytest.approx({
        "pairhmm: host": 350e-6, "between calls: host": 35e-6, "pdhmm: host": 380e-6,
        "pdhmm: aten::copy_": 120e-6})
    gaps = stages.stage_gaps(events)
    assert gaps == pytest.approx({
        "pairhmm: host": 350e-6, "between calls: host": 35e-6,
        "pdhmm: gkl.pdhmm_pack: host": 140e-6, "pdhmm: gkl.pdhmm_pack: aten::copy_": 120e-6,
        "pdhmm: host": 240e-6})
    assert sum(gaps.values()) == pytest.approx(old.window_s - old.busy_s)
    share = stages.unnamed_share(gaps)
    assert share["idle_in_calls_s"] == pytest.approx(850e-6)
    assert share["unnamed_s"] == pytest.approx(590e-6)
    assert share["unnamed_pct"] == pytest.approx(100 * 590 / 850)


def test_no_slice_no_gaps():
    assert stages.stage_gaps([_x("kernel", "k", 0, 1)]) == {}


def _run(counters, reads=500):
    return readers.Run(reads=reads, spans=[], counters=counters, trace=None)


def _c(seconds=0.0, calls=1):
    return {"calls": calls, "items": 0, "cells": 0, "bytes_in": 0, "seconds": seconds}


STAGED = {"pairhmm_pack": _c(0.001), "pairhmm_finalize": _c(0.002), "sw_pack": _c(0.003),
          "sw_bt_copy": _c(0.004), "pdhmm_plan": _c(0.005), "pdhmm_pack": _c(0.006),
          "pairhmm_wait": _c(0.0005), "sw_wait": _c(0.0015), "pdhmm_wait": _c(0.0025),
          "pipeline_inflate": _c(0.0075), "pipeline_decode": _c(0.01),
          "launch.pairhmm_scaled": _c(calls=6), "launch.sw_forward": _c(calls=3),
          "launch.pdhmm": _c(calls=1)}
# the counters of a program that predates the stage spans
OLD = {"pairhmm": _c(0.1), "pairhmm_rescue": _c(0.0), "sw_bt_copy": _c(0.004),
       "sw_host_walk": _c(0.02), "pipeline_wait": _c(0.001)}

READERS = [
    ("pairhmm.pack_us_per_read", 2.0), ("pairhmm.finalize_us_per_read", 4.0),
    ("sw.pack_us_per_read", 6.0), ("sw.bt_copy_us_per_read", 8.0),
    ("pdhmm.plan_us_per_read", 10.0), ("pdhmm.pack_us_per_read", 12.0),
    ("device.wait_us_per_read", 9.0), ("kernels.launches_per_kread", 20.0),
    ("pipeline.inflate_us_per_read", 15.0), ("pipeline.decode_us_per_read", 20.0),
]


@pytest.mark.parametrize("name,want", READERS)
def test_stage_reader(name, want):
    """Each new reader on a program with stages, and on one without them:
    nothing to read (``sw_bt_copy`` alone predates them), and no error."""
    reader = spec.metric_reader(name)
    assert reader.read(_run(STAGED)) == pytest.approx(want)
    old = reader.read(_run(OLD))
    assert old == (pytest.approx(8.0) if name == "sw.bt_copy_us_per_read" else None)
    assert reader.read(_run({})) is None and reader.read(_run(STAGED, reads=0)) is None


def test_launches_read_zero_where_nothing_launched():
    """A program with stages that launched nothing (the CPU twins) reads 0."""
    assert stages.launches_per_kread(_run({"pdhmm_plan": _c(0.1)})) == 0.0


def test_new_metrics_are_declared_as_the_readers_read_them():
    bench = spec.benchmark()
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name, _ in READERS:
        m = layer[name]
        assert (m["source"], m["moves"], m["better"]) == ("program_counter", "reads_per_s",
                                                          "lower")
        assert ("workloads" in m) == name.startswith("pipeline.")


def test_breakdown_of_a_tiny_run(monkeypatch):
    """The tiny region cell on the CPU: every call's stages cover most of
    it, and every gap is labelled."""
    run.pin_environment()
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    out = stage_breakdown.measure(tiny_cell("hc_wgs30x.region"), SEED, 2.0, "cpu")
    for call, got in out["calls"].items():
        assert 50 < got["covered_pct"] <= 100, (call, got)
    assert out["spans_per_region"] > 10
    assert sum(out["gaps"].values()) == pytest.approx(out["idle_s"]) and out["idle_s"] > 0
    assert any(k.count(": ") == 2 for k in out["gaps"])
