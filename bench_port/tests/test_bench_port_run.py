"""Whole runs of tiny cells on the CPU (the port's plain twins in the
kernels' place, the chip's look skipped), the control and planted faults
that the check must refuse, the trace reading, and the roofline
arithmetic; one test on the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from bench_port import run
from bench_port.harness import check, drive, roofline, spec, trace
from bench_port.tests.conftest import CELLS, REPO_DIR, tiny_cell

SEED = 2 ** 31 + 4099


def run_tiny(name, traced=False, seconds=3.0):
    run.pin_environment()
    return run.run_cell(tiny_cell(name), SEED, seconds, traced, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_runs_correct(name):
    result, lines = run_tiny(name)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in spec.load_cell(name).end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert set(result["setup"]) == {"built", "build_s"} and result["setup"]["build_s"] >= 0
    assert [line.split()[1] for line in lines[-len(result["checks"]):]] == list(result["checks"])


def test_traced_tiny_cell_reads_its_layers():
    result, lines = run_tiny("hc_deep_panel.bam_stream", traced=True)
    assert result["correct"], lines
    got = set(result["metrics"])
    # the CPU has no kernels: the rooflines find nothing to read
    assert got == {m["name"] for m in spec.load_cell("hc_deep_panel.bam_stream").per_layer
                   if not m["name"].endswith("_roofline")}
    assert result["device"]["window_s"] > 0 and "breakdown" in result


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    """The reference a precision below the configuration's in the program's
    place: bfloat16 likelihoods with the lanes below ``rescue_below`` in
    float64, int16 SW; every number finite, and ``correct`` false."""
    cell = tiny_cell(name)
    plan = check.plan(range(cell.mix["pool_regions"]), cell.generator().pool(
        cell.config, cell.mix, SEED), cell.mix, SEED)
    pool = cell.generator().pool(cell.config, cell.mix, SEED)
    numbers, _ = check.compare(check.control_calls(pool, plan, cell.config), pool, plan,
                               cell.config)
    assert all(np.isfinite(v) for v in numbers.values()), numbers
    assert not check.verdict(numbers, cell.limits), numbers


def _alter_pairhmm(monkeypatch):
    from gkl_tpu_torch import api

    real = api.PendingLikelihoods.result

    def result(self):
        out = real(self).copy()
        out[len(out) // 2] += 0.01
        return out
    monkeypatch.setattr(api.PendingLikelihoods, "result", result)


def _half_pairhmm(monkeypatch):
    from gkl_tpu_torch import api

    real = api.PendingLikelihoods.result

    def result(self):
        out = real(self).copy()
        half = len(out) // 2
        out[half:] = out[:len(out) - half]
        return out
    monkeypatch.setattr(api.PendingLikelihoods, "result", result)


def _alter_sw(monkeypatch):
    from gkl_tpu_torch import api_sw

    real = api_sw.SmithWaterman._align_walked
    calls = []

    def walked(self, *args):
        res = real(self, *args)
        for k, r in enumerate(res):
            calls.append(1)
            if len(calls) % 7 == 3:
                res[k] = api_sw.SWAlignerResult(r.cigar, r.alignment_offset + 1)
        return res
    monkeypatch.setattr(api_sw.SmithWaterman, "_align_walked", walked)


def _alter_pdhmm(monkeypatch):
    from gkl_tpu_torch import api_pdhmm

    real = api_pdhmm.PDHMM._compute_pairs

    def pairs(self, *args):
        out = real(self, *args).copy()
        out[1] -= 0.01
        return out
    monkeypatch.setattr(api_pdhmm.PDHMM, "_compute_pairs", pairs)


def _drop_record(monkeypatch):
    from gkl_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "_is_filtered", lambda rec: rec.name == "r000003")


FAULTS = {"pairhmm_answer_altered": _alter_pairhmm, "pairhmm_half_left_out": _half_pairhmm,
          "sw_answer_altered": _alter_sw, "pdhmm_answer_altered": _alter_pdhmm}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["hc_wgs30x.region", "hc_deep_panel.bam_stream"])
def test_planted_fault_fails_the_check(monkeypatch, fault, name):
    FAULTS[fault](monkeypatch)
    result, lines = run_tiny(name)
    assert not result["correct"], lines


def test_dropped_bam_record_fails_the_check(monkeypatch):
    _drop_record(monkeypatch)
    result, lines = run_tiny("hc_deep_panel.bam_stream")
    assert not result["correct"]
    assert result["checks"]["bam_records"]["value"] != 0


def test_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from bench_port import run\n"
            "from bench_port.tests.conftest import tiny_cell\n"
            "run.pin_environment()\n"
            "res, _ = run.run_cell(tiny_cell('hc_deep_panel.bam_stream'), 3, 2.0, True, 'cpu',"
            " time.perf_counter())\n"
            "assert res['correct']\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % REPO_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO_DIR, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "gkl_tpu_torch" in loaded and not loaded & run.FORBIDDEN_MODULES


def test_main_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_trace_summary_attributes_kernels_by_launch():
    spans = drive.Spans()
    spans.items = [drive.Span("pairhmm", 0, 0, 10, 2e-6), drive.Span("sw", 0, 0, 10, 1e-6)]

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1,
                "args": args}
    events = [
        x("user_annotation", trace.SLICE, 0, 1000),
        x("user_annotation", "pairhmm", 10, 400),
        x("user_annotation", "sw", 500, 400),
        x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 390, 5, correlation=2),
        x("cpu_op", "aten::copy_", 600, 100),
        # launched inside pairhmm, run while sw's span is open: pairhmm's
        x("kernel", "k_a", 100, 50, correlation=1),
        x("kernel", "k_b", 550, 20, correlation=2),
        # no launch in the trace: attributed by its own start, inside sw
        x("kernel", "k_c", 800, 40, correlation=9),
        x("gpu_memcpy", "Memcpy DtoH", 700, 10, correlation=10),
    ]
    s = trace.summarize(events, spans)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(120e-6)
    assert s.kernel_s == pytest.approx({"pairhmm": 70e-6, "sw": 40e-6})
    assert s.least_s == {"pairhmm": 2e-6, "sw": 1e-6}
    assert (s.kernels, s.by_launch) == (3, 2)
    assert dict(s.device_ops) == pytest.approx({"k_a": 50e-6, "k_b": 20e-6, "k_c": 40e-6,
                                                "Memcpy DtoH": 10e-6})
    gaps = dict(s.idle_gaps)
    assert gaps["sw: aten::copy_"] == pytest.approx(130e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 120e-6)


def test_roofline_matches_the_chip_smoke_arithmetic():
    sys.path.insert(0, REPO_DIR)
    import chip_smoke

    rl, hl = [128] * 64, [224] * 32
    cells = sum(rl) * sum(hl)
    io = 5 * sum(rl) + sum(hl) + 8 * len(rl) * len(hl)
    want = chip_smoke.bound("pairhmm_scaled", io, cells, len(rl) * sum(hl))["bound_ms"]
    assert roofline.pairhmm_s(rl, hl) * 1e3 == pytest.approx(want)
    want = chip_smoke.bound("sw_forward", 448 * 256 * 2 + 4 * 2 + 10, 448 * 256 * 2)["bound_ms"]
    assert roofline.sw_s([448, 448], [256, 256], [5, 5]) * 1e3 == pytest.approx(
        want - 448 * 256 * 2 / roofline.PEAK_BYTES_PER_S * 0 * 1e3)
    cells = 256 * 448 * 100
    io = 5 * 256 * 100 + 2 * 448 + 8 * 100
    want = chip_smoke.bound("pdhmm", io, cells)["bound_ms"]
    assert roofline.pdhmm_s([256] * 100, [448]) * 1e3 == pytest.approx(want)


@pytest.mark.gpu
def test_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, cwd=REPO_DIR, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert {"pairhmm_roofline", "device.idle_pct"} <= set(result["metrics"])
    assert all(0 < result["metrics"][k]["value"] <= 100 for k in result["metrics"]
               if k.endswith("_roofline"))


def test_refuses_in_a_directory_without_the_port(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO_DIR, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO_DIR, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
