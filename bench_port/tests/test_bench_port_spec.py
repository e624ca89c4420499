"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from bench_port.harness import spec

from .conftest import CELLS

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
BENCH = spec.benchmark()


def one_line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.REPO_DIR, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    named = [w for w in BENCH["command"] if w.endswith(".py")]
    assert all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in named)


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.fullmatch(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and one_line(w["why"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for group in (metrics, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.load_cell(name)
    assert callable(cell.generator().pool)
    assert cell.mix["entry"] in ("three_calls", "region_stream")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "reads_per_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert set(cell.limits) >= {"pairhmm_err", "best_gap", "sw_mismatches", "pdhmm_err"}


def test_configs_state_their_source_and_cuts():
    for c in BENCH["configs"]:
        with open(os.path.join(spec.REPO_DIR, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and "precision" in cfg and "guarantees" in cfg
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(any(f.startswith(p + "/") for p in BENCH["paths"]) for f in files)


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    readers = {f[:-3] for f in os.listdir(os.path.join(spec.BENCH_DIR, "layer_metrics"))
               if f.endswith(".py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}
