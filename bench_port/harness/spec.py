"""A cell and everything it names, found by name under ``bench_port/``:

* ``configs/<config>.json`` — the deployment's settings: GATK's arguments
  under names of their own (``arguments`` says which), among them
  ``native_pair_hmm_use_double_precision`` (bool, absent means false),
  GATK's ``--native-pair-hmm-use-double-precision``: the engines run
  PairHMM and PDHMM in float64 throughout, the control drops to float32
  with the float64 rescue, and the PairHMM and PDHMM rooflines read the
  card's FP64 peak;
* ``traffic/<mix>.json`` — the traffic mix, naming its generator;
* ``gen/<generator>.py`` — ``pool(config, mix, seed)``;
* ``limits/<cell>.json`` — the limit of each number the check compares;
* ``layer_metrics/<metric>.py`` — ``read(run)`` of each per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(REPO_DIR, "BENCHMARK.json")


def double_precision(config: dict) -> bool:
    """Whether the deployment sets GATK's
    ``--native-pair-hmm-use-double-precision``."""
    value = config.get("native_pair_hmm_use_double_precision", False)
    if not isinstance(value, bool):
        raise ValueError(f"native_pair_hmm_use_double_precision is {value!r}, not a bool")
    return value


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def generator(self):
        return importlib.import_module(f"bench_port.gen.{self.mix['generator']}")


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"],
        config=_json(REPO_DIR, config["file"]),
        mix=_json(BENCH_DIR, "traffic", entry["traffic"] + ".json"),
        limits=_json(BENCH_DIR, "limits", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """The module of ``layer_metrics/<name>.py``; its ``read(run)`` returns
    the metric's value, or None where the run holds nothing to read."""
    path = os.path.join(BENCH_DIR, "layer_metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_port_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
