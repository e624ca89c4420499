"""Helpers of the benchmark's tests: cells cut to a size the CPU holds."""

from __future__ import annotations

import os
import sys

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO_DIR not in sys.path:
    sys.path.insert(0, REPO_DIR)

from bench_port.harness import spec  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def tiny_cell(name: str):
    """The cell with its regions cut to a few short reads and haplotypes,
    for the plain CPU twins; its limits as committed."""
    cell = spec.load_cell(name)
    deep = "n_haplotypes" in cell.mix
    cell.config.update(min_assembly_region_size=10, max_assembly_region_size=20,
                       assembly_region_padding=8, read_length=20, min_read_length=8,
                       max_haplotypes=4, coverage=12 if deep else 3, indel_length=[1, 3])
    cell.mix.update(pool_regions=2 if deep else 6, strata=2 if deep else 3, warmup_regions=1,
                    trace_slice_seconds=0.3)
    if deep:
        cell.mix.update(n_haplotypes=3, check_reads=16, chunk_reads=16)
    else:
        cell.mix.update(check_regions=3)
    return cell
