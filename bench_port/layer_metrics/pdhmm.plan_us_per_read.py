"""Microseconds a read spends in PDHMM's planning: the read x haplotype
cross product, the lane order, the permutation and the slices (the
port's ``profiling.METRICS["pdhmm_plan"]`` seconds)."""
from bench_port.harness import stages


def read(run):
    return stages.stage_us_per_read(run, "pdhmm_plan")
