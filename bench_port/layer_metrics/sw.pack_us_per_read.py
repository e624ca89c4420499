"""Microseconds a read spends in SW's validation, shape merge and lane
packing (the port's ``profiling.METRICS["sw_pack"]`` seconds)."""
from bench_port.harness import stages


def read(run):
    return stages.stage_us_per_read(run, "sw_pack")
