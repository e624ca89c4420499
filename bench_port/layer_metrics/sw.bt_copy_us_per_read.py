"""Microseconds a read spends bringing SW's backtrack to the host (the
port's ``profiling.METRICS["sw_bt_copy"]`` seconds)."""
from bench_port.harness import stages


def read(run):
    return stages.stage_us_per_read(run, "sw_bt_copy")
