"""Microseconds a read spends in the SW maximum selection and CIGAR walk
on the host (the port's
``profiling.METRICS["sw_host_walk"]`` seconds)."""
from bench_port.harness import readers


def read(run):
    return readers.counter_us_per_read(run, "sw_host_walk")
