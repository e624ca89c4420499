"""Microseconds a read spends in the benchmark's spans around the pairhmm call."""
from bench_port.harness import readers


def read(run):
    return readers.span_us_per_read(run, "pairhmm")
