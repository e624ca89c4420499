"""Microseconds a read spends in the PDHMM f64 rescue of lanes below
MIN_ACCEPTED (the port's
``profiling.METRICS["pdhmm_rescue"]`` seconds)."""
from bench_port.harness import readers


def read(run):
    return readers.counter_us_per_read(run, "pdhmm_rescue")
