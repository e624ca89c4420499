"""Microseconds a read spends in the PairHMM f64 rescue of lanes below
MIN_ACCEPTED (the port's
``profiling.METRICS["pairhmm_rescue"]`` seconds)."""
from bench_port.harness import readers


def read(run):
    return readers.counter_us_per_read(run, "pairhmm_rescue")
