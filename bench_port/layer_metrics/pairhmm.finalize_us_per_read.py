"""Microseconds a read spends in PairHMM's finalize: log10, the rescue
choice, the f64 rescue and the scatter (the port's
``profiling.METRICS["pairhmm_finalize"]`` seconds)."""
from bench_port.harness import stages


def read(run):
    return stages.stage_us_per_read(run, "pairhmm_finalize")
