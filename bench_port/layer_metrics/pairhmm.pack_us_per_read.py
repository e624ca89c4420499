"""Microseconds a read spends in PairHMM's validation, length grouping,
constant-quality check, packing and in-flight budget (the port's
``profiling.METRICS["pairhmm_pack"]`` seconds)."""
from bench_port.harness import stages


def read(run):
    return stages.stage_us_per_read(run, "pairhmm_pack")
