"""Microseconds a read spends in PDHMM's identity dedup and packing (the
port's ``profiling.METRICS["pdhmm_pack"]`` seconds)."""
from bench_port.harness import stages


def read(run):
    return stages.stage_us_per_read(run, "pdhmm_pack")
