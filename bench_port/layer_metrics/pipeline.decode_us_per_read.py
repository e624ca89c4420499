"""Microseconds a read spends in region_stream's record parsing, filter and
chunking on the producer thread (the port's
``profiling.METRICS["pipeline_decode"]`` seconds)."""
from bench_port.harness import stages


def read(run):
    return stages.stage_us_per_read(run, "pipeline_decode")
