"""Microseconds a read spends in region_stream's wait for the producer
thread's next chunk (the port's
``profiling.METRICS["pipeline_wait"]`` seconds)."""
from bench_port.harness import readers


def read(run):
    return readers.counter_us_per_read(run, "pipeline_wait")
