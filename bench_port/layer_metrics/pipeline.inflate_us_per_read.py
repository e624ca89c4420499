"""Microseconds a read spends in region_stream's BGZF inflate on the
producer thread (the port's ``profiling.METRICS["pipeline_inflate"]``
seconds)."""
from bench_port.harness import stages


def read(run):
    return stages.stage_us_per_read(run, "pipeline_inflate")
