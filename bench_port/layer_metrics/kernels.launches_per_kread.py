"""CUDA kernel launches per 1,000 reads (the port's ``launch.*`` counts
in ``profiling.METRICS``)."""
from bench_port.harness import stages


def read(run):
    return stages.launches_per_kread(run)
