"""The share of the profiled slice in which the card ran no kernel, copy or memset."""
from bench_port.harness import readers


def read(run):
    return readers.idle_pct(run)
