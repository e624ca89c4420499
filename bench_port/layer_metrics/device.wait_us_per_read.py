"""Microseconds a read's host thread spends blocked on the card: the
port's ``pairhmm_wait``, ``sw_wait`` and ``pdhmm_wait`` seconds (PDHMM's
from its upload's start until its results are on the host)."""
from bench_port.harness import stages


def read(run):
    return stages.stage_us_per_read(run, "pairhmm_wait", "sw_wait", "pdhmm_wait")
