"""The pairhmm call's work at the card's peak over the device time of the
kernels launched inside its spans (profiled slice), in percent."""
from bench_port.harness import readers


def read(run):
    return readers.roofline_pct(run, "pairhmm")
