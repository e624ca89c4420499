"""Share of PairHMM's DP cells that its f64 rescue recomputes, in percent:
the port's ``profiling.METRICS["pairhmm_rescue"]`` cells over its
``METRICS["pairhmm"]`` cells (every call's whole cross product)."""


def read(run):
    total = (run.counters or {}).get("pairhmm", {}).get("cells", 0)
    if not total:
        return None
    return 100.0 * run.counters.get("pairhmm_rescue", {}).get("cells", 0) / total
