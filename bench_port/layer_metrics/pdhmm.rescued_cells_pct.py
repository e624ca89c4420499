"""Share of PDHMM's DP cells that its f64 rescue recomputes, in percent:
the port's ``profiling.METRICS["pdhmm_rescue"]`` cells over its
``METRICS["pdhmm"]`` cells (every call's pairs)."""


def read(run):
    total = (run.counters or {}).get("pdhmm", {}).get("cells", 0)
    if not total:
        return None
    return 100.0 * run.counters.get("pdhmm_rescue", {}).get("cells", 0) / total
