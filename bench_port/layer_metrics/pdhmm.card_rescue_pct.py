"""Share of PDHMM's rescued lanes (those below MIN_ACCEPTED) that the
kernel's f64 instance recomputed on the device, in percent: the port's
``profiling.METRICS["pdhmm_card_rescue"]`` items over its
``METRICS["pdhmm_rescue"]`` items.  A run with no rescue, or a program
without that counter, gives nothing to read."""


def read(run):
    counters = run.counters or {}
    total = counters.get("pdhmm_rescue", {}).get("items", 0)
    if not total or "pdhmm_card_rescue" not in counters:
        return None
    return 100.0 * counters["pdhmm_card_rescue"]["items"] / total
