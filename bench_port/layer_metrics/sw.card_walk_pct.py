"""Share of SW's alignments whose CIGAR the device walked where the DP left
the backtrack, in percent: the port's ``profiling.METRICS["sw_card_walk"]``
items over its ``METRICS["smithwaterman"]`` items (every call's pairs).  A
program without that counter gives nothing to read."""


def read(run):
    counters = run.counters or {}
    total = counters.get("smithwaterman", {}).get("items", 0)
    if not total or "sw_card_walk" not in counters:
        return None
    return 100.0 * counters["sw_card_walk"]["items"] / total
