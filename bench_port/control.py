"""Readings that the check's limits are set from (not part of a run).

    python3 bench_port/control.py --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

For each ``--seeds`` seed: the cell's pool, then the port driven through a
short window at the cell's own load (at least every region the check
compares), and the check's numbers: the program's readings.  For each
``--control-seeds`` seed: the check's numbers with the plain reference,
a precision below the configuration's (``check.control_calls``: float32
likelihoods where the configuration sets
``native_pair_hmm_use_double_precision``, else bfloat16, each with the
float64 rescue of the lanes below ``rescue_below``; int16 SW scores), in
the program's place: the control's readings.  One JSON line
each, with ``correct`` as a run would judge those numbers, then the
largest program reading and the smallest control reading of every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench_port import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    run.pin_environment()
    import torch

    from bench_port.harness import check, drive, spec
    from bench_port.harness import session as session_mod

    cell = spec.load_cell(args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    session_mod.pin_threads(cell.config)
    session_mod.build_port(device)
    engines = session_mod.engines(device, cell.config)
    program, control = {}, {}
    need = min(cell.mix["pool_regions"], cell.mix.get("check_regions") or 1)
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            s = session_mod.Session(cell, seed, device, port_engines=engines)
            try:
                if side == "program":
                    loop = drive.closed_loop(s.call, s.reads_of, 0, args.seconds,
                                                 min_regions=need)
                    if loop.error:
                        print(loop.error, file=sys.stderr)
                    numbers, counts = s.check(loop.done)
                    error = loop.error
                else:
                    (numbers, counts), error = s.control(), None
            finally:
                s.close()
            into = program if side == "program" else control
            for k, v in numbers.items():
                into.setdefault(k, []).append(v)
            print(json.dumps({"workload": cell.name, "side": side, "seed": seed,
                              "correct": check.verdict(numbers, cell.limits, error),
                              "numbers": numbers, "compared": counts,
                              "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": cell.name,
                      "program_max": {k: max(v) for k, v in program.items()},
                      "control_min": {k: min(v) for k, v in control.items()},
                      "device": torch.cuda.get_device_name(0) if device != "cpu" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
