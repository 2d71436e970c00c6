#!/usr/bin/env python3
"""Readings for a cell's limits: the program's compared numbers and the
control's, on many seeds, in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13
        [--seconds 4] [--control 1] [--fault half_batch]

Each seed runs the cell as ``bench/run.py`` does (set-up, a short window,
the reference), with no limit applied; with ``--control 1`` the reference
is also computed with fp8 products, and its reading of the same numbers is
printed beside the program's; ``--fault`` plants one of
``bench/harness/faults.py`` under the timed path.  One JSON line a seed,
then the program's largest readings and the control's least.
"""

import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench.harness import core, faults  # noqa: E402


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--fault", choices=faults.FAULTS, default=None,
                    help="plant a fault under the timed path")
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    cell["limits"] = {k: float("inf") for k in cell["limits"]}
    config = core.load_config(cell["config"])
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    program, control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            run = core.run_cell(cell, config, seed=seed,
                                seconds=args.seconds, trace=False,
                                device=torch.device("cuda", 0), t_start=t0,
                                control=bool(args.control))
        got = run.counters.get("readings") or \
            {name: v for name, v, _ in run.checks}
        for k, v in got.items():
            program.setdefault(k, []).append(v)
        for k, v in run.control_readings.items():
            control.setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, "program": got,
                          "control": run.control_readings, "e2e": run.e2e,
                          "counters": run.counters,
                          "seconds": time.monotonic() - t0}), flush=True)
        del run
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": {k: max(v) for k, v in program.items()},
                      "control_min": {k: min(v) for k, v in control.items()}
                      }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
