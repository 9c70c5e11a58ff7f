"""The readings the limits of `correct` are set from, and the readings of
the planted faults, for one cell on the card, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--faults stale,half,altered] [--seconds 6]

Each seed is one run of the cell (``driver.run_cell``: set-up, a short
window at the cell's own load, the check of its answers): the program's
readings; with ``--faults``, one run of each seed with each fault planted
under the timed path (``faults.py``) in place of the sound runs. For
each control seed, after its run, the same rows with the configuration's
reference at its control's lower precision in the program's place: the
control's readings. One JSON line per seed. The benchmark's runs never
run this.
"""

import argparse
import io
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(1, str(BENCH_DIR.parent))


def readings(cell: str, seed: int, seconds: float, control: bool, fault: str | None = None,
             **run_kwargs) -> dict:
    import faults
    from pbcore import driver

    with faults.planted(fault):
        run = driver.run_cell(cell, seed, seconds, False, out=io.StringIO(), err=io.StringIO(),
                              **run_kwargs)
    r = run.result
    out = {"cell": cell, "seed": seed, "fault": fault, "correct": r["correct"],
           "calls": r["attempted"], "failed": r["failed"],
           "program": {name: v["value"] for name, v in r["checks"].items()}}
    if control:
        out["control"] = run.traffic.control(r["attempted"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for fault in [f for f in args.faults.split(",") if f] or [None]:
        for seed in seeds:
            print(json.dumps(readings(args.workload, seed, args.seconds,
                                      fault is None and seed in controls, fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
