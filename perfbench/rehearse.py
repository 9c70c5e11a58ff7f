"""Rehearse a cell on the CPU at a tiny size, with the port's plain kernels.

    python3 perfbench/rehearse.py --workload <cell> [--seed N] [--seconds S]
        [--trace 0|1] [--users 3000] [--items 1500] [--param NAME=VALUE ...]

It runs the whole path of a run (set-up, window, check, result line) on
about that many users and items of the pattern, evenly strided. Its result says
``"platform": "cpu"``: it finds faults in the harness and measures
nothing. No cell runs at this size.
"""

import argparse
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(1, str(BENCH_DIR.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--users", type=int, default=3000)
    ap.add_argument("--items", type=int, default=1500)
    ap.add_argument("--param", action="append", default=[],
                    help="a traffic parameter for the tiny size, e.g. targets=200")
    args = ap.parse_args(argv)

    from pbcore import driver

    driver.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cpu",
                    scale={"users": args.users, "items": args.items},
                    params={k: int(v) for k, v in (p.split("=", 1) for p in args.param)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
