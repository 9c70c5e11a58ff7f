"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (loading the pattern, deriving this seed's inputs, the warm-up call
that builds the kernels on a checkout's first run) is ``setup_s``; then a
closed loop with one caller runs for ``--seconds``; the last line of
standard output is the result, the last lines of standard error the
compared numbers beside their limits. With ``--trace 1`` the metrics are
the cell's per-layer metrics. Without a card the run fails and prints no
result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(1, str(BENCH_DIR.parent))  # the port, imported by name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pbcore import driver, manifest

    chips = manifest.cell_entry(args.workload, manifest.benchmark())["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    t_process=T_PROCESS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
