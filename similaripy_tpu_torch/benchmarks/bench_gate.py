"""Performance-regression gate: fresh bench vs the latest same-backend report.

A copy of ``benchmarks/bench_gate.py`` in the port. Runs a quick benchmark
(the port's ``run_benchmarks``, synthetic_small by default), then compares
it against the most recent compatible prior report in the output
directory through ``compare_benchmarks``' --max-regression logic, failing
(exit 1) when any similarity regressed beyond the threshold.

Reports are only comparable on the same backend class (a CPU run must not
be judged against a card's report), so the prior-report search also
requires matching `system.backend` and `system.devices`. With no
comparable prior report the fresh run becomes the new baseline and the
gate passes (bootstrap).

Usage:
    python -m similaripy_tpu_torch.benchmarks.bench_gate [--dataset synthetic_small]
        [--rounds 2] [--max-regression 0.10] [--output-dir reports]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

from .compare_benchmarks import compare_reports, compatible
from .run_benchmarks import main as run_main


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _same_machine_class(a: dict, b: dict) -> bool:
    sa, sb = a.get("system", {}), b.get("system", {})
    return (
        sa.get("backend") == sb.get("backend")
        and sa.get("devices") == sb.get("devices")
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="synthetic_small")
    p.add_argument("--data-path", default=None,
                   help="local ratings file overriding the dataset")
    p.add_argument("--similarities", nargs="+",
                   default=["dot_product", "cosine", "rp3beta"])
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--max-regression", type=float, default=0.10)
    p.add_argument("--output-dir", default="reports")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    pattern = os.path.join(args.output_dir, f"benchmark_{args.dataset}_*.json")
    prior = sorted(glob.glob(pattern))
    # second-resolution report stamps can collide with a run from the same
    # second; track mtimes so the fresh report is found even if it reused
    # (overwrote) a prior filename
    prior_mtime = {p: os.path.getmtime(p) for p in prior}

    run_args = [
        "--dataset", args.dataset,
        "--similarities", *args.similarities,
        "--k", str(args.k),
        "--rounds", str(args.rounds),
        "--warmup", str(args.warmup),
        "--output-dir", args.output_dir,
        "--device", args.device,
    ]
    if args.data_path:
        run_args += ["--data-path", args.data_path]
    rc = run_main(run_args)
    if rc:
        print("bench-gate: benchmark run failed", file=sys.stderr)
        return rc

    fresh_paths = sorted(glob.glob(pattern))
    new_paths = [
        f for f in fresh_paths
        if f not in prior_mtime or os.path.getmtime(f) > prior_mtime[f]
    ]
    if not new_paths:
        print("bench-gate: no fresh report written", file=sys.stderr)
        return 1
    fresh = _load(new_paths[-1])

    baseline_path = None
    for path in reversed([p for p in prior if p not in new_paths]):
        rep = _load(path)
        if compatible(rep, fresh) and _same_machine_class(rep, fresh):
            baseline_path = path
            break
    if baseline_path is None:
        print(
            f"bench-gate: no comparable prior report for {args.dataset} on "
            f"this backend — fresh run ({new_paths[-1]}) is the new baseline; "
            "PASS (bootstrap)"
        )
        return 0

    print(f"bench-gate: comparing against {baseline_path} "
          f"(threshold {args.max_regression:.0%})")
    reports = [
        (Path(baseline_path), _load(baseline_path)),
        (Path(new_paths[-1]), fresh),
    ]
    return compare_reports(reports, None, args.max_regression)


if __name__ == "__main__":
    raise SystemExit(main())
