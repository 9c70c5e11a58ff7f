"""Compare benchmark JSON reports produced by run_benchmarks.py.

A copy of ``benchmarks/compare_benchmarks.py`` in the port (which imports
nothing of the top-level ``benchmarks``), reading the reports of either
package's ``run_benchmarks``. Capability parity with the reference
comparison CLI (reference: tests/benchmarks/compare_benchmarks.py:1-491):
report discovery + --list, latest-N selection, multi-report labelled
comparison with per-similarity speedup tables, system-info diffing (the
port's reports add torch, cuda and the card's power limit), similarity
filtering, and a regression gate for CI.

Usage:
    # Compare two specific runs (first = reference for speedup)
    python -m similaripy_tpu_torch.benchmarks.compare_benchmarks ref.json cand.json

    # Compare the latest run against all compatible previous runs
    python -m similaripy_tpu_torch.benchmarks.compare_benchmarks

    # List available reports
    python -m similaripy_tpu_torch.benchmarks.compare_benchmarks --list

    # Latest N runs (most recent = reference)
    python -m similaripy_tpu_torch.benchmarks.compare_benchmarks --latest 3

    # Only one similarity; fail CI if >10% slower than the reference run
    python -m similaripy_tpu_torch.benchmarks.compare_benchmarks a.json b.json \
        --similarity cosine --max-regression 0.10
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


# ---- I/O -------------------------------------------------------------------


def load_report(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_reports(bench_dir: Path, pattern: str | None = None) -> list:
    files = sorted(bench_dir.glob("benchmark_*.json"))
    if pattern:
        files = [f for f in files if pattern in f.stem]
    return files


def resolve(raw: str, bench_dir: Path) -> Path:
    p = Path(raw)
    if p.exists():
        return p
    alt = bench_dir / raw
    if alt.exists():
        return alt
    print(f"error: file not found: {raw}", file=sys.stderr)
    sys.exit(1)


def compatible(a: dict, b: dict) -> bool:
    return a.get("dataset") == b.get("dataset") and a.get("k") == b.get("k")


# ---- display ---------------------------------------------------------------


def _fmt_time(mean_s: float, std_s: float) -> str:
    return f"{mean_s:.2f} ± {std_s:.2f}" if std_s else f"{mean_s:.2f}"


def summary_line(path: Path, rep: dict) -> str:
    sysinfo = rep.get("system", {})
    sims = ", ".join(r["name"] for r in rep.get("results", []))
    return (
        f"{path.name:<48} {rep.get('dataset', '?'):<18} "
        f"k={rep.get('k', '?'):<5} rounds={rep.get('rounds', '?'):<3} "
        f"{sysinfo.get('backend', '?'):<6} {sims}"
    )


def list_reports(bench_dir: Path, pattern: str | None) -> None:
    files = find_reports(bench_dir, pattern)
    if not files:
        print(f"no reports in {bench_dir}" + (f" (filter '{pattern}')" if pattern else ""))
        return
    print(f"\n{len(files)} report(s) in {bench_dir}:\n")
    for i, f in enumerate(files, 1):
        try:
            print(f"{i:<4} {summary_line(f, load_report(f))}")
        except (json.JSONDecodeError, KeyError) as e:
            print(f"{i:<4} {f.name:<48} [unreadable: {e}]")
    print()


def _system_diff(ref: dict, other: dict) -> str:
    """One-line description of system differences vs the reference run."""
    a, b = ref.get("system", {}), other.get("system", {})
    diffs = []
    for key in ("backend", "devices", "gpu_power_limit", "cpu", "torch", "cuda",
                "jax", "python", "version"):
        if a.get(key) != b.get(key) and (a.get(key) or b.get(key)):
            diffs.append(f"{key}: {a.get(key, '?')} -> {b.get(key, '?')}")
    return "; ".join(diffs) if diffs else "same system"


def compare_reports(reports: list, similarity: str | None,
                    max_regression: float | None) -> int:
    """Print labelled per-similarity speedup tables; first report = [REF].

    Returns a process exit code: 1 if any compared similarity regressed
    beyond --max-regression, else 0.
    """
    (ref_path, ref), others = reports[0], reports[1:]
    labels = [chr(66 + i) for i in range(len(others))]  # B, C, D...

    w = 110
    print("=" * w)
    print("BENCHMARK COMPARISON")
    print("=" * w)
    print(f"  [REF] {summary_line(ref_path, ref)}")
    for lab, (p, rep) in zip(labels, others):
        print(f"  [{lab}]   {summary_line(p, rep)}")
        print(f"         system vs REF: {_system_diff(ref, rep)}")
    print("=" * w)

    ref_by = {r["name"]: r for r in ref.get("results", [])}
    names = sorted(ref_by)
    if similarity:
        names = [n for n in names if n == similarity]
    failed = False

    for name in names:
        rr = ref_by[name]
        print(f"\n{name.upper()}")
        header = (
            f"{'label':<7}{'time (s)':<16}{'items/s':>12}{'out nnz':>14}"
            f"{'avg nbrs':>10}{'speedup':>9}"
        )
        print(header)
        print("-" * len(header))
        print(
            f"{'[REF]':<7}{_fmt_time(rr['mean_s'], rr.get('std_s', 0)):<16}"
            f"{rr['throughput_items_s']:>12.1f}{rr.get('output_nnz', 0):>14,}"
            f"{rr.get('avg_neighbors', 0):>10.1f}{'-':>9}"
        )
        for lab, (_p, rep) in zip(labels, others):
            r = next((x for x in rep.get("results", []) if x["name"] == name), None)
            if r is None:
                print(f"{'[' + lab + ']':<7}{'N/A':<16}{'N/A':>12}{'N/A':>14}"
                      f"{'N/A':>10}{'N/A':>9}")
                continue
            speed = rr["mean_s"] / r["mean_s"] if r["mean_s"] else float("inf")
            print(
                f"{'[' + lab + ']':<7}{_fmt_time(r['mean_s'], r.get('std_s', 0)):<16}"
                f"{r['throughput_items_s']:>12.1f}{r.get('output_nnz', 0):>14,}"
                f"{r.get('avg_neighbors', 0):>10.1f}{speed:>8.2f}x"
            )
            if max_regression is not None and speed < 1.0 - max_regression:
                failed = True
                print(f"        ^ REGRESSION: {name} is {1/speed:.2f}x slower "
                      f"than REF (threshold {max_regression:.0%})")

    print("\n" + "=" * w)
    print("speedup = time(REF) / time; >1.00x = faster than the reference run")
    return 1 if failed else 0


# ---- CLI -------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("files", nargs="*",
                   help="reports to compare; first = reference for speedup")
    p.add_argument("--list", action="store_true", help="list available reports")
    p.add_argument("--latest", type=int, metavar="N",
                   help="compare the latest N runs (most recent = reference)")
    p.add_argument("--filter", metavar="PATTERN",
                   help="only consider report files containing PATTERN")
    p.add_argument("--similarity", help="only compare this similarity")
    p.add_argument("--max-regression", type=float, metavar="FRAC",
                   help="exit 1 if any candidate is more than FRAC slower")
    p.add_argument("--bench-dir", default="reports",
                   help="report directory (default: reports)")
    args = p.parse_args(argv)
    bench_dir = Path(args.bench_dir)

    if args.list:
        if not bench_dir.exists():
            print(f"error: no report directory {bench_dir}", file=sys.stderr)
            return 1
        list_reports(bench_dir, args.filter)
        return 0

    reports = []
    if args.files:
        for f in args.files:
            path = resolve(f, bench_dir)
            reports.append((path, load_report(path)))
        if len(reports) == 1:
            ref = reports[0][1]
            for f in find_reports(bench_dir, args.filter):
                if f != reports[0][0]:
                    rep = load_report(f)
                    if compatible(ref, rep):
                        reports.append((f, rep))
    elif args.latest:
        files = find_reports(bench_dir, args.filter)
        chosen = list(reversed(files[-args.latest:]))
        reports = [(f, load_report(f)) for f in chosen]
    else:
        files = find_reports(bench_dir, args.filter)
        if files:
            ref_path = files[-1]
            ref = load_report(ref_path)
            reports = [(ref_path, ref)] + [
                (f, load_report(f))
                for f in files[:-1]
                if compatible(ref, load_report(f))
            ]

    if len(reports) < 2:
        print("need at least 2 comparable reports (use --list to inspect)",
              file=sys.stderr)
        return 1
    return compare_reports(reports, args.similarity, args.max_regression)


if __name__ == "__main__":
    sys.exit(main())
