"""Benchmark CLI runner of the port.

    python -m similaripy_tpu_torch.benchmarks.run_benchmarks --dataset movielens_32m \\
        --similarities dot_product cosine rp3beta --k 100 --rounds 3 \\
        --output-dir reports [--device cuda]

Port of ``benchmarks/run_benchmarks.py`` (reference:
tests/benchmarks/run_benchmarks.py:434-512): pick a dataset and a set of
similarities, run rounds, print a summary table, write JSON/text reports
with the original's keys (``benchmarks/compare_benchmarks.py`` and the
port's copy of it read them; ``bench_gate.py`` gates on them).

`--stage scoring` times the pipeline's SECOND half (reference: notebooks
cell 37 / README.md:86-94): build the item-item model once untimed, then
time `dot_product(urm, W.T, k=--scoring-k, filter_cols=urm)` over all
users. Throughput is users scored per second. `--device` defaults to
`cuda` and raises without a card; `cpu` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from datetime import datetime, timezone

import similaripy_tpu_torch as sim

from ..utils.device import resolve_device
from .benchmark import benchmark_scoring, benchmark_similarity, system_info
from .dataset_loaders import DATASETS, load_urm

SIMILARITIES = {
    "dot_product": lambda m, **kw: sim.dot_product(m, **kw),
    "cosine": lambda m, **kw: sim.cosine(m, **kw),
    "asymmetric_cosine": lambda m, **kw: sim.asymmetric_cosine(m, alpha=0.5, **kw),
    "jaccard": lambda m, **kw: sim.jaccard(m, binary=True, **kw),
    "dice": lambda m, **kw: sim.dice(m, binary=True, **kw),
    "tversky": lambda m, **kw: sim.tversky(m, alpha=1.0, beta=1.0, binary=True, **kw),
    "p3alpha": lambda m, **kw: sim.p3alpha(m, alpha=1.0, **kw),
    "rp3beta": lambda m, **kw: sim.rp3beta(m, alpha=1.0, beta=0.6, **kw),
    "s_plus": lambda m, **kw: sim.s_plus(m, l1=0.5, l2=0.5, **kw),
}


def format_summary_table(results: list) -> str:
    header = (
        f"{'similarity':<20}{'mean (s)':>10}{'std':>8}{'best (s)':>10}"
        f"{'items/s':>12}{'out nnz':>14}{'avg nbrs':>10}"
    )
    lines = [header, "-" * len(header)]
    for r in results:
        lines.append(
            f"{r.name:<20}{r.mean_s:>10.2f}{r.std_s:>8.2f}{r.best_s:>10.2f}"
            f"{r.throughput_items_s:>12.1f}{r.output_nnz:>14,}{r.avg_neighbors:>10.1f}"
        )
    return "\n".join(lines)


def write_reports(results, args, info, provenance, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    stamp = datetime.now(timezone.utc).strftime("%Y%m%d_%H%M%S")
    stage = getattr(args, "stage", "similarity")
    tag = f"{args.dataset}_scoring" if stage == "scoring" else args.dataset
    base = os.path.join(out_dir, f"benchmark_{tag}_{stamp}")
    n = 1
    while os.path.exists(base + ".json"):  # same-second runs must not clobber
        n += 1
        base = os.path.join(out_dir, f"benchmark_{tag}_{stamp}_{n}")
    payload = {
        "dataset": args.dataset,
        "stage": stage,
        "provenance": provenance,
        "k": args.k,
        "rounds": args.rounds,
        "system": info,
        "results": [r.to_dict() for r in results],
    }
    with open(base + ".json", "w") as f:
        json.dump(payload, f, indent=2)
    with open(base + ".txt", "w") as f:
        f.write(f"dataset: {args.dataset} ({provenance})\n")
        f.write(f"stage={stage} k={args.k} rounds={args.rounds}\n\n")
        f.write(format_summary_table(results) + "\n")
    return base + ".json"


def _positive_int(s):
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _nonneg_int(s):
    v = int(s)
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {v}")
    return v


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="synthetic_small", choices=sorted(DATASETS))
    p.add_argument("--data-path", default=None,
                   help="local ratings.csv or sparse .npz overriding the dataset")
    p.add_argument("--similarities", nargs="+",
                   default=["dot_product", "cosine", "rp3beta"],
                   choices=sorted(SIMILARITIES))
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--stage", default="similarity",
                   choices=["similarity", "scoring"],
                   help="'similarity': time the item-item model build "
                        "(reference protocol). 'scoring': build each "
                        "model once untimed, then time "
                        "dot_product(urm, W.T, k=--scoring-k, "
                        "filter_cols=urm) over ALL users — the reference "
                        "pipeline's recommendation stage; throughput is "
                        "users/s")
    p.add_argument("--scoring-k", type=int, default=10,
                   help="recommendations per user in --stage scoring "
                        "(the model build uses --k)")
    p.add_argument("--rounds", type=_positive_int, default=3)
    p.add_argument("--warmup", type=_nonneg_int, default=1)
    p.add_argument("--output-dir", default="reports")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of each benchmark's timed "
                        "rounds here (<name>.json, Chrome trace format)")
    p.add_argument("--compute-dtype", default="auto",
                   choices=["auto", "float32", "bfloat16", "int8"])
    p.add_argument("--precision", default="highest",
                   choices=["default", "high", "highest"],
                   help="float32 matmul precision; 'high' runs the "
                        "split-bf16x3 products on the tensor cores")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    info = system_info(dev)
    print(f"# backend: {info.get('backend')}, devices: {info.get('devices')}, "
          f"power limit: {info.get('gpu_power_limit', 'n/a')}")

    t0 = time.perf_counter()
    urm, provenance = load_urm(args.dataset, args.data_path)
    print(f"# loaded {provenance}: {urm.shape[0]}x{urm.shape[1]} nnz={urm.nnz:,} "
          f"({time.perf_counter() - t0:.1f}s, untimed)")
    item_user = urm.T.tocsr()  # item-item similarity input (reference protocol)
    common = dict(compute_dtype=args.compute_dtype, precision=args.precision, device=dev)

    results = []
    for name in args.similarities:
        if args.stage == "scoring":
            print(f"# building {name} model (k={args.k}, untimed)...")
            t0 = time.perf_counter()
            model = SIMILARITIES[name](item_user, k=args.k, verbose=False, **common).T.tocsr()
            print(f"#   built in {time.perf_counter() - t0:.1f}s "
                  f"(nnz={model.nnz:,})")
            print(f"# scoring all {urm.shape[0]:,} users "
                  f"(k={args.scoring_k}, filter_cols=urm, "
                  f"{args.rounds} rounds)...")
            r = benchmark_scoring(
                lambda m, model=model, **kw: sim.dot_product(
                    m, model, filter_cols=m, **kw
                ),
                urm,
                name=f"scoring[{name}]",
                k=args.scoring_k,
                rounds=args.rounds,
                warmup=args.warmup,
                profile_dir=args.profile_dir,
                **common,
            )
            unit = "users/s"
        else:
            print(f"# running {name} (k={args.k}, {args.rounds} rounds)...")
            r = benchmark_similarity(
                SIMILARITIES[name],
                item_user,
                name=name,
                k=args.k,
                rounds=args.rounds,
                warmup=args.warmup,
                profile_dir=args.profile_dir,
                **common,
            )
            unit = "items/s"
        results.append(r)
        print(f"#   {r.mean_s:.2f}s ± {r.std_s:.2f} "
              f"({r.throughput_items_s:.0f} {unit})")

    print()
    print(format_summary_table(results))
    path = write_reports(results, args, info, provenance, args.output_dir)
    print(f"\nreport: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
