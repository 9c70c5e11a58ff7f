"""Sharded symmetric schedule: per-rank work at N cards, with modeled seconds.

The counterpart of ``benchmarks/scaling_anatomy.py``, on the port's own
schedule and the card's own rates. For each N it plans the geometry with
the symmetric executor's planner (``engine/symmetric.py::_plan``) and
replays the schedule the executor walks on a mesh
(``engine/sym_sharded.py::schedule_anatomy``, with its ``pair_schedule``
and ``rank_work``; no second schedule): the K2 blocks, K5 scatters and
collectives of every rank, the busiest rank's 1/N speed-ups, and its
modeled seconds by the planner's own cost model,

    K2 blocks x (gt tc) tc u_pad 2 / symmetric._PRODUCT_RATE[dtype]
  + K5 tiles x nnz_tile / symmetric._DENSIFY_NNZ_RATE[dtype],

so the table and the planner cannot disagree: summed over the ranks, the
K2 blocks and K5 tiles are the planner's ``_triangle_counts``. A K5 tile
is one tile's densify: an inner tile's scatter is one, an anchor group's
(one scatter) is gt; with gt 1 the K5 tiles are the K5 scatters. The
collectives move only the (rows x k) top-k partials of a finished pair
(``parallel/mesh.py``): the table gives their count and bytes per rank
and models no time for them, as no rate between cards has been measured.
Deterministic host logic: no card needed.

Usage: python -m similaripy_tpu_torch.benchmarks.scaling_anatomy
           [--out reports/scaling_anatomy_torch.json]

writes the int8 headline build's table (``anatomy_table`` takes the other
compute types).
"""

from __future__ import annotations

import argparse
import json
import math
import os

from ..engine import symmetric
from ..engine.sym_sharded import pair_schedule, rank_work, schedule_anatomy

# ML-32M item-item geometry: C items x U users, the ratings of the tracked
# .bench_data_1.0.npz
ML32M = {"C": 84_432, "U": 200_948, "nnz": 31_468_483}

# The device budget every row plans with, fixed so the table is the same
# on every host: about what an H100 80GB leaves the planner
# (utils/device.py::hbm_budget_bytes: free memory less the 2 GiB reserve)
# before a call. With it the N=1 rows reproduce the plans of chip_smoke.py
# on the card (PERF.md section 5): int8 tc 4,096, gt 1, 21 tiles, K2 231,
# K5 121; f32 tc 2,048, gt 1, 42 tiles, K2 903, K5 462; split-bf16x3
# ('high') gt 2, K2 462, K5 221.
BUDGET = 72 << 30

# Bytes of one top-k entry in a collective: an f32 value and an int32 id
# packed together (parallel/mesh.py::_pack).
ENTRY_BYTES = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def k5_tiles(n_tiles: int, gt: int, N: int) -> list:
    """Each rank's K5 work in tiles: gt for every anchor group it
    densifies, one for every inner tile."""
    tiles = [0] * N
    for pair, steps in pair_schedule(n_tiles, gt, N):
        for rank in range(N):
            _mine, anchors, inner = rank_work(pair, steps, gt, rank)
            tiles[rank] += len(anchors) * gt + inner
    return tiles


def anatomy_table(C: int, U: int, nnz: int, n_list=(1, 2, 4, 8), budget: int = BUDGET,
                  compute_dtype: str = "int8", k: int = 100) -> dict:
    """Per-rank counts and modeled seconds of the symmetric build of a
    (C x U, nnz) matrix in `compute_dtype` ("int8", "float32", "bfloat16"
    or "split", the split-bf16x3 mode that plans twice the COO entries) for
    each mesh size in `n_list`."""
    k_pad = _round_up(min(k, C), 8)
    plan_nnz = nnz * (2 if compute_dtype == "split" else 1)
    tc, gt, u_pad = symmetric._plan(C, U, plan_nnz, compute_dtype, budget, k_pad)
    n_real = math.ceil(C / tc)
    n_tiles = math.ceil(n_real / gt) * gt
    t_block = (gt * tc) * tc * u_pad * 2 / symmetric._PRODUCT_RATE[compute_dtype]
    t_tile = plan_nnz / n_real / symmetric._DENSIFY_NNZ_RATE[compute_dtype]
    # a pair's rows are all-gathered once; over the schedule every device
    # slot's row is, k entries each; plus the budget agreement's one int64
    topk_bytes = n_tiles * tc * min(k, C) * ENTRY_BYTES

    rows = []
    base = None
    for n in n_list:
        a = schedule_anatomy(n_tiles=n_tiles, gt=gt, N=n)
        a["k5_tiles"] = k5_tiles(n_tiles, gt, n)
        k2_max, k5_max = max(a["k2_blocks"]), max(a["k5_scatters"])
        # the busiest rank's time: the largest of the ranks' sums
        t_k2, t_k5 = max(((b * t_block, s * t_tile)
                          for b, s in zip(a["k2_blocks"], a["k5_tiles"])), key=sum)
        total = t_k2 + t_k5
        if base is None:
            base = (k2_max, k5_max, total)
        sent = topk_bytes + 8 if n > 1 else 0
        rows.append({
            **a,
            "k2_blocks_max_rank": k2_max,
            "k5_scatters_max_rank": k5_max,
            "k2_speedup_vs_1": base[0] / max(k2_max, 1),
            "k5_speedup_vs_1": base[1] / max(k5_max, 1),
            "collective_bytes_per_rank": {"sent": sent, "received": (n - 1) * sent},
            "modeled_seconds": {"k2": t_k2, "k5": t_k5, "total": total},
            "modeled_speedup_vs_1": base[2] / total,
            "modeled_efficiency": base[2] / total / n,
            "k5_time_fraction": t_k5 / total,
        })
    return {
        "geometry": {"C": C, "U": U, "nnz": nnz},
        "plan": {"compute_dtype": compute_dtype, "tc": tc, "gt": gt, "u_pad": u_pad,
                 "n_tiles": n_tiles, "k": k, "k_pad": k_pad, "budget": budget},
        "seconds_per_unit": {"k2_block": t_block, "k5_tile": t_tile},
        "collective_seconds": "not modeled: no rate between cards measured",
        "mesh_sizes": rows,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="reports/scaling_anatomy_torch.json")
    args = p.parse_args(argv)

    table = anatomy_table(**ML32M)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=2)
        f.write("\n")

    pl = table["plan"]
    print(f"# {pl['compute_dtype']}: tc {pl['tc']}, gt {pl['gt']}, {pl['n_tiles']} tiles, "
          f"u_pad {pl['u_pad']}")
    print(f"{'N':>3} {'K2/rank':>8} {'K5/rank':>8} {'coll/rank':>10} {'MB sent':>8} "
          f"{'modeled-s':>10} {'speedup':>8} {'eff':>6} {'K5-frac':>8}")
    for r in table["mesh_sizes"]:
        print(
            f"{r['N']:>3} {r['k2_blocks_max_rank']:>8} {r['k5_scatters_max_rank']:>8} "
            f"{max(r['collectives']):>10} "
            f"{r['collective_bytes_per_rank']['sent'] / 1e6:>8.1f} "
            f"{r['modeled_seconds']['total']:>10.2f} "
            f"{r['modeled_speedup_vs_1']:>8.2f} "
            f"{r['modeled_efficiency']:>6.1%} "
            f"{r['k5_time_fraction']:>8.1%}"
        )
    print(f"written to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
