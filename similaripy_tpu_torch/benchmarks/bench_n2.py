"""The headline on one card against an N-card mesh.

The counterpart of ``benchmarks/bench_n2.py``: times the ML-32M headline
(item-item ``cosine(item_user, k=100)`` on the raw ratings, the exact int8
build) on one device and on a (1, N) mesh, checks that the mesh result
equals the single device's (equal nnz, ``check_sum`` within 1e-5
relative; a mismatch exits 1), and prints the measured speed-up and
efficiency beside the modeled ones (``scaling_anatomy.anatomy_table`` at
the same geometry: the K2 blocks and K5 scatters of the busiest rank at
the card's rates; the collectives are counted, not timed). ``--stage
scoring`` times the filtered scoring of all users instead,
``dot_product(urm, model_t, k=10, filter_cols=urm, compute_dtype="float32",
precision="high")`` with the model built once, untimed (no model: measured
numbers only). A diagnostic round after the timed ones prints
``engine.splus.last_laps``.

N=1 is the single-device call (``mesh=None``) in this process. The N
ranks are ``torch.multiprocessing.spawn``ed over a ``file://`` store in a
temporary directory: on ``cuda`` one card a rank over NCCL, on ``cpu``
gloo. Every rank makes the same call with ``mesh=make_mesh(1, N)``; rank
0 reports the times.

Usage:
  python -m similaripy_tpu_torch.benchmarks.bench_n2 --n 2     # N cards
  python -m similaripy_tpu_torch.benchmarks.bench_n2 --n 2 --smoke --device cpu
      (a small matrix on N gloo ranks on the CPU: the harness end to end,
       no timing claims)

The report goes to reports/bench_n2_torch_<timestamp>.json (``--out``), with
the JAX harness's keys; on ``cuda`` it also names the card and its power
limit. Exit codes: 0 ok, 1 the mesh result differs, 3 fewer cards than
``--n`` (never a fall back to the CPU or to ranks sharing a card).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp

REPO = Path(__file__).resolve().parent.parent.parent


def check_sum(x) -> float:
    """Tie-robust scalar of a top-k matrix: the sum of its squared row
    sums (tests/oracles.py::check_sum)."""
    aux = np.asarray(sp.csr_array(x).sum(axis=1), dtype=np.float64).ravel()
    return float(np.sum(aux**2))


def _work(cfg: dict, urm, model_t, device):
    """The timed call of the stage, as a function of the mesh."""
    import similaripy_tpu_torch as sim

    if cfg["stage"] == "scoring":
        def work(mesh):
            return sim.dot_product(urm, model_t, k=10, filter_cols=urm,
                                   compute_dtype="float32", precision="high",
                                   verbose=False, mesh=mesh, device=device)
    else:
        item_user = urm.T.tocsr()

        def work(mesh):
            return sim.cosine(item_user, k=cfg["k"], verbose=False, mesh=mesh, device=device)
    return work


def _timed(work, mesh, cfg: dict, n: int, barrier=None, report: bool = True) -> dict:
    """Round 0 untimed, then cfg["rounds"] timed rounds (each started
    together on every rank by `barrier`), then, unless a smoke run, a
    diagnostic round with the engine's timing laps on."""
    from similaripy_tpu_torch.engine import splus

    n_units, unit = cfg["n_units"], cfg["unit"]
    times, out = [], None
    for r in range(cfg["rounds"] + 1):
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        out = work(mesh)
        dt = time.perf_counter() - t0
        if report:
            print(f"# N={n} round {r}: {dt:.2f}s ({n_units / dt:.0f} {unit}/s)", flush=True)
        if r > 0:
            times.append(dt)
    laps = None
    if not cfg["smoke"]:
        splus.TIMING = True
        try:
            work(mesh)
        finally:
            splus.TIMING = False
        laps = dict(splus.last_laps)
        if report:
            print(f"# N={n} diagnostic round laps: {json.dumps(laps)}", flush=True)
    return {"best_s": min(times), "times": times, "nnz": int(out.nnz),
            "check_sum": check_sum(out), "laps": laps}


def _rank(rank: int, n: int, tmp: str, cfg: dict) -> None:
    """One rank of the N-rank world: the stage's call on a (1, N) mesh,
    its record written to `tmp`."""
    import torch
    import torch.distributed as dist

    from similaripy_tpu_torch.parallel import make_mesh

    # one host: NCCL's and gloo's sockets on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if cfg["device"] == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=1800))
    try:
        urm = sp.load_npz(os.path.join(tmp, "urm.npz")).tocsr()
        model_t = (sp.load_npz(os.path.join(tmp, "model_t.npz")).tocsr()
                   if cfg["stage"] == "scoring" else None)
        mesh = make_mesh(1, n)
        rec = _timed(_work(cfg, urm, model_t, device), mesh, cfg, n,
                     barrier=dist.barrier, report=rank == 0)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=2, help="mesh size to measure")
    p.add_argument("--scale", type=float, default=1.0,
                   help="fraction of ML-32M nnz (measured mode)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--stage", default="similarity", choices=["similarity", "scoring"],
                   help="'scoring' measures the filtered recommendation stage "
                        "(users/s) on the mesh instead of the item-item build")
    p.add_argument("--smoke", action="store_true",
                   help="tiny matrix; proves the harness end to end, no timing claims")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: one card a rank over NCCL; cpu: gloo ranks")
    p.add_argument("--out", default=None,
                   help="report path (default reports/bench_n2_torch_<ts>.json)")
    args = p.parse_args(argv)

    import torch

    import similaripy_tpu_torch as sim
    from similaripy_tpu_torch.engine import executor as ex
    from similaripy_tpu_torch.utils.synth import synthetic_urm

    card = None
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < args.n:
            print(f"# bench-n2: need {args.n} cards, have {have} — skipping (exit 3). On a "
                  f"host with {args.n} cards this runs as it is; for a world of gloo ranks "
                  "on the CPU use --smoke --device cpu", flush=True)
            return 3
        from .benchmark import nvidia_smi

        card = nvidia_smi("name,power.limit") or "nvidia-smi unavailable"
    device = torch.device(args.device)

    if args.smoke:
        urm = synthetic_urm(n_users=3000, n_items=800, nnz=40_000, seed=0)
    else:
        from similaripy_tpu_torch.utils.npz_cache import cached_npz
        from similaripy_tpu_torch.utils.synth import ML32M_ITEMS, ML32M_NNZ, ML32M_USERS

        urm, _ = cached_npz(
            str(REPO / f".bench_data_{args.scale}.npz"),
            lambda: synthetic_urm(nnz=int(ML32M_NNZ * args.scale)),
            expect_shape=(ML32M_USERS, ML32M_ITEMS),
        )
    urm = sp.csr_array(urm, dtype=np.float32)
    item_user = urm.T.tocsr()
    C, U = item_user.shape
    print(f"# bench-n2: {C} items x {U} users, nnz={item_user.nnz:,}, device={args.device}"
          f"{f' ({card})' if card else ''}, mesh sizes [1, {args.n}]", flush=True)

    model_t = None
    if args.stage == "scoring":
        # the model is built once, untimed, on one device; each mesh size
        # times the filtered scoring of ALL users
        model = sim.cosine(item_user, k=args.k, verbose=False, device=device)
        model_t = model.T.tocsr()
        cfg_units = (urm.shape[0], "users")
    else:
        cfg_units = (C, "items")
    cfg = {"stage": args.stage, "k": args.k, "rounds": args.rounds, "smoke": args.smoke,
           "device": args.device, "n_units": cfg_units[0], "unit": cfg_units[1]}

    results = {1: _timed(_work(cfg, urm, model_t, device), None, cfg, 1)}
    plan = {k: v for k, v in ex.last_plan.items()
            if isinstance(v, (int, float, str, type(None)))}
    ranks_agree = True
    if args.n != 1:
        sim.clear_caches()  # the ranks take the card(s) next
        if args.device == "cuda":
            torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="bench_n2_") as tmp:
            sp.save_npz(os.path.join(tmp, "urm.npz"), urm, compressed=False)
            if model_t is not None:
                sp.save_npz(os.path.join(tmp, "model_t.npz"), model_t, compressed=False)
            torch.multiprocessing.spawn(_rank, args=(args.n, tmp, cfg), nprocs=args.n,
                                        join=True)
            recs = []
            for r in range(args.n):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    recs.append(json.load(f))
        # every rank returns the whole result
        ranks_agree = all((r["nnz"], r["check_sum"]) == (recs[0]["nnz"], recs[0]["check_sum"])
                          for r in recs)
        results[args.n] = recs[0]

    # exactness: the mesh must reproduce the single device's result
    r1, rN = results[1], results[args.n]
    check_ok = ranks_agree and rN["nnz"] == r1["nnz"] and (
        abs(rN["check_sum"] - r1["check_sum"]) <= 1e-5 * max(abs(r1["check_sum"]), 1.0))
    speedup = r1["best_s"] / rN["best_s"]
    efficiency = speedup / args.n

    m1 = mN = None
    if args.stage == "similarity":
        # the schedule-replay model covers the symmetric executor only
        from .scaling_anatomy import anatomy_table

        dtype = "split" if plan.get("f32x3") else plan["compute_dtype"]
        table = anatomy_table(C=C, U=U, nnz=int(item_user.nnz), n_list=(1, args.n),
                              budget=plan["budget"], compute_dtype=dtype, k=args.k)
        modeled = {r["N"]: r for r in table["mesh_sizes"]}
        m1, mN = modeled[1], modeled[args.n]
        pl = table["plan"]
        print(f"# modeled per-stage seconds (schedule replay x the card's K2/K5 rates; "
              f"{dtype}, tc {pl['tc']}, gt {pl['gt']}, {pl['n_tiles']} tiles; measured plan: "
              f"tc {plan.get('tc')}, gt {plan.get('gt')}):", flush=True)
        for n, m in ((1, m1), (args.n, mN)):
            s = m["modeled_seconds"]
            print(f"#   N={n}: K2 {s['k2']:.2f}  K5 {s['k5']:.2f}  total {s['total']:.2f}  "
                  f"(collectives {max(m['collectives'])}, "
                  f"{m['collective_bytes_per_rank']['sent']:,} bytes sent a rank, not timed)",
                  flush=True)
    modeled_note = (f" (modeled {mN['modeled_speedup_vs_1']:.2f}x / "
                    f"{mN['modeled_efficiency']:.1%})" if mN is not None else "")
    print(f"# measured: 1dev {r1['best_s']:.2f}s, {args.n}dev {rN['best_s']:.2f}s -> speedup "
          f"{speedup:.2f}x, efficiency {efficiency:.1%}{modeled_note}; check_sum "
          f"{'OK' if check_ok else 'MISMATCH'}", flush=True)

    out = args.out or str(REPO / "reports"
                          / f"bench_n2_torch_{time.strftime('%Y%m%d_%H%M%S')}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump({
            "mode": "smoke" if args.smoke else "measured",
            "stage": args.stage,
            "backend": args.device,
            "card": card,
            "n": args.n,
            "k": args.k,
            "geometry": {"C": C, "U": U, "nnz": int(item_user.nnz)},
            "plan": plan,
            "best_s": {str(n): r["best_s"] for n, r in results.items()},
            "nnz": {str(n): r["nnz"] for n, r in results.items()},
            "check_sum": {str(n): r["check_sum"] for n, r in results.items()},
            "laps": {str(n): r["laps"] for n, r in results.items()},
            "measured_speedup": speedup,
            "measured_efficiency": efficiency,
            "modeled_speedup": mN["modeled_speedup_vs_1"] if mN is not None else None,
            "modeled_efficiency": mN["modeled_efficiency"] if mN is not None else None,
            "modeled_seconds": ({"1": m1["modeled_seconds"],
                                 str(args.n): mN["modeled_seconds"]}
                                if mN is not None else None),
            "check_sum_ok": bool(check_ok),
        }, f, indent=2)
        f.write("\n")
    print(f"# report: {out}", flush=True)
    return 0 if check_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
