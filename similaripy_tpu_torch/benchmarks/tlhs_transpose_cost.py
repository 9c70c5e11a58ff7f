"""What the int8 transposes cost in P1, on a CUDA card.

    python -m similaripy_tpu_torch.benchmarks.tlhs_transpose_cost [--reps 5] [--rounds 3]

P1's int8 call (``csrc/probe_tlhs.cu``) transposes both operands in a
K-major pass of its own (``csrc/kmajor.cuh``) and then runs ``wgmma`` s8 on
the K-major tiles; the script times the call, the pass on each operand and
the product alone (``probes.s8_kmajor_product``), interleaved in each
round, and checks that the call and the product alone equal P1's plain
version. On one int8 block of K2's full-width shape (K = u_pad 200,960, M
= N = 4,096, values in [-5, 5]); each reading is the mean of ``reps``
calls by CUDA events. (K2's own int8 product reads K-major tiles that K5
writes, so it transposes nothing.) Prints one JSON line: the card, P1's
medians and readings under ``p1`` (the passes' share of the call). Needs a
card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

SHAPE = (200_960, 4096, 4096)  # (K, M, N): K2's int8 block at full width


def _mean_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _p1_pieces(runs: dict, reps: int, rounds: int) -> dict:
    """The medians of P1's call and its pieces, each timed in every round."""
    readings = {name: [] for name in runs}
    for _ in range(rounds):
        for name, fn in runs.items():
            readings[name].append(_mean_ms(fn, reps))
    med = {f"{name}_ms": float(np.median(r)) for name, r in readings.items()}
    med["passes_share"] = (med["pass_a_ms"] + med["pass_b_ms"]) / med["call_ms"]
    return {**med, "readings_ms": readings}


def run(reps: int = 5, rounds: int = 3) -> dict:
    from . import probes

    dev = torch.device("cuda")
    K, M, N = SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randint(-5, 6, (K, M), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-5, 6, (K, N), generator=gen, device=dev, dtype=torch.int8)

    ref = probes.transposed_lhs_product_plain(a, b)
    probes.reset_counts()
    if not torch.equal(probes.transposed_lhs_product(a, b), ref):
        raise AssertionError("P1 int8 differs from its plain version")
    if probes.tlhs_counts.last_kernel != "wgmma s8":
        raise AssertionError(f"P1 int8 took {probes.tlhs_counts.last_kernel}, not wgmma s8")
    at, bt = probes.kmajor_pass(a), probes.kmajor_pass(b)
    if not torch.equal(probes.s8_kmajor_product(at, bt, M, N), ref):
        raise AssertionError("P1's int8 product on the K-major pass's output differs")
    del ref
    torch.cuda.synchronize()

    ops = 2.0 * K * M * N
    p1 = _p1_pieces({"call": lambda: probes.transposed_lhs_product(a, b),
                     "pass_a": lambda: probes.kmajor_pass(a),
                     "pass_b": lambda: probes.kmajor_pass(b),
                     "product": lambda: probes.s8_kmajor_product(at, bt, M, N)}, reps, rounds)
    p1["product_tops"] = ops / p1["product_ms"] / 1e9
    p1["call_tops"] = ops / p1["call_ms"] / 1e9
    return {"shape": {"K": K, "M": M, "N": N, "dtype": "int8"}, "reps": reps, "p1": p1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tlhs_transpose_cost: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res = run(args.reps, args.rounds)
    print(json.dumps({"device": smi.splitlines()[0] if smi else None, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
