"""The int8 / int4 tensor-core rate probe (P2) on a CUDA card.

Port of ``benchmarks/micro_int4.py``. Run:

    python -m similaripy_tpu_torch.benchmarks.micro_int4 [--steps 512] [--reps 10]

For each mode (int8, then s4: the same int8 values multiplied as int4,
cast inside the kernel) it runs ``probes.int_rate_product``: ``steps``
products of one fixed (512 x 2,048) x (2,048 x 512) int8 pair added into
one int32 output. The values are ``arange(...) % 15 - 7``, in [-7, 7], so
the s4 cast loses nothing and both modes compute the same product. The
result must equal the int32 oracle times ``steps`` exactly. The time is
the best of 3 rounds of ``reps`` calls, by CUDA events; the rate is
``2 * M * K * N * steps / time``, and the rate bound the time the card's
dense int8 peak (1,979 TOP/s, H100 SXM data sheet) would take for the
``steps`` products. (The function itself, ``steps * A . B``, needs only
one product; the probe repeats it to measure the rate.) Prints the product
kernel each mode ran (int8 ``wgmma s8`` after the K-major pass, s4
``mma.sync s4``), ms per call, TOP/s, the rate bound and the s4/int8 ratio.
``--device cpu`` checks exactness only (the plain version; no timing).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

M, K, N = 512, 2048, 512
STEPS = 512
REPS = 10
PEAK_INT8_OPS = 1979e12  # H100 SXM, dense, at the 700 W limit


def inputs(device, m=M, k=K, n=N):
    a = torch.from_numpy((np.arange(m * k).reshape(m, k) % 15 - 7).astype(np.int8))
    b = torch.from_numpy((np.arange(k * n).reshape(k, n) % 15 - 7).astype(np.int8))
    return a.to(device), b.to(device)


def bound_ms(m, k, n, steps) -> float:
    return 1e3 * 2.0 * m * k * n * steps / PEAK_INT8_OPS


def best_ms(fn, reps: int, rounds: int = 3) -> float:
    """Best of `rounds` rounds of `reps` calls, per call, by CUDA events."""
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def probe(mode: str, steps: int = STEPS, reps: int = REPS, device="cuda", shape=(M, K, N)):
    """One mode: exactness against the oracle and, on a card, the best
    time. Returns a dict (ms, tops None on the CPU)."""
    from .probes import int_mma_counts, int_rate_product

    m, k, n = shape
    a, b = inputs(device, m, k, n)
    out = int_rate_product(a, b, steps, mode)
    on_card = torch.device(device).type == "cuda"
    kernel = int_mma_counts.last_kernel if on_card else None  # the CPU runs the plain version
    oracle = (a.cpu().numpy().astype(np.int64) @ b.cpu().numpy().astype(np.int64)) * steps
    got = out.cpu().numpy()
    exact = bool(np.array_equal(got, oracle))
    res = {"mode": mode, "kernel": kernel, "shape": [m, k, n], "steps": steps, "exact": exact,
           "max_abs_diff": int(np.max(np.abs(got - oracle))) if got.size else 0,
           "ms": None, "tops": None, "bound_ms": bound_ms(m, k, n, steps)}
    if exact and on_card:
        ms = best_ms(lambda: int_rate_product(a, b, steps, mode), reps)
        res["ms"] = ms
        res["tops"] = 2.0 * m * k * n * steps / ms / 1e9
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (exactness only)")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name} M={M} K={K} N={N} steps={args.steps} "
          f"rate bound {bound_ms(M, K, N, args.steps):.3f} ms", flush=True)
    rates = {}
    for mode in ("int8", "s4"):
        r = probe(mode, args.steps, args.reps, dev)
        if not r["exact"]:
            print(f"# {mode}: WRONG RESULT (max abs diff {r['max_abs_diff']})", flush=True)
            return 1
        if r["ms"] is None:
            print(f"# {mode}: exact (time not measured on the CPU)", flush=True)
            continue
        rates[mode] = r["tops"]
        print(f"# {mode} ({r['kernel']}): {r['ms']:.4f} ms/call -> {r['tops']:.1f} TOP/s "
              f"(rate bound {r['bound_ms']:.4f} ms)", flush=True)
    if len(rates) == 2:
        print(f"# verdict: s4 is {rates['s4'] / rates['int8']:.2f}x int8", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
