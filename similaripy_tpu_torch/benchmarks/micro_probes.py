"""The probes P1 and P2 at their card shapes, in one or more checkouts on
one CUDA card, in turns.

    python -m similaripy_tpu_torch.benchmarks.micro_probes [ROOT ...]

Times (median of 5 after a warm-up, CUDA events) P1
(``probes.transposed_lhs_product``) at K2's full-width block (K = u_pad
200,960; M = N = 4,096 in int8, 2,048 in bf16 and f32), on seeded values
in [-5, 5] made on the card, each call first checked bit-equal to the plain
version; bf16 once more with 98% of the values zeroed (``bfloat16_sparse``:
the density of ``micro_bf16_products``'s K2 tiles, whose product is P1
bf16's code); then P2 (``micro_int4.probe``: int8 and s4 at 512 x 2,048 x 512,
512 steps, best of 3 rounds of 10 calls, exact against the oracle times
steps). Each ROOT (a checkout's root; the default is this one) runs in a
process of its own that builds its own kernels, in the order A, B, ..., B,
A, so that every root sees the card alike. Prints one JSON line per turn:
per call the ms, the TOP/s (2 x M x N x K, times steps for P2) and the
product kernel the call took (where the checkout names it); then the
card's name and power limit. Needs a card; exits 1 without one. To compare
a change, unpack the other tree with ``git archive`` into a git-ignored
directory and pass both roots.
"""

from __future__ import annotations

import os
import subprocess
import sys

# one turn: the checkout at argv[1]
_TURN = r"""
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np, torch
from similaripy_tpu_torch.benchmarks import micro_int4 as mi4, probes as pr
from similaripy_tpu_torch.engine import build

t0 = time.perf_counter()
build.load()
out = {"root": root, "build_s": time.perf_counter() - t0}
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(0)


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def last_kernel(counts):
    return getattr(counts, "last_kernel", None)


def operand(rows, cols, tdt, density):
    x = torch.randint(-5, 6, (rows, cols), generator=gen, device=dev, dtype=torch.int8)
    if density < 1:
        x *= torch.rand((rows, cols), generator=gen, device=dev) < density
    return x.to(tdt)


for dtype, (K, M, N), density in (
        ("int8", (200960, 4096, 4096), 1.0), ("bfloat16", (200960, 2048, 2048), 1.0),
        ("bfloat16_sparse", (200960, 2048, 2048), 0.02), ("float32", (200960, 2048, 2048), 1.0)):
    tdt = getattr(torch, dtype.split("_")[0])
    a, b = operand(K, M, tdt, density), operand(K, N, tdt, density)
    if not torch.equal(pr.transposed_lhs_product(a, b), pr.transposed_lhs_product_plain(a, b)):
        raise AssertionError(f"P1 {dtype} differs from its plain version")
    out[f"P1_{dtype}_kernel"] = last_kernel(pr.tlhs_counts)
    out[f"P1_{dtype}_ms"] = time_ms(lambda: pr.transposed_lhs_product(a, b))
    out[f"P1_{dtype}_tops"] = 2.0 * K * M * N / out[f"P1_{dtype}_ms"] / 1e9
    del a, b
    torch.cuda.empty_cache()
for mode in ("int8", "s4"):
    r = mi4.probe(mode, mi4.STEPS, mi4.REPS, dev)
    if not r["exact"]:
        raise AssertionError(f"P2 {mode} differs from the oracle")
    out[f"P2_{mode}_kernel"] = last_kernel(pr.int_mma_counts)
    out[f"P2_{mode}_ms"], out[f"P2_{mode}_tops"] = r["ms"], r["tops"]
print(json.dumps(out))
"""


def main(argv=None) -> int:
    import torch

    roots = (argv if argv is not None else sys.argv[1:]) or [
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
    if not torch.cuda.is_available():
        print("micro_probes: needs a CUDA card", file=sys.stderr)
        return 1
    for root in roots + roots[::-1]:
        p = subprocess.run([sys.executable, "-c", _TURN, os.path.abspath(root)],
                           capture_output=True, text=True)
        if p.returncode:
            print(p.stdout[-2000:], p.stderr[-4000:], file=sys.stderr)
            return 1
        print(p.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
