"""K1's and K2's bf16 tensor-core products at the main path's shapes, in
one or more checkouts on one CUDA card, in turns.

    python -m similaripy_tpu_torch.benchmarks.micro_bf16_products [ROOT ...]

Times (median of 5 after a warm-up, CUDA events) the kernels that
``precision='high'`` and ``compute_dtype='bfloat16'`` run: K2 on a live
block (sw = tc = 2,048, u_pad 200,960) in bf16 and in the split-bf16x3
mode 'both'; K1 on the 1,024-item cosine tile (trp 1,024, u_pad 200,960,
tc 7,040) in bf16 and 'both', and on the recommend tile (u_pad 84,480, tc
7,680) in 'rhs'. Operands are seeded uniform values at the main path's
densities, made on the card; the product kernels' time does not depend on
the values. Each ROOT (a checkout's root; the default is this one) runs in
a process of its own that builds its own kernels, in the order A, B, ...,
B, A, so that every root sees the card alike. Prints one JSON line per
turn: per call the ms, the TFLOP/s of its bf16 products (2 x rows x
columns x depth x phases over the call's ms), the product kernels that
launched (``product_launches``, where the checkout counts them) and the
product kernel's registers, spills, shared memory and blocks per SM; then
the card's name and power limit. Needs a card; exits 1 without one. To
compare a change, unpack the other tree with ``git archive`` into a
git-ignored directory and pass both roots.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# one turn: the checkout at argv[1]
_TURN = r"""
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np, torch
from similaripy_tpu_torch.engine import build, sym_topk as st, tile_topk as tt

t0 = time.perf_counter()
build.load()
out = {"root": root, "build_s": time.perf_counter() - t0}
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(0)


def sparse(shape, density):
    x = torch.rand(shape, device=dev, generator=gen)
    keep = torch.rand(shape, device=dev, generator=gen) < density
    return torch.where(keep, x, torch.zeros((), device=dev))


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


def carry(k_pad, width):
    return (torch.full((k_pad, width), float("-inf"), device=dev),
            torch.zeros((k_pad, width), dtype=torch.int32, device=dev))


# the product kernels of the module's launches since its counts were set
# to 0; None where the checkout does not count them
def products(mod):
    counts = getattr(mod, "product_launches", None)
    return {k: n for k, n in counts.items() if n} if counts is not None else None


def run(key, mod, fn, flops):
    mod.reset_counts()
    fn()
    out[f"{key}_products"] = products(mod)
    out[f"{key}_ms"] = time_ms(fn)
    out[f"{key}_tflops"] = flops / out[f"{key}_ms"] / 1e9


flags = (False, True, False, False, False, True)  # cosine
k, k_pad = 100, 104
pv = torch.zeros(16, device=dev)
pv[2] = pv[4] = pv[5] = pv[9] = 1.0

# K2: anchor tile 0 against tile 1, every anchor row live on both sides
u, tc = 200960, 2048
items = sparse((u, 2 * tc), 0.02)
pv2 = pv.clone()
pv2[10:14] = torch.tensor([tc, 0, 1, 0], dtype=torch.float32, device=dev)
ones = torch.ones(tc, device=dev)
for mode in ("bf16", "split"):
    split = mode == "split"
    a, d = items[:, :tc].contiguous(), items[:, tc:].contiguous()
    a, d = (tt.split_bf16x3(a, 0), tt.split_bf16x3(d, 0)) if split else (a.bfloat16(), d.bfloat16())
    crv, cri = carry(k_pad, tc)
    ccv, cci = carry(k_pad, tc)
    args = (a[None], d, ones, ones, ones, ones, ones, ones, crv, cri, crv[k_pad - 1].view(tc, 1),
            ccv, cci, pv2)
    kw = dict(flags=flags, k=k, tc=tc, int8_mode=False, split_f32=split)
    run(f"K2_{mode}", st, lambda: st.fused_sym_topk(*args, **kw),
        2.0 * tc * tc * u * (3 if split else 1))
    out[f"K2_{mode}_attrs"] = st.product_attrs(torch.bfloat16, split=split)
    del a, d, args
del items

# K1: the cosine tile in bf16 and 'both', the recommend tile in 'rhs'
for name, trp, u, tc, split in (("K1_bf16", 1024, 200960, 7040, None),
                                ("K1_both", 1024, 200960, 7040, "both"),
                                ("K1_rhs", 1024, 84480, 7680, "rhs")):
    a32, d32 = sparse((trp, u), 0.05), sparse((u, tc), 0.01)
    a = tt.split_bf16x3(a32, 1) if split in ("both", "lhs") else a32.bfloat16()
    d = tt.split_bf16x3(d32, 0) if split in ("both", "rhs") else d32.bfloat16()
    del a32, d32
    ones_r, ones_c = torch.ones(trp, device=dev), torch.ones(tc, device=dev)
    kw = dict(carry=carry(k_pad, trp), flags=flags, k_pad=k_pad, int8_mode=False,
              split_f32=split or False)
    run(name, tt, lambda: tt.fused_tile_topk(
        a, d, ones_r, ones_r, ones_r, ones_c, ones_c, ones_c, pv, **kw),
        2.0 * trp * u * tc * {None: 1, "both": 3, "rhs": 2}[split])
    out[f"{name}_attrs"] = tt.product_attrs(torch.bfloat16, split=split)
    del a, d
print(json.dumps(out))
"""


def main(argv=None) -> int:
    import torch

    roots = (argv if argv is not None else sys.argv[1:]) or [
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
    if not torch.cuda.is_available():
        print("micro_bf16_products: needs a CUDA card", file=sys.stderr)
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
