"""How close K1's products come to float64 on a CUDA card, by mode.

    python -m similaripy_tpu_torch.benchmarks.split_accuracy

For seeded f32 operands (M = N = 256) at a few depths and densities, one
signed, runs K1 (``tile_topk.fused_tile_topk``) with the raw-product
epilogue and k_pad = N, so that every product of the tile comes out, in
true f32 (the SIMT kernel), in bf16 (the operands rounded), in the
split-bf16x3 mode 'both' (precision='high'), and the plain version of
'both' (library products, summed phase by phase). Each is held against the
float64 product of the operands it was given (bf16: of the rounded
operands). Prints one JSON line per case with the largest, the mean and
the mean signed relative error of each, and the card's name and power
limit. It shows what the tensor core's own accumulation and the kernels'
per-slab partial sums cost against the f32 SIMT loop and the library.
Needs a card; exits 1 without one.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

# (label, K, density, signed values)
CASES = (("pos-K65536-d30", 65536, 0.3, False), ("signed-K65536-d30", 65536, 0.3, True),
         ("pos-K200960-d2", 200960, 0.02, False))


def main() -> int:
    import torch

    from ..engine import tile_topk as tt

    if not torch.cuda.is_available():
        print("split_accuracy: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    M = N = 256
    ones_m, ones_n = torch.ones(M, device=dev), torch.ones(N, device=dev)
    pv = torch.zeros(16, device=dev)
    pv[0] = pv[4] = pv[5] = pv[9] = 1.0
    pv[8] = -3e38  # a threshold below every product: all of them come out
    flags = (False,) * 6  # the raw product
    for label, K, density, signed in CASES:
        def operand(shape):
            v = rng.random(shape) * (rng.random(shape) < density)
            if signed:
                v = v - 0.3 * (rng.random(shape) < 0.5) * (v != 0)
            return v.astype(np.float32)

        a, d = operand((M, K)), operand((K, N))
        ta, td = torch.from_numpy(a).to(dev), torch.from_numpy(d).to(dev)
        out = {"case": label, "K": K, "density": density, "signed": signed}
        for mode in ("f32", "bf16", "both", "plain-both"):
            if mode == "f32":
                A, D, kw, fn = ta, td, {}, tt.fused_tile_topk
            elif mode == "bf16":
                A, D, kw, fn = ta.bfloat16(), td.bfloat16(), {}, tt.fused_tile_topk
            else:
                A, D = tt.split_bf16x3(ta, 1), tt.split_bf16x3(td, 0)
                kw = {"split_f32": "both"}
                fn = tt.fused_tile_topk if mode == "both" else tt.fused_tile_topk_plain
            vals, idx = fn(A, D, ones_m, ones_m, ones_m, ones_n, ones_n, ones_n, pv,
                           flags=flags, k_pad=N, int8_mode=False, **kw)
            torch.cuda.synchronize()
            xy = np.zeros((M, N))
            np.put_along_axis(xy, idx.cpu().numpy().T.astype(np.int64), vals.cpu().numpy().T, 1)
            if mode == "bf16":
                ref = (ta.bfloat16().double() @ td.bfloat16().double()).cpu().numpy()
            else:
                ref = a.astype(np.float64) @ d.astype(np.float64)
            rel = (xy - ref) / np.maximum(np.abs(ref), 1e-30)
            out[mode] = {"max_rel": float(np.abs(rel).max()), "mean_rel": float(np.abs(rel).mean()),
                         "mean_signed_rel": float(rel.mean())}
        print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
