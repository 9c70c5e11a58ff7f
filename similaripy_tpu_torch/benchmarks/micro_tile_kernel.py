"""Microbenchmark of K1 (fused_tile_topk) at the ML-32M scoring tile shape.

Port of ``benchmarks/micro_tile_kernel.py``. Run on a CUDA card:

    python -m similaripy_tpu_torch.benchmarks.micro_tile_kernel [--fresh]
        [--trp 2048] [--upad 84480] [--tc 2048] [--kpad 16] [--reps 10]

It times ONE (panel x tile) product of K1 with the raw-product epilogue
(the scoring call's mode) as a chained-carry loop: each call's carry feeds
the next, the executor's own dataflow, where the carry's kth prunes nearly
every candidate. ``--fresh`` feeds a cold carry to every call instead, so
that the top-k runs at its worst case; the two bracket a real run's top-k
cost. Operands are made on the card as the reference script makes them: a
~17% dense panel of values 1..9 and a ~0.1% dense tile whose entries are
the reference's split [hi; lo] halves added back into one f32 value (the
port multiplies in true f32, so the tile is one f32 matrix, not two bf16
ones). Prints ms per product (3 rounds of ``reps`` by CUDA events) and K1's
f32 bound for the shape, 2 * trp * u_pad * tc over the card's 67 TFLOP/s
of f32 FMA (H100 SXM data sheet).
"""

from __future__ import annotations

import argparse
import sys

import torch

PEAK_F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores


def _iota2(rows, cols, device):
    r = torch.arange(rows, dtype=torch.int32, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int32, device=device)[None, :]
    return r, c


def make_inputs(trp: int, u_pad: int, tc: int, device):
    """The panel (trp, u_pad) and tile (u_pad, tc), f32, by the reference's
    formulas (int32 arithmetic wraps, as in XLA)."""
    r, c = _iota2(trp, u_pad, device)
    ai = r * 7919 + c * 104729
    a = torch.where(ai % 6 == 0, (ai % 9 + 1).to(torch.bfloat16), 0).to(torch.float32)
    del ai
    d = torch.zeros((u_pad, tc), dtype=torch.float32, device=device)
    for half, scale in ((0, 1.0), (1, 2.0**-9)):
        r, c = _iota2(u_pad, tc, device)
        di = (r + half * u_pad) * 31337 + c * 6151
        v = ((di % 13 + 1).to(torch.float32) * scale / 13.0).to(torch.bfloat16)
        d += torch.where(di % 845 == 0, v, 0).to(torch.float32)
        del di, v
    return a, d


def run(trp=2048, u_pad=84480, tc=2048, k_pad=16, reps=10, fresh=False, device="cuda",
        rounds=3):
    """The chained (or fresh) loop; returns a dict with the per-round ms
    (None on the CPU, where nothing is timed) and the last carry."""
    from ..engine.tile_topk import fused_tile_topk

    dev = torch.device(device)
    a, d = make_inputs(trp, u_pad, tc, dev)
    ones_r = torch.ones(trp, device=dev)
    ones_c = torch.ones(tc, device=dev)
    pvec = torch.zeros(16, device=dev)
    pvec[9] = 1.0  # inv_scale; col_base 0
    flags = (False,) * 6  # raw-product epilogue
    cold = (torch.full((k_pad, trp), float("-inf"), device=dev),
            torch.zeros((k_pad, trp), dtype=torch.int32, device=dev))

    def one(carry):
        return fused_tile_topk(a, d, ones_r, ones_r, ones_r, ones_c, ones_c, ones_c, pvec,
                               carry=carry, flags=flags, k_pad=k_pad, int8_mode=False)

    carry = one(cold)  # warm-up (and the build on a first call)
    timed = dev.type == "cuda"
    round_ms = []
    for _ in range(rounds):
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        for _ in range(reps):
            carry = one(cold if fresh else carry)
        if timed:
            end.record()
            end.synchronize()
            round_ms.append(start.elapsed_time(end) / reps)
    return {"shape": {"trp": trp, "u_pad": u_pad, "tc": tc, "k_pad": k_pad}, "fresh": fresh,
            "round_ms": round_ms if timed else None,
            "bound_ms": 1e3 * 2.0 * trp * u_pad * tc / PEAK_F32_FLOPS, "carry": carry}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trp", type=int, default=2048)
    ap.add_argument("--upad", type=int, default=84480)
    ap.add_argument("--tc", type=int, default=2048)
    ap.add_argument("--kpad", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--fresh", action="store_true", help="a cold carry for every call")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (no timing)")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# shape: trp={args.trp} u_pad={args.upad} tc={args.tc} k_pad={args.kpad} "
          f"f32 device={name}", flush=True)
    res = run(args.trp, args.upad, args.tc, args.kpad, args.reps, args.fresh, dev)
    bound = res["bound_ms"]
    if res["round_ms"] is None:
        print(f"# ran on the CPU: time not measured (f32 bound on the card {bound:.2f} ms)",
              flush=True)
        return 0
    for i, ms in enumerate(res["round_ms"]):
        print(f"# round {i}: {ms:.3f} ms/product (f32 bound {bound:.2f} ms, "
              f"overhead {ms - bound:+.3f} ms, fresh={args.fresh})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
