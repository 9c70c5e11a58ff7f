"""What the int8 transposes cost in P1 and in K2, on a CUDA card.

    python -m similaripy_tpu_torch.benchmarks.tlhs_transpose_cost [--reps 5] [--rounds 3]

P1's int8 call (``csrc/probe_tlhs.cu``) transposes both operands in a
K-major pass of its own (``csrc/kmajor.cuh``) and then runs ``wgmma`` s8 on
the K-major tiles; the script times the call, the pass on each operand and
the product alone (``probes.s8_kmajor_product``), interleaved in each
round, and checks that the call and the product alone equal P1's plain
version. K2's int8 product (``csrc/sym_topk.cu``) transposes each warp's
fragments in registers (PRMT, ``transpose4x4`` of
``csrc/tensor_core.cuh``) as it reads them from its copy ring: the script
builds ``sym_topk.cu`` a second time with ``-DNO_PRMT_TRANSPOSE``, which
compiles only that pass out (every load, store and ``mma.sync`` stays, the
products come out wrong), checks that the real kernel is right (its
raw-product scores equal P1's product) and that the control is not, and
times real and control interleaved as real, control, control, real in
each round. Both on one int8 block of K2's full-width shape (K = u_pad
200,960, M = N = 4,096, values in [-5, 5]; for K2 its product launch
alone); each reading is the mean of ``reps`` calls by CUDA events. Prints
one JSON line: the card, P1's medians and readings under ``p1`` (the
passes' share of the call), K2's under ``k2`` (the transpose's share of
its real kernel's time). Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

SHAPE = (200_960, 4096, 4096)  # (K, M, N): K2's int8 block at full width
_P_INT8 = 2  # sym_product's mode number for int8
_SOURCES = ("sym_topk.cu",)


def build_control():
    """K2's source built with the transpose compiled out, as a library next
    to the engine's; returns it loaded."""
    from ..engine import build

    srcs = [build.CSRC / name for name in _SOURCES]
    flags = (*build.NVCC_FLAGS, "-DNO_PRMT_TRANSPOSE")
    digest = hashlib.sha1(" ".join(flags).encode())
    for path in srcs + sorted(build.CSRC.glob("*.cuh")):
        digest.update(path.read_bytes())
    out = build.BUILD_DIR / f"libno_prmt_transpose_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        proc = subprocess.run([build._nvcc(), *flags, "-shared", "-o", str(tmp), *map(str, srcs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sym_product.argtypes = [i, p, p, i, i, i, p, p, i, p, p, p, p]
    lib.sym_product.restype = i
    return lib


def _mean_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _interleaved(run_real, run_control, reps: int, rounds: int) -> dict:
    readings = {"kernel": [], "no_transpose": []}
    for _ in range(rounds):
        for name in ("kernel", "no_transpose", "no_transpose", "kernel"):
            readings[name].append(_mean_ms(run_real if name == "kernel" else run_control, reps))
    kernel_ms = float(np.median(readings["kernel"]))
    control_ms = float(np.median(readings["no_transpose"]))
    return {"kernel_ms": kernel_ms, "no_transpose_ms": control_ms,
            "transpose_share": (kernel_ms - control_ms) / kernel_ms,
            "readings_ms": readings}


def _p1_pieces(runs: dict, reps: int, rounds: int) -> dict:
    """The medians of P1's call and its pieces, each timed in every round."""
    readings = {name: [] for name in runs}
    for _ in range(rounds):
        for name, fn in runs.items():
            readings[name].append(_mean_ms(fn, reps))
    med = {f"{name}_ms": float(np.median(r)) for name, r in readings.items()}
    med["passes_share"] = (med["pass_a_ms"] + med["pass_b_ms"]) / med["call_ms"]
    return {**med, "readings_ms": readings}


def _k2_product(lib, a, b, out_r, out_c, pvec, vecs, stream):
    """K2's product launch on the block a^T . b (one anchor tile, a live
    block: every row feeds both sides) with the raw epilogue, into out_r
    (M x N) and out_c (N x M)."""
    K, M = a.shape
    N = b.shape[1]
    kind = ctypes.c_int(-1)
    err = lib.sym_product(_P_INT8, a.data_ptr(), b.data_ptr(), M, K, N, vecs, pvec.data_ptr(), 0,
                          out_r.data_ptr(), out_c.data_ptr(), stream, ctypes.byref(kind))
    if err != 0:
        raise RuntimeError(f"K2's product failed to launch: CUDA error {err}")


def run(reps: int = 5, rounds: int = 3) -> dict:
    from ..engine import build
    from . import probes

    dev = torch.device("cuda")
    K, M, N = SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randint(-5, 6, (K, M), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-5, 6, (K, N), generator=gen, device=dev, dtype=torch.int8)
    control = build_control()
    engine = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    ref = probes.transposed_lhs_product_plain(a, b)
    probes.reset_counts()
    if not torch.equal(probes.transposed_lhs_product(a, b), ref):
        raise AssertionError("P1 int8 differs from its plain version")
    if probes.tlhs_counts.last_kernel != "wgmma s8":
        raise AssertionError(f"P1 int8 took {probes.tlhs_counts.last_kernel}, not wgmma s8")
    at, bt = probes.kmajor_pass(a), probes.kmajor_pass(b)
    if not torch.equal(probes.s8_kmajor_product(at, bt, M, N), ref):
        raise AssertionError("P1's int8 product on the K-major pass's output differs")
    # K2: the raw epilogue (no S-Plus denominator, threshold -inf, scale 1)
    # writes every nonzero product as it is, so the row-side scores must be
    # P1's product and the col-side scores its transpose
    want = torch.where(ref != 0, ref.float(), torch.full((), float("-inf"), device=dev))
    del ref
    ones_m, ones_n = torch.ones(M, device=dev), torch.ones(N, device=dev)
    vec_ptrs = [v.data_ptr() for v in (ones_m,) * 3 + (ones_n,) * 3] + [None] * 6
    vecs = (ctypes.c_void_p * 12)(*vec_ptrs)
    pvec = torch.zeros(16, device=dev)
    pvec[8], pvec[9], pvec[12] = float("-inf"), 1.0, 1.0  # threshold, scale, t = a0 + 1
    out_r = torch.empty((M, N), device=dev)
    out_c = torch.empty((N, M), device=dev)
    _k2_product(engine, a, b, out_r, out_c, pvec, vecs, stream)
    if not (torch.equal(out_r, want) and torch.equal(out_c, want.T)):
        raise AssertionError("K2's int8 product differs from P1's")
    _k2_product(control, a, b, out_r, out_c, pvec, vecs, stream)
    if torch.equal(out_r, want):
        raise AssertionError("the K2 control gave the right product: the transpose was not removed")
    del want
    torch.cuda.synchronize()

    ops = 2.0 * K * M * N
    p1 = _p1_pieces({"call": lambda: probes.transposed_lhs_product(a, b),
                     "pass_a": lambda: probes.kmajor_pass(a),
                     "pass_b": lambda: probes.kmajor_pass(b),
                     "product": lambda: probes.s8_kmajor_product(at, bt, M, N)}, reps, rounds)
    p1["product_tops"] = ops / p1["product_ms"] / 1e9
    p1["call_tops"] = ops / p1["call_ms"] / 1e9
    k2 = _interleaved(lambda: _k2_product(engine, a, b, out_r, out_c, pvec, vecs, stream),
                      lambda: _k2_product(control, a, b, out_r, out_c, pvec, vecs, stream),
                      reps, rounds)
    k2["kernel_tops"] = ops / k2["kernel_ms"] / 1e9
    return {"shape": {"K": K, "M": M, "N": N, "dtype": "int8"}, "reps": reps, "p1": p1,
            "k2": k2}


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
