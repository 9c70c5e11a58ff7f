"""What P1's in-kernel int8 transpose costs, on a CUDA card.

    python -m similaripy_tpu_torch.benchmarks.tlhs_transpose_cost [--reps 5] [--rounds 3]

P1's int8 kernel (``csrc/probe_tlhs.cu``) transposes both operands in
registers (PRMT) on their way into shared memory. This script builds the
same source a second time with ``-DPROBE_TLHS_NO_TRANSPOSE``, which
compiles only that pass out: every global load and shared store stays as
it is, and the products come out wrong. It checks that the real kernel
equals its plain version and that the control does not (so the pass
really went), then times the two on one int8 block of K2's full-width
shape (K = u_pad 200,960, M = N = 4,096, values in [-5, 5]), interleaved
as real, control, control, real in each round; each reading is the mean
of ``reps`` calls by CUDA events. Prints one JSON line: the card, both
medians, every reading, and the transpose's share of the real kernel's
time. Needs a card; exits 1 without one.
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
_P_INT8 = 2  # probe_tlhs's mode number for int8


def build_control():
    """The P1 source built with the transpose compiled out, as its own
    library next to the engine's; returns it loaded."""
    from ..engine import build

    src = build.CSRC / "probe_tlhs.cu"
    flags = (*build.NVCC_FLAGS, "-DPROBE_TLHS_NO_TRANSPOSE")
    digest = hashlib.sha1(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"libprobe_tlhs_no_transpose_{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        proc = subprocess.run([build._nvcc(), *flags, "-shared", "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_tlhs.argtypes = [i, p, p, i, i, i, p, p]
    lib.probe_tlhs.restype = i
    return lib


def _mean_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(reps: int = 5, rounds: int = 3) -> dict:
    from . import probes

    dev = torch.device("cuda")
    K, M, N = SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randint(-5, 6, (K, M), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-5, 6, (K, N), generator=gen, device=dev, dtype=torch.int8)
    control = build_control()
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run_control():
        err = control.probe_tlhs(_P_INT8, a.data_ptr(), b.data_ptr(), K, M, N,
                                 out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"the no-transpose control failed to launch: CUDA error {err}")

    def run_real():
        return probes.transposed_lhs_product(a, b)

    ref = probes.transposed_lhs_product_plain(a, b)
    if not torch.equal(run_real(), ref):
        raise AssertionError("P1 int8 differs from its plain version")
    run_control()
    if torch.equal(out, ref):
        raise AssertionError("the control gave the right product: the transpose was not removed")
    del ref
    torch.cuda.synchronize()
    readings = {"kernel": [], "no_transpose": []}
    for _ in range(rounds):
        for name in ("kernel", "no_transpose", "no_transpose", "kernel"):
            fn = run_real if name == "kernel" else run_control
            readings[name].append(_mean_ms(fn, reps))
    kernel_ms = float(np.median(readings["kernel"]))
    control_ms = float(np.median(readings["no_transpose"]))
    return {"shape": {"K": K, "M": M, "N": N, "dtype": "int8"}, "reps": reps,
            "kernel_ms": kernel_ms, "no_transpose_ms": control_ms,
            "transpose_share": (kernel_ms - control_ms) / kernel_ms,
            "kernel_tops": 2.0 * K * M * N / kernel_ms / 1e9, "readings_ms": readings}


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
