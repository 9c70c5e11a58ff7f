#!/usr/bin/env python3
"""Smoke check of similaripy_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. Imports neither JAX nor
``similaripy_tpu``. Each phase prints one JSON line with its `seconds`:

  0 device   the card, and `nvidia-smi --query-gpu=name,power.limit`
  1 build    nvcc builds csrc/*.cu (K1 tile_topk, K2 sym_topk, K3 panel_topk,
             K4 gather, K5 scatter, P1 probe_tlhs, P2 probe_int_mma), one
             process per source, into
             similaripy_tpu_torch/_build/
  2 parity   each kernel against its plain PyTorch version on the card.
             K1: small ragged shapes in every mode (f32, bf16, int8) x carry
             x mask, with epilogue flag sets, and the edges of its product's
             copy ring and blocks in every mode: K shorter than the ring with
             fewer rows than a block, M = 256 with K ending mid-ring and
             mid-slab and rows not 16-byte aligned, the widest tile (tc
             8,192), int8 over all of [-128, 127] (tests/torch_k1_cases.py);
             the split-bf16x3 modes 'both', 'rhs' and 'lhs' on the CPU
             cases that fit their 16-byte copies and at the ring's and
             blocks' edges (values within rtol 1e-5, with the largest
             relative error printed). K2: every mode, symmetric and
             asymmetric epilogues, blocks with dead, diagonal and live anchor
             rows, cold and warm carries, k > tc, the main path's widths
             (sw = 2,048, and sw = 18,432 whose col side takes more than one
             shared-memory chunk), and the edges of the product's copy ring:
             K shorter than the ring, K ending mid-ring and mid-slab, a band
             that cuts a three-tile anchor group, the asymmetric epilogue on a
             diagonal block at tc 2,048, int8 over all of [-128, 127],
             and the split-bf16x3 mode on every block kind, at the main
             path's widths and at the ring's edges (tests/torch_k2_cases.py).
             K3: every mode
             with and without the hot bias under each mask, k_pad > tc, K of
             several KB blocks, tc up to 4,096, K shorter than the product's
             ring, K ending mid-ring with unaligned rows and an odd group
             width, int8 over all of [-128, 127] with an int32 bias near its
             extremes (tests/torch_k3_cases.py). K4:
             every dtype, repeated and unsorted ids and the last row, rows not
             16-byte aligned. K5: every mode with sentinel padding. int8
             bit-equal (through pow: 2 ulp), f32/bf16 values within rtol 1e-5,
             ids equal where values are not tied; K4 rows and K5 tiles
             bit-equal
  3 main     the main path at ML-32M width on the tracked .bench_data_1.0.npz
             (200,948 users x 84,432 items), driven through the public calls
             with the launch counts set to 0 just before and read just after:
             bm25 -> cosine(k=100) over ALL items (the symmetric route, K2 and
             K5) -> recommend(k=10) for 1,024 users (the general route, K1 and
             K5;
             the exclude-seen fold's gate refuses it, as BM25 weights some
             ratings below 0); recommend(urm, W, k=10) on the raw ratings for
             the same users with the fold on, off, on, off (last_plan shows
             the fold's M, then none; the results are equal: nnz per row,
             check_sum rtol 1e-5, the largest value difference printed;
             splus.TIMING's laps of each turn);
             cosine(k=100) for 1,024 items (the general route, K1 and K5); the exact
             int8 cosine on the raw ratings over all items and for the 1,024
             items; asymmetric_cosine(alpha=0.3) over the 16,384 most popular
             items; with precision='high' (the split-bf16x3 modes), the
             f32 build over all items (mode 'both', K2 and K5) and
             recommend(urm, W, k=10) for the 1,024 users on the raw
             ratings (mode 'rhs', the fold on, K1 and K5). Each call took
             its route, launched its kernels and no plain version, and had
             its output assembled by the native library (`native_calls`;
             these calls hold the compaction route off). Then
             the checks: recommend and the 1,024-item
             cosines match the same calls through the plain versions (nnz,
             check_sum rtol 1e-4; int8 identical); 64 sampled rows match a
             float64 SciPy oracle (rtol 1e-4; the 'high' build and the
             'high' recommend too, and each matches its 'highest' call:
             nnz, check_sum rtol 1e-4); the symmetric results' rows
             at the 1,024 items match the general route's (nnz, check_sum
             rtol 1e-5 for f32, equal values for int8); the asymmetric call
             matches the general route on all its rows, and so does the same
             call planned with anchor groups of three tiles; recommend never
             returns a seen item. Then three calls on the compaction route
             (K3, K4, K5) and on the general route (K1, K5), each run on, off,
             on, off: cosine(k=100) for 8,192 items, f32 and exact int8, and
             dot_product(bm25(urm), W.T, k=10) for the 1,024 users with the
             8,192 items excluded; both routes give the same rows (nnz,
             check_sum rtol 1e-5; int8 equal values), K3 and K4 launch as
             often as the plan needs, 64 rows of the f32 call match the
             float64 oracle; both routes' walls and the plans are printed
  3b mesh    multi-device execution (mesh=) over torch.distributed, the
             stores in a temporary directory: (a) this process as one rank
             over NCCL, mesh (1, 1): the f32 cosine over all items (sharded
             symmetric route, K2 and K5), recommend(urm, W) for the 1,024
             users with the fold and the cosine for the 1,024 items (grouped
             sharded route, K1 and K5), each equal to phase main's single-device
             result (nnz per row, check_sum rtol 1e-5, and the same column
             id at every entry clear of ties); (b) two ranks over
             gloo sharing the card (torch.multiprocessing.spawn, join=True),
             meshes (1, 2) and (2, 1): the exact int8 cosine over all items
             and recommend; both ranks return the same CSR, equal to the
             single device's (int8 values identical, ids as in (a)), each rank's K2
             launches equal sym_sharded.schedule_anatomy's share for the
             plan the ranks chose, no rank runs a plain version; each
             call's wall and each rank's launches are printed
  4 times    at the main path's shapes: K2 on a live off-diagonal block and a
             diagonal block (f32), a live block in bf16 (the f32 build's
             geometry), in split-bf16x3 (the 'high' build's) and in int8, K5
             on one inner tile, K1 on a 1,024-item cosine panel (f32, int8,
             bf16, split 'both') and a recommend panel (f32; split 'rhs' on
             the raw ratings), K3 on a panel of the
             largest cold bucket of the 8,192-item cosine (f32, int8 and
             bf16) and K4 on its gather: kernel, bound, plain and library
             (K2: torch.matmul + epilogue + torch.topk on both sides, bf16
             and split as one cuBLAS bf16 product with an f32 result per
             phase, `library_chain` naming the call; K5:
             index_put_; K1: torch.matmul, torch._int_mm or one cuBLAS bf16
             product with an f32 result + torch.topk; K3: the same with the
             bias and the epilogue; K4: index_select);
             K2's three launches and a warm repeat of the asymmetric call
             under torch.profiler (device time by kernel, idle share); a line
             of its own (`times_k2_split`) with K2's per-launch split
             (product, row merge, col merge) of each timed block and its
             product kernels' registers, spills, shared memory and blocks
             per SM; and two more such lines, `times_k1_split` (K1_f32,
             K1_int8, K1_f32_recommend, K1_bf16 and the split modes) and
             `times_k3_split` (K3_f32, K3_int8, K3_bf16), with each timed
             call's product and top-k launch
             (device ms), kernel ms and TOP/s, and the registers, spills,
             shared memory and blocks per SM of K1's product kernels
             (tile_product_attrs, no bias) and of K3's (with the bias)
  5 probes   the hardware-probe entry points, with the counts set to 0 just
             before and read just after: kernel_check's transposed-lhs probe
             (P1) in int8, bf16 and f32, and micro_int4's rate probe (P2) in
             int8 and s4 (exact against the oracle x steps, best-of-3 time,
             TOP/s). Then P1 against its plain version, bit-equal on
             integer data, in every dtype at the probe's shape, on ragged
             shapes, and at K2's full-width block (K = u_pad 200,960, M = N
             = 2,048; 4,096 for int8), with kernel, plain, library
             (torch.matmul(a.t(), b) with TF32 off; torch._int_mm with the
             transpose copies and without) and bound times; P1 f32 on
             standard-normal data at the probe's shape, a ragged one and
             K2's block, its mean scaled error within the f32 tolerance
             that a TF32 product exceeds; P2 against its plain version on
             small shapes, s4 also on values in [-8, 9] that its cast
             wraps, and as a function (one product times steps: bound of
             one product, library torch._int_mm * steps) beside its rate;
             the --quick kernel-check sweep (must pass); K1's
             microbenchmark (micro_tile_kernel, chained and fresh carry)
  6 bench    the benchmark entry points: the bench's kernel guard
             (benchmarks.bench.ensure_kernel_stamp runs the quick sweep in a
             subprocess when the stamp is stale, as on a fresh checkout; the
             stamp then matches kernel_stamp.kernel_hash()); the headline
             benchmarks.bench.main(["--rounds", "1"]) in this process on the
             tracked data (the five-key last line, value = 84,432 / the best
             round, recall@100 >= 0.99, the symmetric route with the plan's
             K2 and K5 launches, no plain version, the native assembly, the
             laps of round 0 and of the diagnostic round); run_benchmarks on synthetic_small in
             the similarity stage (dot_product, cosine, rp3beta) and the
             scoring stage (cosine, precision='high'), both reports read by
             compare_benchmarks, and bench_gate from no earlier report
             (bootstrap); assemble on the headline's (T, k) buffers, native
             against plain, in COO and CSR: bit-equal, both times printed

then the `kernels` line (K1 and K2 once more as "tile_topk:split-bf16x3"
and "sym_topk:split-bf16x3": their launches in the 'high' calls, their
split times) and, last, {"ok": true, "device": {...}}. Any failed
check raises and the script exits non-zero; without a card it exits non-zero
before printing anything. It writes nothing but the kernel and native
builds, the kernel stamp and the synthetic_small cache (all in
similaripy_tpu_torch/_build/) and temporary directories.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, ".bench_data_1.0.npz")
ML32M_SHAPE = (200_948, 84_432)
N_TARGETS = 1024
N_ORACLE_ROWS = 64
N_POPULAR = 16_384
KERNELS = {
    "tile_topk": ("similaripy_tpu_torch/csrc/tile_topk.cu",
                  "similaripy_tpu/engine/pallas_kernels.py:712"),
    "sym_topk": ("similaripy_tpu_torch/csrc/sym_topk.cu",
                 "similaripy_tpu/engine/pallas_kernels.py:1145"),
    "scatter": ("similaripy_tpu_torch/csrc/scatter.cu",
                "similaripy_tpu/engine/pallas_kernels.py:1301"),
    "panel_topk": ("similaripy_tpu_torch/csrc/panel_topk.cu",
                   "similaripy_tpu/engine/pallas_kernels.py:559"),
    "gather": ("similaripy_tpu_torch/csrc/gather.cu",
               "similaripy_tpu/engine/gather.py:96"),
    "probe_tlhs": ("similaripy_tpu_torch/csrc/probe_tlhs.cu",
                   "benchmarks/tpu_kernel_check.py:102"),
    "probe_int_mma": ("similaripy_tpu_torch/csrc/probe_int_mma.cu",
                      "benchmarks/micro_int4.py:67"),
}
# the kernels driven by the probes phase, not by the main path
PROBE_KERNELS = ("probe_tlhs", "probe_int_mma")
# the split-bf16x3 modes (precision='high') of K1 and K2, each with a line
# of its own in `kernels`: the same sources, their launches in the main
# path's 'high' calls
SPLIT_KERNELS = {"tile_topk:split-bf16x3": "tile_topk", "sym_topk:split-bf16x3": "sym_topk"}
# P1 at K2's full-width block: (K, M, N); int8 blocks are 4,096 wide
P1_FULL = {"float32": (200_960, 2048, 2048), "bfloat16": (200_960, 2048, 2048),
           "int8": (200_960, 4096, 4096)}
N_COMPACT_TARGETS = 8192
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
POW_RTOL = 2.0**-22  # int8 values through pow: two ulp (tests/torch_k1_cases.py)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_sum(x) -> float:
    """Tie-robust scalar of a top-k matrix (tests/oracles.py::check_sum)."""
    aux = np.asarray(x.sum(axis=1), dtype=np.float64).ravel()
    return float(np.sum(aux**2))


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _not_tied(v, rel):
    """(k, rows) mask of finite values clear of both neighbours."""
    out = np.isfinite(v)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(v, axis=0)) > rel * np.maximum(np.abs(v[1:]), 1e-30)
    out[1:] &= gap
    out[:-1] &= gap
    return out


def _compare(where, mode, got, ref, use_pow=False):
    """(values, ids) of (k, rows) against the plain version; returns the
    largest absolute difference."""
    (kv, ki), (pv, pi) = got, ref
    fin = np.isfinite(pv)
    if not np.array_equal(np.isfinite(kv), fin):
        raise AssertionError(f"parity {where}: finite slots differ")
    if mode == "int8" and not use_pow:
        if not np.array_equal(kv, pv):
            raise AssertionError(f"parity {where}: int8 values not bit-equal")
        rel = 0.0
    else:
        rel = POW_RTOL if mode == "int8" else 1e-5
        np.testing.assert_allclose(kv[fin], pv[fin], rtol=rel, atol=0,
                                   err_msg=f"parity {where}")
    ok = _not_tied(pv, rel)
    if not np.array_equal(ki[ok], pi[ok]):
        raise AssertionError(f"parity {where}: ids differ at untied values")
    return float(np.max(np.abs(kv[fin] - pv[fin]))) if fin.any() else 0.0


# ---------------------------------------------------------------------------
# phase 2: kernel parity
# ---------------------------------------------------------------------------


def _operands(rng, mode, trp, u, tc):
    """A panel and a tile with the vectors an S-Plus call derives from them
    (squared norms, their square roots, positive depop weights)."""
    if mode == "int8":
        a = rng.integers(-6, 7, (trp, u)) * (rng.random((trp, u)) < 0.3)
        d = rng.integers(-6, 7, (u, tc)) * (rng.random((u, tc)) < 0.3)
        a, d = a.astype(np.int8), d.astype(np.int8)
    else:
        a = (rng.random((trp, u)) * (rng.random((trp, u)) < 0.3)).astype(np.float32)
        d = (rng.random((u, tc)) * (rng.random((u, tc)) < 0.3)).astype(np.float32)
    xt = (a.astype(np.float32) ** 2).sum(1).astype(np.float32)
    yt = (d.astype(np.float32) ** 2).sum(0).astype(np.float32)
    xd = (rng.random(trp) + 0.5).astype(np.float32)
    yd = (rng.random(tc) + 0.5).astype(np.float32)
    return a, d, [xt, np.sqrt(xt), xd, yt, np.sqrt(yt), yd]


# (flags, a1 l1 l2 l3 t1 t2 stab bayes threshold) — cosine, raw dot,
# tversky + depop + power, bayesian-shrunk cosine with a threshold
FLAG_SETS = [
    ((False, True, False, False, False, True), [1, 0, 1, 0, 1, 1, 0, 0, 0]),
    ((False, False, False, False, False, False), [1, 0, 0, 0, 1, 1, 0, 0, 0]),
    ((True, False, True, True, False, True), [0.8, 1, 0, 0.5, 0.7, 0.4, 0.5, 0, 0]),
    ((False, True, False, False, True, True), [1, 0, 1, 0, 1, 1, 0.1, 2.0, 0.05]),
]
SHAPES = [(37, 300, 200, 8), (130, 515, 333, 100), (64, 260, 1100, 1024)]


def parity_k1(torch, tt, dev):
    rng = np.random.default_rng(0)
    cases = 0
    max_err = {"f32": 0.0, "bf16": 0.0, "int8": 0.0}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    for mi, mode in enumerate(("f32", "bf16", "int8")):
        for carry_on in (False, True):
            for ki, mask in enumerate(("none", "allowed", "filter", "target")):
                trp, u, tc, k_pad = SHAPES[(mi + ki + carry_on) % len(SHAPES)]
                flags, p = FLAG_SETS[(ki + 2 * carry_on) % len(FLAG_SETS)]
                a, d, vecs = _operands(rng, mode, trp, u, tc)
                pv = np.zeros(16, np.float32)
                pv[:9] = p
                pv[9] = 0.25 if mode == "int8" else 1.0
                pv[10] = 3 * tc  # col_base
                args = [torch.from_numpy(x).to(dev).to(dtypes[mode]) for x in (a, d)]
                args += [torch.from_numpy(v).to(dev) for v in vecs]
                args.append(torch.from_numpy(pv).to(dev))
                kw = dict(flags=flags, k_pad=k_pad, int8_mode=mode == "int8")
                if mask == "allowed":
                    kw["allowed"] = torch.from_numpy((rng.random(tc) < 0.7).astype(np.uint8)).to(dev)
                elif mask != "none":
                    m = torch.from_numpy((rng.random((trp, tc)) < 0.4).astype(np.uint8)).to(dev)
                    kw["fmask" if mask == "filter" else "tmask"] = m
                if carry_on:
                    # a real carry: the plain top-k of another tile of ids
                    a2, d2, vecs2 = _operands(rng, mode, trp, u, tc)
                    prev = [torch.from_numpy(x).to(dev).to(dtypes[mode]) for x in (a, d2)]
                    prev += [torch.from_numpy(v).to(dev) for v in vecs[:3] + vecs2[3:]]
                    pv0 = pv.copy()
                    pv0[10] = 0
                    prev.append(torch.from_numpy(pv0).to(dev))
                    kw["carry"] = tt.fused_tile_topk_plain(*prev, **kw)
                got = tt.fused_tile_topk(*args, **kw)
                ref = tt.fused_tile_topk_plain(*args, **kw)
                _sync(torch, dev)
                got, ref = [tuple(t.cpu().numpy() for t in x) for x in (got, ref)]
                where = f"K1 {mode} carry={carry_on} mask={mask} shape={(trp, u, tc, k_pad)}"
                err = _compare(where, mode, got, ref)
                max_err[mode] = max(max_err[mode], err)
                cases += 1
    # the edges of the product's copy ring and blocks (tests/torch_k1_cases.py)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_k1_cases import CARD_CASES, assert_same, make_case, run_port

    def plain(mode, *case):
        return run_port(tt.fused_tile_topk_plain, mode, *case, device=dev.type)

    card_err = {"f32": 0.0, "bf16": 0.0, "int8": 0.0}
    card_top = 0.0  # the largest finite value of those cases, for scale
    for mode, carry_on, mask, label in CARD_CASES:
        case = make_case(mode, carry_on, mask, plain, label)
        got = run_port(tt.fused_tile_topk, mode, *case, device=dev.type)
        ref = plain(mode, *case)
        try:
            assert_same(mode, got, ref, case[6])
        except AssertionError as e:
            raise AssertionError(f"parity K1 {mode} carry={carry_on} mask={mask} "
                                 f"{label}: {e}") from None
        fin = np.isfinite(ref[0])
        if fin.any():
            card_err[mode] = max(card_err[mode], float(np.max(np.abs(got[0][fin] - ref[0][fin]))))
            card_top = max(card_top, float(np.max(np.abs(ref[0][fin]))))
        cases += 1
    split = _parity_k1_split(tt, dev)
    return {"cases": cases, "max_abs_err": max_err, "card_cases": len(CARD_CASES),
            "card_max_abs_err": card_err, "card_max_value": card_top, "split": split}


def _rel_err(got, ref):
    """The largest |got - ref| / |ref| over the finite slots of `ref`."""
    fin = np.isfinite(ref) & (ref != 0)
    return float(np.max(np.abs(got[fin] - ref[fin]) / np.abs(ref[fin]))) if fin.any() else 0.0


def _parity_k1_split(tt, dev):
    """K1's split-bf16x3 modes against the plain version: the CPU parity
    cases that fit the split kernels' 16-byte copies and the ring's and
    blocks' edges (tests/torch_k1_cases.py), values within SPLIT_RTOL."""
    from torch_k1_cases import (SPLIT_CARD_CASES, SPLIT_CASES, SPLIT_RTOL, assert_same_split,
                                make_split_case, run_port_split, split_card_ok)

    def plain(split, *case):
        return run_port_split(tt.fused_tile_topk_plain, split, *case, device=dev.type)

    cases = [c + (None,) for c in SPLIT_CASES if split_card_ok(*c)] + SPLIT_CARD_CASES
    abs_err = {"both": 0.0, "rhs": 0.0, "lhs": 0.0}
    rel_err = dict(abs_err)
    for split, carry_on, mask, label in cases:
        case = make_split_case(split, carry_on, mask, plain, label)
        got = run_port_split(tt.fused_tile_topk, split, *case, device=dev.type)
        ref = plain(split, *case)
        try:
            assert_same_split(got, ref, case[6])
        except AssertionError as e:
            raise AssertionError(f"parity K1 split {split} carry={carry_on} mask={mask} "
                                 f"{label}: {e}") from None
        fin = np.isfinite(ref[0])
        if fin.any():
            abs_err[split] = max(abs_err[split], float(np.max(np.abs(got[0][fin] - ref[0][fin]))))
            rel_err[split] = max(rel_err[split], _rel_err(got[0], ref[0]))
    return {"cases": len(cases), "rtol": SPLIT_RTOL, "max_abs_err": abs_err,
            "max_rel_err": rel_err}


def parity_k2(torch, st, dev):
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_k2_cases import (CARD_CASES, CASES, EPILOGUES, SPLIT_CARD_CASES, SPLIT_CASES,
                                assert_same, case_id, make_inputs, torch_fn)

    max_err = {"f32": 0.0, "bf16": 0.0, "int8": 0.0, "split": 0.0}
    split_rel = 0.0
    cases = CASES + CARD_CASES + SPLIT_CASES + SPLIT_CARD_CASES
    for case in cases:
        mode = case["mode"]
        plain = torch_fn(st.fused_sym_topk_plain, mode, device=dev.type)
        args, kw = make_inputs(case, plain)
        got = torch_fn(st.fused_sym_topk, mode, device=dev.type)(*args, **kw)
        ref = plain(*args, **kw)
        flags = EPILOGUES[case["epi"]][0]
        if mode == "split":  # ids not compared across the top-k's cut (torch_k2_cases)
            try:
                assert_same(mode, got, ref, flags)
            except AssertionError as e:
                raise AssertionError(f"parity K2 {case_id(case)}: {e}") from None
        for side, sl in (("row", slice(0, 2)), ("col", slice(2, 4))):
            g, r = got[sl], ref[sl]
            if mode == "split":
                fin = np.isfinite(r[0])
                err = float(np.max(np.abs(g[0][fin] - r[0][fin]))) if fin.any() else 0.0
                split_rel = max(split_rel, _rel_err(g[0], r[0]))
            else:
                err = _compare(f"K2 {case_id(case)} {side}", mode, g, r, flags[3])
            max_err[mode] = max(max_err[mode], err)
    return {"cases": len(cases), "split_cases": len(SPLIT_CASES) + len(SPLIT_CARD_CASES),
            "max_abs_err": max_err, "split_max_rel_err": split_rel}


def parity_k5(torch, sc, dev):
    rng = np.random.default_rng(5)
    g, u_pad, tc, p2 = 2, 4096, 2048, 300_000
    cases = 0
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        ru = np.full((g, p2), u_pad, np.int32)  # the sentinel pads every row's tail
        sl = np.zeros((g, p2), np.int32)
        vv = np.zeros((g, p2), np.float32)
        for t in range(g):
            n = p2 - 7_777 * (t + 1)
            cells = rng.choice(u_pad * tc, n, replace=False)
            ru[t, :n], sl[t, :n] = cells // tc, cells % tc
            vv[t, :n] = rng.integers(-6, 7, n) if name == "int8" else rng.random(n) + 0.1
        args = [torch.from_numpy(a).to(dev) for a in (ru, sl, vv)]
        got = sc.densify_tiles(*args, u_pad=u_pad, tc=tc, cdt=dt)
        ref = sc.densify_tiles_plain(*args, u_pad=u_pad, tc=tc, cdt=dt)
        _sync(torch, dev)
        if got.dtype != dt or not torch.equal(got, ref):
            raise AssertionError(f"parity K5 {name}: tiles differ from the plain version")
        cases += 1
    return {"cases": cases, "max_abs_err": 0.0}


def parity_k3(torch, pt, dev):
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_k3_cases import CARD_CASES, CASES, assert_same_panel, make_case, run_port

    max_err = {"f32": 0.0, "bf16": 0.0, "int8": 0.0}
    cases = [c + (None,) for c in CASES] + CARD_CASES
    for mode, bias_on, mask, card_shape in cases:
        inputs = make_case(mode, bias_on, mask, card_shape)
        got = run_port(pt.fused_panel_topk, mode, *inputs, device=dev.type)
        ref = run_port(pt.fused_panel_topk_plain, mode, *inputs, device=dev.type)
        try:
            assert_same_panel(mode, got, ref, inputs[6])
        except AssertionError as e:
            raise AssertionError(f"parity K3 {mode} bias={bias_on} mask={mask} "
                                 f"shape={card_shape}: {e}") from None
        fin = np.isfinite(ref[0])
        if fin.any():
            max_err[mode] = max(max_err[mode], float(np.max(np.abs(got[0][fin] - ref[0][fin]))))
    return {"cases": len(cases), "max_abs_err": max_err}


def parity_k4(torch, ga, dev):
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_k3_cases import GATHER_CASES, gather_inputs

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    for mode, u_pad, cg, n in GATHER_CASES:
        table, idx = gather_inputs(mode, u_pad, cg, n)
        t = torch.from_numpy(table).to(dev).to(dtypes[mode])
        i = torch.from_numpy(idx).to(dev)
        got, ref = ga.row_gather(t, i), ga.row_gather_plain(t, i)
        _sync(torch, dev)
        if got.dtype != t.dtype or not torch.equal(got, ref):
            raise AssertionError(f"parity K4 {mode} {(u_pad, cg, n)}: rows differ from the plain version")
    return {"cases": len(GATHER_CASES), "max_abs_err": 0.0}


# ---------------------------------------------------------------------------
# phase 3: the main path at ML-32M width
# ---------------------------------------------------------------------------


def _oracle_rows(m1, m2, rows, k, *, l2, filt=None):
    """float64 top-k values of the sampled target rows: dot product, or
    cosine with sqrt squared-norm denominators (tests/oracles.py py_cosine
    and top_k semantics: candidates are nonzero products, threshold 0)."""
    import scipy.sparse as sp

    m1 = sp.csr_array(m1, dtype=np.float64)
    m2 = sp.csc_array(m2, dtype=np.float64)
    xy = (m1[rows] @ m2).toarray()
    if l2:
        xn = np.sqrt(np.asarray(m1.multiply(m1).sum(axis=1)).ravel())[rows]
        yn = np.sqrt(np.asarray(m2.multiply(m2).sum(axis=0)).ravel())
        with np.errstate(divide="ignore", invalid="ignore"):
            val = np.where(xy != 0, xy / (xn[:, None] * yn[None, :]), 0.0)
    else:
        val = xy
    keep = (xy != 0) & (val >= 0.0)
    if filt is not None:
        keep &= ~(sp.csr_array(filt)[rows].toarray() != 0)
    val = np.where(keep, val, -np.inf)
    top = -np.sort(-val, axis=1)[:, :k]
    return [r[np.isfinite(r)] for r in top]


def _check_oracle(name, got, rows, expect):
    got = got.tocsr()
    for r, e in zip(rows, expect):
        g = np.sort(got.data[got.indptr[r]:got.indptr[r + 1]].astype(np.float64))[::-1]
        if g.shape != e.shape:
            raise AssertionError(f"{name}: row {r} has {g.shape[0]} entries, oracle {e.shape[0]}")
        np.testing.assert_allclose(g, e, rtol=1e-4, err_msg=f"{name}: row {r} vs float64 oracle")


def _same_rows(name, got, ref, rows, exact):
    """The rows `rows` of two results: equal nnz; check_sum within rtol
    1e-5, or (exact) the same values in every row."""
    got, ref = got.tocsr()[rows], ref.tocsr()[rows]
    if got.nnz != ref.nnz:
        raise AssertionError(f"{name}: nnz {got.nnz} vs the general route's {ref.nnz}")
    if exact:
        for r in range(got.shape[0]):
            a = np.sort(got.data[got.indptr[r]:got.indptr[r + 1]])
            b = np.sort(ref.data[ref.indptr[r]:ref.indptr[r + 1]])
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: row {rows[r]} values differ from the general route")
    else:
        np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-5,
                                   err_msg=f"{name}: check_sum vs the general route")


def _same(name, got, ref, exact):
    """A call against the same call through the plain versions: equal nnz;
    check_sum within rtol 1e-4, or (exact) the identical CSR."""
    got, ref = got.tocsr(), ref.tocsr()
    if got.nnz != ref.nnz:
        raise AssertionError(f"{name}: nnz {got.nnz} vs plain {ref.nnz}")
    if exact:
        for f in ("indptr", "indices", "data"):
            if not np.array_equal(getattr(got, f), getattr(ref, f)):
                raise AssertionError(f"{name}: not identical to the plain version ({f})")
    else:
        np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-4,
                                   err_msg=f"{name}: check_sum vs plain")


def _check_plan_launches(name, route, launches, plan):
    """A call launched its plan's kernels (on a mesh, this rank's share):
    the symmetric routes their K2 blocks and K5 scatters (schedule_anatomy),
    the grouped routes K1 once per (panel, own tile) and K5 once per
    group."""
    if route in ("symmetric", "sym_sharded"):
        expect = {"sym_topk": plan["blocks"], "scatter": plan["scatters"]}
    elif route in ("general", "sharded"):
        expect = {"tile_topk": plan["k1_launches"], "scatter": plan["k5_launches"]}
    else:
        return
    if any(launches[k] != v for k, v in expect.items()):
        raise AssertionError(f"{name}: launches {launches}, the plan counts {expect}")


def _make_call(torch, counters, ex, dev, calls):
    """The main path's call driver: counts set to 0 just before a call and
    read just after; the route taken, its kernels launched (K3 and K4 as
    often as the compaction plan needs), no plain version run and the
    output assembled by the native library (`native_calls`); the result's
    wall, launches, nnz, check_sum and plan go into `calls`."""

    from similaripy_tpu_torch import native

    def call(key, name, fn, route):
        for c in counters.values():
            c.reset_counts()
        native.reset_counts()
        t = time.perf_counter()
        out = fn()
        _sync(torch, dev)
        wall = time.perf_counter() - t
        launches = {k: c.kernel_launches for k, c in counters.items()}
        plain = {k: c.plain_calls for k, c in counters.items()}
        if ex.last_route != route:
            raise AssertionError(f"{name}: took the {ex.last_route} route, not {route}")
        if native.native_calls == 0:
            raise AssertionError(f"{name}: the output was not assembled by the native library")
        # a mesh rank launches its plan's share (checked below), which may be none
        used = {"symmetric": ("sym_topk", "scatter"), "general": ("tile_topk", "scatter"),
                "compact": ("panel_topk", "scatter")}.get(route, ())
        if any(launches[k] == 0 for k in used) or any(plain.values()):
            raise AssertionError(f"{name}: launches {launches}, plain calls {plain}")
        _check_plan_launches(name, route, launches, ex.last_plan)
        if route == "compact":
            # K3 once per panel and group, K4 once per gathering panel and group
            buckets, n_groups = ex.last_plan["buckets"], ex.last_plan["n_groups"]
            expect = {"panel_topk": n_groups * sum(n for _, n in buckets),
                      "gather": n_groups * sum(n for b, n in buckets if b)}
            if any(launches[k] != v for k, v in expect.items()):
                raise AssertionError(f"{name}: launches {launches}, expected {expect}")
        calls[key] = {"call": name, "route": route, "seconds": wall, "launches": launches,
                      "native_calls": native.native_calls,
                      "nnz": int(out.nnz), "check_sum": check_sum(out),
                      "plan": dict(ex.last_plan)}
        return out
    return call


def _compaction_calls(sim, compact, call, calls, common, urm, urm_n, W, users, item_t, t8k):
    """Slice 3's calls: the compaction route (K3, K4, K5) against the
    general route (K1, K5), each call run on, off, on, off: a partial rebuild
    of the model for 8,192 new or changed items, f32 and exact int8, and
    scoring with a catalog-level exclusion list (K3's allowed mask). Both
    routes give the same rows; 64 rows of the f32 rebuild match the
    float64 oracle. Returns both routes' walls, the plan and the launches
    of each call."""
    compaction = {}
    for key, name, fn, rows, exact in (
        ("cosine_t8k", "cosine(bm25(urm).T, k=100), 8,192 items",
         lambda: sim.cosine(urm_n.T, k=100, target_rows=t8k, **common), t8k, False),
        ("cosine_int8_t8k", "cosine(urm.T, k=100) int8, 8,192 items",
         lambda: sim.cosine(urm.T, k=100, target_rows=t8k, **common), t8k, True),
        ("score_excluding_t8k",
         "dot_product(bm25(urm), W.T, k=10), 1,024 users, 8,192 items excluded",
         lambda: sim.dot_product(urm_n, W.T, k=10, target_rows=users, filter_cols=t8k,
                                 **common), users, False),
    ):
        out = {}
        for i, mode in enumerate(("on", "off", "on", "off")):
            compact.MODE = mode
            route = "compact" if mode == "on" else "general"
            out[mode] = call(f"{key}_{mode}_{i // 2}", f"{name} [{route}]", fn, route)
        compact.MODE = "off"
        on, off = calls[f"{key}_on_1"], calls[f"{key}_off_1"]
        for c in (on, off):
            if exact and c["plan"]["compute_dtype"] != "int8":
                raise AssertionError(f"{c['call']} ran {c['plan']['compute_dtype']}, not int8")
        _same_rows(f"{name}: compaction", out["on"], out["off"], rows, exact=exact)
        if key == "score_excluding_t8k":
            hit = set(out["on"].tocsr().indices.tolist()) & set(t8k.tolist())
            if hit:
                raise AssertionError(f"{name}: returned {len(hit)} excluded items")
        walls = {m: [calls[f"{key}_{m}_{j}"]["seconds"] for j in (0, 1)] for m in ("on", "off")}
        compaction[key] = {
            "compact_s": walls["on"], "general_s": walls["off"],
            "faster": min(walls["on"]) < min(walls["off"]),
            "plan": {k: on["plan"][k] for k in ("H", "buckets", "tc", "cg", "n_groups",
                                                 "u_pad", "compute_dtype")},
            "launches": on["launches"],
        }
        if key == "cosine_t8k":
            sample = np.sort(np.random.default_rng(1).choice(t8k, N_ORACLE_ROWS, replace=False))
            _check_oracle("cosine, 8,192 items [compact]", out["on"], sample,
                          _oracle_rows(item_t, urm_n, sample, 100, l2=True))
    compact.MODE = "auto"
    return compaction


def phase_main(torch, sim, counters, ex, urm, dev):
    """The main path on `urm` (users x items, f32 half-star ratings)."""
    from similaripy_tpu_torch.engine import compact, splus, symmetric
    from similaripy_tpu_torch.engine.assembly import assemble
    from similaripy_tpu_torch.engine.params import SPlusParams
    from similaripy_tpu_torch.engine.preprocess import preprocess

    rng = np.random.default_rng(0)
    C = urm.shape[1]
    items = np.sort(rng.choice(C, N_TARGETS, replace=False))
    users = np.sort(rng.choice(urm.shape[0], N_TARGETS, replace=False))
    sample = np.sort(rng.choice(C, N_ORACLE_ROWS, replace=False))
    popular = np.sort(np.argsort(-np.diff(urm.tocsc().indptr), kind="stable")[:N_POPULAR])
    common = dict(verbose=False, format_output="csr", device=dev)

    calls = {}
    # slices 1 and 2 hold these calls to the general route (K1, K5): the
    # compaction route is off for them; slice 3's calls below set it
    compact.MODE = "off"

    call = _make_call(torch, counters, ex, dev, calls)

    def plain_route(m1, m2, params, k, targets, filt=None, **prep):
        """The same call through the engine with the plain versions."""
        pre = preprocess(m1, m2 if m2 is not None else m1.T, k=k, target_rows=targets,
                         filter_cols=filt, self_similar=m2 is None, **prep)
        vals, idx = ex.execute(pre, params, compute_dtype="auto", device=dev, _tile_fn="plain")
        return assemble(vals, idx, pre.targets, pre.n_output_rows, pre.n_output_cols, "csr",
                        native=False)

    # the main path, every count read right after its call: the model build
    # over all items (symmetric route), scoring, the targeted cosine over
    # 1,024 items (general route), the same in int8, and an asymmetric build
    t = time.perf_counter()
    urm_n = sim.bm25(urm, device=dev)
    _sync(torch, dev)
    bm25_s = time.perf_counter() - t
    W = call("cosine", "cosine(bm25(urm).T, k=100)",
             lambda: sim.cosine(urm_n.T, k=100, **common), "symmetric")
    recs = call("recommend", "recommend(bm25(urm), W, k=10)",
                lambda: sim.recommend(urm_n, W, k=10, target_rows=users, **common), "general")
    # the fold needs every rating > 0: on the tracked data BM25 weights some
    # ratings of the most popular items below 0, so its gate refuses
    bm25_min = float(urm_n.data.min())
    if (calls["recommend"]["plan"]["fold"] is None) != (bm25_min <= 0):
        raise AssertionError(f"recommend(bm25(urm)): fold {calls['recommend']['plan']['fold']} "
                             f"with the smallest weight {bm25_min}")
    # recommend on the raw ratings (all > 0) with the exclude-seen fold (the
    # default) and with it off, in turns on, off, on, off (the second turn
    # of each runs on warm caches); the timing laps of each
    splus.TIMING = True
    laps = {}
    try:
        for turn, fold_on in (("0", True), ("0", False), ("1", True), ("1", False)):
            ex.FOLD_FILTER = fold_on
            key = ("recommend_raw" if fold_on else "recommend_raw_masked") + (
                "" if turn == "0" else "_1")
            out = call(key, "recommend(urm, W, k=10)" + ("" if fold_on else ", fold off"),
                       lambda: sim.recommend(urm, W, k=10, target_rows=users, **common),
                       "general")
            laps[key] = dict(splus.last_laps)
            if key == "recommend_raw":
                recs_raw = out
            elif key == "recommend_raw_masked":
                masked = out
    finally:
        ex.FOLD_FILTER = True
        splus.TIMING = False
    fold = _fold_check(calls, recs_raw, masked, laps)
    fold["bm25"] = {"fold": calls["recommend"]["plan"]["fold"], "min_weight": bm25_min}
    G = call("cosine_targeted", "cosine(bm25(urm).T, k=100), 1,024 items",
             lambda: sim.cosine(urm_n.T, k=100, target_rows=items, **common), "general")
    W8 = call("cosine_int8", "cosine(urm.T, k=100) int8",
              lambda: sim.cosine(urm.T, k=100, **common), "symmetric")
    G8 = call("cosine_int8_targeted", "cosine(urm.T, k=100) int8, 1,024 items",
              lambda: sim.cosine(urm.T, k=100, target_rows=items, **common), "general")
    for key in ("cosine_int8", "cosine_int8_targeted"):
        if calls[key]["plan"]["compute_dtype"] != "int8":
            raise AssertionError(f"{key} ran {calls[key]['plan']['compute_dtype']}, not int8")
    pop_t = urm_n[:, popular].T.tocsr()
    A = call("asymmetric_cosine", "asymmetric_cosine(bm25(urm)[:, popular].T, alpha=0.3, k=100)",
             lambda: sim.asymmetric_cosine(pop_t, alpha=0.3, k=100, **common), "symmetric")
    if not calls["asymmetric_cosine"]["plan"]["asym"]:
        raise AssertionError("asymmetric_cosine did not run the asymmetric epilogue")
    # precision='high' on f32: the build over all items in the split-bf16x3
    # mode 'both' (K2 on the tensor cores, K5 densifying the [hi; lo]
    # stacks), and recommend on the raw ratings (exact in bf16) in 'rhs',
    # the scoring shape of the Makefile's bench-scoring, with the fold
    high = dict(compute_dtype="float32", precision="high")
    Wh = call("cosine_high", "cosine(bm25(urm).T, k=100), precision='high'",
              lambda: sim.cosine(urm_n.T, k=100, **high, **common), "symmetric")
    recs_high = call("recommend_high", "recommend(urm, W, k=10), precision='high'",
                     lambda: sim.recommend(urm, W, k=10, target_rows=users, **high, **common),
                     "general")
    for key, mode in (("cosine_high", "both"), ("recommend_high", "rhs")):
        if calls[key]["plan"]["f32x3"] != mode:
            raise AssertionError(f"{key} ran split mode {calls[key]['plan']['f32x3']}, not {mode}")
    if calls["recommend_high"]["plan"]["fold"] is None:
        raise AssertionError("recommend(urm, W), precision='high': the fold did not arm")

    # checks
    checks = {}
    t = time.perf_counter()
    item_t, raw_t = urm_n.T.tocsr(), urm.T.tocsr()
    cos = dict(l2=1, c1=0.5, c2=0.5)
    _same("recommend", recs, plain_route(urm_n, W.T.tocsr(), SPlusParams(), 10, users,
                                         filt=urm_n), exact=False)
    _same("recommend, raw ratings, folded", recs_raw,
          plain_route(urm, W.T.tocsr(), SPlusParams(), 10, users, filt=urm), exact=False)
    _same("cosine, 1,024 items", G,
          plain_route(item_t, None, SPlusParams(l2=1), 100, items, **cos), exact=False)
    _same("cosine int8, 1,024 items", G8,
          plain_route(raw_t, None, SPlusParams(l2=1), 100, items, **cos), exact=True)
    checks["plain_route_s"] = time.perf_counter() - t

    t = time.perf_counter()
    _check_oracle("cosine", W, sample, _oracle_rows(item_t, urm_n, sample, 100, l2=True))
    _check_oracle("cosine int8", W8, sample, _oracle_rows(raw_t, urm, sample, 100, l2=True))
    usample = np.sort(rng.choice(users, N_ORACLE_ROWS, replace=False))
    _check_oracle("recommend", recs, usample,
                  _oracle_rows(urm_n, W.T, usample, 10, l2=False, filt=urm_n))
    # precision='high' against the float64 oracle and against 'highest'
    _check_oracle("cosine, precision='high'", Wh, sample,
                  _oracle_rows(item_t, urm_n, sample, 100, l2=True))
    _check_oracle("recommend(urm), precision='high'", recs_high, usample,
                  _oracle_rows(urm, W.T, usample, 10, l2=False, filt=urm))
    high_vs_highest = {}
    for name, got, ref in (("cosine", Wh, W), ("recommend", recs_high, recs_raw)):
        got, ref = got.tocsr(), ref.tocsr()
        if got.nnz != ref.nnz:
            raise AssertionError(f"{name}, precision='high': nnz {got.nnz} vs {ref.nnz}")
        np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-4,
                                   err_msg=f"{name}, precision='high': check_sum vs 'highest'")
        high_vs_highest[name] = {"nnz": int(got.nnz),
                                 "check_sum_rel": abs(check_sum(got) / check_sum(ref) - 1.0)}
    checks["high_vs_highest"] = high_vs_highest
    checks["oracle_s"] = time.perf_counter() - t

    # the symmetric route against the general route on the same rows
    t = time.perf_counter()
    _same_rows("cosine", W, G, items, exact=False)
    _same_rows("cosine int8", W8, G8, items, exact=True)
    rev = np.arange(N_POPULAR)[::-1].copy()  # not natural order: the general route
    general_a = sim.asymmetric_cosine(pop_t, alpha=0.3, k=100, target_rows=rev, **common)
    if ex.last_route != "general":
        raise AssertionError("the reversed-rows asymmetric_cosine did not take the general route")
    _same_rows("asymmetric_cosine", A, general_a, np.arange(N_POPULAR), exact=False)
    checks["general_route_s"] = time.perf_counter() - t

    # the same call with anchor groups of three 1,024-wide tiles (the main
    # path plans one tile per group): band sweeps with dead and diagonal
    # blocks, second anchors sliced, and padding tiles (16 tiles -> 18)
    t = time.perf_counter()
    real_plan = symmetric._plan
    symmetric._plan = lambda *a: (1024, 3, real_plan(*a)[2])
    try:
        grouped = sim.asymmetric_cosine(pop_t, alpha=0.3, k=100, **common)
    finally:
        symmetric._plan = real_plan
    if (ex.last_route, ex.last_plan["gt"], ex.last_plan["n_tiles"]) != ("symmetric", 3, 18):
        raise AssertionError(f"grouped plan not taken: {ex.last_route} {ex.last_plan}")
    _same_rows("asymmetric_cosine gt=3", grouped, A, np.arange(N_POPULAR), exact=False)
    checks["grouped_plan_s"] = time.perf_counter() - t

    t = time.perf_counter()
    t8k = np.sort(np.random.default_rng(0).choice(C, N_COMPACT_TARGETS, replace=False))
    compaction = _compaction_calls(sim, compact, call, calls, common, urm, urm_n, W, users,
                                   item_t, t8k)
    checks["compaction_s"] = time.perf_counter() - t

    seen = urm_n[users].tocsr()
    for name, res in (("recommend", recs), ("recommend, raw ratings, folded", recs_raw)):
        recs_u = res.tocsr()[users]
        for r in range(users.shape[0]):
            s = set(seen.indices[seen.indptr[r]:seen.indptr[r + 1]].tolist())
            g = recs_u.indices[recs_u.indptr[r]:recs_u.indptr[r + 1]].tolist()
            if s.intersection(g):
                raise AssertionError(f"{name}: user {users[r]} got a seen item")
    for name, res in (("recommend, precision='high'", recs_high),):
        recs_u = res.tocsr()[users]
        for r in range(users.shape[0]):
            s = set(seen.indices[seen.indptr[r]:seen.indptr[r + 1]].tolist())
            if s.intersection(recs_u.indices[recs_u.indptr[r]:recs_u.indptr[r + 1]].tolist()):
                raise AssertionError(f"{name}: user {users[r]} got a seen item")
    state = {"urm_n": urm_n, "W": W, "users": users, "items": items, "pop_t": pop_t,
             "t8k": t8k, "plans": {k: c["plan"] for k, c in calls.items()},
             "recs_raw": recs_raw, "G": G, "W8": W8}
    return {"bm25_seconds": bm25_s, "calls": list(calls.values()), "checks": checks,
            "fold": fold, "compaction": compaction}, state


def _fold_check(calls, folded, masked, laps):
    """recommend with the fold armed equals recommend with it off: the plan
    shows the fold's M on the first call and None on the second, equal nnz
    and check_sum within rtol 1e-5, and the largest value difference
    between the rows' sorted values."""
    on, off = calls["recommend_raw"], calls["recommend_raw_masked"]
    if on["plan"].get("fold") is None or off["plan"].get("fold") is not None:
        raise AssertionError(f"fold: armed {on['plan'].get('fold')}, "
                             f"off {off['plan'].get('fold')}")
    a, b = folded.tocsr(), masked.tocsr()
    if a.nnz != b.nnz or not np.array_equal(a.indptr, b.indptr):
        raise AssertionError(f"fold: nnz {a.nnz} vs {b.nnz} with the fold off")
    np.testing.assert_allclose(check_sum(a), check_sum(b), rtol=1e-5,
                               err_msg="fold: check_sum vs the fold off")
    return {"M": on["plan"]["fold"], "nnz": int(a.nnz), "check_sum": [on["check_sum"],
            off["check_sum"]], "max_value_diff": float(np.max(np.abs(
                _row_sorted(a) - _row_sorted(b)), initial=0.0)),
            "ids_equal": bool(np.array_equal(a.indices, b.indices)),
            "seconds": {k: calls[k]["seconds"] for k in laps}, "laps": laps}


def _row_sorted(x):
    """A CSR's values sorted within each row (rows in order)."""
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    return x.data[np.lexsort((x.data, rows))].astype(np.float64)


def _rows_equal(name, got, ref, exact):
    """Every row of two results: equal nnz per row; identical sorted values
    (exact), or check_sum within rtol 1e-5; and the same column id at every
    entry clear of ties (``_ids_agree``). Returns the share of entries
    whose id was compared."""
    got, ref = got.tocsr(), ref.tocsr()
    if got.shape != ref.shape or not np.array_equal(got.indptr, ref.indptr):
        raise AssertionError(f"{name}: nnz {got.nnz} vs the single device's {ref.nnz}")
    if exact:
        if not np.array_equal(_row_sorted(got), _row_sorted(ref)):
            raise AssertionError(f"{name}: values differ from the single device's")
    else:
        np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-5,
                                   err_msg=f"{name}: check_sum vs the single device")
    return _ids_agree(name, got, ref, 0.0 if exact else 1e-5)


def _sorted_rows(x):
    """(values, ids) of a CSR's rows, each sorted by value descending (ties
    by id), as (rows, widest row) arrays padded with -inf and -1."""
    counts = np.diff(x.indptr)
    rows = np.repeat(np.arange(x.shape[0]), counts)
    order = np.lexsort((x.indices, -x.data.astype(np.float64), rows))
    pos = np.arange(x.nnz) - x.indptr[rows]
    width = int(counts.max(initial=0))
    v = np.full((x.shape[0], width), -np.inf)
    i = np.full((x.shape[0], width), -1, np.int64)
    v[rows, pos] = x.data[order]
    i[rows, pos] = x.indices[order]
    return v, i


def _ids_agree(name, got, ref, rel):
    """The same column id in both results at every entry whose value is
    clear, by a relative gap `rel`, of its row neighbours and, in the
    widest rows (which the top-k may have cut), of the row's last value:
    there the id does not depend on how a top-k breaks ties. Returns the
    share of entries compared."""
    gv, gi = _sorted_rows(got)
    rv, ri = _sorted_rows(ref)
    ok = _not_tied(rv.T, rel).T
    width = np.isfinite(rv).sum(axis=1)
    last = np.where(width > 0, rv[np.arange(rv.shape[0]), np.maximum(width - 1, 0)], 0.0)
    with np.errstate(invalid="ignore"):
        ok &= ~((width == rv.shape[1])[:, None]
                & (np.abs(rv - last[:, None]) <= rel * np.abs(last[:, None])))
    np.testing.assert_allclose(gv[ok], rv[ok], rtol=max(rel, 1e-7), atol=0,
                               err_msg=f"{name}: values at untied entries")
    bad = int(np.count_nonzero(ok & (gi != ri)))
    if bad:
        raise AssertionError(f"{name}: {bad} untied entries hold another column id "
                             "than the single device's")
    return float(ok.sum()) / max(ref.nnz, 1)


# ---------------------------------------------------------------------------
# phase 3b: multi-device execution (mesh=) over torch.distributed
# ---------------------------------------------------------------------------

MESH_SHAPES_2 = ((1, 2), (2, 1))


def phase_mesh(torch, sim, counters, ex, urm, dev, state):
    """(a) one rank over NCCL with mesh (1, 1): the f32 cosine over all
    items (sharded symmetric: K2, K5), recommend(urm, W) for the 1,024 users
    with the fold and the cosine for the 1,024 items (grouped sharded: K1, K5),
    each equal to phase main's single-device result. (b) two ranks over
    gloo sharing the card, meshes (1, 2) and (2, 1): the exact int8 cosine
    over all items and recommend(urm, W); both ranks return the same result, equal
    to the single-device one, each rank launches its schedule_anatomy share
    of K2 and no plain version. The stores live in a temporary directory."""
    import tempfile

    import scipy.sparse as sp
    import torch.distributed as dist

    from similaripy_tpu_torch.parallel import make_mesh

    urm_n, W, users, items = state["urm_n"], state["W"], state["users"], state["items"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="similaripy_mesh_") as tmp:
        # (a) this process, one rank over NCCL
        # one host: NCCL's and gloo's sockets on the loopback interface
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(torch.cuda.current_device())
        t = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh(1, 1)
            init_s = time.perf_counter() - t
            calls = {}
            call = _make_call(torch, counters, ex, dev, calls)
            common = dict(verbose=False, format_output="csr", device=dev, mesh=mesh)
            got = call("cosine", "cosine(bm25(urm).T, k=100), mesh (1, 1)",
                       lambda: sim.cosine(urm_n.T, k=100, **common), "sym_sharded")
            calls["cosine"]["ids_compared"] = _rows_equal("mesh cosine", got, W, exact=False)
            got = call("recommend", "recommend(urm, W, k=10), mesh (1, 1)",
                       lambda: sim.recommend(urm, W, k=10, target_rows=users, **common),
                       "sharded")
            if calls["recommend"]["plan"]["fold"] is None:
                raise AssertionError("mesh recommend: the fold did not arm")
            calls["recommend"]["ids_compared"] = _rows_equal(
                "mesh recommend", got, state["recs_raw"], exact=False)
            got = call("cosine_targeted", "cosine(bm25(urm).T, k=100), 1,024 items, mesh (1, 1)",
                       lambda: sim.cosine(urm_n.T, k=100, target_rows=items, **common), "sharded")
            calls["cosine_targeted"]["ids_compared"] = _rows_equal(
                "mesh cosine, 1,024 items", got, state["G"], exact=False)
        finally:
            dist.destroy_process_group()
        out["nccl_1"] = {"init_s": init_s, "calls": list(calls.values())}

        # (b) two ranks over gloo on this one card
        sim.clear_caches()
        torch.cuda.empty_cache()
        sp.save_npz(os.path.join(tmp, "W.npz"), W, compressed=False)
        np.save(os.path.join(tmp, "users.npy"), users)
        t = time.perf_counter()
        torch.multiprocessing.spawn(_mesh_rank, args=(2, tmp), nprocs=2, join=True)
        spawn_s = time.perf_counter() - t
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        out["gloo_2"] = {"spawn_s": spawn_s,
                         "ranks": _check_gloo_ranks(tmp, ranks, state)}
    return out


def _mesh_rank(rank, world, tmp):
    """One rank of the gloo world: the int8 cosine over all items and
    recommend for the 1,024 users on each mesh of MESH_SHAPES_2, each
    result saved to `tmp` beside the rank's walls, launches and plans."""
    import datetime

    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    sys.path.insert(0, HERE)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/gloo_store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        import similaripy_tpu_torch as sim
        from similaripy_tpu_torch.engine import build
        from similaripy_tpu_torch.engine import executor as ex
        from similaripy_tpu_torch.engine import gather, panel_topk, scatter, sym_topk, tile_topk
        from similaripy_tpu_torch.parallel import make_mesh

        build.load()
        counters = {"tile_topk": tile_topk, "sym_topk": sym_topk, "scatter": scatter,
                    "panel_topk": panel_topk, "gather": gather}
        urm = sp.load_npz(DATA).tocsr().astype(np.float32)
        W = sp.load_npz(os.path.join(tmp, "W.npz")).tocsr()
        users = np.load(os.path.join(tmp, "users.npy"))
        dev = torch.device("cuda", 0)
        record = {"rank": rank, "calls": {}}
        for shape in MESH_SHAPES_2:
            mesh = make_mesh(*shape)
            record["ranks_per_card"] = mesh.ranks_per_card
            calls = {}
            call = _make_call(torch, counters, ex, dev, calls)
            common = dict(verbose=False, format_output="csr", device=dev, mesh=mesh)
            tag = f"{shape[0]}x{shape[1]}"
            for key, name, fn, route in (
                ("cosine_int8", f"cosine(urm.T, k=100) int8, mesh {shape}",
                 lambda: sim.cosine(urm.T, k=100, **common), "sym_sharded"),
                ("recommend", f"recommend(urm, W, k=10), mesh {shape}",
                 lambda: sim.recommend(urm, W, k=10, target_rows=users, **common),
                 "sharded"),
            ):
                res = call(key, name, fn, route)
                sp.save_npz(os.path.join(tmp, f"rank{rank}_{tag}_{key}.npz"), res,
                            compressed=False)
                c = calls[key]
                c["plan"] = {k: v for k, v in c["plan"].items()
                             if isinstance(v, (int, float, str, list, tuple, type(None)))}
                c["plain_calls"] = {k: m.plain_calls for k, m in counters.items()}
                record["calls"][f"{tag}_{key}"] = c
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()


def _geometry(plan):
    """A mesh plan without its rank-specific entries."""
    own = ("rank", "coordinate", "blocks", "scatters")
    return {k: v for k, v in plan.items() if k not in own}


def _check_gloo_ranks(tmp, ranks, state):
    """Both ranks returned the same result, equal to the single device's
    (int8 values identical; recommend by nnz and check_sum rtol 1e-5); the
    K2 launches of each rank, and their sum, equal schedule_anatomy's
    counts for the plan the ranks chose; no rank ran a plain version."""
    import scipy.sparse as sp

    from similaripy_tpu_torch.engine.sym_sharded import schedule_anatomy

    for r in ranks:
        if r["ranks_per_card"] != 2:
            raise AssertionError(f"rank {r['rank']}: {r['ranks_per_card']} ranks on its card")
    summary = {}
    for shape in MESH_SHAPES_2:
        tag = f"{shape[0]}x{shape[1]}"
        for key, ref, exact in (("cosine_int8", state["W8"], True),
                                ("recommend", state["recs_raw"], False)):
            results = [sp.load_npz(os.path.join(tmp, f"rank{r}_{tag}_{key}.npz")).tocsr()
                       for r in range(len(ranks))]
            for r, res in enumerate(results[1:], 1):
                for f in ("indptr", "indices", "data"):
                    if not np.array_equal(getattr(res, f), getattr(results[0], f)):
                        raise AssertionError(f"mesh {tag} {key}: rank {r} differs from rank 0")
            ids = _rows_equal(f"mesh {tag} {key}", results[0], ref, exact=exact)
            calls = [r["calls"][f"{tag}_{key}"] for r in ranks]
            plan = calls[0]["plan"]
            if any(_geometry(c["plan"]) != _geometry(plan) for c in calls):
                raise AssertionError(f"mesh {tag} {key}: the ranks planned differently")
            if any(any(c["plain_calls"].values()) for c in calls):
                raise AssertionError(f"mesh {tag} {key}: a rank ran a plain version")
            entry = {"seconds": [c["seconds"] for c in calls],
                     "launches": [c["launches"] for c in calls], "nnz": results[0].nnz,
                     "check_sum": check_sum(results[0]), "ids_compared": ids}
            if key == "cosine_int8":
                if plan["compute_dtype"] != "int8":
                    raise AssertionError(f"mesh {tag} cosine ran {plan['compute_dtype']}")
                an = schedule_anatomy(n_tiles=plan["n_tiles"], gt=plan["gt"], N=len(ranks))
                k2 = [c["launches"]["sym_topk"] for c in calls]
                if k2 != an["k2_blocks"] or sum(k2) != sum(an["k2_blocks"]):
                    raise AssertionError(f"mesh {tag}: K2 launches {k2}, anatomy "
                                         f"{an['k2_blocks']}")
                entry.update(plan={k: plan[k] for k in ("tc", "gt", "n_tiles", "pairs")},
                             anatomy=an)
            elif plan["fold"] is None:
                raise AssertionError(f"mesh {tag} recommend: the fold did not arm")
            summary[f"{tag}_{key}"] = entry
    return summary


# ---------------------------------------------------------------------------
# phase 4: the kernels at the main path's shapes
# ---------------------------------------------------------------------------


def _time_ms(torch, fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _profile(torch, fn):
    """One warm run of `fn` under torch.profiler: its wall, the device time
    of every kernel and copy (summed by name), and the device's idle share
    of the wall."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a marker launch first: the profiler has dropped the record of a
        # window's first kernel (K2's product once, K3's twice)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    device = {}
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0) / 1e3
        if ms > 0 and "spin_kernel" not in e.key:
            device[e.key[:90]] = {"ms": ms, "count": e.count}
    busy = sum(v["ms"] for v in device.values())
    top = dict(sorted(device.items(), key=lambda kv: -kv[1]["ms"])[:6])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy else None, "top": top}


def _mm_f32(torch, a, b):
    """One cuBLAS bf16 product with an f32 result: torch.mm's out_dtype
    where the installed torch has it, else the bf16 product widened (what
    LIBRARY_BF16_MM says was used)."""
    global LIBRARY_BF16_MM
    if LIBRARY_BF16_MM != "torch.matmul(bf16).float()":
        try:
            out = torch.mm(a, b, out_dtype=torch.float32)
            LIBRARY_BF16_MM = "torch.mm(bf16, bf16, out_dtype=float32)"
            return out
        except (TypeError, RuntimeError):  # no out_dtype in this torch
            LIBRARY_BF16_MM = "torch.matmul(bf16).float()"
    return torch.matmul(a, b).float()


LIBRARY_BF16_MM = None


def _split_library(torch, a, d, split, u_pad):
    """The library chain's product of a split mode: its phases, each one
    cuBLAS bf16 product with an f32 result, summed."""
    a_hi, a_lo = (a[:, :u_pad], a[:, u_pad:]) if split in ("both", "lhs") else (a, None)
    d_hi, d_lo = (d[:u_pad], d[u_pad:]) if split in ("both", "rhs") else (d, None)
    xy = _mm_f32(torch, a_hi, d_hi)
    if a_lo is not None:
        xy += _mm_f32(torch, a_lo, d_hi)
    if d_lo is not None:
        xy += _mm_f32(torch, a_hi, d_lo)
    return xy


def _bound(ops, nbytes, int8, peak=None):
    ops_ms = 1e3 * ops / (peak or (PEAK_INT8_OPS if int8 else PEAK_F32_FLOPS))
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _time_k1(torch, tt, panel, tile, plan, int8, split=None, bf16=False):
    """K1 (kernel, plain, library yardstick) on one panel x tile of the
    main path, as cosine, checked against the plain version; `split`
    ('both', 'rhs') runs that split-bf16x3 mode on the f32 operands, `bf16`
    the operands rounded to bf16 (compute_dtype='bfloat16')."""
    dev = torch.device("cuda")
    trp, u_pad, tc, k_pad = plan["trp"], plan["u_pad"], plan["tc"], plan["k_pad"]
    dtype = torch.int8 if int8 else torch.bfloat16 if bf16 else torch.float32

    def dense(m, shape):
        out = torch.zeros(shape, dtype=torch.float32, device=dev)
        c = m.tocoo()
        out[torch.from_numpy(c.row).to(dev).long(), torch.from_numpy(c.col).to(dev).long()] = \
            torch.from_numpy(c.data).to(dev)
        return out

    a32, d32 = dense(panel[:trp], (trp, u_pad)), dense(tile[:, :tc], (u_pad, tc))
    xn, yn = torch.sqrt((a32 * a32).sum(1)), torch.sqrt((d32 * d32).sum(0))
    scale = 2.0 if int8 else 1.0  # half-star ratings integerize at 2
    a, d = (a32 * scale).to(dtype), (d32 * scale).to(dtype)
    if split:
        a = tt.split_bf16x3(a32, 1) if split in ("both", "lhs") else a32.bfloat16()
        d = tt.split_bf16x3(d32, 0) if split in ("both", "rhs") else d32.bfloat16()
    del a32, d32
    ones_r, ones_c = torch.ones_like(xn), torch.ones_like(yn)
    pvec = torch.zeros(16, device=dev)
    pvec[2], pvec[4], pvec[5] = 1.0, 1.0, 1.0  # cosine: l2 = 1
    pvec[9] = 1.0 / scale**2
    flags = (False, True, False, False, False, True)
    carry = (torch.full((k_pad, trp), float("-inf"), device=dev),
             torch.zeros((k_pad, trp), dtype=torch.int32, device=dev))
    args = (a, d, ones_r, xn, ones_r, ones_c, yn, ones_c, pvec)
    kw = dict(carry=carry, flags=flags, k_pad=k_pad, int8_mode=int8)
    if split:
        kw["split_f32"] = split
    got = [t.cpu().numpy() for t in tt.fused_tile_topk(*args, **kw)]
    ref = [t.cpu().numpy() for t in tt.fused_tile_topk_plain(*args, **kw)]
    if split or bf16:
        # the bf16 product is the split modes' kernel with one phase: the
        # same full-depth tolerance
        from torch_k1_cases import SPLIT_RTOL_FULL_K, assert_same_split

        assert_same_split(got, ref, flags, SPLIT_RTOL_FULL_K)
        fin = np.isfinite(ref[0])
        err = float(np.max(np.abs(got[0][fin] - ref[0][fin]))) if fin.any() else 0.0
    else:
        err = _compare("times K1", "int8" if int8 else "f32", got, ref)
    rel = _rel_err(got[0], ref[0])

    kernel_ms = _time_ms(torch, lambda: tt.fused_tile_topk(*args, **kw), 5)
    launches = _profile(torch, lambda: tt.fused_tile_topk(*args, **kw))
    plain_ms = _time_ms(torch, lambda: tt.fused_tile_topk_plain(*args, **kw), 3)
    if int8:
        def library():
            return torch.topk(torch._int_mm(a, d), k_pad, dim=1)
    elif split or bf16:
        def library():
            return torch.topk(_split_library(torch, a, d, split, u_pad), k_pad, dim=1)
    else:
        def library():
            return torch.topk(torch.matmul(a, d), k_pad, dim=1)
    library_ms = _time_ms(torch, library, 5)
    # operand bytes as stored (a split stack's two halves), each read once
    nbytes = (a.numel() * a.element_size() + d.numel() * d.element_size()
              + 4.0 * (3 * trp + 3 * tc + 16 + 4 * k_pad * trp))
    phases = {None: 1, "both": 3, "rhs": 2, "lhs": 2}[split]
    ops = 2.0 * trp * u_pad * tc * phases  # every phase's products
    bound_ms, bound_by = _bound(ops, nbytes, int8,
                                PEAK_BF16_FLOPS if split or bf16 else None)
    return {
        "shape": {"trp": trp, "u_pad": u_pad, "tc": tc, "k_pad": k_pad,
                  "dtype": f"split-bf16x3 {split}" if split else str(dtype)[6:]},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_chain": LIBRARY_BF16_MM if split or bf16 else None,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "kernel_tops": ops / kernel_ms / 1e9, "max_abs_err": err, "max_rel_err": rel,
        "profile": launches, "split": _tile_split(launches),
    }


def _sym_setup(torch, m_items, compute_dtype, plan, split=False, **prep):
    """The main path's symmetric geometry for `m_items` (items x users):
    its cached device COO and vectors, as the executor holds them (with
    `split`, the COO of the [hi; lo] stacks)."""
    from similaripy_tpu_torch.engine import symmetric
    from similaripy_tpu_torch.engine.preprocess import preprocess

    dev = torch.device("cuda")
    pre = preprocess(m_items, m_items.T, k=100, self_similar=True, **prep)
    coo, vecs, _ = symmetric.cached_prep_symmetric(
        pre, compute_dtype, plan["tc"], plan["n_tiles"], plan["u_pad"], dev, split)
    return coo, vecs


def _time_k2(torch, st, sc, coo, vecs, plan, params, mode, diagonal):
    """K2 on one block of the main path in `mode` (f32, bf16, int8, or
    split: the split-bf16x3 mode of precision='high', `coo` the split
    COO): the first anchor group against a live tile right of it, or
    against its own first tile (diagonal)."""
    from similaripy_tpu_torch.engine.params import build_pvec

    dev = torch.device("cuda")
    tc, gt, u_pad, k_pad = plan["tc"], plan["gt"], plan["u_pad"], plan["k_pad"]
    sw = gt * tc
    int8, split = mode == "int8", mode == "split"
    cdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
           "split": torch.bfloat16}[mode]
    tile_k = 2 * u_pad if split else u_pad  # a split tile's [hi; lo] rows
    anchors = sc.densify_tiles(coo["ru"][:gt], coo["sl"][:gt], coo["vv"][:gt],
                               u_pad=tile_k, tc=tc, cdt=cdt)
    t = 0 if diagonal else plan["n_tiles"] - 1
    d = anchors[0] if diagonal else sc.densify_tiles(
        coo["ru"][t:t + 1], coo["sl"][t:t + 1], coo["vv"][t:t + 1], u_pad=tile_k, tc=tc,
        cdt=cdt)[0]
    pv = np.zeros(16, np.float32)
    pv[:10] = build_pvec(params, 0.25 if int8 else 1.0)
    pv[10:14] = (t * tc, 0, t, 0)
    crv = torch.full((k_pad, sw), float("-inf"), device=dev)
    cri = torch.zeros((k_pad, sw), dtype=torch.int32, device=dev)
    ccv = torch.full((k_pad, tc), float("-inf"), device=dev)
    cci = torch.zeros((k_pad, tc), dtype=torch.int32, device=dev)
    x = [vecs[f"x_{n}"][:gt].reshape(-1) for n in "tcd"]
    y = [vecs[f"y_{n}"][t] for n in "tcd"]
    args = (anchors, d, *x, *y, crv, cri, crv[k_pad - 1].view(sw, 1), ccv, cci,
            torch.from_numpy(pv).to(dev))
    kw = dict(flags=params.static_flags(), k=k_pad, tc=tc, int8_mode=int8, split_f32=split)
    got = [o.cpu().numpy() for o in st.fused_sym_topk(*args, **kw)]
    ref = [o.cpu().numpy() for o in st.fused_sym_topk_plain(*args, **kw)]
    if split:  # ids not compared across the top-k's cut (tests/torch_k2_cases.py)
        from torch_k1_cases import SPLIT_RTOL_FULL_K
        from torch_k2_cases import assert_same

        assert_same("split", got, ref, kw["flags"], SPLIT_RTOL_FULL_K)
        err = max(float(np.max(np.abs(got[s][np.isfinite(ref[s])] - ref[s][np.isfinite(ref[s])]),
                               initial=0.0)) for s in (0, 2))
    else:
        err = max(_compare(f"times K2 {side}", mode, got[s], ref[s])
                  for side, s in (("row", slice(0, 2)), ("col", slice(2, 4))))
    rel = max(_rel_err(got[0], ref[0]), _rel_err(got[2], ref[2]))

    kernel_ms = _time_ms(torch, lambda: st.fused_sym_topk(*args, **kw), 5)
    launches = _profile(torch, lambda: st.fused_sym_topk(*args, **kw))
    plain_ms = _time_ms(torch, lambda: st.fused_sym_topk_plain(*args, **kw), 3)
    from similaripy_tpu_torch.engine.tile_topk import splus_epilogue

    pvl = pv.tolist()
    a2 = anchors.transpose(1, 2).reshape(sw, tile_k)  # (sw, tile_k), a view for gt = 1
    if int8:
        a2 = a2.contiguous()  # cuBLASLt's int8 product takes row-major operands

    def library():
        if int8:
            xy = torch._int_mm(a2, d).float() * pvl[9]
        elif split:
            xy = _split_library(torch, a2, d, "both", u_pad)
        elif mode == "bf16":
            xy = _mm_f32(torch, a2, d)
        else:
            xy = torch.matmul(a2, d).float()
        val = splus_epilogue(xy, xy != 0, *x, *y, pvl, kw["flags"])
        return torch.topk(val, k_pad, dim=1), torch.topk(val.T, k_pad, dim=1)

    library_ms = _time_ms(torch, library, 3)
    n_live = min((t + 1) * tc, sw)  # every anchor row is live here (t >= a0 = 0)
    ops = 2.0 * n_live * tc * u_pad * (3 if split else 1)  # a split block's three phases
    item = anchors.element_size()
    nbytes = (item * (sw * tile_k + tile_k * tc) + 4.0 * (6 * sw + 6 * tc + 16)
              + 2 * 8.0 * k_pad * (sw + tc))  # carries in and out, values and ids
    bound_ms, bound_by = _bound(ops, nbytes, int8,
                                PEAK_BF16_FLOPS if mode in ("bf16", "split") else None)
    return {
        "block": "diagonal" if diagonal else "live off-diagonal",
        "shape": {"sw": sw, "tc": tc, "u_pad": u_pad, "k_pad": k_pad, "t": t,
                  "dtype": "split-bf16x3 both" if split else str(cdt).replace("torch.", "")},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_chain": LIBRARY_BF16_MM if mode in ("bf16", "split") else None,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "kernel_tops": ops / kernel_ms / 1e9, "max_abs_err": err, "max_rel_err": rel,
        "profile": launches, "split": _k2_split(launches),
    }


def _k2_split(profile):
    """Device ms of K2's three launches in one profiled call: the product
    with its epilogue, the row-side merge, the col-side merge; None for a
    launch of which the profiler kept no record."""
    split = dict.fromkeys(("product_ms", "row_merge_ms", "col_merge_ms"))
    for name, v in profile["top"].items():
        if "merge_kernel<true>" in name:
            key = "row_merge_ms"
        elif "merge_kernel<false>" in name:
            key = "col_merge_ms"
        elif any(k in name for k in ("sym_simt_kernel", "sym_s8_kernel", "sym_bf16_kernel")):
            key = "product_ms"
        else:
            continue
        split[key] = (split[key] or 0.0) + v["ms"]
    return split


def _tile_split(profile):
    """Device ms of K1's or K3's two launches in one profiled call: the
    product with its epilogue and the top-k; None for a launch of which the
    profiler kept no record."""
    split = dict.fromkeys(("product_ms", "topk_ms"))
    for name, v in profile["top"].items():
        if "topk_kernel" in name:
            key = "topk_ms"
        elif any(k in name for k in ("tile_s8_kernel", "tile_simt_kernel", "tile_bf16_kernel")):
            key = "product_ms"
        else:
            continue
        split[key] = (split[key] or 0.0) + v["ms"]
    return split


def _split_line(phase, out, keys, attrs):
    """One line with the per-launch split of each timed call and the
    product kernels' registers, spills, shared memory and blocks per SM."""
    emit({"phase": phase,
          "calls": {k: {**out[k]["split"], "kernel_ms": out[k]["kernel_ms"],
                        "tops": out[k]["kernel_tops"]} for k in keys},
          "product_kernels": attrs})


def _time_k5(torch, sc, coo, plan, int8):
    """K5 on one inner tile of the main path."""
    tc, u_pad = plan["tc"], plan["u_pad"]
    cdt = torch.int8 if int8 else torch.float32
    t = plan["n_tiles"] - 1
    ru, sl, vv = coo["ru"][t:t + 1], coo["sl"][t:t + 1], coo["vv"][t:t + 1]
    got = sc.densify_tiles(ru, sl, vv, u_pad=u_pad, tc=tc, cdt=cdt)
    ref = sc.densify_tiles_plain(ru, sl, vv, u_pad=u_pad, tc=tc, cdt=cdt)
    if not torch.equal(got, ref):
        raise AssertionError("times K5: tile differs from the plain version")
    keep = ru[0] < u_pad
    flat = ru[0][keep].long() * tc + sl[0][keep].long()
    vals = vv[0][keep].to(cdt)

    def library():
        out = torch.zeros(u_pad * tc, dtype=cdt, device=ru.device)
        return out.index_put_((flat,), vals, accumulate=True)

    kernel_ms = _time_ms(torch, lambda: sc.densify_tiles(ru, sl, vv, u_pad=u_pad, tc=tc, cdt=cdt), 5)
    plain_ms = _time_ms(torch, lambda: sc.densify_tiles_plain(ru, sl, vv, u_pad=u_pad, tc=tc, cdt=cdt), 3)
    library_ms = _time_ms(torch, library, 5)
    nbytes = 12.0 * ru.shape[1] + u_pad * tc * got.element_size()
    bound_ms, bound_by = _bound(0.0, nbytes, int8)
    return {
        "shape": {"u_pad": u_pad, "tc": tc, "p2": int(ru.shape[1]), "entries": int(keep.sum()),
                  "dtype": "int8" if int8 else "float32"},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "kernel_gbps": nbytes / kernel_ms / 1e6, "max_abs_err": 0.0,
    }


def _compact_panel(torch, dev, m_items, targets, plan, dtype, params, **prep):
    """Panel 0 of the largest cold bucket of a compaction call against the
    call's first column group, staged by the executor's own staging
    (compact.stage_panels, compact.stage_tiles) at the call's plan: the
    panel's hot and cold lhs, the dense group table, the gather ids and
    the vectors."""
    from similaripy_tpu_torch.engine import compact, scatter
    from similaripy_tpu_torch.engine import executor as ex
    from similaripy_tpu_torch.engine.params import build_pvec
    from similaripy_tpu_torch.engine.preprocess import preprocess

    pre = preprocess(m_items, m_items.T, k=100, target_rows=targets, self_similar=True, **prep)
    cd, inv_scale = ex.resolve_compute_dtype(dtype, pre)
    H, tc, u_pad, cg = plan["H"], plan["tc"], plan["u_pad"], plan["cg"]
    buckets, rank_of = compact.stage_panels(pre, cd, u_pad=u_pad, device=dev,
                                            densify=scatter.densify_tiles)
    b = max(buckets, key=lambda b: b["B"])
    (rows, cols, vals, yvecs), _ = compact.stage_tiles(pre, cd, rank_of, tc=tc,
                                                       n_tiles=plan["n_tiles"], u_pad=u_pad,
                                                       device=dev)
    G = cg // tc
    d_group = compact._build_d_group(rows[:G], cols[:G], vals[:G], u_pad=u_pad, tc=tc,
                                     cdt=ex.compute_cast(cd), densify=scatter.densify_tiles)
    pv = np.zeros(16, np.float32)
    pv[:10] = build_pvec(params, inv_scale)
    return {
        "B": b["B"], "H": H, "tc": tc, "cg": cg, "k_pad": plan["k_pad"], "dtype": dtype,
        "a_hot": b["hot"][0], "a_cold": b["cold"][0], "d_group": d_group, "gi": b["gi"][0],
        "x": [b[n][0] for n in ("sx_t", "sx_c", "sx_d")],
        "y": [yvecs[n][:cg] for n in ("y_t", "y_c", "y_d")],
        "pvec": torch.from_numpy(pv).to(dev), "flags": params.static_flags(),
    }


def _time_k3_k4(torch, pt, ga, op):
    """K3 on the staged panel (its cold rows gathered, its hot bias by the
    library product), and K4 on that panel's gather: kernel, bound, plain
    and library."""
    from similaripy_tpu_torch.engine import compact
    from similaripy_tpu_torch.engine.tile_topk import splus_epilogue

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_k3_cases import assert_same_panel

    tm, K, cg, tc, k_pad = compact.TM, op["B"], op["cg"], op["tc"], op["k_pad"]
    int8, bf16 = op["dtype"] == "int8", op["dtype"] == "bfloat16"
    mode = {"int8": "int8", "bfloat16": "bf16", "float32": "f32"}[op["dtype"]]
    d_group, gi = op["d_group"], op["gi"]
    d_cold = ga.row_gather(d_group, gi)
    if not torch.equal(d_cold, ga.row_gather_plain(d_group, gi)):
        raise AssertionError("times K4: rows differ from the plain version")
    d_hot = d_group[: op["H"]]
    bias = compact._hot_bias(op["a_hot"], d_hot.float() if bf16 else d_hot, int8)
    args = (op["a_cold"], d_cold, *op["x"], *op["y"], op["pvec"])
    kw = dict(bias=bias, flags=op["flags"], k_pad=k_pad, tc=tc, int8_mode=int8)
    got = [t.cpu().numpy() for t in pt.fused_panel_topk(*args, **kw)]
    ref = [t.cpu().numpy() for t in pt.fused_panel_topk_plain(*args, **kw)]
    assert_same_panel(mode, got, ref, op["flags"])
    fin = np.isfinite(ref[0])
    err = float(np.max(np.abs(got[0][fin] - ref[0][fin]))) if fin.any() else 0.0

    k3_ms = _time_ms(torch, lambda: pt.fused_panel_topk(*args, **kw), 5)
    k3_profile = _profile(torch, lambda: pt.fused_panel_topk(*args, **kw))
    k3_plain_ms = _time_ms(torch, lambda: pt.fused_panel_topk_plain(*args, **kw), 3)
    pvl = op["pvec"].tolist()

    def library():
        if int8:
            xy = (torch._int_mm(op["a_cold"], d_cold) + bias).float() * pvl[9]
        elif bf16:
            xy = _mm_f32(torch, op["a_cold"], d_cold) + bias
        else:
            xy = torch.matmul(op["a_cold"], d_cold) + bias
        val = splus_epilogue(xy, xy != 0, *op["x"], *op["y"], pvl, op["flags"])
        return torch.topk(val.view(tm, cg // tc, tc), k_pad, dim=2)

    k3_lib_ms = _time_ms(torch, library, 5)
    item = d_cold.element_size()
    ops = 2.0 * tm * K * cg
    nbytes = (item * (tm * K + K * cg) + 4.0 * tm * cg + 4.0 * (3 * tm + 3 * cg + 16)
              + 8.0 * (cg // tc) * k_pad * tm)
    k3_bound, k3_by = _bound(ops, nbytes, int8, PEAK_BF16_FLOPS if bf16 else None)
    k4_ms = _time_ms(torch, lambda: ga.row_gather(d_group, gi), 5)
    k4_plain_ms = _time_ms(torch, lambda: ga.row_gather_plain(d_group, gi), 3)
    k4_lib_ms = _time_ms(torch, lambda: torch.index_select(d_group, 0, gi), 5)
    # each distinct row read once (the bucket's padding repeats row 0), each
    # gathered row written once
    k4_bytes = (int(torch.unique(gi).numel()) + K) * cg * float(item)
    k4_bound, k4_by = _bound(0.0, k4_bytes, int8)
    shape = {"TM": tm, "K": K, "H": op["H"], "cg": cg, "tc": tc, "k_pad": k_pad,
             "u_pad": int(d_group.shape[0]), "dtype": op["dtype"]}
    return (
        {"shape": shape, "kernel_ms": k3_ms, "plain_ms": k3_plain_ms, "library_ms": k3_lib_ms,
         "library_chain": LIBRARY_BF16_MM if bf16 else None,
         "bound_ms": k3_bound, "bound_by": k3_by, "kernel_tops": ops / k3_ms / 1e9,
         "max_abs_err": err, "profile": k3_profile, "split": _tile_split(k3_profile)},
        {"shape": shape, "kernel_ms": k4_ms, "plain_ms": k4_plain_ms, "library_ms": k4_lib_ms,
         "bound_ms": k4_bound, "bound_by": k4_by, "kernel_gbps": k4_bytes / k4_ms / 1e6,
         "max_abs_err": 0.0},
    )


def phase_times(torch, sim, tt, st, sc, urm, state):
    from similaripy_tpu_torch.engine.params import SPlusParams

    plans, urm_n = state["plans"], state["urm_n"]
    cos = SPlusParams(l2=1)
    cos_prep = dict(l2=1.0, c1=0.5, c2=0.5)
    out = {}
    coo, vecs = _sym_setup(torch, urm_n.T.tocsr(), "float32", plans["cosine"], **cos_prep)
    out["K2_f32_live"] = _time_k2(torch, st, sc, coo, vecs, plans["cosine"], cos, "f32", False)
    out["K2_f32_diagonal"] = _time_k2(torch, st, sc, coo, vecs, plans["cosine"], cos, "f32", True)
    out["K5_f32"] = _time_k5(torch, sc, coo, plans["cosine"], False)
    del coo, vecs
    # bf16 (compute_dtype='bfloat16') at the f32 build's geometry: its rate
    coo, vecs = _sym_setup(torch, urm_n.T.tocsr(), "bfloat16", plans["cosine"], **cos_prep)
    out["K2_bf16_live"] = _time_k2(torch, st, sc, coo, vecs, plans["cosine"], cos, "bf16", False)
    del coo, vecs
    # precision='high': the split-bf16x3 block of the 'high' build's plan
    coo, vecs = _sym_setup(torch, urm_n.T.tocsr(), "float32", plans["cosine_high"], split=True,
                           **cos_prep)
    out["K2_split_live"] = _time_k2(torch, st, sc, coo, vecs, plans["cosine_high"], cos, "split",
                                    False)
    del coo, vecs
    coo, vecs = _sym_setup(torch, urm.T.tocsr(), "int8", plans["cosine_int8"], **cos_prep)
    out["K2_int8_live"] = _time_k2(torch, st, sc, coo, vecs, plans["cosine_int8"], cos, "int8",
                                   False)
    out["K5_int8"] = _time_k5(torch, sc, coo, plans["cosine_int8"], True)
    del coo, vecs
    # K2's per-launch split of each timed block, and its product kernels'
    # registers, spills (local bytes), shared memory and blocks per SM
    emit({"phase": "times_k2_split",
          "blocks": {k: {**out[k]["split"], "kernel_ms": out[k]["kernel_ms"],
                         "tops": out[k]["kernel_tops"]}
                     for k in ("K2_f32_live", "K2_f32_diagonal", "K2_bf16_live", "K2_split_live",
                               "K2_int8_live")},
          "product_kernels": {**{str(dt).replace("torch.", ""): st.product_attrs(dt)
                                 for dt in (torch.float32, torch.bfloat16, torch.int8)},
                              "split": st.product_attrs(torch.bfloat16, split=True)}})
    # where a warm symmetric call's wall goes, and the device's idle share
    out["asymmetric_cosine_profile"] = _profile(torch, lambda: sim.asymmetric_cosine(
        state["pop_t"], alpha=0.3, k=100, verbose=False, device="cuda"))
    # K1 on the main path's general-route calls: the 1,024-item cosine panel
    # against one tile (f32 and int8), and a recommend panel against a tile
    # of W
    items = state["items"]
    out["K1_f32"] = _time_k1(torch, tt, urm_n.T.tocsr()[items], urm_n.tocsc(),
                             plans["cosine_targeted"], False)
    out["K1_int8"] = _time_k1(torch, tt, urm.T.tocsr()[items], urm.tocsc(),
                              plans["cosine_int8_targeted"], True)
    out["K1_f32_recommend"] = _time_k1(torch, tt, urm_n.tocsr()[state["users"]],
                                       state["W"].T.tocsc(), plans["recommend"], False)
    # compute_dtype='bfloat16' at the f32 cosine tile's geometry: its rate
    out["K1_bf16"] = _time_k1(torch, tt, urm_n.T.tocsr()[items], urm_n.tocsc(),
                              plans["cosine_targeted"], False, bf16=True)
    # precision='high': 'both' on the cosine tile (both sides float), 'rhs'
    # on the 'high' recommend's tile (raw ratings exact in bf16, W float)
    out["K1_split_both"] = _time_k1(torch, tt, urm_n.T.tocsr()[items], urm_n.tocsc(),
                                    plans["cosine_targeted"], False, split="both")
    out["K1_split_rhs"] = _time_k1(torch, tt, urm.tocsr()[state["users"]],
                                   state["W"].T.tocsc(), plans["recommend_high"], False,
                                   split="rhs")
    dtypes = (torch.float32, torch.bfloat16, torch.int8)
    _split_line("times_k1_split", out, ("K1_f32", "K1_int8", "K1_f32_recommend", "K1_bf16",
                                        "K1_split_both", "K1_split_rhs"),
                {**{str(dt).replace("torch.", ""): tt.product_attrs(dt) for dt in dtypes},
                 **{f"split_{s}": tt.product_attrs(torch.bfloat16, split=s)
                    for s in ("both", "rhs", "lhs")}})
    # K3 and K4 on the 8,192-item cosine's largest cold bucket, f32, int8 and
    # bf16 at the f32 call's geometry (the same panel: plan_compact reads
    # only the sparsity structure); the engine caches are dropped first to
    # make room for a full group
    from similaripy_tpu_torch.engine import gather as ga
    from similaripy_tpu_torch.engine import panel_topk as pt

    sim.clear_caches()
    for name, m_items, key, dtype in (
            ("f32", urm_n.T.tocsr(), "cosine_t8k_on_1", "float32"),
            ("int8", urm.T.tocsr(), "cosine_int8_t8k_on_1", "int8"),
            ("bf16", urm_n.T.tocsr(), "cosine_t8k_on_1", "bfloat16")):
        op = _compact_panel(torch, torch.device("cuda"), m_items, state["t8k"], plans[key],
                            dtype, cos, **cos_prep)
        out[f"K3_{name}"], out[f"K4_{name}"] = _time_k3_k4(torch, pt, ga, op)
        del op
        torch.cuda.empty_cache()
    _split_line("times_k3_split", out, ("K3_f32", "K3_int8", "K3_bf16"),
                {str(dt).replace("torch.", ""): tt.product_attrs(dt, bias=True)
                 for dt in dtypes})
    return out


# ---------------------------------------------------------------------------
# phase 5: the hardware probes (P1, P2), the kernel-check sweep, K1's micro
# ---------------------------------------------------------------------------


def _probe_path(torch, pr, kc, mi4, dev):
    """The probe entry points as a user runs them, the counts set to 0 just
    before and read just after: kernel_check's P1 probe in each dtype and
    micro_int4's P2 probe in each mode."""
    pr.reset_counts()
    p1 = {dt: kc.probe_transposed_lhs(dt, dev) for dt in kc.PROBE_DTYPES}
    p2 = {mode: mi4.probe(mode, mi4.STEPS, mi4.REPS, dev) for mode in ("int8", "s4")}
    torch.cuda.synchronize()
    launches = {"probe_tlhs": pr.tlhs_counts.kernel_launches,
                "probe_int_mma": pr.int_mma_counts.kernel_launches}
    plain = pr.tlhs_counts.plain_calls + pr.int_mma_counts.plain_calls
    if plain or not all(launches.values()):
        raise AssertionError(f"probe path: launches {launches}, plain calls {plain}")
    bad = [dt for dt, (_, ok) in p1.items() if not ok]
    bad += [mode for mode, r in p2.items() if not r["exact"]]
    if bad:
        raise AssertionError(f"probe path: wrong results in {bad}")
    return {"p1": {dt: status for dt, (status, _) in p1.items()}, "p2": p2,
            "launches": launches}


def _probe_cases():
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_probe_cases

    return torch_probe_cases


def _f32_randn_check(torch, pr, where, a, b):
    """P1 f32 on standard-normal data: the mean scaled error against the
    float64 product within the f32 tolerance, and a TF32-rounded product's
    outside it (tests/torch_probe_cases.py); the largest difference from
    the plain version is reported."""
    cases = _probe_cases()
    got = pr.transposed_lhs_product(a, b)
    mean, worst, tf32_mean = cases.f32_scaled_errors(torch, got, a, b)
    tol = cases.f32_tolerance(a.shape[0])
    if not mean <= tol < tf32_mean:
        raise AssertionError(f"{where}: mean scaled error {mean} (TF32 would give {tf32_mean}), "
                             f"tolerance {tol}")
    max_abs = float((got - pr.transposed_lhs_product_plain(a, b)).abs().max())
    return {"mean_scaled_err": mean, "max_scaled_err": worst, "tf32_mean_scaled_err": tf32_mean,
            "tol": tol, "max_abs_err": max_abs}


def _parity_probes(torch, pr, dev):
    """P1 and P2 against their plain versions on the shared small cases:
    bit-equal on integer data; P1 f32 also on standard-normal data, within
    the f32 tolerance; P2 s4 also on values its cast wraps."""
    c = _probe_cases()

    dts = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = 0
    for shape in c.P1_SHAPES:
        a_i, b_i = c.p1_inputs(*shape, seed=sum(shape))
        for name, dt in dts.items():
            a, b = (torch.from_numpy(x).to(dev).to(dt) for x in (a_i, b_i))
            if not torch.equal(pr.transposed_lhs_product(a, b),
                               pr.transposed_lhs_product_plain(a, b)):
                raise AssertionError(f"parity P1 {name} {shape}: differs from the plain version")
            cases += 1
    randn = {}
    for shape in c.P1_F32_RANDN_SHAPES:
        a, b = (torch.from_numpy(x).to(dev) for x in c.p1_randn(*shape, seed=sum(shape)))
        randn[c.shape_id(shape)] = _f32_randn_check(torch, pr, f"parity P1 f32 randn {shape}",
                                                    a, b)
        cases += 1
    for M, K, N, steps in c.P2_CASES:
        a, b = (torch.from_numpy(x).to(dev) for x in c.p2_inputs(M, K, N, seed=M + K))
        for mode in ("int8", "s4"):
            if not torch.equal(pr.int_rate_product(a, b, steps, mode),
                               pr.int_rate_product_plain(a, b, steps, mode)):
                raise AssertionError(f"parity P2 {mode} {(M, K, N, steps)}: differs")
            cases += 1
    for M, K, N, steps in c.P2_WRAP_CASES:
        a, b = (torch.from_numpy(x).to(dev) for x in c.p2_wrap_inputs(M, K, N, seed=M))
        if not torch.equal(pr.int_rate_product(a, b, steps, "s4"),
                           pr.int_rate_product_plain(a, b, steps, "s4")):
            raise AssertionError(f"parity P2 s4 on [-8, 9] {(M, K, N, steps)}: differs")
        cases += 1
    _sync(torch, dev)
    return {"cases": cases, "f32_randn": randn,
            "max_abs_err": max(r["max_abs_err"] for r in randn.values())}


def _time_p1(torch, pr, dtype):
    """P1 at K2's full-width block, values in [-5, 5] (exact in every mode):
    kernel, plain, library and bound; for int8 also the library on K-major
    operands and the transpose copies; for f32 also standard-normal data
    against the f32 tolerance."""
    dev = torch.device("cuda")
    K, M, N = P1_FULL[dtype]
    tdt = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"shape": {"K": K, "M": M, "N": N, "dtype": dtype}, "max_abs_err": 0.0}
    if dtype == "float32":
        a = torch.randn((K, M), generator=gen, device=dev)
        b = torch.randn((K, N), generator=gen, device=dev)
        out["f32_randn"] = _f32_randn_check(torch, pr, "times P1 f32 randn", a, b)
        out["max_abs_err"] = out["f32_randn"]["max_abs_err"]
        del a, b
        torch.cuda.empty_cache()
    a = torch.randint(-5, 6, (K, M), generator=gen, device=dev, dtype=torch.int8).to(tdt)
    b = torch.randint(-5, 6, (K, N), generator=gen, device=dev, dtype=torch.int8).to(tdt)
    got = pr.transposed_lhs_product(a, b)
    ref = pr.transposed_lhs_product_plain(a, b)
    if not torch.equal(got, ref):
        raise AssertionError(f"times P1 {dtype}: differs from the plain version")
    del got
    kernel_ms = _time_ms(torch, lambda: pr.transposed_lhs_product(a, b), 5)
    plain_ms = _time_ms(torch, lambda: pr.transposed_lhs_product_plain(a, b), 3)
    if dtype == "int8":
        at, bt = a.t().contiguous(), b.t().contiguous()
        if not torch.equal(torch._int_mm(at, bt.t()), ref):
            raise AssertionError("times P1 int8: _int_mm on K-major operands differs")
        library_ms = _time_ms(torch, lambda: torch._int_mm(a.t().contiguous(), b), 5)
        out["library_no_copy_ms"] = _time_ms(torch, lambda: torch._int_mm(at, b), 5)
        out["library_kmajor_ms"] = _time_ms(torch, lambda: torch._int_mm(at, bt.t()), 5)
        out["library_both_copies_ms"] = _time_ms(
            torch, lambda: torch._int_mm(a.t().contiguous(), b.t().contiguous().t()), 5)
        out["transpose_copy_ms"] = _time_ms(torch, lambda: a.t().contiguous(), 5)
        del at, bt
    else:
        library_ms = _time_ms(torch, lambda: torch.matmul(a.t(), b), 5)
    del ref
    ops = 2.0 * K * M * N
    peak = {"int8": PEAK_INT8_OPS, "bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_F32_FLOPS}[dtype]
    nbytes = a.element_size() * (K * M + K * N) + 4.0 * M * N
    ops_ms, bytes_ms = 1e3 * ops / peak, 1e3 * nbytes / PEAK_BYTES
    out.update({"kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "kernel_tops": ops / kernel_ms / 1e9})
    del a, b
    torch.cuda.empty_cache()
    return out


def _time_p2(torch, pr, mi4, p2):
    """P2 as a function: out = steps * a . b needs one product and a scale,
    so its bound is one product's (here its bytes) and its library yardstick
    one torch._int_mm times steps. The probe's own figure, the rate of its
    `steps` products against the int8 peak, is kept beside them."""
    a, b = mi4.inputs(torch.device("cuda"))
    steps = mi4.STEPS
    ref = pr.int_rate_product_plain(a, b, steps)
    if not torch.equal(torch._int_mm(a, b) * steps, ref):
        raise AssertionError("times P2: _int_mm times steps differs from the plain version")
    ops = 2.0 * mi4.M * mi4.K * mi4.N
    nbytes = 1.0 * (mi4.M * mi4.K + mi4.K * mi4.N) + 4.0 * mi4.M * mi4.N
    bound, bound_by = _bound(ops, nbytes, int8=True)
    return {
        "shape": {"M": mi4.M, "K": mi4.K, "N": mi4.N, "steps": steps},
        "kernel_ms": p2["int8"]["ms"], "max_abs_err": 0.0,
        "plain_ms": _time_ms(torch, lambda: pr.int_rate_product_plain(a, b, steps), 3),
        "library_ms": _time_ms(torch, lambda: torch._int_mm(a, b) * steps, 5),
        "bound_ms": bound, "bound_by": bound_by,
        "rate_tops": p2["int8"]["tops"], "rate_bound_ms": p2["int8"]["bound_ms"],
        "s4_ms": p2["s4"]["ms"], "s4_tops": p2["s4"]["tops"],
        "s4_over_int8": p2["s4"]["tops"] / p2["int8"]["tops"],
    }


def phase_probes(torch, dev):
    from similaripy_tpu_torch.benchmarks import kernel_check as kc
    from similaripy_tpu_torch.benchmarks import micro_int4 as mi4
    from similaripy_tpu_torch.benchmarks import micro_tile_kernel as mtk
    from similaripy_tpu_torch.benchmarks import probes as pr

    out = {}
    t = time.perf_counter()
    out["path"] = _probe_path(torch, pr, kc, mi4, dev)
    out["parity"] = _parity_probes(torch, pr, dev)
    out["path_parity_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for dtype in ("float32", "bfloat16", "int8"):
        out[f"P1_{dtype}"] = _time_p1(torch, pr, dtype)
    out["P2_int8"] = _time_p2(torch, pr, mi4, out["path"]["p2"])
    out["times_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log = []
    probes, results, ok = kc.run_sweep(quick=True, device=dev, out=log.append)
    if not ok:
        raise AssertionError("kernel_check --quick failed:\n" + "\n".join(log))
    out["kernel_check_quick"] = {"probes": probes, "variants": [
        {k: r[k] for k in ("label", "rel", "tol", "nnz", "launches", "kernel_s", "plain_s")}
        for r in results]}
    out["kernel_check_s"] = time.perf_counter() - t

    t = time.perf_counter()
    micro = {}
    for fresh in (False, True):
        r = mtk.run(reps=5, fresh=fresh, device=dev)
        micro["fresh" if fresh else "chained"] = {"round_ms": r["round_ms"],
                                                  "bound_ms": r["bound_ms"]}
        micro["shape"] = r["shape"]
        del r
        torch.cuda.empty_cache()
    out["K1_micro"] = micro
    out["K1_micro_s"] = time.perf_counter() - t
    return out


# ---------------------------------------------------------------------------
# phase 6: the benchmark entry points and the native assembly
# ---------------------------------------------------------------------------

BENCH_SUITE = (
    ["--dataset", "synthetic_small", "--similarities", "dot_product", "cosine", "rp3beta",
     "--rounds", "1"],
    ["--dataset", "synthetic_small", "--stage", "scoring", "--similarities", "cosine",
     "--precision", "high", "--rounds", "1"],
)


def _captured(fn, *args):
    """fn(*args) with its stdout and stderr captured: (result, stdout, stderr).
    The stderr is echoed to this process's stderr."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*args)
    sys.stderr.write(err.getvalue())
    return rc, out.getvalue(), err.getvalue()


def _bench_headline(torch, counters, ex, n_items):
    """benchmarks.bench.main(["--rounds", "1"]) in this process on the
    tracked data; its contract line, best round, recall, route, launches
    and laps checked. Returns (the line's numbers, the last assemble call's
    arguments)."""
    import re

    from similaripy_tpu_torch.benchmarks import bench
    from similaripy_tpu_torch.engine import splus

    captured = {}
    real = splus.assemble

    def keep(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return real(*args, **kwargs)

    splus.assemble = keep
    t = time.perf_counter()
    try:
        rc, out, err = _captured(bench.main, ["--rounds", "1"])
    finally:
        splus.assemble = real
    seconds = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"bench.main exited {rc}")
    line = json.loads(out.strip().splitlines()[-1])
    keys = ["metric", "value", "unit", "vs_baseline", "vs_cpu_measured"]
    if sorted(line) != sorted(keys) or line["metric"] != "ml32m_item_item_cosine_k100":
        raise AssertionError(f"bench's last line is not the contract: {line}")
    times = json.loads(re.search(r"^# timed rounds: (\[.*\]); best", err, re.M).group(1))
    if line["value"] != round(n_items / min(times), 1):
        raise AssertionError(f"bench value {line['value']} is not {n_items} / {min(times)}")
    recall = float(re.search(r"^# recall@100 \(256-row sample\) vs exact oracle: ([0-9.]+)$",
                             err, re.M).group(1))
    if recall < 0.99:
        raise AssertionError(f"bench recall@100 {recall} < 0.99")
    m = re.search(r"^# device: (.*); route (\w+), K2 launches (\d+), K5 launches (\d+), "
                  r"plain calls (\d+), native calls (\d+)", err, re.M)
    card, route = m.group(1), m.group(2)
    launches = {"sym_topk": int(m.group(3)), "scatter": int(m.group(4))}
    plain, native_calls = int(m.group(5)), int(m.group(6))
    if route != "symmetric" or plain != 0 or native_calls == 0:
        raise AssertionError(f"bench round: route {route}, plain calls {plain}, "
                             f"native calls {native_calls}")
    _check_plan_launches("bench", route, launches, ex.last_plan)
    laps = {}
    for which in ("round 0", "diagnostic round"):
        lap = json.loads(re.search(rf"^# {which} laps: (.*)$", err, re.M).group(1))
        if sorted(lap) != sorted(["validate", "preprocess", "execute (wall)", "assembly"]):
            raise AssertionError(f"bench {which} laps: {lap}")
        stages = json.loads(re.search(rf"^# {which} stages: (.*)$", err, re.M).group(1))
        laps[which] = {**lap, "stages": stages}
    return {"line": line, "timed_rounds_s": times, "recall_at_100": recall, "card": card,
            "route": route, "launches": launches, "plain_calls": plain,
            "native_calls": native_calls, "laps": laps,
            "plan": {k: ex.last_plan[k] for k in ("tc", "gt", "blocks", "scatters")},
            "seconds": seconds}, captured


def _bench_suite(tmp):
    """run_benchmarks in both stages into `tmp`, both reports read by
    compare_benchmarks, and bench_gate from no earlier report (bootstrap)."""
    from similaripy_tpu_torch.benchmarks import bench_gate, compare_benchmarks, run_benchmarks

    reports = {}
    for argv in BENCH_SUITE:
        t = time.perf_counter()
        rc, out, _ = _captured(run_benchmarks.main, argv + ["--output-dir", tmp])
        if rc != 0:
            raise AssertionError(f"run_benchmarks {argv} exited {rc}")
        path = out.strip().splitlines()[-1].split("report: ", 1)[1]
        with open(path) as f:
            rep = json.load(f)
        stage = rep["stage"]
        if rep["system"]["backend"] != "cuda" or not rep["results"]:
            raise AssertionError(f"run_benchmarks {stage}: {rep['system']} {rep['results']}")
        reports[stage] = {"path": path, "seconds": time.perf_counter() - t, "results": [
            {k: r[k] for k in ("name", "mean_s", "throughput_items_s", "output_nnz")}
            for r in rep["results"]]}
    paths = [r["path"] for r in reports.values()]
    rc, out, _ = _captured(compare_benchmarks.main, paths + ["--bench-dir", tmp])
    if rc != 0 or "BENCHMARK COMPARISON" not in out:
        raise AssertionError(f"compare_benchmarks exited {rc}:\n{out}")
    t = time.perf_counter()
    rc, out, _ = _captured(bench_gate.main, ["--dataset", "synthetic_small", "--rounds", "1",
                                             "--output-dir", os.path.join(tmp, "gate")])
    if rc != 0 or "PASS (bootstrap)" not in out:
        raise AssertionError(f"bench_gate exited {rc}:\n{out}")
    return {"reports": reports, "bench_gate_s": time.perf_counter() - t}


def _bench_assembly(captured, reps=3):
    """assemble on the headline's own (T, k) buffers, native and plain, in
    the headline's format (COO, the similarities' default) and in CSR: the
    results bit-equal; each branch's times (s) and native calls."""
    from similaripy_tpu_torch import native
    from similaripy_tpu_torch.engine.assembly import assemble

    vals, idx, targets, n_rows, n_cols, _ = captured["args"]
    out = {"T": int(vals.shape[0]), "k": int(vals.shape[1])}
    for fmt in ("coo", "csr"):
        results, row = {}, {}
        for branch in (True, False):
            native.reset_counts()
            times = []
            for _ in range(reps):
                t = time.perf_counter()
                results[branch] = assemble(vals, idx, targets, n_rows, n_cols, fmt,
                                           native=branch)
                times.append(time.perf_counter() - t)
            row["native_s" if branch else "plain_s"] = times
            if branch:
                row["native_calls"] = native.native_calls
        fields = ("indptr", "indices", "data") if fmt == "csr" else ("row", "col", "data")
        for f in fields:
            a, b = getattr(results[True], f), getattr(results[False], f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"native assembly ({fmt}) differs from the plain "
                                     f"version in {f}")
        row["nnz"] = int(results[True].nnz)
        out[fmt] = row
    return out


def phase_bench(torch, counters, ex, dev):
    """The benchmark entry points as a user runs them: the bench's kernel
    guard (the quick kernel-check sweep in a subprocess when the stamp is
    stale), the headline bench in this process, the suite in both stages
    with compare_benchmarks and bench_gate, and the native assembly against
    its plain version on the headline's buffers."""
    import tempfile

    from similaripy_tpu_torch.benchmarks import bench, kernel_stamp

    import similaripy_tpu_torch as sim

    out = {}
    sim.clear_caches()  # the sweep's process shares the card
    torch.cuda.empty_cache()
    stale = not kernel_stamp.stamp_is_current()
    t = time.perf_counter()
    if not bench.ensure_kernel_stamp(dev):
        raise AssertionError("kernel_check --quick failed through the bench's guard")
    stamp = kernel_stamp.read_stamp()
    if stamp["hash"] != kernel_stamp.kernel_hash():
        raise AssertionError(f"the stamp {stamp} does not match {kernel_stamp.kernel_hash()}")
    out["guard"] = {"swept": stale, "sweep_s": time.perf_counter() - t, "stamp": stamp}

    out["headline"], captured = _bench_headline(torch, counters, ex, ML32M_SHAPE[1])
    with tempfile.TemporaryDirectory(prefix="similaripy_bench_") as tmp:
        out["suite"] = _bench_suite(tmp)
    out["assembly"] = _bench_assembly(captured)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import similaripy_tpu_torch as sim
    from similaripy_tpu_torch.engine import build
    from similaripy_tpu_torch.engine import executor as ex
    from similaripy_tpu_torch.engine import gather as ga
    from similaripy_tpu_torch.engine import panel_topk as pt
    from similaripy_tpu_torch.engine import scatter as sc
    from similaripy_tpu_torch.engine import sym_topk as st
    from similaripy_tpu_torch.engine import tile_topk as tt

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32 everywhere here
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    emit({"phase": "build", "library": os.path.relpath(lib_path, HERE),
          "sources": [os.path.relpath(p, HERE) for p in build.sources()],
          "seconds": time.perf_counter() - t0})

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    parity = {"K1": parity_k1(torch, tt, dev), "K2": parity_k2(torch, st, dev),
              "K5": parity_k5(torch, sc, dev), "K3": parity_k3(torch, pt, dev),
              "K4": parity_k4(torch, ga, dev)}
    emit({"phase": "parity", **parity, "seconds": time.perf_counter() - t0})

    import scipy.sparse as sp

    t0 = time.perf_counter()
    urm = sp.load_npz(DATA).tocsr().astype(np.float32)
    if urm.shape != ML32M_SHAPE:
        raise AssertionError(f"{DATA} has shape {urm.shape}, expected {ML32M_SHAPE}")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counters = {"tile_topk": tt, "sym_topk": st, "scatter": sc, "panel_topk": pt, "gather": ga}
    main_path, state = phase_main(torch, sim, counters, ex, urm, dev)
    emit({"phase": "main", "load_seconds": load_s, **main_path,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    mesh = phase_mesh(torch, sim, counters, ex, urm, dev, state)
    emit({"phase": "mesh", **mesh, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    times = phase_times(torch, sim, tt, st, sc, urm, state)
    emit({"phase": "times", **times, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    probes = phase_probes(torch, dev)
    emit({"phase": "probes", **probes, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    bench_out = phase_bench(torch, counters, ex, dev)
    emit({"phase": "bench", **bench_out, "seconds": time.perf_counter() - t0})

    mesh_calls = mesh["nccl_1"]["calls"] + [
        {"launches": r} for e in mesh["gloo_2"]["ranks"].values() for r in e["launches"]]
    launches = {k: sum(c["launches"][k] for c in main_path["calls"] + mesh_calls)
                for k in KERNELS if k not in PROBE_KERNELS}
    launches.update(probes["path"]["launches"])
    for name, base in SPLIT_KERNELS.items():
        launches[name] = sum(c["launches"][base] for c in main_path["calls"]
                             if c["plan"].get("f32x3"))
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path or the probe path never launched: "
                             f"{launches}")
    timed = {"tile_topk": times["K1_f32"], "sym_topk": times["K2_f32_live"],
             "scatter": times["K5_f32"], "panel_topk": times["K3_f32"],
             "gather": times["K4_f32"], "probe_tlhs": probes["P1_int8"],
             "probe_int_mma": probes["P2_int8"],
             "tile_topk:split-bf16x3": times["K1_split_both"],
             "sym_topk:split-bf16x3": times["K2_split_live"]}
    errs = {
        "tile_topk": max(times["K1_f32"]["max_abs_err"], times["K1_int8"]["max_abs_err"],
                         times["K1_f32_recommend"]["max_abs_err"],
                         times["K1_bf16"]["max_abs_err"],
                         *parity["K1"]["max_abs_err"].values(),
                         *parity["K1"]["card_max_abs_err"].values()),
        "sym_topk": max(times["K2_f32_live"]["max_abs_err"],
                        times["K2_f32_diagonal"]["max_abs_err"],
                        times["K2_bf16_live"]["max_abs_err"],
                        times["K2_int8_live"]["max_abs_err"],
                        *parity["K2"]["max_abs_err"].values()),
        "scatter": 0.0,
        "panel_topk": max(times["K3_f32"]["max_abs_err"], times["K3_int8"]["max_abs_err"],
                          times["K3_bf16"]["max_abs_err"],
                          *parity["K3"]["max_abs_err"].values()),
        "gather": 0.0,
        # P1 is bit-equal on integer data; its f32 errors on normal data
        "probe_tlhs": max(probes["parity"]["max_abs_err"], probes["P1_float32"]["max_abs_err"]),
        "probe_int_mma": 0.0,
        "tile_topk:split-bf16x3": max(times["K1_split_both"]["max_abs_err"],
                                      times["K1_split_rhs"]["max_abs_err"],
                                      *parity["K1"]["split"]["max_abs_err"].values()),
        "sym_topk:split-bf16x3": max(times["K2_split_live"]["max_abs_err"],
                                     parity["K2"]["max_abs_err"]["split"]),
    }
    sources = {**KERNELS, **{name: KERNELS[base] for name, base in SPLIT_KERNELS.items()}}
    emit({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": timed[name]["kernel_ms"],
        "plain_ms": timed[name]["plain_ms"],
        "bound_ms": timed[name]["bound_ms"],
        "bound_by": timed[name]["bound_by"],
        "library_ms": timed[name]["library_ms"],
    } for name, (source, replaces) in sources.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
