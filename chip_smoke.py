#!/usr/bin/env python3
"""Smoke check of similaripy_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. Imports neither JAX nor
``similaripy_tpu``. Each phase prints one JSON line with its `seconds`:

  0 device   the card, and `nvidia-smi --query-gpu=name,power.limit`
  1 build    nvcc builds csrc/tile_topk.cu into similaripy_tpu_torch/_build/
  2 parity   K1 against its plain PyTorch version at small ragged shapes, in
             every mode (f32, bf16, int8) x carry x mask, with epilogue flag
             sets; int8 bit-equal, f32/bf16 values within rtol 1e-5, ids equal
             where values are not tied
  3 main     the main path at ML-32M width on the tracked .bench_data_1.0.npz
             (200,948 users x 84,432 items): bm25 -> cosine(k=100) for 1,024
             items -> recommend(k=10) for 1,024 users, and cosine on the raw
             ratings (exact int8). Each call is held against the same call
             through the plain version (nnz, check_sum rtol 1e-4; int8
             identical), against a float64 SciPy oracle on 16 sampled rows,
             and must have launched K1 and never its plain version; then the
             first call's stages (preprocess, execute, assemble) are timed
             with the preprocess cache emptied
  4 times    K1 at the main path's shapes (the f32 and the int8 cosine's
             panel x one tile): kernel, bound, plain and library
             (torch.matmul + torch.topk, f32 only) times

then the `kernels` line and, last, {"ok": true, "device": {...}}. Any failed
check raises and the script exits non-zero; without a card it exits non-zero
before printing anything. It writes nothing but the kernel build.
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
N_ORACLE_ROWS = 16
TPU_KERNEL = "similaripy_tpu/engine/pallas_kernels.py::fused_tile_topk"
TPU_KERNEL_LINE = "similaripy_tpu/engine/pallas_kernels.py:712"
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_sum(x) -> float:
    """Tie-robust scalar of a top-k matrix (tests/oracles.py::check_sum)."""
    aux = np.asarray(x.sum(axis=1), dtype=np.float64).ravel()
    return float(np.sum(aux**2))


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


def _not_tied(v, rel):
    """(k, rows) mask of finite values clear of both neighbours."""
    out = np.isfinite(v)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(v, axis=0)) > rel * np.maximum(np.abs(v[1:]), 1e-30)
    out[1:] &= gap
    out[:-1] &= gap
    return out


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_parity(torch, tt, dev):
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
                args = [torch.from_numpy(x).to(dev) for x in (a, d)]
                args[0], args[1] = args[0].to(dtypes[mode]), args[1].to(dtypes[mode])
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
                kv, ki_ = tt.fused_tile_topk(*args, **kw)
                pv_, pi_ = tt.fused_tile_topk_plain(*args, **kw)
                _sync(torch, dev)
                kv, ki_, pv_, pi_ = (t.cpu().numpy() for t in (kv, ki_, pv_, pi_))
                where = f"{mode} carry={carry_on} mask={mask} shape={(trp, u, tc, k_pad)}"
                fin = np.isfinite(pv_)
                if not np.array_equal(np.isfinite(kv), fin):
                    raise AssertionError(f"parity {where}: finite slots differ")
                if mode == "int8":
                    if not np.array_equal(kv, pv_):
                        raise AssertionError(f"parity {where}: int8 values not bit-equal")
                    ok_ids = _not_tied(pv_, 0.0)
                else:
                    np.testing.assert_allclose(kv[fin], pv_[fin], rtol=1e-5, atol=0,
                                               err_msg=f"parity {where}")
                    ok_ids = _not_tied(pv_, 1e-5)
                if not np.array_equal(ki_[ok_ids], pi_[ok_ids]):
                    raise AssertionError(f"parity {where}: ids differ at untied values")
                if fin.any():
                    max_err[mode] = max(max_err[mode], float(np.max(np.abs(kv[fin] - pv_[fin]))))
                cases += 1
    return {"cases": cases, "max_abs_err": max_err}


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


def _same(name, got, ref, exact):
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


def phase_main(torch, sim, tt, ex, urm, dev, n_targets=N_TARGETS):
    """The main path on `urm` (users x items, f32 half-star ratings)."""
    from similaripy_tpu_torch.engine.assembly import assemble
    from similaripy_tpu_torch.engine.params import SPlusParams
    from similaripy_tpu_torch.engine.preprocess import clear_prep_cache, preprocess

    rng = np.random.default_rng(0)
    items = np.sort(rng.choice(urm.shape[1], n_targets, replace=False))
    users = np.sort(rng.choice(urm.shape[0], n_targets, replace=False))

    t0 = time.perf_counter()
    urm_n = sim.bm25(urm, device=dev)
    _sync(torch, dev)
    bm25_s = time.perf_counter() - t0

    def staged(m1, m2, params, k, targets, filt=None, tile_fn="plain", **prep):
        """The call through the engine's stages, each timed: preprocess,
        execute (K1's kernel or its plain version), assemble."""
        t = [time.perf_counter()]
        pre = preprocess(m1, m2 if m2 is not None else m1.T, k=k, target_rows=targets,
                         filter_cols=filt, self_similar=m2 is None, **prep)
        t.append(time.perf_counter())
        vals, idx = ex.execute(pre, params, compute_dtype="auto", device=dev, _tile_fn=tile_fn)
        _sync(torch, dev)
        t.append(time.perf_counter())
        out = assemble(vals, idx, pre.targets, pre.n_output_rows, pre.n_output_cols, "csr")
        t.append(time.perf_counter())
        stages = dict(zip(("preprocess_s", "execute_s", "assemble_s"), np.diff(t).tolist()))
        return out, stages

    calls = []

    def run(name, kernel_fn, plain_fn, exact, oracle):
        tt.reset_counts()
        t = time.perf_counter()
        got = kernel_fn()
        _sync(torch, dev)
        wall = time.perf_counter() - t
        launches, plain_calls = tt.kernel_launches, tt.plain_calls
        plan = dict(ex.last_plan)
        if dev.type == "cuda" and (launches == 0 or plain_calls != 0):
            raise AssertionError(f"{name}: kernel_launches={launches} plain_calls={plain_calls}")
        t = time.perf_counter()
        ref, plain_stages = plain_fn()
        plain_wall = time.perf_counter() - t
        _same(name, got, ref, exact)
        rows, expect = oracle(got)
        _check_oracle(name, got, rows, expect)
        calls.append({"call": name, "seconds": wall, "plain_seconds": plain_wall,
                      "plain_stages": plain_stages,
                      "launches": launches, "nnz": int(got.nnz),
                      "check_sum": check_sum(got), "plan": plan})
        return got

    common = dict(verbose=False, format_output="csr", device=dev)
    sample = np.sort(rng.choice(items, N_ORACLE_ROWS, replace=False))
    item_t = urm_n.T.tocsr()
    W = run(
        "cosine(bm25(urm).T, k=100)",
        lambda: sim.cosine(urm_n.T, k=100, target_rows=items, **common),
        lambda: staged(item_t, None, SPlusParams(l2=1), 100, items, l2=1, c1=0.5, c2=0.5),
        False,
        lambda got: (sample, _oracle_rows(item_t, urm_n, sample, 100, l2=True)),
    )
    usample = np.sort(rng.choice(users, N_ORACLE_ROWS, replace=False))
    recs = run(
        "recommend(bm25(urm), W, k=10)",
        lambda: sim.recommend(urm_n, W, k=10, target_rows=users, **common),
        lambda: staged(urm_n, W.T.tocsr(), SPlusParams(), 10, users, filt=urm_n),
        False,
        lambda got: (usample, _oracle_rows(urm_n, W.T, usample, 10, l2=False, filt=urm_n)),
    )
    seen = urm_n[users].tocsr()
    recs_u = recs.tocsr()[users]
    for r in range(users.shape[0]):
        s = set(seen.indices[seen.indptr[r]:seen.indptr[r + 1]].tolist())
        g = recs_u.indices[recs_u.indptr[r]:recs_u.indptr[r + 1]].tolist()
        if s.intersection(g):
            raise AssertionError(f"recommend: user {users[r]} got a seen item")
    raw_t = urm.T.tocsr()
    run(
        "cosine(urm.T, k=100) int8",
        lambda: sim.cosine(urm.T, k=100, target_rows=items, **common),
        lambda: staged(raw_t, None, SPlusParams(l2=1), 100, items, l2=1, c1=0.5, c2=0.5),
        True,
        lambda got: (sample, _oracle_rows(raw_t, urm, sample, 100, l2=True)),
    )
    if calls[-1]["plan"]["compute_dtype"] != "int8":
        raise AssertionError(f"raw-ratings cosine ran {calls[-1]['plan']['compute_dtype']}, not int8")

    # where the first call's wall goes: its stages through the kernel
    # route, with the preprocess cache emptied so preprocessing runs cold
    clear_prep_cache()
    _, breakdown = staged(item_t, None, SPlusParams(l2=1), 100, items, tile_fn="kernel",
                          l2=1, c1=0.5, c2=0.5)
    return {"bm25_seconds": bm25_s, "calls": calls, "cosine_stages": breakdown}, urm_n, items


# ---------------------------------------------------------------------------
# phase 4: K1 at the main path's shape
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


def _time_k1(torch, tt, panel, tile, plan, int8):
    """Time K1 (kernel, plain, library yardstick) on one panel x tile of the
    main path, as cosine, and check the kernel against the plain version."""
    dev = torch.device("cuda")
    trp, u_pad, tc, k_pad = plan["trp"], plan["u_pad"], plan["tc"], plan["k_pad"]
    dtype = torch.int8 if int8 else torch.float32

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

    kv, _ = tt.fused_tile_topk(*args, **kw)
    pv, _ = tt.fused_tile_topk_plain(*args, **kw)
    fin = torch.isfinite(pv)
    if not torch.equal(torch.isfinite(kv), fin):
        raise AssertionError("times: finite slots differ between kernel and plain")
    if int8:
        if not torch.equal(kv, pv):
            raise AssertionError("times: int8 kernel not bit-equal to the plain version")
    else:
        torch.testing.assert_close(kv[fin], pv[fin], rtol=1e-5, atol=0)
    err = float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0

    kernel_ms = _time_ms(torch, lambda: tt.fused_tile_topk(*args, **kw), 5)
    plain_ms = _time_ms(torch, lambda: tt.fused_tile_topk_plain(*args, **kw), 3)
    library_ms = None
    if not int8:  # torch.matmul has no integer kernel on CUDA
        def library():
            return torch.topk(torch.matmul(a, d), k_pad, dim=1)

        library_ms = _time_ms(torch, library, 5)
    ops = 2.0 * trp * u_pad * tc
    item = a.element_size()
    nbytes = item * (trp * u_pad + u_pad * tc) + 4.0 * (3 * trp + 3 * tc + 16 + 4 * k_pad * trp)
    ops_ms = 1e3 * ops / (PEAK_INT8_OPS if int8 else PEAK_F32_FLOPS)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    return {
        "shape": {"trp": trp, "u_pad": u_pad, "tc": tc, "k_pad": k_pad,
                  "dtype": "int8" if int8 else "float32"},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "kernel_tops": ops / kernel_ms / 1e9, "max_abs_err": err,
    }


def phase_times(torch, tt, urm, urm_n, items, plans):
    """K1 on the main path's first panel against one tile: the f32 cosine's
    geometry on bm25 weights, and the int8 cosine's on raw ratings."""
    return {
        "f32": _time_k1(torch, tt, urm_n.T.tocsr()[items], urm_n.tocsc(), plans[0], False),
        "int8": _time_k1(torch, tt, urm.T.tocsr()[items], urm.tocsc(), plans[2], True),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import similaripy_tpu_torch as sim
    from similaripy_tpu_torch.engine import build
    from similaripy_tpu_torch.engine import executor as ex
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
          "seconds": time.perf_counter() - t0})

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    parity = phase_parity(torch, tt, dev)
    emit({"phase": "parity", **parity, "seconds": time.perf_counter() - t0})

    import scipy.sparse as sp

    t0 = time.perf_counter()
    urm = sp.load_npz(DATA).tocsr().astype(np.float32)
    if urm.shape != ML32M_SHAPE:
        raise AssertionError(f"{DATA} has shape {urm.shape}, expected {ML32M_SHAPE}")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    main_path, urm_n, items = phase_main(torch, sim, tt, ex, urm, dev)
    emit({"phase": "main", "load_seconds": load_s, **main_path,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    times = phase_times(torch, tt, urm, urm_n, items, [c["plan"] for c in main_path["calls"]])
    emit({"phase": "times", **times, "seconds": time.perf_counter() - t0})

    launches = sum(c["launches"] for c in main_path["calls"])
    max_err = max([times["f32"]["max_abs_err"], times["int8"]["max_abs_err"],
                   *parity["max_abs_err"].values()])
    f32 = times["f32"]
    emit({"kernels": [{
        "name": "tile_topk",
        "route": "cuda",
        "source": "similaripy_tpu_torch/csrc/tile_topk.cu",
        "replaces": TPU_KERNEL_LINE,
        "tpu": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": f32["kernel_ms"],
        "kernel_ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
