"""The kernel-check sweep of the port: its kernels against their plain
versions through the public calls.

Port of ``benchmarks/tpu_kernel_check.py``. Run on a CUDA card:

    python -m similaripy_tpu_torch.benchmarks.kernel_check [--quick]

It first runs the transposed-lhs probe (P1, ``probes.transposed_lhs_product``)
in int8, bf16 and f32 at the probe's shape and data; each result must be
bit-equal to ``a.T @ b``. Then it drives every variant of the reference's
sweep (symmetric and general routes, the epilogue families, the compute
dtypes, selector masks, deep carries) through the public calls twice: once
on the kernels, once on their plain versions (``preprocess`` and then
``executor.execute(..., _tile_fn="plain")``, the same calls with the
kernels swapped out). The two must agree per row (``row_values_rel``,
each variant at its own tolerance, 0 meaning equal), with no repeated
neighbour in every 97th row; on a card the first run must launch the
engine's kernels and run none of their plain versions, the second the
reverse. Exit code 1 on any mismatch.

Where a variant sets a TPU planning knob the port does not have
(``SIMILARIPY_TPU_SYM_TC`` / ``SIMILARIPY_TPU_SYM_GT``) it runs at the
port's own plan: the labels say so. ``precision="high"`` runs the
split-bf16x3 modes, as the reference's does. ``--device cpu`` runs the
same sweep on the CPU, where both sides are the plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

PROBE_SHAPE = (512, 256, 1024)  # K, M, N
PROBE_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


def row_values_rel(got, ref) -> float:
    """Max relative difference between per-row SORTED value sets.

    Tie-insensitive: when scores tie at the k boundary the two paths may
    keep different (equally-scored) columns, so indices are not
    comparable, but the sorted kept values must agree (exactly, for the
    int8 path). A row whose value counts differ gives inf."""
    g, r = got.tocsr(), ref.tocsr()
    assert g.shape == r.shape and g.nnz == r.nnz
    worst = 0.0
    for i in range(g.shape[0]):
        gv = np.sort(g.data[g.indptr[i]:g.indptr[i + 1]])
        rv = np.sort(r.data[r.indptr[i]:r.indptr[i + 1]])
        if gv.shape != rv.shape:
            return float("inf")
        denom = np.maximum(np.abs(rv), 1e-30)
        if gv.shape[0]:
            worst = max(worst, float(np.max(np.abs(gv - rv) / denom)))
    return worst


def has_repeated_neighbour(out) -> bool:
    """True if one of every 97th row lists a column twice."""
    c = out.tocsr()
    return any(
        len(set(c.indices[c.indptr[r]:c.indptr[r + 1]].tolist())) != c.indptr[r + 1] - c.indptr[r]
        for r in range(0, c.shape[0], 97)
    )


def probe_transposed_lhs(dtype: str, device="cuda"):
    """P1 at the probe's shape and data; returns (status, ok)."""
    from .probes import transposed_lhs_product

    K, M, N = PROBE_SHAPE
    rng = np.random.default_rng(0)
    a_i = rng.integers(-5, 6, (K, M))
    b_i = rng.integers(-5, 6, (K, N))
    tdt = PROBE_DTYPES[dtype]
    a = torch.from_numpy(a_i).to(device=device, dtype=tdt)
    b = torch.from_numpy(b_i).to(device=device, dtype=tdt)
    out = transposed_lhs_product(a, b)
    # |values| <= 5, overlap <= 512: exact in every mode
    ok = bool(np.array_equal(out.cpu().numpy().astype(np.int64), a_i.T @ b_i))
    return ("ok" if ok else "WRONG DATA"), ok


def sweep_inputs(quick: bool, C=None, U=None):
    """The sweep's matrices: m (C x U, integral values, so 'auto' takes
    int8), mf (the same plus 0.123, float), and the per-row selectors
    filt and tgt (C x C)."""
    rng = np.random.default_rng(0)
    if C is None:
        C, U = (3000, 1500) if quick else (6144, 3000)
    m = sp.random_array((C, U), density=0.01, format="csr", dtype=np.float32, random_state=rng)
    m.data[:] = np.round(m.data * 4) + 1.0  # integral -> auto int8
    mf = m.copy()
    mf.data = mf.data + 0.123  # non-integral -> float paths
    rng_sel = np.random.default_rng(1)
    filt = sp.random_array((C, C), density=0.005, format="csr", dtype=np.float32,
                           random_state=rng_sel)
    tgt = sp.random_array((C, C), density=0.3, format="csr", dtype=np.float32,
                          random_state=rng_sel)
    return m, mf, filt, tgt


def sweep_variants(sim, m, mf, filt, tgt, quick: bool = False, **kw):
    """(label, call, tol) of every sweep entry, as tpu_kernel_check.py's
    sym_variants + gen_variants, on the package `sim`; `kw` goes to every
    call (the port's `device`)."""
    C = m.shape[0]
    common = dict(verbose=False, **kw)
    sym = [
        ("sym cosine int8", lambda: sim.cosine(m, k=50, **common), 0),
        ("sym dot int8", lambda: sim.dot_product(m, k=50, **common), 0),
        ("sym splus full int8",
         lambda: sim.s_plus(m, l1=0.4, l2=0.6, t1=0.8, t2=0.8, c1=0.4, c2=0.4, l3=0.2,
                            shrink=2.0, shrink_type="stabilized", threshold=0.001, k=50,
                            **common), 1e-5),
        ("sym jaccard binary", lambda: sim.jaccard(m, k=50, binary=True, **common), 0),
        ("sym cosine f32",
         lambda: sim.cosine(mf, k=50, compute_dtype="float32", **common), 1e-5),
        ("sym cosine bf16",
         lambda: sim.cosine(m, k=50, compute_dtype="bfloat16", **common), 5e-2),
        ("sym tversky asym",
         lambda: sim.tversky(m, alpha=0.2, beta=0.9, k=50, **common), 1e-5),
        ("sym asym-cosine", lambda: sim.asymmetric_cosine(m, alpha=0.2, k=50, **common), 1e-5),
        ("sym rp3beta (refactored)",
         lambda: sim.rp3beta(m, alpha=0.7, beta=0.4, k=50, **common), 1e-5),
        ("sym cosine f32-high",
         lambda: sim.cosine(mf, k=50, compute_dtype="float32", precision="high", **common),
         1e-4),
        ("sym tversky asym f32-high",
         lambda: sim.tversky(mf, alpha=0.2, beta=0.9, k=50, compute_dtype="float32",
                             precision="high", **common), 1e-4),
        ("sym k>tile-width int8 [port plan, no SYM_TC=128]",
         lambda: sim.dot_product(m, k=200, **common), 0),
        ("sym mid-k int8 [port plan, no SYM_TC=4096]",
         lambda: sim.cosine(m, k=256, **common), 0),
    ]
    gen = [
        ("gen cosine int8 (target_rows)",
         lambda: sim.cosine(m, k=50, target_rows=np.arange(0, C, 2), **common), 0),
        ("gen cosine f32 (target_rows)",
         lambda: sim.cosine(mf, k=50, compute_dtype="float32", target_rows=np.arange(0, C, 2),
                            **common), 1e-5),
        ("gen cosine f32-high (target_rows)",
         lambda: sim.cosine(mf, k=50, compute_dtype="float32", precision="high",
                            target_rows=np.arange(0, C, 2), **common), 1e-4),
        ("gen filter+target masks int8",
         lambda: sim.cosine(m, m.T.tocsr(), k=50, filter_cols=filt, target_cols=tgt,
                            **common), 0),
        ("gen f32-high int x float",
         lambda: sim.dot_product(m, mf.T.tocsr(), k=50, compute_dtype="float32",
                                 precision="high", **common), 1e-4),
        ("gen f32-high float x int",
         lambda: sim.dot_product(mf, m.T.tocsr(), k=50, compute_dtype="float32",
                                 precision="high", **common), 1e-4),
        ("gen f32-high int x float tc=4224",
         lambda: sim.dot_product(m, mf.T.tocsr(), k=50, compute_dtype="float32",
                                 precision="high", block_size=4224, **common), 1e-4),
    ]
    if quick:
        # as the reference's quick mode: the first two symmetric entries,
        # the first general one and the wide-tile one
        return sym[:2] + gen[:1] + gen[-1:]
    return sym + gen


@contextlib.contextmanager
def plain_versions():
    """Inside, every public call runs the kernels' plain versions: the
    engine's execute gets `_tile_fn="plain"`."""
    from ..engine import splus

    real = splus.execute
    splus.execute = functools.partial(real, _tile_fn="plain")
    try:
        yield
    finally:
        splus.execute = real


def _engine_counters():
    from ..engine import gather, panel_topk, scatter, sym_topk, tile_topk

    return {"tile_topk": tile_topk, "sym_topk": sym_topk, "panel_topk": panel_topk,
            "gather": gather, "scatter": scatter}


def _counted(call):
    """`call()` with the engine kernels' counts set to 0 just before and
    read just after: (result, seconds, kernel launches, plain calls)."""
    counters = _engine_counters()
    for c in counters.values():
        c.reset_counts()
    t0 = time.perf_counter()
    out = call()
    seconds = time.perf_counter() - t0
    return (out, seconds, sum(c.kernel_launches for c in counters.values()),
            sum(c.plain_calls for c in counters.values()))


def check_variant(sim, label, call, tol, on_card: bool):
    """One variant on the kernels and on the plain versions; returns its
    result line (a dict with `ok`). On a card the kernel run must launch
    kernels and run no plain version, and the plain run the reverse."""
    sim.clear_caches()
    got, t_kernel, launches, plain_in_kernel_run = _counted(call)
    sim.clear_caches()
    with plain_versions():
        ref, t_plain, launches_in_plain_run, _ = _counted(call)
    sim.clear_caches()
    if got.shape != ref.shape or got.nnz != ref.nnz:
        rel = float("inf")
    else:
        rel = row_values_rel(got, ref)
    match = (rel == 0.0) if tol == 0 else (rel <= tol)
    dupes = has_repeated_neighbour(got)
    routed = not on_card or (launches > 0 and plain_in_kernel_run == 0
                             and launches_in_plain_run == 0)
    return {"label": label, "ok": bool(match and not dupes and routed), "rel": rel, "tol": tol,
            "nnz": (int(got.nnz), int(ref.nnz)), "dupes": dupes, "launches": launches,
            "plain_calls_in_kernel_run": plain_in_kernel_run,
            "launches_in_plain_run": launches_in_plain_run,
            "kernel_s": t_kernel, "plain_s": t_plain}


def run_sweep(quick: bool = False, device="cuda", C=None, U=None, out=print):
    """The whole sweep; returns (probe results, variant results, ok)."""
    import similaripy_tpu_torch as sim
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    probes = {}
    for dt in PROBE_DTYPES:
        status, ok = probe_transposed_lhs(dt, dev)
        probes[dt] = {"status": status, "ok": ok}
        out(f"probe transposed-lhs product [{dt}]: {status}")
    m, mf, filt, tgt = sweep_inputs(quick, C, U)
    results = []
    for label, call, tol in sweep_variants(sim, m, mf, filt, tgt, quick, device=dev):
        r = check_variant(sim, label, call, tol, dev.type == "cuda")
        results.append(r)
        out(f"{'ok' if r['ok'] else 'FAIL':4s} {label:50s} rel={r['rel']:.2e} "
            f"nnz {r['nnz'][0]}/{r['nnz'][1]} dupes={r['dupes']} launches {r['launches']} "
            f"kernels {r['kernel_s']:.2f}s / plain {r['plain_s']:.2f}s")
    ok = all(p["ok"] for p in probes.values()) and all(r["ok"] for r in results)
    return probes, results, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the reduced sweep (C 3,000)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    else:
        print(f"device: {dev}", flush=True)
    probes, results, ok = run_sweep(args.quick, dev, out=lambda s: print(s, flush=True))
    if not ok:
        failed = [k for k, p in probes.items() if not p["ok"]]
        failed += [r["label"] for r in results if not r["ok"]]
        print(f"FAILED: {failed}", flush=True)
        return 1
    print("all kernel variants match", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
