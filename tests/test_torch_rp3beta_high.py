"""rp3beta at precision='high' and 'highest' against the benchmark's plain
float64 reference of the published definition
(perfbench/reference/item_rp3beta.py), on the CPU: the whole matrix through
the symmetric route with its asymmetric epilogue, and target rows through
the general route. The port alone: no JAX is needed.

The served rows are held to the limits of the benchmark's cell
``ml32m-rp3beta-high.full-build`` (perfbench/workloads/), with the cell's
comparison (perfbench/pbcore/compare.py), which is robust to ties: an id
must be a candidate of the reference and the served columns' reference
values must match its own top-k rank by rank, so tied columns may trade
places and nothing else may. Why these tolerances: the split-bf16x3
products carry about 16 bits of each operand (their relative error in
PERF.md is some 1e-5), true f32 some 1e-7, and the nearest precision below
the configuration's, the operands rounded to TF32, errs by some 5e-4; the
limits lie between (PERF.md, the cell's calibration), and a TF32 run must
fail them."""

import numpy as np
import pytest
import scipy.sparse as sp

import similaripy_tpu_torch as tsim
from perfbench_parts import COMPARE, limits, reference
from similaripy_tpu_torch.engine import executor

CELL = "ml32m-rp3beta-high.full-build"
CPU = dict(device="cpu", verbose=False)
ITEM_RP3BETA = reference("item_rp3beta")
LIMITS = limits(CELL)


def _ratings(users=600, items=300, seed=0):
    """Half stars, the items' popularity skewed as in the cell's pattern."""
    rng = np.random.default_rng(seed)
    weight = 1.0 / np.arange(1, items + 1) ** 0.7
    per_user = rng.integers(3, 40, users)
    rows, cols = [], []
    for u, n in enumerate(per_user):
        cols.append(rng.choice(items, size=n, replace=False, p=weight / weight.sum()))
        rows.append(np.full(n, u))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.integers(1, 11, rows.shape[0]).astype(np.float32) / 2
    return sp.csr_array((vals, (rows, cols)), shape=(users, items))


URM = _ratings()
SOME = np.arange(1, URM.shape[1], 7)


def _reference(alpha, beta, k=100):
    call = {"function": "rp3beta", "kwargs": {"k": k, "alpha": alpha, "beta": beta}}
    return ITEM_RP3BETA.Reference(URM, call, {}, "cpu")


def _numbers(served, rows, ref_rows):
    out = served.tocsr()
    got = [(out.indices[out.indptr[r]:out.indptr[r + 1]], out.data[out.indptr[r]:out.indptr[r + 1]])
           for r in rows]
    return COMPARE.compare_rows(got, ref_rows.vals, ref_rows.at, ref_rows.scale)


@pytest.mark.parametrize("targets", ["all", "some"])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.6), (0.5, 0.0)])
@pytest.mark.parametrize("precision", ["high", "highest"])
def test_rp3beta_matches_the_published_definition(precision, alpha, beta, targets):
    tsim.clear_caches()
    rows = np.arange(URM.shape[1]) if targets == "all" else SOME
    got = tsim.rp3beta(URM.T, alpha=alpha, beta=beta, k=100, precision=precision,
                       target_rows=None if targets == "all" else SOME, **CPU)
    if targets == "all":
        assert executor.last_route == "symmetric"
        assert executor.last_plan["asym"]
        assert executor.last_plan["f32x3"] == ("both" if precision == "high" else None)
    else:
        assert executor.last_route != "symmetric"
    numbers = _numbers(got, rows, _reference(alpha, beta).rows(URM.data, rows))
    ok, shown = COMPARE.judge(numbers, LIMITS)
    assert ok, shown
    assert numbers["count_off"] == 0 and numbers["bad_ids"] == 0


def test_a_tf32_run_fails_the_limits():
    ref = _reference(1.0, 0.6)
    rows = np.arange(URM.shape[1])
    exact = ref.rows(URM.data, rows)
    numbers = COMPARE.compare_rows(ref.rows(URM.data, rows, "tf32").served(), exact.vals,
                                   exact.at, exact.scale)
    assert numbers["value_err"] > LIMITS["value_err"]
    assert not COMPARE.judge(numbers, LIMITS)[0]
