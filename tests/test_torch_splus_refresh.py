"""S-Plus at the library's defaults over BM25 weights, refreshed on target
rows, against the benchmark's plain float64 reference of the published
definition (perfbench/reference/item_splus.py), on the CPU: the targets
through the compaction route (compact.MODE "on", the kernels' plain
versions) at one column group and at two and three, and through the
general route; and the compaction route at one and at two and three column
groups against the JAX package's s_plus on the same inputs.

The served rows are held to the limits of the benchmark's cell
``ml32m-bm25-splus.refresh-8k`` (perfbench/workloads/), with the cell's
comparison (perfbench/pbcore/compare.py), which is robust to ties: an id
must be a candidate of the reference and the served columns' reference
values must match its own top-k rank by rank. Why these tolerances: a
row's best value is the item's S-Plus with itself, 1, and the port's f32
sum of a popular item's squared weights (up to 200k terms) against its
norm summed in float64 puts that value up to 4.3e-5 off on the card, as
far off as the weights rounded to TF32 put the others; so ``value_err``'s
limit lies between the port's largest reading and the smallest of the
weights rounded to bf16 (1.9e-3 on the card), and ``topk_gap`` (the port
0, TF32 7.5e-6 and more) is the limit a TF32 run fails (PERF.md, the
cell's calibration)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu as jsim
import similaripy_tpu_torch as tsim
from perfbench_parts import COMPARE, config, limits, reference
from similaripy_tpu_torch.engine import compact, executor

torch.set_num_threads(2)

CELL = "ml32m-bm25-splus.refresh-8k"
CPU = dict(device="cpu", verbose=False)
ITEM_SPLUS = reference("item_splus")
LIMITS = limits(CELL)
CONFIG = config("ml32m-bm25-splus")
BUILD = dict(CONFIG["build"]["kwargs"])


def _ratings(users=4096, items=600, seed=0):
    """Half stars, the items' popularity skewed as in the cell's pattern, so
    that a few items are rated by most users (their BM25 weights are
    negative); 4,096 users give the compaction route a hot prefix."""
    rng = np.random.default_rng(seed)
    weight = 1.0 / np.arange(1, items + 1) ** 0.9
    per_user = rng.integers(3, 30, users)
    rows, cols = [], []
    for u, n in enumerate(per_user):
        top = [0] if rng.random() < 0.7 else []  # item 0: rated by most users
        rest = rng.choice(np.arange(1, items), size=n, replace=False,
                          p=weight[1:] / weight[1:].sum())
        cols.append(np.concatenate([top, rest]).astype(np.int64))
        rows.append(np.full(cols[-1].shape[0], u))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.integers(1, 11, rows.shape[0]).astype(np.float32) / 2
    return sp.csr_array((vals, (rows, cols)), shape=(users, items))


URM = _ratings()
TARGETS = np.arange(0, URM.shape[1], 2)  # 300 items: two panels


def _reference():
    return ITEM_SPLUS.Reference(URM, CONFIG["build"], CONFIG, "cpu")


def _served(out, rows):
    out = out.tocsr()
    return [(out.indices[out.indptr[r]:out.indptr[r + 1]],
             out.data[out.indptr[r]:out.indptr[r + 1]]) for r in rows]


def _numbers(served, ref_rows):
    return COMPARE.compare_rows(served, ref_rows.vals, ref_rows.at, ref_rows.scale)


@pytest.fixture(scope="module")
def exact():
    return _reference().rows(URM.data, TARGETS)


@pytest.fixture(autouse=True)
def _clean():
    tsim.clear_caches()
    jsim.clear_caches()
    yield
    tsim.clear_caches()
    jsim.clear_caches()


def _refresh(monkeypatch, mode, groups):
    """s_plus(bm25(urm).T, target_rows=TARGETS) with the cell's arguments;
    `groups` > 1 narrows the tiles to 600 / groups columns and starves the
    budget, so each group holds one tile."""
    monkeypatch.setattr(compact, "MODE", mode)
    if groups > 1:
        monkeypatch.setattr(compact, "DEFAULT_TC", {2: 768, 3: 512}[groups])
        monkeypatch.setattr(executor, "hbm_budget_bytes", lambda device: 64 << 20)
    weighted = tsim.normalization.bm25(URM, device="cpu")
    return tsim.s_plus(weighted.T, target_rows=TARGETS, **BUILD, **CPU)


def test_the_weights_hold_negative_entries():
    # the reference and the port meet items whose idf is negative
    weighted = tsim.normalization.bm25(URM, device="cpu")
    assert (weighted.data < 0).any() and (weighted.data > 0).any()


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_the_compaction_route_matches_the_published_definition(monkeypatch, exact, groups):
    got = _refresh(monkeypatch, "on", groups)
    assert executor.last_route == "compact"
    assert executor.last_plan["compute_dtype"] == "float32"
    assert executor.last_plan["n_groups"] == groups
    numbers = _numbers(_served(got, TARGETS), exact)
    ok, shown = COMPARE.judge(numbers, LIMITS)
    assert ok, shown
    assert numbers["count_off"] == 0 and numbers["bad_ids"] == 0


def test_the_general_route_matches_the_published_definition(monkeypatch, exact):
    got = _refresh(monkeypatch, "off", 1)
    assert executor.last_route == "general"
    numbers = _numbers(_served(got, TARGETS), exact)
    ok, shown = COMPARE.judge(numbers, LIMITS)
    assert ok, shown


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_the_compaction_route_matches_the_jax_package(monkeypatch, groups):
    got = _served(_refresh(monkeypatch, "on", groups), TARGETS)
    assert executor.last_route == "compact"
    assert executor.last_plan["n_groups"] == groups
    weighted = jsim.normalization.bm25(URM)
    ref = _served(jsim.s_plus(weighted.T, target_rows=TARGETS, verbose=False, **BUILD), TARGETS)
    for (ids, vals), (ref_ids, ref_vals) in zip(got, ref):
        assert ids.shape == ref_ids.shape
        np.testing.assert_allclose(np.sort(vals), np.sort(ref_vals), rtol=1e-5, atol=1e-6)
        mine, theirs = dict(zip(ids, vals)), dict(zip(ref_ids, ref_vals))
        for c in mine.keys() & theirs.keys():
            np.testing.assert_allclose(mine[c], theirs[c], rtol=1e-5, atol=1e-6)
        # columns may trade places only in a tie at the row's cut
        cut = min(vals.min(), ref_vals.min())
        for c in mine.keys() ^ theirs.keys():
            np.testing.assert_allclose(mine.get(c, theirs.get(c)), cut, rtol=1e-5, atol=1e-6)


def test_a_tf32_run_fails_the_limits(exact):
    # by the ranking: the port's f32 values err as far as TF32's at the
    # self-similarity of popular items (PERF.md, the cell's calibration)
    control = _reference().rows(URM.data, TARGETS, "tf32").served()
    numbers = _numbers(control, exact)
    assert numbers["topk_gap"] > LIMITS["topk_gap"]
    assert not COMPARE.judge(numbers, LIMITS)[0]


def test_weights_rounded_to_bf16_fail_the_value_limit(monkeypatch, exact):
    # the upper reading of value_err: the cell's call with the weights
    # rounded to bf16, as a dtype gate that misjudged them would run it
    monkeypatch.setattr(compact, "MODE", "on")
    weighted = tsim.normalization.bm25(URM, device="cpu")
    got = tsim.s_plus(weighted.T, target_rows=TARGETS, **{**BUILD, "compute_dtype": "bfloat16"},
                      **CPU)
    assert executor.last_route == "compact"
    assert executor.last_plan["compute_dtype"] == "bfloat16"
    numbers = _numbers(_served(got, TARGETS), exact)
    assert numbers["value_err"] > LIMITS["value_err"]
