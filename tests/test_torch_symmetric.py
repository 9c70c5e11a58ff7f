"""The port's symmetric executor against the JAX package, end to end on the
CPU.

Every matrix2=None call over all rows, without selectors, takes the port's
symmetric route (executor.last_route), as it takes the JAX package's. The
port's planner is monkeypatched to small tiles and groups so that small
matrices run the whole triangle schedule: many tiles, anchor pairs, the
band, dead and diagonal blocks and the col-side delivery. The JAX package
runs its own calls as its tests run them on the CPU. Results have equal nnz
and check_sum within rtol 1e-4 (tests/oracles.py); the exact int8 path is
identical. The cases mirror tests/test_symmetric.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu as jsim
import similaripy_tpu_torch as tsim
from oracles import check_sum, top_k
from similaripy_tpu_torch.engine import executor, scatter, sym_topk, symmetric
from similaripy_tpu_torch.engine import preprocess as prep_mod
from similaripy_tpu_torch.engine.params import SPlusParams

torch.set_num_threads(2)

CPU = dict(device="cpu", verbose=False)


@pytest.fixture(autouse=True)
def _clear_caches():
    tsim.clear_caches()
    jsim.clear_caches()
    yield
    tsim.clear_caches()
    jsim.clear_caches()


def _force(monkeypatch, tc, gt):
    """The port's planner returns these tile and group sizes."""

    def plan(C, U, nnz, compute_dtype, budget, k_pad):
        return tc, gt, max(-(-U // 128) * 128, 128)

    monkeypatch.setattr(symmetric, "_plan", plan)


def _rand(n, m, density=0.15, seed=3, integral=True):
    rng = np.random.default_rng(seed)
    a = sp.random_array((n, m), density=density, format="csr",
                        dtype=np.float32, random_state=rng)
    if integral:
        a.data[:] = np.round(a.data * 4) + 1.0
    return a


def _both(name, m, **kw):
    """The port's call (its route checked) and the JAX package's."""
    sym_topk.reset_counts()
    scatter.reset_counts()
    got = getattr(tsim, name)(m, **CPU, **kw)
    assert executor.last_route == "symmetric"
    assert sym_topk.plain_calls == executor.last_plan["blocks"] > 0
    assert sym_topk.kernel_launches == 0 and scatter.kernel_launches == 0
    ref = getattr(jsim, name)(m, verbose=False, **kw)
    return got, ref


def _assert_match(got, ref, rtol=1e-4):
    assert got.shape == ref.shape
    assert got.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=rtol)


@pytest.mark.parametrize("tc,gt", [(128, 1), (128, 2), (256, 3)])
def test_multi_tile_triangle(monkeypatch, tc, gt):
    _force(monkeypatch, tc, gt)
    m = _rand(70, 900, seed=11).T.tocsr()  # 900 items x 70 users
    got, ref = _both("cosine", m, k=17)
    plan = executor.last_plan
    assert (plan["tc"], plan["gt"]) == (tc, gt)
    assert plan["n_groups"] >= 2  # at least one pair of anchors
    _assert_match(got, ref)


SIMILARITIES = {
    "dot_product": {},
    "cosine": dict(shrink=5.0),
    "asymmetric_cosine": dict(alpha=0.5),
    "jaccard": {},
    "dice": {},
    "tversky": dict(alpha=0.7, beta=0.7),
    "p3alpha": dict(alpha=0.8),
    "rp3beta": dict(alpha=0.7, beta=0.4),
    "s_plus": dict(l1=0.4, l2=0.6, t1=0.8, t2=0.8, c1=0.5, c2=0.5),
}


@pytest.mark.parametrize("name", sorted(SIMILARITIES))
def test_similarities_match_jax(monkeypatch, name):
    _force(monkeypatch, 128, 2)
    m = _rand(50, 420, seed=7).T.tocsr()
    got, ref = _both(name, m, k=11, **SIMILARITIES[name])
    _assert_match(got, ref)


@pytest.mark.parametrize("name,kw,gt", [
    ("tversky", dict(alpha=0.2, beta=0.9), 2),
    ("asymmetric_cosine", dict(alpha=0.2), 1),
])
def test_asymmetric_epilogue(monkeypatch, name, kw, gt):
    """The col side re-runs the epilogue with X and Y swapped."""
    _force(monkeypatch, 128, gt)
    m = _rand(45, 700, seed=37).T.tocsr()
    got, ref = _both(name, m, k=9, **kw)
    assert executor.last_plan["asym"]
    _assert_match(got, ref)


def test_rp3beta_refactor_matches_two_matrix_form(monkeypatch):
    """rp3beta's value-symmetric form (matrix2=None) takes the symmetric
    route; the explicit matrix2 call keeps the two-matrix formulation on
    the general route, equal up to its rounding (the JAX test's 5e-4)."""
    _force(monkeypatch, 128, 2)
    m = _rand(45, 650, seed=43).T.tocsr()
    got, ref = _both("rp3beta", m, alpha=0.7, beta=0.4, k=10)
    _assert_match(got, ref)
    old = tsim.rp3beta(m, matrix2=m.T, alpha=0.7, beta=0.4, k=10, **CPU)
    assert executor.last_route == "general"
    np.testing.assert_allclose(check_sum(got), check_sum(old), rtol=5e-4)


def test_k_exceeds_tile_width(monkeypatch):
    """k > tc: both carries accumulate over the whole sweep, so they are k
    deep (the regression the JAX package's test_pallas_k_exceeds_tile_width
    guards)."""
    _force(monkeypatch, 128, 2)
    m = _rand(60, 600, density=0.4, seed=3).T.tocsr()
    got, ref = _both("dot_product", m, k=200)
    _assert_match(got, ref)


def test_k_exceeds_catalog(monkeypatch):
    _force(monkeypatch, 128, 1)
    m = _rand(30, 280, density=0.4, seed=23).T.tocsr()
    got, ref = _both("dot_product", m, k=5000)
    _assert_match(got, ref)


def test_wide_k_branch(monkeypatch):
    """k_pad > 1024 takes the executor's counted plain branch per block, as
    the JAX package hands it to XLA."""
    _force(monkeypatch, 256, 2)
    m = _rand(40, 1100, density=0.1, seed=9).T.tocsr()
    symmetric.wide_k_calls = 0
    sym_topk.reset_counts()
    got = tsim.dot_product(m, k=1050, **CPU)
    assert executor.last_route == "symmetric"
    assert symmetric.wide_k_calls == executor.last_plan["blocks"]
    assert sym_topk.plain_calls == 0 and sym_topk.kernel_launches == 0
    _assert_match(got, jsim.dot_product(m, k=1050, verbose=False))


def test_trailing_empty_rows(monkeypatch):
    _force(monkeypatch, 128, 1)
    m = _rand(35, 260, seed=29).T.tocsr().tolil()
    m[258] = 0
    m[259] = 0
    m = sp.csr_array(m.tocsr())
    m.eliminate_zeros()
    got, ref = _both("cosine", m, k=7)
    _assert_match(got, ref)
    row = got.tocsr()[[5], :].toarray().ravel()
    assert abs(row[5] - 1.0) < 1e-5  # self-similarity on the diagonal


def test_threshold_with_negative_data(monkeypatch):
    _force(monkeypatch, 128, 2)
    m = _rand(45, 500, seed=19, integral=False).T.tocsr()
    m.data -= 0.5  # both signs
    got, ref = _both("cosine", m, k=8, threshold=0.2, compute_dtype="float32")
    _assert_match(got, ref)
    got, ref = _both("dot_product", m, k=500, threshold=-0.3, compute_dtype="float32")
    assert (got.tocsr().data < 0).any()
    _assert_match(got, ref)


def test_binary_and_edge_k(monkeypatch):
    _force(monkeypatch, 128, 2)
    m = _rand(30, 280, seed=23).T.tocsr()
    for k in (1, 10_000):
        got, ref = _both("jaccard", m, k=k, binary=True)
        _assert_match(got, ref)


def test_int8_path_is_identical(monkeypatch):
    _force(monkeypatch, 128, 2)
    m = _rand(40, 500, seed=5).T.tocsr()  # integral: auto takes int8
    got, ref = _both("cosine", m, k=12)
    assert executor.last_plan["compute_dtype"] == "int8"
    _assert_match(got, ref)
    np.testing.assert_array_equal(np.sort(got.tocsr().data), np.sort(ref.tocsr().data))


@pytest.mark.parametrize("compute_dtype,name,kw", [
    ("int8", "cosine", {}),
    ("int4", "cosine", {}),
    ("int8", "tversky", dict(alpha=0.2, beta=0.9)),
    ("int4", "asymmetric_cosine", dict(alpha=0.2)),
])
def test_int_routes_hand_k2_kmajor_operands(monkeypatch, compute_dtype, name, kw):
    """int8 and int4 densify their tiles K-major (K5's layout "kmajor") and
    hand K2 the anchors as a contiguous (sw, u_pad) stack and each inner
    tile as the (u_pad, tc) view, strides (1, u_pad), of a contiguous (tc,
    u_pad) tile, resident or densified; symmetric and asymmetric epilogues
    alike, and the results stay the JAX package's: values identical where
    the epilogue rounds as the JAX package's does (tversky's division
    differs from it by an ulp on either route, so it is held to rtol
    1e-4)."""
    _force(monkeypatch, 128, 2)
    m = _rand(40, 500, seed=5).T.tocsr()
    seen = []
    orig = sym_topk.fused_sym_topk

    def spy(a, d, *args, **kwargs):
        seen.append((tuple(a.shape), a.is_contiguous(), tuple(d.shape), d.stride(),
                     d.T.is_contiguous(), a.dtype, d.dtype))
        return orig(a, d, *args, **kwargs)

    monkeypatch.setattr(sym_topk, "fused_sym_topk", spy)
    got, ref = _both(name, m, k=12, compute_dtype=compute_dtype, **kw)
    plan = executor.last_plan
    assert plan["compute_dtype"] == "int8" and plan["asym"] == (name != "cosine")
    sw, u_pad, tc = plan["sw"], plan["u_pad"], plan["tc"]
    assert len(seen) == plan["blocks"] > 0
    assert set(seen) == {((sw, u_pad), True, (u_pad, tc), (1, u_pad), True, torch.int8,
                          torch.int8)}
    _assert_match(got, ref)
    if name != "tversky":
        np.testing.assert_array_equal(np.sort(got.tocsr().data), np.sort(ref.tocsr().data))


def test_bfloat16_compute(monkeypatch):
    _force(monkeypatch, 128, 2)
    m = _rand(40, 400, seed=6).T.tocsr()
    got, ref = _both("dot_product", m, k=10, compute_dtype="bfloat16")
    _assert_match(got, ref)


def test_cosine_oracle_direct(monkeypatch):
    """Against the SciPy oracle, not only the JAX package."""
    _force(monkeypatch, 128, 2)
    m = _rand(40, 300, seed=13).T.tocsr()
    got = tsim.cosine(m, k=10, **CPU)
    sq = m.multiply(m)
    norms = np.sqrt(np.asarray(sq.sum(axis=1)).ravel())
    dense = np.asarray((m @ m.T).todense())
    with np.errstate(divide="ignore", invalid="ignore"):
        cos = np.where((np.outer(norms, norms) > 0) & (dense != 0),
                       dense / np.outer(norms, norms), 0.0)
    np.testing.assert_allclose(check_sum(got), check_sum(top_k(sp.csr_array(cos), 10)),
                               rtol=1e-5)


def test_no_duplicate_neighbors(monkeypatch):
    """Exactly-once delivery: a pair delivered twice would show as a
    repeated column within a row."""
    _force(monkeypatch, 128, 2)
    m = _rand(80, 640, density=0.4, seed=17).T.tocsr()
    got = tsim.dot_product(m, k=30, **CPU).tocsr()
    for r in range(got.shape[0]):
        cols = got.indices[got.indptr[r]:got.indptr[r + 1]]
        assert len(set(cols.tolist())) == cols.shape[0], f"row {r} has duplicates"


def _pre(m, **kw):
    return prep_mod.preprocess(m, m.T, self_similar=True, **kw)


def test_eligibility_gates():
    m = _rand(20, 60, seed=31)
    params = SPlusParams(l2=1)
    assert symmetric.symmetric_eligible(_pre(m, l2=1.0), params, 0)
    # an explicit block size keeps the reference's semantics: general route
    assert not symmetric.symmetric_eligible(_pre(m, l2=1.0), params, 64)
    assert not symmetric.symmetric_eligible(_pre(m, l2=1.0), params, None)
    for kw in (dict(target_rows=[1, 2]), dict(filter_cols=[3]), dict(target_cols=[0, 4]),
               dict(filter_cols=m)):
        pre = prep_mod.preprocess(m, m.T, l2=1.0, self_similar=True, **kw)
        assert not symmetric.symmetric_eligible(pre, params, 0), kw
    # not a self-similarity call
    assert not symmetric.symmetric_eligible(prep_mod.preprocess(m, m.T, l2=1.0), params, 0)
    # asymmetric epilogues are eligible, and detected
    asym = SPlusParams(l1=1, t1=0.3, t2=0.9)
    pre_l1 = _pre(m, l1=1.0)
    assert symmetric.symmetric_eligible(pre_l1, asym, 0)
    assert not symmetric.epilogue_is_symmetric(pre_l1, asym)
    pre_ac = _pre(m, l2=1.0, c1=0.2, c2=0.8)
    assert symmetric.symmetric_eligible(pre_ac, params, 0)
    assert not symmetric.epilogue_is_symmetric(pre_ac, params)
    assert symmetric.epilogue_is_symmetric(_pre(m, l2=1.0), params)


def test_selected_calls_take_the_general_route(monkeypatch):
    _force(monkeypatch, 128, 2)
    m = _rand(40, 200, seed=41).T.tocsr()
    full = tsim.cosine(m, k=9, **CPU).tocsr()
    assert executor.last_route == "symmetric"
    sub = tsim.cosine(m, k=9, target_rows=[4, 9, 77], **CPU).tocsr()
    assert executor.last_route == "general"
    for r in (4, 9, 77):
        np.testing.assert_allclose(sub[[r], :].toarray(), full[[r], :].toarray(), rtol=1e-6)
    tsim.cosine(m, k=9, filter_cols=[1, 2], **CPU)
    assert executor.last_route == "general"
    tsim.cosine(m, k=9, block_size=128, **CPU)
    assert executor.last_route == "general"


def test_inputs_never_mutated():
    """The quantized paths work on copies: the caller's arrays (shared with
    the lazy transpose) stay untouched, and a later f32 call sees no
    quantized leftovers."""
    m = _rand(40, 300, seed=47, integral=False).T.tocsr()
    data_before = m.data.copy()
    tsim.cosine(m, k=6, compute_dtype="bfloat16", **CPU)
    f32_first = tsim.cosine(m, k=6, compute_dtype="float32", **CPU)
    np.testing.assert_array_equal(m.data, data_before)
    tsim.clear_caches()
    f32_fresh = tsim.cosine(m, k=6, compute_dtype="float32", **CPU)
    np.testing.assert_allclose(check_sum(f32_first), check_sum(f32_fresh), rtol=0)
    _assert_match(f32_first, jsim.cosine(m, k=6, compute_dtype="float32", verbose=False))


def test_quantized_call_does_not_poison_cached_m2(monkeypatch):
    _force(monkeypatch, 128, 1)
    m = _rand(40, 300, seed=53).T.tocsr()  # integral: auto takes int8
    tsim.cosine(m, k=6, **CPU)  # caches the int8 stacks
    assert executor.last_plan["compute_dtype"] == "int8"
    warm = tsim.cosine(m, k=6, compute_dtype="float32", **CPU)
    tsim.clear_caches()
    cold = tsim.cosine(m, k=6, compute_dtype="float32", **CPU)
    np.testing.assert_allclose(check_sum(warm), check_sum(cold), rtol=0)


def test_oom_replans_once_on_the_symmetric_route(monkeypatch):
    budgets = []
    real = symmetric.execute_symmetric

    def flaky(pre, params, **kw):
        budgets.append(kw["budget_bytes"])
        if len(budgets) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(pre, params, **kw)

    monkeypatch.setattr(symmetric, "execute_symmetric", flaky)
    m = _rand(40, 300, seed=59).T.tocsr()
    got = tsim.cosine(m, k=8, **CPU)
    assert budgets == [budgets[0], int(budgets[0] * 0.75)]
    _assert_match(got, jsim.cosine(m, k=8, verbose=False))
