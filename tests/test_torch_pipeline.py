"""The port's public API against the JAX package's, end to end on the CPU.

bm25 -> cosine -> recommend (the README's and the reference notebook's
pipeline), the other normalizers and similarities, and the same errors
with the same messages on bad input. Normalized data agrees to rtol 1e-5
(f32 sums in another order; float64 input exactly); similarity outputs have
equal nnz and check_sum within rtol 1e-4 (tests/oracles.py).
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu as jsim
import similaripy_tpu_torch as tsim
from oracles import check_sum, generate_random_matrix

torch.set_num_threads(2)

CPU = dict(device="cpu")


def _urm(seed=0, shape=(160, 90), density=0.06):
    rng = np.random.default_rng(seed)
    urm = sp.random_array(shape, density=density, format="csr", dtype=np.float32,
                          random_state=rng)
    urm.data = rng.choice(np.arange(0.5, 5.5, 0.5), urm.nnz).astype(np.float32)
    return urm


def _assert_match(got, ref):
    assert got.shape == ref.shape
    assert got.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-4)


def _assert_same_data(got, ref, rtol=1e-5):
    got, ref = got.tocsr(), ref.tocsr()
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=rtol, atol=1e-7)


def test_bm25_cosine_recommend():
    urm = _urm()
    urm_n, urm_nj = tsim.bm25(urm, **CPU), jsim.bm25(urm)
    _assert_same_data(urm_n, urm_nj)

    W = tsim.cosine(urm_nj.T, k=20, verbose=False, **CPU)
    Wj = jsim.cosine(urm_nj.T, k=20, verbose=False)
    _assert_match(W, Wj)

    users = list(range(0, 160, 2))
    recs = tsim.recommend(urm_nj, Wj, k=5, target_rows=users, verbose=False, **CPU)
    recs_j = jsim.recommend(urm_nj, Wj, k=5, target_rows=users, verbose=False)
    _assert_match(recs, recs_j)
    recs, seen = recs.tocsr(), urm.tocsr()
    for u in users:
        got = set(recs.indices[recs.indptr[u]:recs.indptr[u + 1]])
        assert not got & set(seen.indices[seen.indptr[u]:seen.indptr[u + 1]])


def test_raw_ratings_cosine_takes_int8():
    urm = _urm(seed=1)
    from similaripy_tpu_torch.engine import executor

    got = tsim.cosine(urm.T, k=15, verbose=False, format_output="csr", **CPU)
    assert executor.last_plan["compute_dtype"] == "int8"
    ref = jsim.cosine(urm.T, k=15, verbose=False, format_output="csr")
    _assert_match(got, ref)


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("axis", [0, 1])
def test_normalize(norm, axis):
    m = generate_random_matrix(70, 40, density=0.1, seed=2)
    _assert_same_data(tsim.normalize(m, norm=norm, axis=axis, **CPU),
                      jsim.normalize(m, norm=norm, axis=axis))


@pytest.mark.parametrize("tf_mode,idf_mode", [
    ("sqrt", "smooth"), ("raw", "base"), ("log", "prob"), ("binary", "unary"),
    ("freq", "bm25"),
])
def test_tfidf_modes(tf_mode, idf_mode):
    m = _urm(seed=3)
    _assert_same_data(tsim.tfidf(m, tf_mode=tf_mode, idf_mode=idf_mode, **CPU),
                      jsim.tfidf(m, tf_mode=tf_mode, idf_mode=idf_mode))


def test_bm25plus_and_axis0():
    m = _urm(seed=4)
    _assert_same_data(tsim.bm25plus(m, delta=0.5, axis=0, **CPU),
                      jsim.bm25plus(m, delta=0.5, axis=0))


def test_float64_input_takes_the_numpy_twin():
    m = _urm(seed=5).astype(np.float64)
    got, ref = tsim.bm25(m, **CPU), jsim.bm25(m)
    assert got.dtype == np.float64
    _assert_same_data(got, ref, rtol=1e-12)


def test_inplace_writes_through():
    m = _urm(seed=6)
    ref = jsim.normalize(m, norm="l2")
    out = tsim.normalize(m, norm="l2", inplace=True, **CPU)
    np.testing.assert_allclose(m.data, ref.data, rtol=1e-6)
    np.testing.assert_allclose(out.data, ref.data, rtol=1e-6)


SIMILARITIES = [
    ("dot_product", {}),
    ("cosine", dict(shrink=2.0)),
    ("asymmetric_cosine", dict(alpha=0.3)),
    ("jaccard", {}),
    ("dice", {}),
    ("tversky", dict(alpha=0.6, beta=0.3)),
    ("p3alpha", dict(alpha=0.8)),
    ("rp3beta", dict(alpha=0.8, beta=0.4)),
    ("s_plus", dict(l3=1.0, pop2="sum", beta2=0.5)),
    ("cosine", dict(shrink=3.0, shrink_type="bayesian", threshold=0.01)),
    ("cosine", dict(shrink=1.0, shrink_type="additive", binary=True)),
]


@pytest.mark.parametrize("name,kw", SIMILARITIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SIMILARITIES)])
def test_similarities(name, kw):
    m = generate_random_matrix(80, 60, density=0.08, seed=7)
    got = getattr(tsim, name)(m, k=12, verbose=False, **kw, **CPU)
    ref = getattr(jsim, name)(m, k=12, verbose=False, **kw)
    _assert_match(got, ref)


def test_two_matrix_call_with_target_cols_matrix():
    m = generate_random_matrix(70, 50, density=0.1, seed=8).tocsr()
    w = generate_random_matrix(50, 40, density=0.2, seed=9).tocsr()
    tc = generate_random_matrix(70, 40, density=0.3, seed=10).tocsr()
    got = tsim.dot_product(m, w, k=8, target_cols=tc, verbose=False, **CPU)
    ref = jsim.dot_product(m, w, k=8, target_cols=tc, verbose=False)
    _assert_match(got, ref)


def test_empty_target_rows():
    m = generate_random_matrix(30, 20, density=0.1, seed=11)
    assert tsim.cosine(m, k=5, target_rows=[], verbose=False, **CPU).nnz == 0


def _bad_calls():
    m = generate_random_matrix(30, 20, density=0.1, seed=12).tocsr()
    urm = _urm(seed=13, shape=(30, 20))
    return {
        "dense_matrix": lambda s: s.cosine(m.toarray(), verbose=False),
        "k_zero": lambda s: s.cosine(m, k=0, verbose=False),
        "format": lambda s: s.cosine(m, format_output="dense", verbose=False),
        "shapes": lambda s: s.dot_product(m, m, verbose=False),
        "target_rows": lambda s: s.cosine(m, target_rows=list(range(31)), verbose=False),
        "filter_shape": lambda s: s.cosine(m, filter_cols=m, verbose=False),
        "filter_type": lambda s: s.cosine(m, filter_cols="all", verbose=False),
        "verbose": lambda s: s.cosine(m, verbose="yes"),
        "depop": lambda s: s.s_plus(m, pop1=[1.0, 2.0], verbose=False),
        "shrink_type": lambda s: s.cosine(m, shrink_type="huge", verbose=False),
        "int8_float_data": lambda s: s.cosine(m, compute_dtype="int8", verbose=False),
        "recommend_model": lambda s: s.recommend(urm, m, verbose=False),
        "recommend_array_filter": lambda s: s.recommend(
            urm, sp.identity(20, format="csr"), filter_cols=[1, 2], verbose=False),
        "norm": lambda s: s.normalize(m, norm="l3"),
        "axis": lambda s: s.normalize(m, axis=2),
        "normalize_dense": lambda s: s.normalize(m.toarray()),
        "tf_mode": lambda s: s.bm25(m, tf_mode="loud"),
        "idf_mode": lambda s: s.tfidf(m, idf_mode="loud"),
    }


class _Cpu:
    """The port's public API with device='cpu' bound."""

    def __getattr__(self, name):
        fn = getattr(tsim, name)
        return lambda *a, **kw: fn(*a, device="cpu", **kw)


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_same_errors(case):
    call = _bad_calls()[case]
    with pytest.raises((TypeError, ValueError)) as ref:
        call(jsim)
    with pytest.raises(ref.type, match=re.escape(str(ref.value))):
        call(_Cpu())
