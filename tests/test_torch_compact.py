"""The port's union-compaction executor against the JAX package's, end to end
on the CPU.

The cases mirror tests/test_compact.py. The JAX side is forced onto its
compaction route (SIMILARIPY_TPU_COMPACT=1) with its symmetric route off
(SIMILARIPY_TPU_SYMMETRIC=0); the port is forced with compact.MODE = "on"
and its symmetric route off, and each call asserts that it took the
"compact" route and ran K3 (and K4 where a bucket gathers) through their
plain versions. Results have equal nnz and check_sum within rtol 1e-4
(tests/oracles.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu as jsim
import similaripy_tpu_torch as tsim
from oracles import check_sum, py_cosine, top_k
from similaripy_tpu.engine import compact as jcompact
from similaripy_tpu.engine.preprocess import preprocess as jpreprocess
from similaripy_tpu_torch.engine import compact, executor, gather, panel_topk, symmetric
from similaripy_tpu_torch.engine.preprocess import preprocess

torch.set_num_threads(2)

CPU = dict(device="cpu", verbose=False)


@pytest.fixture(autouse=True)
def _force_compact(monkeypatch):
    """Both packages on their compaction routes, caches cleared."""
    monkeypatch.setenv("SIMILARIPY_TPU_COMPACT", "1")
    monkeypatch.setenv("SIMILARIPY_TPU_SYMMETRIC", "0")
    monkeypatch.setattr(compact, "MODE", "on")
    monkeypatch.setattr(symmetric, "symmetric_eligible", lambda *a, **kw: False)
    tsim.clear_caches()
    jsim.clear_caches()
    yield
    tsim.clear_caches()
    jsim.clear_caches()


def _int_matrix(rows, cols, density, seed):
    rng = np.random.default_rng(seed)
    m = sp.random_array((rows, cols), density=density, format="csr",
                        dtype=np.float32, random_state=rng)
    m.data[:] = np.round(m.data * 4) + 1.0  # small ints -> int8 path arms
    return m


def _both(name, *args, **kw):
    """The port's call (its route and kernels checked: K4 runs exactly when
    a bucket gathers) and the JAX package's."""
    panel_topk.reset_counts()
    gather.reset_counts()
    got = getattr(tsim, name)(*args, **CPU, **kw)
    assert executor.last_route == "compact"
    assert panel_topk.plain_calls > 0 and panel_topk.kernel_launches == 0
    gathers = any(B > 0 for B, _ in executor.last_plan["buckets"])
    assert (gather.plain_calls > 0) == gathers
    ref = getattr(jsim, name)(*args, verbose=False, **kw)
    return got, ref


def _assert_match(got, ref, rtol=1e-4):
    assert got.shape == ref.shape
    assert got.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=rtol)


def test_compact_eligibility_threshold(monkeypatch):
    m_small = _int_matrix(50, 500, 0.05, 0)
    m_big = _int_matrix(50, 4096, 0.05, 0)
    cpu = torch.device("cpu")
    for m, expect in ((m_small, False), (m_big, True)):
        pre = preprocess(m, m.T, l2=1.0, k=10)
        assert compact.compact_eligible(pre, 10, cpu) is expect
        assert jcompact.compact_eligible(jpreprocess(m, m.T, l2=1.0, k=10), 10) is expect
    # "auto" takes it on a card only, "off" nowhere; k above K3's cap never
    monkeypatch.setattr(compact, "MODE", "auto")
    assert not compact.compact_eligible(pre, 10, cpu)
    assert compact.compact_eligible(pre, 10, torch.device("cuda"))
    small = preprocess(m_small, m_small.T, l2=1.0, k=10)
    assert not compact.compact_eligible(small, 10, torch.device("cuda"))
    monkeypatch.setattr(compact, "MODE", "off")
    assert not compact.compact_eligible(pre, 10, cpu)
    monkeypatch.setattr(compact, "MODE", "on")
    m2 = sp.random_array((4096, 2000), density=0.01, format="csr", dtype=np.float32,
                         random_state=np.random.default_rng(1))
    assert not compact.compact_eligible(preprocess(m_big, m2, k=1025), 1025, cpu)


def test_compact_cosine_int8_vs_oracle():
    m = _int_matrix(400, 6000, 0.02, 1)
    got, ref = _both("cosine", m, k=30)
    assert executor.last_plan["compute_dtype"] == "int8"
    _assert_match(got, ref)
    np.testing.assert_allclose(check_sum(got), check_sum(py_cosine(m, 30)), rtol=1e-4)


def test_compact_dot_float32_vs_oracle():
    rng = np.random.default_rng(2)
    m = sp.random_array((300, 5000), density=0.02, format="csr",
                        dtype=np.float32, random_state=rng)
    got, ref = _both("dot_product", m, k=25)
    assert executor.last_plan["compute_dtype"] == "float32"
    _assert_match(got, ref)


def test_compact_jaccard_binary():
    m = _int_matrix(300, 4500, 0.02, 3)
    _assert_match(*_both("jaccard", m, k=20, binary=True))


def test_compact_rp3beta():
    m = _int_matrix(350, 4096, 0.015, 4)
    _assert_match(*_both("rp3beta", m, alpha=0.8, beta=0.4, k=15))


def test_compact_matches_grouped_path(monkeypatch):
    """The general route gives the same result (both exact int8)."""
    m = _int_matrix(300, 5000, 0.02, 5)
    got_c, ref = _both("cosine", m, k=40)
    monkeypatch.setattr(compact, "MODE", "off")
    got_d = tsim.cosine(m, k=40, **CPU)
    assert executor.last_route == "general"
    np.testing.assert_allclose(check_sum(got_c), check_sum(got_d), rtol=1e-6)
    _assert_match(got_c, ref)


def test_compact_target_rows():
    m = _int_matrix(300, 4096, 0.02, 6)
    tr = [5, 250, 17, 100]
    got, ref = _both("cosine", m, k=10, target_rows=tr, format_output="csr")
    _assert_match(got, ref)
    full = tsim.cosine(m, k=10, **CPU, format_output="csr")
    for r in tr:
        a = np.sort(got.data[got.indptr[r]: got.indptr[r + 1]])
        b = np.sort(full.data[full.indptr[r]: full.indptr[r + 1]])
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_compact_filter_cols_array():
    m = _int_matrix(250, 4096, 0.02, 7)
    banned = np.arange(0, 250, 3)
    got, ref = _both("cosine", m, k=15, filter_cols=banned)
    _assert_match(got, ref)
    assert not set(got.tocsr().indices) & set(banned.tolist())


def test_compact_matrix_selector_falls_back():
    """MATRIX-mode selectors route to the general executor."""
    m = _int_matrix(200, 4096, 0.02, 8)
    fil = sp.random_array((200, 200), density=0.05, format="csr",
                          dtype=np.float32, random_state=np.random.default_rng(9))
    got = tsim.dot_product(m, m.T, k=10, filter_cols=fil, **CPU)
    assert executor.last_route == "general"
    ref = jsim.dot_product(m, m.T, k=10, filter_cols=fil, verbose=False)
    _assert_match(got, ref)


def test_compact_tiny_hot_prefix(monkeypatch):
    """A hot prefix below KB (512) makes both packages fall back to the
    general route; the smallest one allowed (768) sends most of the inner
    dimension to cold unions, which gather."""
    monkeypatch.setenv("SIMILARIPY_TPU_HOT", "512")
    monkeypatch.setattr(compact, "HOT", 512)
    m = _int_matrix(300, 4096, 0.03, 10)
    got = tsim.cosine(m, k=20, **CPU)
    assert executor.last_route == "general"
    _assert_match(got, jsim.cosine(m, k=20, verbose=False))
    np.testing.assert_allclose(check_sum(got), check_sum(py_cosine(m, 20)), rtol=1e-4)

    monkeypatch.setenv("SIMILARIPY_TPU_HOT", "768")
    monkeypatch.setattr(compact, "HOT", 768)
    m = _int_matrix(300, 20000, 0.002, 10)
    got, ref = _both("cosine", m, k=20)
    assert executor.last_plan["H"] == 768
    assert any(B > 0 for B, _ in executor.last_plan["buckets"])
    _assert_match(got, ref)


def test_compact_skewed_degrees_promotion():
    """Power-law degrees force head panels into bigger buckets / dense."""
    rng = np.random.default_rng(11)
    n_rows, n_cols = 400, 4096
    rows, cols = [], []
    w = 1.0 / np.arange(1, n_cols + 1) ** 1.1
    w /= w.sum()
    for r in range(n_rows):
        deg = int(rng.integers(1, 60)) if r > 10 else 2000  # 10 head rows
        c = rng.choice(n_cols, size=min(deg, n_cols), replace=False, p=None) \
            if r <= 10 else rng.choice(n_cols, size=deg, replace=False, p=w)
        rows.extend([r] * len(c))
        cols.extend(c.tolist())
    vals = np.ones(len(rows), np.float32)
    m = sp.csr_array((vals, (rows, cols)), shape=(n_rows, n_cols))
    got, ref = _both("cosine", m, k=30)
    _assert_match(got, ref)
    np.testing.assert_allclose(check_sum(got), check_sum(py_cosine(m, 30)), rtol=1e-4)


def test_compact_second_matrix():
    """dot_product(m1, m2) with distinct matrices through compact."""
    m1 = _int_matrix(200, 4096, 0.02, 12)
    m2 = _int_matrix(200, 4096, 0.02, 13).T.tocsr()  # 4096 x 200
    got, ref = _both("dot_product", m1, m2, k=20, threshold=float("-inf"))
    _assert_match(got, ref)
    ref_t = top_k(sp.csr_array((m1 @ m2).toarray()), 20)
    np.testing.assert_allclose(check_sum(got), check_sum(ref_t), rtol=1e-4)


def test_compact_caching_roundtrip():
    m = _int_matrix(300, 4096, 0.02, 14)
    a, ref = _both("cosine", m, k=10)
    info = tsim.cache_info()
    assert {"compact_m1", "compact_m2"} <= set(info["by_kind"])
    assert info["by_kind"]["compact_m1"]["device_bytes"] > 0
    b, _ = _both("cosine", m, k=10)  # warm: cached plan + tiles
    assert tsim.cache_info()["entries"] == info["entries"]
    np.testing.assert_allclose(check_sum(a), check_sum(b), rtol=0)
    _assert_match(a, ref)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32", "int8"])
def test_compact_compute_dtypes(compute_dtype):
    """Every compute mode through the cold buckets: the hot bias as f32 (an
    f32 product of bf16 values for bfloat16) or exact int32."""
    m = _int_matrix(300, 20000, 0.002, 15)
    got, ref = _both("cosine", m, k=20, compute_dtype=compute_dtype)
    assert executor.last_plan["compute_dtype"] == compute_dtype
    assert any(B > 0 for B, _ in executor.last_plan["buckets"])
    _assert_match(got, ref)


def test_oom_replans_once_on_the_compact_route(monkeypatch):
    budgets = []
    real = compact.execute_compact

    def flaky(pre, params, **kw):
        budgets.append(kw["budget_bytes"])
        if len(budgets) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(pre, params, **kw)

    monkeypatch.setattr(compact, "execute_compact", flaky)
    m = _int_matrix(300, 4096, 0.02, 16)
    got, ref = _both("cosine", m, k=10)
    assert budgets == [budgets[0], int(budgets[0] * 0.75)]
    _assert_match(got, ref)
