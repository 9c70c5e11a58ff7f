"""The port's device-resident cache (similaripy_tpu_torch.engine.cache) and
its public cache_info / clear_caches.

Mirrors the JAX package's cache tests (tests/test_advice_regressions.py,
tests/test_edge_cases.py::test_cache_info_reflects_residents): an in-place
mutation of an input is always seen, eviction is LRU, stale geometries are
evicted, host-resident entries are bounded by bytes, other matrices'
uploads are counted for the planners, and the symmetric planner warns when
they crowd the budget. Calls run on the CPU, where the cached tensors count
as device bytes, as JAX's CPU arrays do in the JAX package.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu as jsim
import similaripy_tpu_torch as tsim
from oracles import check_sum
from similaripy_tpu_torch.engine import cache
from similaripy_tpu_torch.engine import executor as ex

torch.set_num_threads(2)

CPU = dict(device="cpu", verbose=False)


@pytest.fixture(autouse=True)
def _clear_caches():
    tsim.clear_caches()
    yield
    tsim.clear_caches()


def _rand(shape, seed, density=0.2):
    m = sp.random_array(shape, density=density, format="csr", dtype=np.float32,
                        random_state=np.random.default_rng(seed))
    m.data[:] = np.round(m.data * 4) + 1.0
    return m


@pytest.mark.parametrize("symmetric", [True, False])
def test_inplace_data_mutation_invalidates_caches(symmetric):
    m = _rand((50, 30), seed=1)

    def call():
        m2 = None if symmetric else m.T.tocsr()
        return tsim.dot_product(m, m2, k=50, threshold=float("-inf"), **CPU).tocsr()

    out1 = call()
    assert ex.last_route == ("symmetric" if symmetric else "general")
    m.data[m.data.shape[0] // 2] += 1.0  # one element, in place
    out2 = call()
    np.testing.assert_allclose(out2.toarray(), (m @ m.T).toarray(), rtol=1e-4)
    assert not np.allclose(out1.toarray(), out2.toarray())


def test_clear_caches_api():
    m = _rand((20, 10), seed=2, density=0.3)
    tsim.dot_product(m, k=5, **CPU)
    assert tsim.cache_info()["entries"] > 0
    tsim.clear_caches()  # must not raise; the next call re-stages
    assert tsim.cache_info()["entries"] == 0
    assert tsim.dot_product(m, k=5, **CPU).nnz > 0


def test_device_cache_is_lru():
    """_cache_get refreshes recency: a hot entry survives colder ones."""
    for i in range(cache._DEVICE_CACHE_CAP):
        cache._cache_put(("t", i), i)
    assert cache._cache_get(("t", 0)) == 0  # touch the oldest
    cache._cache_put(("t", "new"), 99)  # one over the cap
    assert cache._cache_get(("t", 0)) == 0, "hot entry was evicted"
    assert cache._cache_get(("t", 1)) is None, "LRU entry survived"


def test_evict_stale_drops_other_geometries():
    fp, other_fp = "a" * 40, "b" * 40
    cache._cache_put(("m2", fp, "x", "float32", 512, 2, 128), 1)
    cache._cache_put(("m2", fp, "x", "int8", 1024, 4, 256), 2)
    cache._cache_put(("m2", other_fp, "x", "int8", 1024, 4, 256), 3)
    keep = ("m2", fp, "x", "int8", 1024, 4, 256)
    cache._evict_stale("m2", fp, keep)
    assert cache._cache_get(("m2", fp, "x", "float32", 512, 2, 128)) is None
    assert cache._cache_get(keep) == 2
    assert cache._cache_get(("m2", other_fp, "x", "int8", 1024, 4, 256)) == 3


def test_host_cache_byte_budget(monkeypatch):
    """Host-resident entries (NumPy arrays) are bounded by bytes, oldest
    evicted first, the newest always kept."""
    monkeypatch.setattr(cache, "_HOST_CACHE_MAX_BYTES", 1000)
    big = np.zeros(150, np.float64)  # 1200 bytes each
    cache._cache_put(("sel", "one"), {"fil_rows": big})
    cache._cache_put(("dev", "x"), 42)  # entries without host arrays stay
    cache._cache_put(("sel", "two"), {"fil_rows": big.copy()})
    assert cache._cache_get(("sel", "one")) is None, "oldest sel survived"
    assert cache._cache_get(("sel", "two")) is not None
    assert cache._cache_get(("dev", "x")) == 42


def test_selector_cache_detects_filter_mutation():
    """The selector stacks are cached by full-content fingerprint; an
    in-place change of the filter's pattern is never served stale."""
    rng = np.random.default_rng(21)
    m1 = sp.random_array((60, 30), density=0.2, format="csr", dtype=np.float32,
                         random_state=rng)
    m2 = sp.random_array((30, 40), density=0.2, format="csr", dtype=np.float32,
                         random_state=rng)
    rows = np.arange(60)
    filt = sp.csr_matrix((np.ones(60, np.float32), (rows, np.full(60, 3))), shape=(60, 40))
    out1 = tsim.dot_product(m1, m2, k=40, filter_cols=filt, **CPU).tocsr()
    assert np.all(out1[:, 3].toarray() == 0)
    assert "sel" in tsim.cache_info()["by_kind"]
    filt.indices[:] = 7  # same shape of pattern, another excluded column
    out2 = tsim.dot_product(m1, m2, k=40, filter_cols=filt, **CPU).tocsr()
    assert np.all(out2[:, 7].toarray() == 0)
    ref = tsim.dot_product(m1, m2, k=40, **CPU).tocsr()
    np.testing.assert_allclose(out2[:, 3].toarray(), ref[:, 3].toarray(), rtol=1e-5)


def test_symmetric_budget_floor_warns(monkeypatch):
    """When other matrices' cached uploads exceed 75% of the budget the
    symmetric planner floors it at a quarter, and says so."""
    monkeypatch.setattr(ex, "hbm_budget_bytes", lambda device: 64 << 20)
    m = _rand((30, 20), seed=3, density=0.3)
    cache._cache_put(("m2", "f" * 40, "geom"), torch.zeros(14 << 20))  # 56 MB
    with pytest.warns(RuntimeWarning, match="other matrices"):
        tsim.cosine(m, k=5, **CPU)
    assert ex.last_route == "symmetric"
    tsim.clear_caches()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        tsim.cosine(m, k=5, **CPU)


def test_foreign_cache_bytes_accounting():
    a = _rand((50, 30), seed=5)
    b = _rand((40, 30), seed=6)
    tsim.dot_product(a, b.T.tocsr(), k=5, **CPU)
    assert cache._DEVICE_CACHE, "expected device-cache entries after a call"
    assert cache.foreign_cache_bytes(()) > 0  # with no fingerprint kept, all are foreign
    fps = {
        part for key in cache._DEVICE_CACHE for part in key
        if isinstance(part, str) and len(part) == 40  # sha1 hex digests
    }
    assert cache.foreign_cache_bytes(tuple(fps)) == 0
    tsim.clear_caches()
    assert cache.foreign_cache_bytes(()) == 0


def test_cache_info_reflects_residents():
    empty = tsim.cache_info()
    assert empty["entries"] == 0 and empty["device_bytes"] == 0
    assert empty["prep_entries"] == 0

    m = sp.random_array((300, 200), density=0.05, format="csr", dtype=np.float32,
                        random_state=np.random.default_rng(7))
    m.data[:] = np.round(m.data * 4) + 1.0
    tsim.dot_product(m, m.T.tocsr(), k=10, **CPU)
    info = tsim.cache_info()
    assert info["entries"] >= 2  # m1 panels + m2 tiles
    assert info["device_bytes"] > 0
    assert {"m1", "m2"} <= set(info["by_kind"])
    assert info["prep_entries"] >= 1
    assert sum(e["entries"] for e in info["by_kind"].values()) == info["entries"]

    tsim.cosine(m, k=10, **CPU)  # the symmetric route's stacks
    assert "sym_coo" in tsim.cache_info()["by_kind"]

    tsim.clear_caches()
    after = tsim.cache_info()
    assert after["entries"] == 0 and after["prep_entries"] == 0


def test_cache_info_keys_match_the_jax_package():
    """The same calls leave the same kinds of entries in both packages."""
    m = _rand((120, 80), seed=8, density=0.1)
    for pkg, kw in ((tsim, CPU), (jsim, dict(verbose=False))):
        pkg.clear_caches()
        pkg.dot_product(m, m.T.tocsr(), k=10, **kw)
        pkg.cosine(m, k=10, **kw)
    assert set(tsim.cache_info()["by_kind"]) == set(jsim.cache_info()["by_kind"])
    assert tsim.cache_info()["entries"] == jsim.cache_info()["entries"]
    jsim.clear_caches()


def test_warm_calls_reuse_the_cache_and_match():
    """A repeated call hits the cache (no new entries) and gives the same
    result as a cold one and as the JAX package."""
    m = _rand((90, 70), seed=9, density=0.1)
    cold = tsim.cosine(m, k=8, **CPU)
    n = tsim.cache_info()["entries"]
    warm = tsim.cosine(m, k=8, **CPU)
    assert tsim.cache_info()["entries"] == n
    np.testing.assert_allclose(check_sum(warm), check_sum(cold), rtol=0)
    ref = jsim.cosine(m, k=8, verbose=False)
    assert warm.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(warm), check_sum(ref), rtol=1e-4)
