"""The port's exclude-seen fold against the JAX package, on the CPU.

One counterpart for each case of tests/test_filter_fold.py: the recommend
idiom ``dot_product(urm, W.T, filter_cols=urm)`` scores with m2 - M*I under
the exactness gate (``engine/executor.py::_exclude_seen_fold``) and stages
no filter masks. The fold must arm exactly where the JAX package's gate
arms, its results must equal the masked path's, and both must equal the
JAX package's on the same seeded inputs (equal nnz, check_sum within rtol
1e-4). The opt-out is the module setting ``executor.FOLD_FILTER``.
"""

import datetime

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu as jsim
import similaripy_tpu_torch as tsim
from oracles import check_sum
from similaripy_tpu.engine import executor as jex
from similaripy_tpu_torch.engine import cache, executor
from torch_mesh_cases import knn_model, ratings

torch.set_num_threads(2)

CPU = dict(device="cpu", verbose=False)


@pytest.fixture(autouse=True)
def _clean():
    tsim.clear_caches()
    jsim.clear_caches()
    yield
    executor.FOLD_FILTER = True
    tsim.clear_caches()
    jsim.clear_caches()


@pytest.fixture()
def data():
    urm, w = ratings()
    return urm.copy(), w.copy()


def _spy_fold(monkeypatch, module):
    calls = []
    orig = module._exclude_seen_fold

    def rec(*a, **kw):
        r = orig(*a, **kw)
        calls.append(r)
        return r

    monkeypatch.setattr(module, "_exclude_seen_fold", rec)
    return calls


def _pair(urm, w, **kw):
    """The port's (folded, masked) results of the same recommend-idiom
    call, and the fold's M on the first."""
    tsim.clear_caches()
    folded = tsim.dot_product(urm, w.T.tocsr(), filter_cols=urm, **CPU, **kw)
    fold_m = executor.last_plan.get("fold")
    executor.FOLD_FILTER = False
    tsim.clear_caches()
    masked = tsim.dot_product(urm, w.T.tocsr(), filter_cols=urm, **CPU, **kw)
    assert executor.last_plan.get("fold") is None
    executor.FOLD_FILTER = True
    tsim.clear_caches()
    return folded, masked, fold_m


def _jax(urm, w, **kw):
    jsim.clear_caches()
    return jsim.dot_product(urm, w.T.tocsr(), filter_cols=urm, verbose=False, **kw)


def _same(a, b, rtol=1e-4):
    assert a.shape == b.shape
    assert a.nnz == b.nnz
    np.testing.assert_allclose(check_sum(a), check_sum(b), rtol=rtol)


def test_fold_arms_and_matches_masked_path(data, monkeypatch):
    urm, w = data
    tcalls = _spy_fold(monkeypatch, executor)
    jcalls = _spy_fold(monkeypatch, jex)
    folded, masked, fold_m = _pair(urm, w, k=10)
    ref = _jax(urm, w, k=10)
    assert tcalls[0] is not None and tcalls[0] == fold_m
    assert jcalls[-1] == fold_m  # the same power of two as the reference
    _same(folded, masked, rtol=1e-6)
    _same(folded, ref)


def test_fold_excludes_every_seen_item(data):
    urm, w = data
    folded = tsim.dot_product(urm, w.T.tocsr(), k=10, filter_cols=urm, **CPU).tocsr()
    assert executor.last_plan["fold"] is not None
    u = urm.tocsr()
    for r in range(urm.shape[0]):
        got = set(folded.indices[folded.indptr[r]:folded.indptr[r + 1]])
        seen = set(u.indices[u.indptr[r]:u.indptr[r + 1]])
        assert not (got & seen), (r, got & seen)
    _same(folded, _jax(urm, w, k=10))


def test_fold_with_target_rows_and_precision_high(data):
    urm, w = data
    tr = np.arange(0, urm.shape[0], 3)
    kw = dict(k=10, target_rows=tr, compute_dtype="float32", precision="high")
    folded, masked, fold_m = _pair(urm, w, **kw)
    assert fold_m is not None
    _same(folded, masked, rtol=1e-5)
    _same(folded, _jax(urm, w, **kw))


def test_fold_plain_branch_parity(monkeypatch):
    """The counterpart of the JAX package's non-Pallas (XLA) case: the
    port's plain per-tile branch, which a carry deeper than the kernels'
    1,024 takes (executor._wide_k_tile), folds too."""
    rng = np.random.default_rng(8)
    urm = sp.random_array((40, 1100), density=0.02, format="csr",
                          dtype=np.float32, random_state=rng)
    urm.data[:] = np.rint(urm.data * 8) / 2 + 0.5
    w = knn_model(urm, 40)
    executor.wide_k_calls = 0
    folded, masked, fold_m = _pair(urm, w, k=1030)
    assert fold_m is not None and executor.wide_k_calls > 0
    _same(folded, masked, rtol=1e-6)
    monkeypatch.setenv("SIMILARIPY_TPU_USE_PALLAS", "0")
    _same(folded, _jax(urm, w, k=1030))


def test_fold_gate_disarms(data, monkeypatch):
    """Each gate condition disarms the fold, in both packages."""
    urm, w = data
    tcalls = _spy_fold(monkeypatch, executor)
    jcalls = _spy_fold(monkeypatch, jex)
    wt = w.T.tocsr()

    def both(fn, m1, m2, **kw):
        tsim.clear_caches()
        jsim.clear_caches()
        got = getattr(tsim, fn)(m1, m2, k=10, **CPU, **kw)
        ref = getattr(jsim, fn)(m1, m2, k=10, verbose=False, **kw)
        assert tcalls[-1] is None and jcalls[-1] is None
        assert executor.last_plan["fold"] is None
        _same(got, ref)
        return got

    # denominator epilogue (cosine)
    both("cosine", urm, wt, filter_cols=urm)
    # negative threshold
    both("dot_product", urm, wt, filter_cols=urm, threshold=-1.0)
    # a filter of another pattern
    rng = np.random.default_rng(5)
    other = sp.random_array(urm.shape, density=0.06, format="csr",
                            dtype=np.float32, random_state=rng)
    both("dot_product", urm, wt, filter_cols=other)
    # non-positive ratings
    neg = urm.copy()
    neg.data[0] = -1.0
    both("dot_product", neg, wt, filter_cols=neg)
    # a pathological dynamic range: the penalty would overflow f32
    tiny = urm.copy()
    tiny.data = tiny.data.copy()
    tiny.data[0] = 1e-35
    got = both("dot_product", tiny, wt, filter_cols=tiny)
    assert got.nnz > 0


def test_fold_opt_out_setting(data, monkeypatch):
    urm, w = data
    calls = _spy_fold(monkeypatch, executor)
    executor.FOLD_FILTER = False
    got = tsim.dot_product(urm, w.T.tocsr(), k=10, filter_cols=urm, **CPU)
    assert calls[-1] is None and executor.last_plan["fold"] is None
    monkeypatch.setenv("SIMILARIPY_TPU_FOLD_FILTER", "0")
    _same(got, _jax(urm, w, k=10))


def test_fold_binary_mode_stays_int8(data, monkeypatch):
    """binary=True binarizes both matrices, so the call takes the exact
    int8 path and the fold stays off (-M cannot ride int8)."""
    urm, w = data
    calls = _spy_fold(monkeypatch, executor)
    folded, masked, fold_m = _pair(urm, w, k=10, binary=True)
    assert calls and calls[0] is None and fold_m is None
    assert executor.last_plan["compute_dtype"] == "int8"
    _same(folded, masked, rtol=1e-6)
    _same(folded, _jax(urm, w, k=10, binary=True))


def test_fold_positive_threshold(data):
    urm, w = data
    folded, masked, fold_m = _pair(urm, w, k=10, threshold=0.5)
    assert fold_m is not None
    _same(folded, masked, rtol=1e-6)
    _same(folded, _jax(urm, w, k=10, threshold=0.5))


def test_fold_csr_output_format(data):
    urm, w = data
    folded, masked, _ = _pair(urm, w, k=10, format_output="csr")
    assert folded.format == masked.format == "csr"
    _same(folded, masked, rtol=1e-6)
    _same(folded, _jax(urm, w, k=10, format_output="csr"))


def test_fold_mesh_parity(data, tmp_path):
    """The sharded grouped path folds too: on a mesh (a gloo world of this
    one process; tests/test_torch_sharded.py runs worlds of 2 and 4), the
    folded result equals the mesh's masked path and the single-device
    folded path."""
    import torch.distributed as dist

    from similaripy_tpu_torch.parallel import make_mesh

    urm, w = data
    wt = w.T.tocsr()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(1, 1)
        mesh_folded = tsim.dot_product(urm, wt, k=10, filter_cols=urm, mesh=mesh, **CPU)
        assert executor.last_route == "sharded"
        assert executor.last_plan["fold"] is not None
        executor.FOLD_FILTER = False
        tsim.clear_caches()
        mesh_masked = tsim.dot_product(urm, wt, k=10, filter_cols=urm, mesh=mesh, **CPU)
        assert executor.last_plan["fold"] is None
        executor.FOLD_FILTER = True
    finally:
        dist.destroy_process_group()
    tsim.clear_caches()
    single = tsim.dot_product(urm, wt, k=10, filter_cols=urm, **CPU)
    _same(mesh_folded, mesh_masked, rtol=1e-6)
    _same(mesh_folded, single, rtol=1e-6)
    _same(mesh_folded, _jax(urm, w, k=10))


def test_fold_recommend_api(data, monkeypatch):
    """recommend() (exclude_seen=True) takes the fold and equals the masked
    path and the JAX package's recommend."""
    urm, w = data
    calls = _spy_fold(monkeypatch, executor)
    recs = tsim.recommend(urm, w, k=8, **CPU)
    assert calls and calls[-1] is not None
    executor.FOLD_FILTER = False
    tsim.clear_caches()
    ref = tsim.recommend(urm, w, k=8, **CPU)
    _same(recs, ref, rtol=1e-6)
    _same(recs, jsim.recommend(urm, w, k=8, verbose=False))


def test_folded_and_masked_never_share_a_cached_w(data):
    """fold_M is part of the matrix2 cache key: a masked call after a folded
    one (and the reverse) stages its own tiles, without clear_caches."""
    urm, w = data
    wt = w.T.tocsr()

    def m2_keys():
        return [k for k in cache._DEVICE_CACHE if k[0] == "m2"]

    folded = tsim.dot_product(urm, wt, k=10, filter_cols=urm, **CPU)
    (key,) = m2_keys()
    fold_m = executor.last_plan["fold"]
    assert fold_m is not None and fold_m in key
    executor.FOLD_FILTER = False
    masked = tsim.dot_product(urm, wt, k=10, filter_cols=urm, **CPU)
    (key2,) = m2_keys()
    assert fold_m not in key2 and None in key2
    executor.FOLD_FILTER = True
    again = tsim.dot_product(urm, wt, k=10, filter_cols=urm, **CPU)
    _same(masked, folded, rtol=1e-6)
    _same(again, folded, rtol=1e-6)
    # clear_caches drops the fold statistics with the rest
    assert executor._FOLD_STAT_CACHE
    tsim.clear_caches()
    assert not executor._FOLD_STAT_CACHE and not m2_keys()


def test_timing_laps(data):
    """splus.TIMING records the four host laps of a call (the JAX package's
    SIMILARIPY_TPU_TIMING laps) in splus.last_laps."""
    from similaripy_tpu_torch.engine import splus

    urm, w = data
    splus.last_laps.clear()
    tsim.recommend(urm, w, k=8, **CPU)
    assert splus.last_laps == {}  # off by default
    splus.TIMING = True
    try:
        tsim.recommend(urm, w, k=8, **CPU)
    finally:
        splus.TIMING = False
    laps = dict(splus.last_laps)
    assert list(laps) == ["validate", "preprocess", "execute (wall)", "assembly"]
    assert all(v >= 0.0 for v in laps.values())
