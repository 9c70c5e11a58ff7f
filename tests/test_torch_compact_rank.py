"""The compaction executor's matrix2 staging across calls: the per-tile COO
stays in user order under a key of matrix2 alone ("compact_m2"), and each
call puts a column group's rows in its own rank order on the device
(compact.rank_rows) just before K5. On the CPU with compact.MODE = "on",
the port alone: every call against a fresh call (bit for bit) and the
NumPy oracle."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu_torch as tsim
from oracles import py_cosine
from similaripy_tpu_torch.engine import compact, executor, scatter, spans, splus, staging
from similaripy_tpu_torch.engine.preprocess import preprocess

torch.set_num_threads(2)

CPU = dict(device="cpu", verbose=False)
K = 20


def _int_matrix(rows, cols, density, seed):
    rng = np.random.default_rng(seed)
    m = sp.random_array((rows, cols), density=density, format="csr",
                        dtype=np.float32, random_state=rng)
    m.data[:] = np.round(m.data * 4) + 1.0  # small ints: exact in every mode
    return m


# items x users: 4,096 users give a hot prefix; 600 items give several
# column tiles once DEFAULT_TC is cut to 256
ITEMS = _int_matrix(600, 4096, 0.02, 21)
FIRST = np.arange(0, 600, 3)
SECOND = np.arange(1, 600, 3)  # disjoint from FIRST


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(compact, "MODE", "on")
    monkeypatch.setattr(splus, "TIMING", False)
    tsim.clear_caches()
    spans.clear()
    yield
    tsim.clear_caches()
    spans.clear()
    splus.last_laps.clear()  # a traced call leaves its laps for the next reader


def _several_groups(monkeypatch):
    """Narrow tiles and a budget below the reserve: one tile a group."""
    monkeypatch.setattr(compact, "DEFAULT_TC", 256)
    monkeypatch.setattr(executor, "hbm_budget_bytes", lambda device: 64 << 20)


def _call(m, targets, dtype):
    out = tsim.cosine(m, k=K, target_rows=targets, compute_dtype=dtype,
                      format_output="csr", **CPU)
    assert executor.last_route == "compact"
    assert executor.last_plan["compute_dtype"] == dtype
    return out


def _fresh(m, targets, dtype):
    tsim.clear_caches()
    return _call(m, targets, dtype)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.data.tobytes() == b.data.tobytes()


def _assert_oracle(got, m, targets):
    ref = py_cosine(m, K).tocsr()
    for r in targets:
        a = np.sort(got.data[got.indptr[r]: got.indptr[r + 1]])
        b = np.sort(ref.data[ref.indptr[r]: ref.indptr[r + 1]])
        np.testing.assert_allclose(a, b, rtol=1e-5)


def _m2_counts():
    info = tsim.cache_info()
    return info["misses"].get("compact_m2", 0), info["hits"].get("compact_m2", 0)


@pytest.mark.parametrize("groups", ["one", "several"])
@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_new_targets_reuse_matrix2_and_answer_as_a_fresh_call(monkeypatch, dtype, groups):
    if groups == "several":
        _several_groups(monkeypatch)
    first = _call(ITEMS, FIRST, dtype)
    second = _call(ITEMS, SECOND, dtype)
    assert (executor.last_plan["n_groups"] > 1) == (groups == "several")
    assert _m2_counts() == (1, 1)
    assert tsim.cache_info()["misses"]["compact_m1"] == 2
    _assert_same(second, _fresh(ITEMS, SECOND, dtype))
    _assert_same(first, _fresh(ITEMS, FIRST, dtype))
    _assert_oracle(second, ITEMS, SECOND)


def test_changed_values_miss_matrix2_and_match_the_reference(monkeypatch):
    _several_groups(monkeypatch)
    changed = ITEMS.copy()
    changed.data = changed.data[::-1].copy()  # the same shape and pattern, new values
    _call(ITEMS, FIRST, "int8")
    got = _call(changed, FIRST, "int8")
    assert _m2_counts() == (2, 0)
    _assert_same(got, _fresh(changed, FIRST, "int8"))
    _assert_oracle(got, changed, FIRST)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_device_ranking_equals_the_host_remap(dtype):
    """rank_rows on each group's slice of the staged rows equals the host
    remap the COO used to be staged with, sentinels included, and so does
    the dense table K5 builds from it."""
    pre = preprocess(ITEMS, ITEMS.T, k=K, target_rows=FIRST)
    U = ITEMS.shape[1]
    u_pad = staging.round_up(U, compact.KB)
    H = compact._hot_height(u_pad)
    cpu = torch.device("cpu")
    _buckets, table = compact.stage_panels(pre, dtype, u_pad=u_pad, device=cpu,
                                           densify=scatter.densify_tiles_plain,
                                           src=compact.stage_source(pre, cpu))
    m1_t = pre.m1[pre.targets]
    plan = compact.plan_compact(m1_t, pre.targets, None, None, None, u_pad=u_pad,
                                TM=compact.TM, H=H, uc_buckets=compact.cold_buckets(H, u_pad))
    rank_of = plan.rank_of
    assert table.dtype == torch.int32 and table.shape == (U + 1,)
    np.testing.assert_array_equal(table.numpy(), np.append(rank_of, u_pad))

    tc, n_tiles, G = 128, 6, 2
    (rows, cols, vals, _y), _map = compact.stage_tiles(pre, dtype, tc=tc, n_tiles=n_tiles,
                                                       u_pad=u_pad, device=cpu)
    host_rows = rows.numpy()
    assert (host_rows == u_pad).any() and (host_rows < U).any()
    assert ((host_rows < U) | (host_rows == u_pad)).all()
    cdt = staging.compute_cast(dtype)
    for t0 in range(0, n_tiles, G):
        got = compact.rank_rows(rows[t0:t0 + G], table)
        part = host_rows[t0:t0 + G]
        old = np.where(part >= U, u_pad, rank_of[np.minimum(part, U - 1)]).astype(np.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), old)
        kw = dict(u_pad=u_pad, tc=tc, cdt=cdt, densify=scatter.densify_tiles_plain)
        assert torch.equal(
            compact._build_d_group(got, cols[t0:t0 + G], vals[t0:t0 + G], **kw),
            compact._build_d_group(torch.from_numpy(old), cols[t0:t0 + G], vals[t0:t0 + G], **kw),
        )


def test_a_second_refresh_stages_the_panels_only():
    """With the span log on, a second call on the same ratings with other
    targets records stage spans of kind compact_m1 only: matrix1's entries
    on the device (compact_src) and matrix2's tiles hit, and each call's
    panels are one card build, which uploads O(targets) vectors alone."""
    splus.TIMING = True
    builds = []
    try:
        for targets in (FIRST, SECOND):
            _call(ITEMS, targets, "int8")
            builds.append(tsim.cache_info()["card_builds"].get("compact_m1", 0))
    finally:
        splus.TIMING = False
    calls: dict = {}
    for s in spans.log():
        calls.setdefault(s.call, []).append(s)
    first, second = calls.values()
    stages = [[s for s in tree if s.name == "stage"] for tree in (first, second)]
    kinds = [[s.attrs["kind"] for s in tree] for tree in stages]
    assert sorted(kinds[0]) == ["compact_m1", "compact_m2", "compact_src"]
    assert kinds[1] == ["compact_m1"]
    info = tsim.cache_info()
    assert info["misses"]["compact_src"] == 1 and info["hits"]["compact_src"] == 1
    assert builds == [1, 2]
    (src,) = [s for s in stages[0] if s.attrs["kind"] == "compact_src"]
    assert src.attrs["bytes"] == ITEMS.nnz * 8
    panels = stages[1][0]
    assert 0 < panels.attrs["upload_bytes"] < ITEMS.nnz * 8
