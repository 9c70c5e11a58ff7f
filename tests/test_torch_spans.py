"""The port's span log (engine/spans.py) behind splus.TIMING, the cache
counters of cache_info(), and the host path leaving the caller's matrices
as they were. The port alone: no JAX is needed."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu_torch as tsim
from similaripy_tpu_torch.engine import compact, executor, spans, splus
from similaripy_tpu_torch.engine.preprocess import build_column_selector
from similaripy_tpu_torch.ops.csr import ensure_csr_f32

CPU = dict(device="cpu", verbose=False)
LAPS = ["validate", "preprocess", "execute (wall)", "assembly"]


def _int_matrix(rows, cols, density, seed):
    rng = np.random.default_rng(seed)
    m = sp.random_array((rows, cols), density=density, format="csr",
                        dtype=np.float32, random_state=rng)
    m.data[:] = np.round(m.data * 4) + 1.0
    return m


# users x items: 4,096 users give the compaction route a hot prefix
URM = _int_matrix(4096, 240, 0.02, 0)
MODEL = _int_matrix(240, 240, 0.05, 1)
FILTER = _int_matrix(4096, 240, 0.01, 2)
USERS = np.arange(0, 4096, 16)


def _symmetric():
    return tsim.cosine(URM.T, k=10, **CPU)


def _compact():
    return tsim.cosine(URM.T, k=10, target_rows=np.arange(0, 240, 3), **CPU)


def _general():
    return tsim.dot_product(URM, MODEL.T, k=10, target_rows=USERS, filter_cols=FILTER, **CPU)


ROUTES = {"symmetric": _symmetric, "compact": _compact, "general": _general}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(compact, "MODE", "on")
    monkeypatch.setattr(splus, "TIMING", False)
    tsim.clear_caches()
    spans.clear()
    # a traced call of another test file on this worker leaves its laps
    splus.last_laps.clear()
    yield
    tsim.clear_caches()
    spans.clear()


def _traced(fn):
    splus.TIMING = True
    try:
        return fn()
    finally:
        splus.TIMING = False


def _calls():
    """{call id: [spans]} of the log, root first."""
    out: dict = {}
    for s in spans.log():
        out.setdefault(s.call, []).append(s)
    return out


def test_log_stays_empty_with_timing_off():
    for fn in ROUTES.values():
        fn()
    assert spans.log() == []
    assert not spans.ACTIVE
    assert spans.span("hash") is spans.OFF and spans.lap("validate") is None
    assert splus.last_laps == {}


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_call_records_one_root_and_nested_children(route):
    before = spans.call(True)
    with before:
        pass
    _traced(ROUTES[route])
    calls = _calls()
    assert sorted(calls) == [before.call, before.call + 1]  # a new id, one up
    tree = calls[before.call + 1]
    root = tree[0]
    assert root.name == "call" and root.parent is None
    assert root.attrs["route"] == route == executor.last_route
    assert root.attrs["targets"] == {"symmetric": 240, "compact": 80, "general": 256}[route]
    by_id = {s.id: s for s in tree}
    for s in tree[1:]:
        parent = by_id[s.parent]  # every child names its parent
        assert parent.start <= s.start <= s.end <= parent.end, (s.name, parent.name)
    # the four laps, contiguous children of the root
    laps = [s for s in tree if s.parent == root.id]
    assert [s.name for s in laps] == LAPS
    assert all(a.end == b.start for a, b in zip(laps, laps[1:]))
    names = {by_id[s.parent].name for s in tree if s.name == "coerce"}
    assert names == {"preprocess"}
    assert any(s.name == "hash" and s.attrs["bytes"] > 0 for s in tree)
    stages = [s for s in tree if s.name == "stage"]
    assert stages and all(s.attrs["bytes"] + s.attrs["host_bytes"] > 0 for s in stages)
    kinds = {s.attrs["kind"] for s in stages}
    assert kinds == {"symmetric": {"sym_coo", "sym_vecs"},
                     "compact": {"compact_src", "compact_m1", "compact_m2"},
                     "general": {"m1", "m2", "sel"}}[route]
    # a hash never lies inside a stage
    for st in stages:
        for h in (s for s in tree if s.name == "hash"):
            assert h.end <= st.start or h.start >= st.end


def test_a_self_similar_int8_call_runs_the_gate_once():
    """The int8 gate of m1 serves m1.T; the gate and the vectors are spans
    of their own under preprocess, and the coercion says where it ran and
    what it read."""
    _traced(_symmetric)
    (tree,) = _calls().values()
    by_id = {s.id: s for s in tree}
    assert executor.last_plan["compute_dtype"] == "int8"
    for name in ("gate", "norms", "coerce"):
        (one,) = [s for s in tree if s.name == name]
        assert by_id[one.parent].name == "preprocess"
    (coerce,) = [s for s in tree if s.name == "coerce"]
    # URM.T is a CSC: the call's device (the CPU here) coerces it
    assert coerce.attrs == {"where": "host",
                            "bytes": URM.data.nbytes + URM.indices.nbytes + URM.indptr.nbytes}
    # a hit of the preprocess cache runs neither again
    _traced(_symmetric)
    second = _calls()[tree[0].call + 1]
    assert [s.name for s in second if s.name in ("gate", "norms")] == []
    assert [s.name for s in second if s.name == "coerce"] == ["coerce"]


@pytest.mark.parametrize("route", list(ROUTES))
def test_last_laps_are_the_lap_spans(route):
    _traced(ROUTES[route])
    (tree,) = _calls().values()
    laps = [s for s in tree if s.parent == tree[0].id]
    assert list(splus.last_laps) == LAPS
    assert list(splus.last_laps.values()) == [s.end - s.start for s in laps]


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_repeated_call_stages_nothing_and_counts_its_hits(route):
    _traced(ROUTES[route])
    _traced(ROUTES[route])
    first, second = _calls().values()
    staged = {s.attrs["kind"] for s in first if s.name == "stage"} - {"sym_vecs"}
    assert staged and not [s for s in second if s.name == "stage"]
    info = tsim.cache_info()
    for kind in staged:
        assert info["misses"][kind] == 1 and info["hits"][kind] == 1
    assert info["prep_misses"] >= 1 and info["prep_hits"] >= 1
    tsim.clear_caches()
    info = tsim.cache_info()
    assert info["hits"] == {} and info["misses"] == {}
    assert info["prep_hits"] == info["prep_misses"] == 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_results_are_bit_equal_with_tracing_on_and_off(route):
    off = ROUTES[route]()
    tsim.clear_caches()
    on = _traced(ROUTES[route])
    for a, b in ((off.row, on.row), (off.col, on.col), (off.data, on.data)):
        np.testing.assert_array_equal(a, b)


def _rp3beta_high():
    return tsim.rp3beta(URM.T, alpha=1.0, beta=0.6, k=10, precision="high", **CPU)


def _p3alpha_general():
    return tsim.p3alpha(URM.T, URM, alpha=0.8, k=10, **CPU)


TRANSFORMED = {"rp3beta_high": _rp3beta_high, "p3alpha_general": _p3alpha_general}


@pytest.mark.parametrize("name", list(TRANSFORMED))
def test_a_transformed_call_has_one_root_and_its_transform_first(name):
    _traced(TRANSFORMED[name])
    (tree,) = _calls().values()
    root = tree[0]
    assert [s.name for s in tree if s.parent is None] == ["call"]
    children = [s for s in tree if s.parent == root.id]
    assert [s.name for s in children] == ["transform"] + LAPS
    transform = children[0]
    assert root.start <= transform.start <= transform.end <= children[1].start
    csr_bytes = URM.data.nbytes + URM.indices.nbytes + URM.indptr.nbytes
    n_inputs = 1 if name == "rp3beta_high" else 2
    # the value-symmetric transform runs on the call's device (the CPU here,
    # so "host"): URM.T's arrays and the users' column factors went up
    sent = csr_bytes + 8 * URM.shape[0] if name == "rp3beta_high" else 0
    assert transform.attrs == {"nnz": n_inputs * URM.nnz, "bytes": n_inputs * csr_bytes,
                               "where": "host", "upload_bytes": sent}
    assert root.attrs["route"] == executor.last_route
    # matrix2 given: a route of two matrices (the fixture turns compaction on)
    assert root.attrs["route"] == ("symmetric" if name == "rp3beta_high" else "compact")
    # the laps read as for any call, the transform not among them
    laps = children[1:]
    assert list(splus.last_laps) == LAPS
    assert list(splus.last_laps.values()) == [s.end - s.start for s in laps]


def test_a_high_call_splits_its_coo_inside_the_stage():
    _traced(_rp3beta_high)
    (tree,) = _calls().values()
    by_id = {s.id: s for s in tree}
    splits = [s for s in tree if s.name == "split"]
    assert splits and all(by_id[s.parent].name == "stage" for s in splits)
    assert {by_id[s.parent].attrs["kind"] for s in splits} == {"sym_coo"}
    # the hi and lo halves of every entry of the staged tile COO (padding included)
    assert all(s.attrs["entries"] > 0 and s.attrs["entries"] % 2 == 0 for s in splits)
    assert executor.last_plan["f32x3"] == "both" and executor.last_plan["asym"]
    assert tree[0].attrs["k2"] == {} and tree[0].attrs["k2_asym"] == 0  # no card


@pytest.mark.parametrize("name", list(TRANSFORMED))
def test_a_transformed_call_records_nothing_with_timing_off(name):
    TRANSFORMED[name]()
    assert spans.log() == [] and not spans.ACTIVE
    assert splus.last_laps == {}


@pytest.mark.parametrize("name", list(TRANSFORMED))
def test_a_transformed_call_gives_the_same_result_traced(name):
    off = TRANSFORMED[name]()
    tsim.clear_caches()
    on = _traced(TRANSFORMED[name])
    for a, b in ((off.row, on.row), (off.col, on.col), (off.data, on.data)):
        np.testing.assert_array_equal(a, b)


def test_a_failed_transformed_call_closes_its_root():
    with pytest.raises(ValueError):
        _traced(lambda: tsim.rp3beta(URM.T, k=0, **CPU))
    assert not spans.ACTIVE
    (tree,) = _calls().values()
    assert [s.name for s in tree] == ["call", "transform", "validate"]
    assert all(s.end is not None for s in tree)


def test_spans_open_cpu_side_profiler_ranges_while_it_records(tmp_path):
    import json

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _traced(_compact)
    names = {"call", "validate", "preprocess", "execute (wall)", "assembly", "coerce", "hash",
             "stage"}
    assert names <= {e.name for e in prof.events()}
    # plain CPU ops, not user annotations (which a card's trace would mirror
    # as GPU-side ranges over the kernels they launched)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert {e.get("cat") for e in events if e.get("name") in names} == {"cpu_op"}


def test_a_failed_call_closes_its_spans():
    with pytest.raises(ValueError):
        _traced(lambda: tsim.cosine(URM.T, k=0, **CPU))
    assert not spans.ACTIVE
    (tree,) = _calls().values()
    assert all(s.end is not None for s in tree)
    assert [s.name for s in tree] == ["call", "validate"]


def test_the_log_keeps_the_latest_calls():
    for _ in range(spans.CALLS_KEPT + 3):
        with spans.call(True):
            spans.lap("validate")
            spans.lap(None)
    roots = [s for s in spans.log() if s.parent is None]
    assert len(roots) == spans.CALLS_KEPT
    ids = [s.call for s in roots]
    assert ids == list(range(ids[0], ids[0] + spans.CALLS_KEPT))


def test_oom_retries_are_counted(monkeypatch):
    real = executor._execute_impl
    failed = []

    def once(*args, **kwargs):
        if not failed:
            failed.append(1)
            raise torch.cuda.OutOfMemoryError("test")
        return real(*args, **kwargs)

    monkeypatch.setattr(executor, "_execute_impl", once)
    _general()
    assert tsim.cache_info()["oom_retries"] == 1
    tsim.clear_caches()
    assert tsim.cache_info()["oom_retries"] == 0


def _messy():
    """A float32 CSR with an explicit zero and unsorted indices."""
    return sp.csr_array((np.array([0.0, 1.0, 2.0, 3.0], np.float32), np.array([1, 0, 2, 0]),
                         np.array([0, 2, 4])), shape=(2, 3))


def _arrays(m):
    return [a.copy() for a in (m.data, m.indices, m.indptr)]


def _unchanged(m, saved):
    for a, b in zip((m.data, m.indices, m.indptr), saved):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", [sp.csr_array, sp.csr_matrix])
def test_host_path_leaves_the_callers_matrix_as_it_was(fmt):
    m = fmt(_messy())
    saved = _arrays(m)
    out = ensure_csr_f32(m)
    _unchanged(m, saved)
    assert out.nnz == 3 and np.array_equal(out.toarray(), m.toarray())
    sel = build_column_selector(m).matrix
    _unchanged(m, saved)
    assert sel.nnz == 3 and sel.has_sorted_indices
    assert np.array_equal(sel.toarray(), m.toarray())
    # a clean CSR is used as it is, without a copy
    clean = ensure_csr_f32(out)
    assert clean.data is out.data or np.shares_memory(clean.data, out.data)


def test_a_call_leaves_its_inputs_and_gives_the_clean_result():
    rng = np.random.default_rng(5)
    urm = _int_matrix(60, 40, 0.2, 5).tocsr()
    # explicit zeros and unsorted indices in both the matrix and the filter
    urm.data[::7] = 0.0
    perm = [rng.permutation(np.arange(a, b)) for a, b in zip(urm.indptr[:-1], urm.indptr[1:])]
    messy = sp.csr_array((urm.data[np.concatenate(perm)], urm.indices[np.concatenate(perm)],
                          urm.indptr.copy()), shape=urm.shape)
    assert not messy.has_sorted_indices
    saved = _arrays(messy)
    got = tsim.dot_product(messy, MODEL[:40, :40].T, k=5, filter_cols=messy, **CPU)
    _unchanged(messy, saved)
    clean = messy.copy()
    clean.eliminate_zeros()
    clean.sort_indices()
    tsim.clear_caches()
    want = tsim.dot_product(clean, MODEL[:40, :40].T, k=5, filter_cols=clean, **CPU)
    assert (got != want).nnz == 0
