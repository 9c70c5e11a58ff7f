"""The compaction executor's spans and the root span's launch counters
(engine/spans.py): a traced compaction call records one ``group`` span per
column group under its ``execute (wall)`` lap, with the group's index,
columns, dense-table bytes and K3 launches; the root span's ``k3``,
``groups`` and ``epilogue`` match the plan on every route; with tracing
off nothing is recorded. On the CPU (the kernels' plain versions, whose
K3 calls count under "plain"), the port alone."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu_torch as tsim
from similaripy_tpu_torch.engine import compact, executor, spans, splus

torch.set_num_threads(2)

CPU = dict(device="cpu", verbose=False)


def _int_matrix(rows, cols, density, seed):
    rng = np.random.default_rng(seed)
    m = sp.random_array((rows, cols), density=density, format="csr",
                        dtype=np.float32, random_state=rng)
    m.data[:] = np.round(m.data * 4) + 1.0
    return m


# users x items: 4,096 users give the compaction route a hot prefix
URM = _int_matrix(4096, 600, 0.02, 3)
MODEL = _int_matrix(600, 600, 0.05, 4)
TARGETS = np.arange(0, 600, 2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(compact, "MODE", "on")
    monkeypatch.setattr(splus, "TIMING", False)
    tsim.clear_caches()
    spans.clear()
    splus.last_laps.clear()
    yield
    tsim.clear_caches()
    spans.clear()
    splus.last_laps.clear()


def _narrow(monkeypatch):
    """One tile a group: 512-column tiles (256 in float32), a starved
    budget; 600 items then take 2 groups in int8, 3 in float32."""
    monkeypatch.setattr(compact, "DEFAULT_TC", 512)
    monkeypatch.setattr(executor, "hbm_budget_bytes", lambda device: 64 << 20)


def _traced(fn):
    splus.TIMING = True
    try:
        return fn()
    finally:
        splus.TIMING = False


def _tree():
    (call,) = {s.call for s in spans.log()}
    return [s for s in spans.log() if s.call == call]


CALLS = {
    "splus_f32": lambda: tsim.s_plus(URM.T, target_rows=TARGETS, compute_dtype="float32", **CPU),
    "cosine_int8": lambda: tsim.cosine(URM.T, k=20, target_rows=TARGETS, **CPU),
}
EPILOGUE = {"splus_f32": ["l1", "l2"], "cosine_int8": ["l2"]}
NARROW_GROUPS = {"splus_f32": 3, "cosine_int8": 2}


@pytest.mark.parametrize("narrow", [False, True], ids=["one_group", "several_groups"])
@pytest.mark.parametrize("name", list(CALLS))
def test_a_compaction_call_records_one_group_span_a_group(monkeypatch, name, narrow):
    n_groups = NARROW_GROUPS[name] if narrow else 1
    if narrow:
        _narrow(monkeypatch)
    _traced(CALLS[name])
    plan = executor.last_plan
    assert executor.last_route == "compact" and plan["n_groups"] == n_groups
    tree = _tree()
    by_id = {s.id: s for s in tree}
    groups = [s for s in tree if s.name == "group"]
    assert [g.attrs["index"] for g in groups] == list(range(n_groups))
    n_panels = sum(n for _, n in plan["buckets"])
    item = 1 if plan["compute_dtype"] == "int8" else 4
    for g in groups:
        assert by_id[g.parent].name == "execute (wall)"
        assert g.attrs == {"index": g.attrs["index"], "cols": plan["cg"],
                           "table_bytes": plan["u_pad"] * plan["cg"] * item,
                           "panels": n_panels}
    assert all(a.end <= b.start for a, b in zip(groups, groups[1:]))
    root = tree[0]
    assert root.attrs["groups"] == n_groups
    # no card: every K3 call ran the plain version
    assert root.attrs["k3"] == {"plain": n_groups * n_panels}
    assert root.attrs["k2"] == {}
    assert root.attrs["epilogue"] == EPILOGUE[name]


OTHER_ROUTES = {
    "symmetric": (lambda: tsim.jaccard(URM.T, k=10, **CPU), ["l1"]),
    "general": (lambda: tsim.dot_product(URM, MODEL.T, k=10, target_rows=np.arange(64),
                                         filter_cols=URM, **CPU), []),
}


@pytest.mark.parametrize("route", list(OTHER_ROUTES))
def test_another_route_records_no_group_and_names_its_epilogue(route):
    fn, epilogue = OTHER_ROUTES[route]
    _traced(fn)
    assert executor.last_route == route
    tree = _tree()
    assert not [s for s in tree if s.name == "group"]
    root = tree[0]
    assert root.attrs["groups"] == 0 and root.attrs["k3"] == {}
    assert root.attrs["epilogue"] == epilogue


@pytest.mark.parametrize("name", list(CALLS))
def test_nothing_is_recorded_with_tracing_off(monkeypatch, name):
    _narrow(monkeypatch)
    CALLS[name]()
    assert executor.last_route == "compact"
    assert spans.log() == [] and not spans.ACTIVE
    assert splus.last_laps == {}


def test_a_traced_call_gives_the_same_result(monkeypatch):
    _narrow(monkeypatch)
    off = CALLS["splus_f32"]()
    tsim.clear_caches()
    on = _traced(CALLS["splus_f32"])
    for a, b in ((off.row, on.row), (off.col, on.col), (off.data, on.data)):
        np.testing.assert_array_equal(a, b)
