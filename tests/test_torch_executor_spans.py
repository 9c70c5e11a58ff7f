"""The executors' own spans (engine/spans.py): the symmetric executor's
``sweep`` and ``pack`` a pair, which sum to its ``last_plan["stages"]``;
the general executor's ``tile_group`` a column group and its ``pack``; the
compaction executor's ``pack``; the host work around them (``alloc``,
``fold``, ``selectors``, ``bf16_exact``). Results are bit-equal traced and untraced,
nothing is recorded untraced, and each span's profiler range lines up
with its own clock readings by one anchor, as the benchmark puts device
intervals on that clock (perfbench/pbcore/trace.py::DeviceProfiler). On
the CPU, the port alone."""

import statistics
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import perfbench_parts
import similaripy_tpu_torch as tsim
from similaripy_tpu_torch.engine import compact, executor, spans, splus, symmetric

torch.set_num_threads(2)

CPU = dict(device="cpu", verbose=False)
TRACE = perfbench_parts.pbcore("trace")


def _int_matrix(rows, cols, density, seed):
    rng = np.random.default_rng(seed)
    m = sp.random_array((rows, cols), density=density, format="csr",
                        dtype=np.float32, random_state=rng)
    m.data[:] = np.round(m.data * 4) + 1.0
    return m


ITEMS = _int_matrix(900, 70, 0.15, 11)  # items x users: a self-similar call
URM = _int_matrix(512, 600, 0.03, 3)  # users x items
MODEL = _int_matrix(600, 600, 0.05, 4)
# 4,096 users give the compaction route a hot prefix
URM_4K = _int_matrix(4096, 240, 0.02, 0)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(splus, "TIMING", False)
    # the symmetric route in 128-item tiles, one a group: 8 groups, 4 pairs
    monkeypatch.setattr(symmetric, "_plan", lambda C, U, nnz, dtype, budget, k_pad:
                        (128, 1, max(-(-U // 128) * 128, 128)))

    # the general route in 128-column tiles, one a group: 5 groups
    def groups(**kw):
        n = -(-kw["C"] // 128)
        return 128, n, 1, n

    monkeypatch.setattr(executor, "plan_fused_groups", groups)
    tsim.clear_caches()
    spans.clear()
    splus.last_laps.clear()
    yield
    tsim.clear_caches()
    spans.clear()
    splus.last_laps.clear()


def _symmetric():
    return tsim.cosine(ITEMS, k=17, **CPU)


def _general():
    return tsim.dot_product(URM, MODEL.T, k=10, target_rows=np.arange(0, 512, 3),
                            filter_cols=URM, **CPU)


def _compact(monkeypatch):
    monkeypatch.setattr(compact, "MODE", "on")
    return tsim.cosine(URM_4K.T, k=10, target_rows=np.arange(0, 240, 3), **CPU)


CALLS = {"symmetric": lambda mp: _symmetric(), "general": lambda mp: _general(),
         "compact": _compact}


def _traced(fn):
    splus.TIMING = True
    try:
        return fn()
    finally:
        splus.TIMING = False


def _tree():
    (call,) = {s.call for s in spans.log()}
    return [s for s in spans.log() if s.call == call]


def _parent_names(tree, name):
    by_id = {s.id: s for s in tree}
    return {by_id[s.parent].name for s in tree if s.name == name}


def test_a_symmetric_call_has_one_sweep_and_one_pack_a_pair():
    _traced(_symmetric)
    plan = executor.last_plan
    assert executor.last_route == "symmetric" and plan["pairs"] == 4
    tree = _tree()
    work = [s for s in tree if s.name in ("sweep", "pack")]
    assert [s.name for s in work] == ["sweep", "pack"] * plan["pairs"]
    assert _parent_names(tree, "sweep") == _parent_names(tree, "pack") == {"execute (wall)"}
    sweeps, packs = work[::2], work[1::2]
    # each pack starts after its sweep ends, and the next sweep after it
    assert all(s.end <= p.start for s, p in zip(sweeps, packs))
    assert all(p.end <= s.start for p, s in zip(packs, sweeps[1:]))
    assert all(not s.attrs for s in work)
    stages = plan["stages"]
    assert abs(sum(s.seconds for s in sweeps) - stages["sweep_s"]) < 1e-3
    assert abs(sum(p.seconds for p in packs) - stages["pack_s"]) < 1e-3


def test_a_general_call_has_one_tile_group_a_column_group_and_one_pack():
    _traced(_general)
    plan = executor.last_plan
    assert executor.last_route == "general" and plan["n_groups"] == 5
    tree = _tree()
    groups = [s for s in tree if s.name == "tile_group"]
    assert len(groups) == plan["n_groups"]
    assert all(a.end <= b.start for a, b in zip(groups, groups[1:]))
    # the compaction executor's `group` stays its own
    assert not [s for s in tree if s.name == "group"]
    (pack,) = [s for s in tree if s.name == "pack"]
    assert groups[-1].end <= pack.start
    assert _parent_names(tree, "tile_group") == _parent_names(tree, "pack") == {
        "execute (wall)"}
    assert all(not s.attrs for s in groups + [pack])


def test_a_compaction_call_has_one_pack(monkeypatch):
    _traced(lambda: _compact(monkeypatch))
    assert executor.last_route == "compact"
    tree = _tree()
    (pack,) = [s for s in tree if s.name == "pack"]
    assert _parent_names(tree, "pack") == {"execute (wall)"}
    assert not pack.attrs
    assert [g for g in tree if g.name == "group"][-1].end <= pack.start
    assert not [s for s in tree if s.name in ("sweep", "tile_group")]


def _one(tree, name, parent):
    (span,) = [s for s in tree if s.name == name]
    assert _parent_names(tree, name) == {parent}
    return span


def test_host_work_around_the_executors_work_has_spans_of_its_own():
    _traced(_symmetric)
    tree = _tree()
    _one(tree, "selectors", "preprocess")
    alloc = _one(tree, "alloc", "execute (wall)")
    assert alloc.end <= min(s.start for s in tree if s.name == "sweep")
    assert not [s for s in tree if s.name in ("fold", "bf16_exact")]
    spans.clear()
    _traced(_general)
    tree = _tree()
    _one(tree, "selectors", "preprocess")
    fold = _one(tree, "fold", "execute (wall)")
    assert fold.end <= min(s.start for s in tree if s.name == "tile_group")
    spans.clear()
    # a 'high' call checks its matrix for bf16 exactness once: a memo hit
    # records nothing
    for n_checks in (1, 0):
        _traced(lambda: tsim.rp3beta(ITEMS, alpha=1.0, beta=0.6, k=10, precision="high", **CPU))
        tree = _tree()
        checks = [s for s in tree if s.name == "bf16_exact"]
        assert len(checks) == n_checks
        assert _parent_names(tree, "bf16_exact") <= {"execute (wall)"}
        spans.clear()


@pytest.mark.parametrize("route", list(CALLS))
def test_results_are_bit_equal_traced_and_untraced(monkeypatch, route):
    off = CALLS[route](monkeypatch)
    assert spans.log() == [] and not spans.ACTIVE and splus.last_laps == {}
    tsim.clear_caches()
    on = _traced(lambda: CALLS[route](monkeypatch))
    assert "pack" in {s.name for s in spans.log()}
    for a, b in ((off.row, on.row), (off.col, on.col), (off.data, on.data)):
        np.testing.assert_array_equal(a, b)


def test_spans_line_up_with_their_profiler_ranges_by_one_anchor():
    """The benchmark puts the profiler's intervals on the spans' clock by
    one reading taken inside an anchor range. Every span's CPU-side range,
    moved by that one offset, starts and ends within 0.5 ms of the span's
    own readings in the median, which a shifted anchor would move; a single
    reading may lag by a preemption between it and its range's, so the
    largest residual is held only to 50 ms, which a range paired with
    another span's would exceed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    # a process's first record_function opens its range about 1 ms before
    # the code inside it runs (its lazy set-up), which would shift every
    # span by that much: that is the anchor's error, not the spans'
    with record_function("warm-up"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(TRACE.ANCHOR):
            anchor_host = time.perf_counter()
        _traced(_symmetric)
        _traced(_general)
    events = TRACE._kineto_events(prof)
    (anchor,) = [e for e in events if e[0] == TRACE.ANCHOR]
    offset = anchor_host - anchor[1]
    log = spans.log()
    names = {s.name for s in log}
    assert {"call", "sweep", "pack", "tile_group", "stage", "hash"} <= names
    residuals = []
    for name in names:
        mine = sorted((s for s in log if s.name == name), key=lambda s: (s.start, s.id))
        ranges = sorted((e for e in events if e[0] == name and not e[3]), key=lambda e: e[1])
        assert len(ranges) == len(mine), name
        for s, (_, start, end, _) in zip(mine, ranges):
            residuals += [abs(start + offset - s.start), abs(end + offset - s.end)]
    assert statistics.median(residuals) < 0.5e-3
    assert max(residuals) < 50e-3
