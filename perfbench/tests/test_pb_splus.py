"""The cell ml32m-bm25-splus.refresh-8k at a tiny size on the CPU: its
reference (reference/item_splus.py) equals a dense NumPy S-Plus over BM25
weights, refuses what it does not compute and loads without the port; the
cell is found by its files; a run of the port through the compaction route
is correct and the TF32 control is not; a traced rehearsal reads the
compaction executor's spans, its ``group`` spans among them
(compact_groups)."""

import io
import json
import textwrap
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
from conftest import TINY
from test_pb_imports import load_blocked

import calibrate
import rehearse
from pbcore import compare, data, guard, manifest, spanlog, trace

CELL = "ml32m-bm25-splus.refresh-8k"
CONFIG = "ml32m-bm25-splus"
NEW_METRICS = ("compact_exec_s.splus", "stage_s.splus", "host_s.splus",
               "device_idle_pct.splus", "k3_roofline.splus", "compact_groups.splus",
               "hash_s.splus", "coerce_s.splus")


@pytest.fixture
def compaction(monkeypatch):
    """The compaction route on the CPU, as ``auto`` takes it on a card."""
    from similaripy_tpu_torch.engine import compact

    import similaripy_tpu_torch as sim

    monkeypatch.setattr(compact, "MODE", "on")
    yield
    sim.clear_caches()


def inputs():
    cfg = manifest.config(CONFIG)
    return cfg, data.load_pattern(cfg["pattern"], TINY["users"], TINY["items"])


def dense_splus(r, k, l1=0.5, l2=0.5, t1=1.0, t2=1.0, c1=0.5, c2=0.5):
    """S-Plus over the BM25 weights of the dense users x items ratings `r`,
    every item against every item, in NumPy float64: per row the sorted
    top-k (ids, values) of the candidates, and the value matrix."""
    n_users = r.shape[0]
    rated = r != 0
    df = rated.sum(axis=0)
    idf = np.where(df != 0, np.log((n_users - df + 0.5) / (df + 0.5)), 0.0)
    doc_len = r.sum(axis=1)
    norm = 0.25 + 0.75 * doc_len / doc_len.mean()
    w = np.where(rated, idf[None, :] * r * 2.2 / (r + 1.2 * norm[:, None]), 0.0)
    xy = w.T @ w
    sq = np.diag(xy).copy()
    den = (l1 * (t1 * (sq[:, None] - xy) + t2 * (sq[None, :] - xy) + xy)
           + l2 * sq[:, None] ** c1 * sq[None, :] ** c2)
    val = np.where(den != 0, xy / np.where(den != 0, den, 1.0), 0.0)
    val = np.where((xy != 0) & (val >= 0), val, -np.inf)
    tops = []
    for row in val:
        order = np.argsort(-row, kind="stable")[:k]
        order = order[np.isfinite(row[order])]
        tops.append((order, row[order]))
    return tops, val


def test_item_splus_equals_a_dense_splus():
    rng = np.random.default_rng(7)
    users, items = 300, 60
    r = np.where(rng.random((users, items)) < 0.15,
                 rng.integers(1, 11, (users, items)) / 2, 0.0)
    r[rng.random(users) < 0.8, 0] = 3.0  # item 0: rated by most users, a negative idf
    pattern = sp.csr_array(r)
    cfg = manifest.config(CONFIG)
    call = {**cfg["build"], "kwargs": {**cfg["build"]["kwargs"], "k": 10}}
    ref = manifest.reference("item_splus").Reference(pattern, call, cfg, "cpu")
    rows = np.arange(items)
    got = ref.rows(pattern.data, rows)
    tops, val = dense_splus(r, 10)
    assert len(tops[0][0]) < 10  # the negative-idf item has few candidates
    for i in rows:
        ids, vals = tops[i]
        np.testing.assert_allclose(got.vals[i], vals, rtol=1e-12, atol=0)
        assert set(got.ids[i]) == set(ids)
        np.testing.assert_allclose(got.at(i, np.arange(items)), val[i], rtol=1e-12, atol=0)


@pytest.mark.parametrize("keyword", ["l3", "pop1", "alpha", "beta1", "shrink", "shrink_type",
                                     "threshold", "binary", "target_cols", "filter_cols"])
def test_item_splus_refuses_a_keyword_it_does_not_compute(keyword):
    cfg, pattern = inputs()
    call = {**cfg["build"], "kwargs": {**cfg["build"]["kwargs"], keyword: 1}}
    with pytest.raises(ValueError, match=keyword):
        manifest.reference("item_splus").Reference(pattern, call, cfg, "cpu")


@pytest.mark.parametrize("weighting", [None, {"function": "bm25plus", "kwargs": {}},
                                       {"function": "bm25", "kwargs": {"k1": 2.0}}],
                         ids=["none", "bm25plus", "bm25_k1"])
def test_item_splus_refuses_another_weighting(weighting):
    cfg, pattern = inputs()
    with pytest.raises(ValueError):
        manifest.reference("item_splus").Reference(pattern, cfg["build"],
                                                   {**cfg, "weighting": weighting}, "cpu")


def test_item_splus_refuses_another_function():
    cfg, pattern = inputs()
    with pytest.raises(ValueError, match="cosine"):
        manifest.reference("item_splus").Reference(pattern, {**cfg["build"], "function": "cosine"},
                                                   cfg, "cpu")


def test_item_splus_takes_its_parameters_from_the_call():
    cfg, pattern = inputs()
    values = manifest.part("values", "half_stars").Values(5, pattern.nnz, "cpu")(0)
    module = manifest.reference("item_splus")
    rows = [0, 1, 2]

    def top(**kw):
        call = {**cfg["build"], "kwargs": {**cfg["build"]["kwargs"], **kw}}
        return module.Reference(pattern, call, cfg, "cpu").rows(values, rows).vals

    base = top()
    for other in (top(l1=0.2), top(l2=0.9), top(t1=0.5), top(t2=2.0), top(c1=0.3),
                  top(c2=0.7), top(k=7)):
        assert any(a.shape != b.shape or not np.allclose(a, b) for a, b in zip(base, other))


def test_item_splus_loads_without_the_port():
    blocked = set(guard.FORBIDDEN) | {"similaripy_tpu_torch"}
    extra = """
        from pbcore import manifest
        manifest.reference("item_splus")
    """
    r = load_blocked(blocked, ["reference"], textwrap.indent(textwrap.dedent(extra), "        "))
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout


def test_the_cell_is_found_by_its_files():
    bench = manifest.benchmark()
    entry = manifest.cell_entry(CELL, bench)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (CONFIG, "refresh-8k", 1)
    wl = manifest.workload(CELL)
    assert wl["kind"] == "refresh_weighted" and wl["rate_metric"] == "refresh_items_per_s"
    assert wl["params"] == {"targets": 8192, "check_rows": 512}
    cfg = manifest.config(wl["config"])
    assert cfg["build"]["function"] == "s_plus"
    assert cfg["weighting"] == {"function": "bm25", "kwargs": {}}
    assert cfg["reference"]["build"] == {"module": "item_splus", "control": "tf32"}
    assert (cfg["users"], cfg["items"], cfg["build"]["kwargs"]["k"]) == (200948, 84432, 100)
    per_layer = {m["name"] for m in manifest.metrics_of(CELL, bench, "per_layer")}
    assert per_layer == set(NEW_METRICS)
    e2e = {m["name"] for m in manifest.metrics_of(CELL, bench, "end_to_end")}
    assert e2e == {"refresh_items_per_s", "setup_s"}


def test_the_traffic_passes_the_weighted_matrix_every_call(compaction):
    from pbcore.deploy import Deployment

    dep = Deployment(CONFIG, "cpu", 2**31 + 5, TINY)
    built = []
    dep.build = lambda ratings, targets=None: built.append((ratings, targets))
    t = manifest.traffic_kind("refresh_weighted").Traffic(dep, {"targets": 50, "check_rows": 8},
                                                          2**31 + 5)
    t.setup()
    t.issue(0)
    t.issue(1)
    raw = dep.ratings(t.values)
    assert len(built) == 3 and all(m is built[0][0] for m, _ in built)
    weighted = built[0][0]
    assert weighted.shape == raw.shape and weighted.nnz == raw.nnz
    assert not np.allclose(weighted.data, raw.data)
    assert [tg.shape[0] for _, tg in built] == [50, 50, 50]
    np.testing.assert_array_equal(built[1][1], t.batch(0))


def test_a_run_of_the_port_is_correct_and_the_control_is_not(compaction):
    from similaripy_tpu_torch.engine import executor

    r = calibrate.readings(CELL, 2**31 + 77, 0.5, True, device="cpu", scale=TINY,
                           params={"targets": 300})
    assert executor.last_route == "compact"
    limits = manifest.workload(CELL)["limits"]
    assert r["correct"] and compare.judge(r["program"], limits)[0], r
    assert not compare.judge(r["control"], limits)[0], r["control"]


def test_a_traced_rehearsal_reads_the_compaction_spans(compaction):
    out = io.StringIO()
    with redirect_stdout(out):
        rehearse.main(["--workload", CELL, "--param", "targets=300", "--trace", "1",
                       "--seconds", "1"])
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1])
    assert result["correct"], result["checks"]
    assert set(json.loads(lines[-2])["routes"]) == {"compact"}
    metrics = result["metrics"]
    for name in ("compact_exec_s.splus", "stage_s.splus", "host_s.splus", "hash_s.splus",
                 "coerce_s.splus"):
        assert metrics[name]["value"] > 0, name
    assert metrics["compact_groups.splus"]["value"] == 1
    # a K3 roofline and an idle share come from a card's trace only
    assert "k3_roofline.splus" not in metrics and "device_idle_pct.splus" not in metrics


def _span(name, call, id, parent, start, end):
    return SimpleNamespace(name=name, call=call, id=id, parent=parent, start=start, end=end,
                           attrs={})


def test_compact_groups_counts_the_window_calls_groups(monkeypatch):
    log = [_span("call", 1, 0, None, 5.0, 9.0), _span("group", 1, 1, 0, 6.0, 7.0),
           _span("call", 2, 0, None, 10.0, 14.0), _span("group", 2, 1, 0, 11.0, 12.0),
           _span("group", 2, 2, 0, 12.0, 13.0),
           _span("call", 3, 0, None, 15.0, 19.0), _span("group", 3, 1, 0, 16.0, 17.0),
           _span("call", 4, 0, None, 21.0, 22.0), _span("group", 4, 1, 0, 21.0, 22.0)]
    monkeypatch.setattr(spanlog, "program_spans", lambda: log)
    window = trace.TraceData([], 10.0, 20.0)
    assert manifest.metric_reader("compact_groups.splus").read(window) == pytest.approx(1.5)


def test_a_port_without_the_group_span_gives_nothing(monkeypatch):
    # the parent program of this metric records no group span
    log = [_span("call", 1, 0, None, 11.0, 12.0), _span("stage", 1, 1, 0, 11.0, 11.5)]
    monkeypatch.setattr(spanlog, "program_spans", lambda: log)
    window = trace.TraceData([], 10.0, 20.0)
    assert manifest.metric_reader("compact_groups.splus").read(window) is None
