"""The cell ml32m-rp3beta-high.full-build at a tiny size on the CPU: its
reference (reference/item_rp3beta.py) refuses what it does not compute and
loads without the port, the cell is found by its files, a run of the port
is correct and the TF32 control is not, and a traced rehearsal reads the
port's transform and split spans (transform_s, split_s)."""

import json
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
from conftest import TINY
from test_pb_imports import load_blocked

import calibrate
from pbcore import compare, data, guard, manifest, spanlog, trace

CELL = "ml32m-rp3beta-high.full-build"
CONFIG = "ml32m-rp3beta-high"


def inputs():
    cfg = manifest.config(CONFIG)
    return cfg, data.load_pattern(cfg["pattern"], TINY["users"], TINY["items"])


@pytest.mark.parametrize("keyword", ["shrink", "threshold", "binary", "shrink_type"])
def test_item_rp3beta_refuses_a_keyword_it_does_not_compute(keyword):
    cfg, pattern = inputs()
    call = {**cfg["build"], "kwargs": {**cfg["build"]["kwargs"], keyword: 1}}
    with pytest.raises(ValueError, match=keyword):
        manifest.reference("item_rp3beta").Reference(pattern, call, cfg, "cpu")


@pytest.mark.parametrize("function", ["p3alpha", "cosine"])
def test_item_rp3beta_refuses_another_function(function):
    cfg, pattern = inputs()
    call = {**cfg["build"], "function": function}
    with pytest.raises(ValueError, match=function):
        manifest.reference("item_rp3beta").Reference(pattern, call, cfg, "cpu")


def test_item_rp3beta_takes_alpha_and_beta_from_the_call():
    cfg, pattern = inputs()
    values = manifest.part("values", "half_stars").Values(5, pattern.nnz, "cpu")(0)
    module = manifest.reference("item_rp3beta")
    rows = [0, 1, 2]

    def top(**kw):
        call = {**cfg["build"], "kwargs": {**cfg["build"]["kwargs"], **kw}}
        return module.Reference(pattern, call, cfg, "cpu").rows(values, rows).vals

    base = top()
    for other in (top(alpha=0.5), top(beta=0.0), top(k=7)):
        assert any(a.shape != b.shape or not np.allclose(a, b) for a, b in zip(base, other))


def test_item_rp3beta_loads_without_the_port():
    blocked = set(guard.FORBIDDEN) | {"similaripy_tpu_torch"}
    extra = """
        from pbcore import manifest
        manifest.reference("item_rp3beta")
    """
    r = load_blocked(blocked, ["reference"], textwrap.indent(textwrap.dedent(extra), "        "))
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout


def test_the_cell_is_found_by_its_files():
    bench = manifest.benchmark()
    entry = manifest.cell_entry(CELL, bench)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (CONFIG, "full-build", 1)
    wl = manifest.workload(CELL)
    assert wl["kind"] == "full_build" and wl["rate_metric"] == "build_items_per_s"
    cfg = manifest.config(wl["config"])
    assert cfg["build"]["function"] == "rp3beta"
    assert cfg["build"]["kwargs"]["precision"] == "high"
    assert cfg["reference"]["build"] == {"module": "item_rp3beta", "control": "tf32"}
    per_layer = {m["name"] for m in manifest.metrics_of(CELL, bench, "per_layer")}
    assert per_layer == {f"{f}.rp3" for f in ("host_s", "coerce_s", "hash_s", "stage_s",
                                               "sym_sweep_s", "k2_roofline", "device_idle_pct",
                                               "transform_s", "split_s")}


def test_a_run_of_the_port_is_correct_and_the_control_is_not():
    r = calibrate.readings(CELL, 2**31 + 99, 0.5, True, device="cpu", scale=TINY)
    limits = manifest.workload(CELL)["limits"]
    assert r["correct"] and compare.judge(r["program"], limits)[0], r
    assert not compare.judge(r["control"], limits)[0], r["control"]


def test_a_traced_rehearsal_reads_the_transform_and_split_spans():
    r = subprocess.run([sys.executable, str(manifest.BENCH_DIR / "rehearse.py"), "--workload",
                        CELL, "--trace", "1", "--seconds", "1"], capture_output=True, text=True,
                       cwd=manifest.REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in ("transform_s.rp3", "split_s.rp3", "stage_s.rp3", "sym_sweep_s.rp3"):
        assert metrics[name]["value"] > 0, name
    # a K2 roofline and an idle share come from a card's trace only
    assert "k2_roofline.rp3" not in metrics and "device_idle_pct.rp3" not in metrics


def _span(name, call, id, parent, start, end):
    return SimpleNamespace(name=name, call=call, id=id, parent=parent, start=start, end=end,
                           attrs={})


def test_the_readers_take_the_window_calls_spans(monkeypatch):
    log = [_span("call", 1, 0, None, 5.0, 9.0), _span("transform", 1, 1, 0, 5.0, 7.0),
           _span("call", 2, 0, None, 10.0, 14.0), _span("transform", 2, 1, 0, 10.0, 11.0),
           _span("stage", 2, 2, 0, 12.0, 13.5), _span("split", 2, 3, 2, 12.5, 13.0),
           _span("call", 3, 0, None, 15.0, 19.0), _span("transform", 3, 1, 0, 15.0, 16.5)]
    monkeypatch.setattr(spanlog, "program_spans", lambda: log)
    window = trace.TraceData([], 10.0, 20.0)
    assert manifest.metric_reader("transform_s.rp3").read(window) == pytest.approx(1.25)
    # the third call split nothing and counts as 0
    assert manifest.metric_reader("split_s.rp3").read(window) == pytest.approx(0.25)
    monkeypatch.setattr(spanlog, "program_spans", lambda: [s for s in log if s.name != "split"])
    assert manifest.metric_reader("split_s.rp3").read(window) is None


def test_a_port_without_the_spans_gives_nothing(monkeypatch):
    # the parent program of these metrics records no transform or split span
    monkeypatch.setattr(spanlog, "program_spans", lambda: [])
    window = trace.TraceData([], 10.0, 20.0)
    for family in ("transform_s", "split_s"):
        assert manifest.metric_reader(f"{family}.rp3").read(window) is None
