"""BENCHMARK.json against the contract's names and units, and every name in
it against the files the harness finds by that name."""

import json
import re

import pytest

from pbcore import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_and_unit():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert ONE_LINE.match(entry[key]), (entry["name"], key)
    assert len(set(n for s in ("configs",) for n in [e["name"] for e in BENCH[s]])) == len(BENCH["configs"])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(w["name"], BENCH, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(w["name"], BENCH, "per_layer")


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            e2e = [e["name"] for e in manifest.metrics_of(cell, BENCH, "end_to_end")]
            assert m["moves"] in e2e, (m["name"], cell)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(entry):
    wl = manifest.workload(entry["name"])
    assert (wl["config"], wl["traffic"]) == (entry["config"], entry["traffic"])
    assert (manifest.BENCH_DIR / "traffic" / f"{wl['kind']}.py").exists()
    e2e = [m["name"] for m in manifest.metrics_of(entry["name"], BENCH, "end_to_end")]
    assert wl["rate_metric"] in e2e
    assert set(wl["limits"]) == {"count_off", "bad_ids", "value_err", "topk_gap"}
    assert wl["limits"]["count_off"] == 0 and wl["limits"]["bad_ids"] == 0


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_has_its_file_and_references(entry):
    cfg = json.loads((manifest.REPO / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for ref in cfg["reference"].values():
        assert (manifest.BENCH_DIR / "reference" / f"{ref['module']}.py").exists()


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(entry):
    assert callable(manifest.metric_reader(entry["name"]).read)


def test_workload_pairs_are_unique_and_four_chip_cells_are_few():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


def test_the_whole_check_fits_its_time_with_the_full_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_each_cut_of_a_config_is_a_key_of_its_file_with_its_reason(entry):
    cfg = json.loads((manifest.REPO / entry["file"]).read_text())
    assert set(cfg["reduced"]) <= set(cfg) and set(cfg["reduced"]) == set(cfg["reduced_why"])
