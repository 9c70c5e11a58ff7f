"""Every per-layer metric, read from a recorded trace (trace_fixture.json:
two full-build calls of 5 s, the card busy 11.5-14.25 and 16.5-19.5 of the
window 10-20, and one K2 record before the window)."""

import json
from pathlib import Path

import pytest

from pbcore import manifest, trace
from pbcore.window import Call

FIXTURE = Path(__file__).with_name("trace_fixture.json")


@pytest.fixture
def recorded():
    f = json.loads(FIXTURE.read_text())
    calls = [Call(c["index"], c["t_issue"], c["t_done"], c["rows"], None, c["info"])
             for c in f["calls"]]
    return trace.TraceData(calls, f["t_start"], f["t_end"],
                           [tuple(d) for d in f["device"]], f["launches"])


def read(name, data):
    return manifest.metric_reader(name).read(data)


def test_host_laps_are_the_mean_of_validate_preprocess_assembly(recorded):
    assert read("host_s.build", recorded) == pytest.approx((2.0 + 1.5) / 2)
    assert read("host_s.refresh", recorded) == pytest.approx(1.75)
    assert read("host_s.score", recorded) == pytest.approx(1.75)


def test_executor_spans_follow_the_route(recorded):
    assert read("sym_sweep_s.build", recorded) == pytest.approx(3.0)
    # no call took the compaction or the general route: nothing to read
    assert read("compact_exec_s.refresh", recorded) is None
    assert read("grouped_exec_s.score", recorded) is None


def test_idle_share_is_from_the_union_of_device_intervals(recorded):
    busy = (14.25 - 11.5) + (19.5 - 16.5)
    for suffix in ("build", "refresh", "score"):
        assert read(f"device_idle_pct.{suffix}", recorded) == pytest.approx(100 * (1 - busy / 10))


def test_k2_roofline_counts_its_launches_and_kernels_in_the_window(recorded):
    # least 1.0 + 0.5 s over the K2 kernels' 2.0 + 0.5 + 2.0 s in the window
    assert read("k2_roofline.build", recorded) == pytest.approx(100 * 1.5 / 4.5)
    assert read("k1_roofline.score", recorded) is None
    assert read("k3_roofline.refresh", recorded) is None


def test_k1_and_k3_in_one_window_cannot_be_told_apart(recorded):
    recorded.launches += [{"kernel": "K1", "t": 12.0, "least_s": 0.1},
                          {"kernel": "K3", "t": 13.0, "least_s": 0.1}]
    assert read("k1_roofline.score", recorded) is None
    assert read("k3_roofline.refresh", recorded) is None


def test_breakdown_names_kernels_and_the_lap_of_each_gap(recorded):
    b = recorded.breakdown()
    names = [n for n, _ in b["device_ops"]]
    assert names[0].startswith("void (anonymous namespace)::sym_s8_kernel")
    assert b["device_ops"][0][1] == pytest.approx(4.0)
    gaps = b["idle_gaps"]
    assert gaps[0] == ["preprocess", pytest.approx(2.25)]  # 14.25-16.5: call 1's laps
    assert gaps[1] == ["preprocess", pytest.approx(1.5)]  # 10-11.5: call 0, 10.5-11.5
    assert gaps[2] == ["execute (wall)", pytest.approx(0.5)]  # 19.5-20
    assert len(gaps) == 3


def test_the_clock_anchor_puts_device_events_on_the_host_clock():
    class Prof:
        pass

    p = trace.DeviceProfiler()
    p._anchor_host = 1000.0
    events = [(trace.ANCHOR, 5.0, 5.1, False), ("k", 6.0, 6.5, True),
              ("spin_kernel", 4.0, 4.5, True)]
    trace._kineto_events, saved = (lambda prof: events), trace._kineto_events
    try:
        assert p.intervals() == [("k", 1001.0, 1001.5)]
    finally:
        trace._kineto_events = saved


def test_a_metric_is_read_by_the_reader_of_its_family(recorded):
    # a later cell's metric of a known family needs no file of its own
    assert read("host_s.some-new-cell", recorded) == read("host_s.build", recorded)
    assert manifest.metric_reader("k2_roofline.build").__file__.endswith("k2_roofline.py")
