"""The readers of the port's spans (hash_s, coerce_s, stage_s) on a
hand-made span log and the trace fixture's window (10-20)."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from pbcore import manifest, spanlog, trace

FIXTURE = Path(__file__).with_name("trace_fixture.json")
FAMILIES = ("hash_s", "coerce_s", "stage_s")
CELLS = ("build", "refresh", "score")


def _span(name, call, id, parent, start, end):
    return SimpleNamespace(name=name, call=call, id=id, parent=parent, start=start, end=end,
                           attrs={})


def _call(call, start, children):
    """A root `call` from `start` to the last child's end, its children under it."""
    end = max([start] + [e for _, _, e in children])
    return [_span("call", call, 0, None, start, end)] + [
        _span(name, call, i + 1, 0, s, e) for i, (name, s, e) in enumerate(children)]


LOG = (
    # before the window: left out
    _call(1, 8.0, [("hash", 8.1, 9.1), ("stage", 9.1, 9.9)])
    # in the window
    + _call(2, 10.0, [("coerce", 10.1, 10.4), ("hash", 10.4, 10.6), ("hash", 11.0, 11.2),
                      ("stage", 11.2, 12.2)])
    + _call(3, 15.0, [("coerce", 15.1, 15.3), ("hash", 15.3, 15.5)])  # hits every cache
    # after the window: left out
    + _call(4, 20.5, [("hash", 20.6, 22.6), ("stage", 22.6, 25.0)])
)


@pytest.fixture
def window():
    f = json.loads(FIXTURE.read_text())
    return trace.TraceData([], f["t_start"], f["t_end"])


def read(name, data):
    return manifest.metric_reader(name).read(data)


def test_each_family_is_the_mean_a_call_of_the_window(monkeypatch, window):
    monkeypatch.setattr(spanlog, "program_spans", lambda: LOG)
    for cell in CELLS:
        assert read(f"hash_s.{cell}", window) == pytest.approx((0.2 + 0.2 + 0.2) / 2)
        assert read(f"coerce_s.{cell}", window) == pytest.approx((0.3 + 0.2) / 2)
        # the second call staged nothing and counts as 0
        assert read(f"stage_s.{cell}", window) == pytest.approx(1.0 / 2)


def test_spans_outside_the_window_are_left_out(monkeypatch, window):
    outside = [s for s in LOG if s.call in (1, 4)]
    monkeypatch.setattr(spanlog, "program_spans", lambda: outside)
    for family in FAMILIES:
        assert read(f"{family}.build", window) is None


def test_a_cell_without_the_span_gives_nothing(monkeypatch, window):
    no_stage = [s for s in LOG if s.name != "stage"]
    monkeypatch.setattr(spanlog, "program_spans", lambda: no_stage)
    assert read("stage_s.refresh", window) is None
    assert read("hash_s.refresh", window) == pytest.approx(0.3)


def test_a_port_without_the_log_gives_nothing(monkeypatch, window):
    monkeypatch.setattr(spanlog, "program_spans", lambda: [])
    for family in FAMILIES:
        assert read(f"{family}.score", window) is None


def test_the_port_log_is_read_through_its_accessor(monkeypatch, window):
    from similaripy_tpu_torch.engine import spans

    monkeypatch.setattr(spans, "log", lambda: LOG)
    assert spanlog.program_spans() is LOG
    assert read("coerce_s.build", window) == pytest.approx(0.25)
