"""The benchmark's readers idle_unnamed_s and pack_s (perfbench/metrics/),
loaded by path, on a hand-made span log and hand-made device intervals,
and once on the span log of a traced call of the port on the CPU."""

from types import SimpleNamespace

import pytest

import perfbench_parts

IDLE = perfbench_parts.reader("idle_unnamed_s")
PACK = perfbench_parts.reader("pack_s")
spanlog = perfbench_parts.pbcore("spanlog")
trace = perfbench_parts.pbcore("trace")


def _tree(call, spans):
    """A call's spans from (name, parent index, start, end), the root first."""
    return [SimpleNamespace(name=name, call=call, id=i, parent=parent, start=start, end=end,
                            attrs={})
            for i, (name, parent, start, end) in enumerate(spans)]


LOG = (
    # starts before the window [0, 100]: left out, though it ends inside
    _tree(0, [("call", None, -5.0, 0.5), ("execute (wall)", 0, -1.0, 0.5),
              ("coerce", 1, -0.5, 0.5)])
    + _tree(1, [("call", None, 1.0, 41.0),
                ("validate", 0, 1.0, 2.0),
                ("preprocess", 0, 2.0, 10.0), ("hash", 2, 3.0, 5.0),
                ("execute (wall)", 0, 10.0, 38.0), ("stage", 4, 11.0, 15.0),
                ("split", 5, 12.0, 13.0), ("sweep", 4, 16.0, 30.0), ("pack", 4, 30.0, 34.0),
                ("assembly", 0, 38.0, 40.0)])
    + _tree(2, [("call", None, 50.0, 60.0), ("validate", 0, 50.0, 51.0),
                ("preprocess", 0, 51.0, 53.0), ("execute (wall)", 0, 53.0, 58.0),
                ("pack", 3, 57.0, 57.5), ("assembly", 0, 58.0, 60.0)])
    # starts after the window: left out
    + _tree(3, [("call", None, 101.0, 102.0), ("pack", 0, 101.0, 102.0)])
)
# the card idle in [0, 1.5], [2.5, 4], [11.5, 13.5], [15, 16.5], [34, 39],
# [39.5, 42], [55, 56] and [70, 71] of the window
BUSY = [(1.5, 2.5), (4.0, 11.5), (13.5, 15.0), (16.5, 34.0), (39.0, 39.5), (42.0, 55.0),
        (56.0, 70.0), (71.0, 100.0)]


def _trace(busy=BUSY):
    return trace.TraceData([], 0.0, 100.0, device=[("kernel", s, e) for s, e in busy])


@pytest.fixture
def log(monkeypatch):
    monkeypatch.setattr(spanlog, "program_spans", lambda: LOG)


def test_an_idle_interval_goes_to_the_innermost_span(log):
    credit = IDLE.by_span(_trace())
    # [11.5, 13.5]: 0.5 s in `stage` before `split`, 1 s in `split`, 0.5 s
    # in `stage` after it; [15, 16.5]: 1 s in execute, 0.5 s in `sweep`
    assert credit["split"] == pytest.approx(1.0 / 2)
    assert credit["stage"] == pytest.approx(1.0 / 2)
    assert credit["sweep"] == pytest.approx(0.5 / 2)
    assert credit["hash"] == pytest.approx(1.0 / 2)  # [3, 4] of [2.5, 4]


def test_idle_under_the_root_preprocess_and_execute_is_unnamed(log):
    credit = IDLE.by_span(_trace())
    assert credit["call"] == pytest.approx(1.0 / 2)  # [40, 41]: after assembly
    assert credit["preprocess"] == pytest.approx(0.5 / 2)  # [2.5, 3]
    # [15, 16], [34, 38] and call 2's [55, 56]
    assert credit["execute (wall)"] == pytest.approx(6.0 / 2)
    assert IDLE.read(_trace()) == pytest.approx((1.0 + 0.5 + 6.0) / 2)


def test_idle_under_named_work_is_not_counted(log, monkeypatch):
    credit = IDLE.by_span(_trace())
    assert credit["validate"] == pytest.approx(0.5 / 2)
    assert credit["assembly"] == pytest.approx(1.5 / 2)
    unnamed = IDLE.read(_trace())
    assert unnamed == pytest.approx(sum(credit[n] for n in IDLE.UNNAMED))
    # the same idle time under no hash reads as the preprocess lap's
    no_hash = [s for s in LOG if s.name != "hash"]
    monkeypatch.setattr(spanlog, "program_spans", lambda: no_hash)
    assert IDLE.read(_trace()) == pytest.approx(unnamed + 1.0 / 2)


def test_idle_outside_every_root_is_in_by_span_only(log):
    credit = IDLE.by_span(_trace())
    # [0.5, 1], [41, 42], [70, 71]; [0, 0.5] lies in call 0's root
    assert credit[IDLE.OUTSIDE] == pytest.approx(2.5 / 2)
    assert IDLE.read(_trace()) == pytest.approx(7.5 / 2)
    # every idle second of the window is credited once, or lies in call 0
    idle = sum(e - s for s, e in trace.gaps(_trace().device, 0.0, 100.0))
    assert sum(credit.values()) * 2 == pytest.approx(idle - 0.5)


def test_calls_outside_the_window_are_left_out(log):
    credit = IDLE.by_span(_trace())
    assert "coerce" not in credit  # call 0's, idle over [0, 0.5]
    # the mean is over the two calls that start in the window: call 3's
    # `pack` is left out
    assert PACK.read(_trace()) == pytest.approx((4.0 + 0.5) / 2)


def test_nothing_is_read_without_device_intervals_or_spans(monkeypatch, log):
    assert IDLE.read(_trace(busy=[])) is None
    assert IDLE.by_span(_trace(busy=[])) is None
    monkeypatch.setattr(spanlog, "program_spans", lambda: [])
    assert IDLE.read(_trace()) is None
    assert PACK.read(_trace()) is None


def test_a_traced_call_of_the_port_is_credited_whole(monkeypatch):
    """On the span log of a real call, an idle card over the whole window
    is credited second for second to the call's spans and the outside."""
    import numpy as np
    import scipy.sparse as sp

    import similaripy_tpu_torch as tsim
    from similaripy_tpu_torch.engine import spans, splus

    rng = np.random.default_rng(0)
    urm = sp.random_array((300, 120), density=0.05, format="csr", dtype=np.float32,
                          random_state=rng)
    spans.clear()
    monkeypatch.setattr(splus, "TIMING", True)
    tsim.cosine(urm.T, k=5, device="cpu", verbose=False)
    monkeypatch.setattr(splus, "TIMING", False)
    log = spans.log()
    spans.clear()
    tsim.clear_caches()
    root = log[0]
    t0, t1 = root.start - 1.0, root.end + 1.0
    data = trace.TraceData([], t0, t1, device=[("kernel", t0 - 2.0, t0 - 1.0)])
    credit = IDLE.by_span(data, log)
    assert sum(credit.values()) == pytest.approx(t1 - t0)
    assert credit[IDLE.OUTSIDE] == pytest.approx(2.0)
    assert {"validate", "preprocess", "execute (wall)", "assembly", "sweep", "pack"} <= set(
        credit)
