"""The window and the rate, against a fake clock."""

import pytest

from pbcore.window import run_closed_loop


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_closes_on_the_first_call_that_ends_after_the_seconds():
    clock = FakeClock()
    durations = [3.0, 4.0, 2.5, 5.0, 1.0]

    def issue(i):
        clock.t += durations[i]
        return 10 * (i + 1), {}

    w = run_closed_loop(issue, 9.0, clock=clock)
    # 3 + 4 = 7 < 9, then 7 + 2.5 = 9.5 >= 9: three calls
    assert [c.index for c in w.calls] == [0, 1, 2]
    assert w.span == pytest.approx(9.5)
    assert w.rows == 10 + 20 + 30
    assert w.rate() == pytest.approx(60 / 9.5)


def test_rate_counts_the_harness_time_between_calls():
    clock = FakeClock()

    def issue(i):
        clock.t += 2.0  # the call
        return 5, {}

    real_issue = issue

    def with_gap(i):
        if i:
            clock.t += 0.5  # time between calls, inside the window
        return real_issue(i)

    w = run_closed_loop(with_gap, 6.0, clock=clock)
    assert len(w.calls) == 3
    assert w.span == pytest.approx(7.0)
    assert w.rate() == pytest.approx(15 / 7.0)


def test_a_failed_call_serves_no_rows_and_is_counted():
    clock = FakeClock()

    def issue(i):
        clock.t += 1.0
        if i == 1:
            raise RuntimeError("out of memory")
        return 4, {}

    w = run_closed_loop(issue, 2.5, clock=clock)
    assert w.failed == 1
    assert w.rows == 8
    assert w.calls[1].error.startswith("RuntimeError")


def test_one_call_longer_than_the_window():
    clock = FakeClock()

    def issue(i):
        clock.t += 30.0
        return 7, {}

    w = run_closed_loop(issue, 10.0, clock=clock)
    assert len(w.calls) == 1 and w.rate() == pytest.approx(7 / 30.0)
