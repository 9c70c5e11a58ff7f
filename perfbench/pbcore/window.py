"""The measured window of a closed loop with one caller.

The window opens when the first timed call is issued and closes when the
first call that finishes `seconds` or more after the opening returns. A rate
is every row of every call in the window over the whole span: never a best
call, never a median of calls.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Call:
    index: int
    t_issue: float
    t_done: float
    rows: int
    error: str | None = None
    info: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t_done - self.t_issue


@dataclass
class Window:
    calls: list[Call]

    @property
    def t_start(self) -> float:
        return self.calls[0].t_issue

    @property
    def t_end(self) -> float:
        return self.calls[-1].t_done

    @property
    def span(self) -> float:
        return self.t_end - self.t_start

    @property
    def rows(self) -> int:
        return sum(c.rows for c in self.calls if c.error is None)

    @property
    def failed(self) -> int:
        return sum(c.error is not None for c in self.calls)

    def rate(self) -> float:
        """Rows of every call that succeeded, over the whole span."""
        return self.rows / self.span


def run_closed_loop(issue: Callable[[int], tuple[int, dict]], seconds: float,
                    clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call ``issue(i)`` for i = 0, 1, ... back to back until a call ends
    `seconds` or more after the first was issued. ``issue`` returns the rows
    the call served and a dict kept with the call; an exception is recorded
    as a failed call of 0 rows."""
    calls: list[Call] = []
    t_start = None
    i = 0
    while True:
        t_issue = clock()
        if t_start is None:
            t_start = t_issue
        try:
            rows, info = issue(i)
            error = None
        except Exception as exc:  # a failed call counts against the run
            rows, info, error = 0, {}, f"{type(exc).__name__}: {exc}"
        t_done = clock()
        calls.append(Call(i, t_issue, t_done, rows, error, info))
        if t_done - t_start >= seconds:
            return Window(calls)
        i += 1
