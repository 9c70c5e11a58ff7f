"""The port's own span log (``similaripy_tpu_torch/engine/spans.py``), as
the readers of its spans take it.

With ``splus.TIMING`` on, every call of the port records a root span
``call`` and, under it, its laps and the spans of its host work (``coerce``,
``hash``, ``stage``), each on ``time.perf_counter()``: the clock of the
window. The log is the port's state, which a run leaves alone until it
clears the port's caches, after the readers. A checkout of the port
without the log gives nothing to read.
"""

from __future__ import annotations


def program_spans() -> list:
    """The spans the port kept (roots have ``parent`` None), or []."""
    try:
        from similaripy_tpu_torch.engine import spans
    except ImportError:
        return []
    return spans.log()


def mean_per_call(trace, name: str):
    """The mean, over the calls whose root span starts in the window
    ``[trace.t_start, trace.t_end]``, of each call's summed seconds of its
    spans called `name`; None where no such span ran in those calls."""
    log = program_spans()
    calls = {s.call for s in log
             if s.parent is None and trace.t_start <= s.start <= trace.t_end}
    total, seen = 0.0, False
    for s in log:
        if s.name == name and s.call in calls and s.end is not None:
            total += s.end - s.start
            seen = True
    return total / len(calls) if seen else None
