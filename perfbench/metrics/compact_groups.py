"""compact_groups.<cell kind>: mean number of column groups a call of the
compaction executor ran (``engine/compact.py``: one ``group`` span each,
a dense table of the group's columns, then every panel against it), over
the calls whose root span starts in the window. Fewer groups densify
matrix2 and run the hot prefix fewer times. Nothing where no such span
ran (a port without the span)."""
from pbcore import spanlog


def read(trace):
    log = spanlog.program_spans()
    calls = {s.call for s in log
             if s.parent is None and trace.t_start <= s.start <= trace.t_end}
    groups = sum(1 for s in log if s.name == "group" and s.call in calls)
    return groups / len(calls) if groups else None
