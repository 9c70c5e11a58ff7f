"""idle_unnamed_s.<cell kind>: mean seconds a call leaves the card idle in
no span of its work, over the calls whose root span starts in the window.

Each idle interval of the card in the window (no kernel, copy or set; the
profiler's device intervals) is cut at the boundaries of the port's spans
(``engine/spans.py``) and each piece is credited to the innermost span
open over it: the one opened latest among those still open. The metric
is what falls to the bare root ``call`` or to the laps ``preprocess`` and
``execute (wall)``: host work that no span names. ``validate`` and
``assembly`` are one function each and count as named. Moves its cells'
rate. Nothing where the window has no device intervals or no spans.

``by_span(trace)`` gives every span name's mean idle seconds a call, and
``"outside the program"`` for idle time outside every call's root.
"""
from bisect import bisect_right

from pbcore import spanlog
from pbcore.trace import gaps

UNNAMED = ("call", "preprocess", "execute (wall)")
OUTSIDE = "outside the program"


def _segments(tree) -> list:
    """A call's time cut at every boundary of its spans, as (start, end,
    name of the innermost span open over it)."""
    closed = [s for s in tree if s.end is not None]
    edges = sorted({t for s in closed for t in (s.start, s.end)})
    out = []
    for a, b in zip(edges, edges[1:]):
        over = [s for s in closed if s.start <= a and b <= s.end]
        if over:
            out.append((a, b, max(over, key=lambda s: (s.start, s.id)).name))
    return out


def by_span(trace, log=None):
    """{span name: mean card-idle seconds a call credited to it}, with
    OUTSIDE for the window's idle time outside every root; None where
    there is nothing to read."""
    log = spanlog.program_spans() if log is None else log
    trees: dict = {}
    for s in log:
        trees.setdefault(s.call, []).append(s)
    roots = [tree[0] for tree in trees.values() if tree[0].parent is None]
    window = {r.call for r in roots if trace.t_start <= r.start <= trace.t_end}
    if not trace.device or not window:
        return None
    idle = gaps(trace.device, trace.t_start, trace.t_end)  # sorted, disjoint
    idle_ends = [e for _, e in idle]
    credit = {OUTSIDE: sum(e - s for s, e in idle)}
    for call, tree in trees.items():
        root = tree[0]
        if root.parent is not None or root.end is None:
            continue
        if root.end <= trace.t_start or root.start >= trace.t_end:
            continue
        segments = _segments(tree)
        starts = [a for a, _, _ in segments]
        j = bisect_right(idle_ends, root.start)
        while j < len(idle) and idle[j][0] < root.end:
            g0, g1 = idle[j]
            j += 1
            lo, hi = max(g0, root.start), min(g1, root.end)
            credit[OUTSIDE] -= hi - lo
            if call not in window:
                continue
            i = max(bisect_right(starts, lo) - 1, 0)
            while i < len(segments) and segments[i][0] < hi:
                a, b, name = segments[i]
                piece = min(b, hi) - max(a, lo)
                if piece > 0:
                    credit[name] = credit.get(name, 0.0) + piece
                i += 1
    return {name: seconds / len(window) for name, seconds in credit.items()}


def read(trace):
    credit = by_span(trace)
    if credit is None:
        return None
    return sum(credit.get(name, 0.0) for name in UNNAMED)
