"""Traffic kind ``full_build``: every call builds the whole item-item model
of a new version of the ratings.

Call i gets version i + 1 of the values (version 0 is the warm-up's), which
no other call of the run has, over the fixed pattern, so nothing a call
leaves in the port's device cache serves the next: the host preparation
and the upload count as they do for a user rebuilding on fresh data. The
values kind makes every version in set-up (``values/<kind>.py``).
Parameters: ``check_rows``, the rows checked over all calls, the
most-rated item among each call's.
"""

from __future__ import annotations

import numpy as np

from pbcore import kinds


class Traffic:
    def __init__(self, dep, params: dict, seed: int):
        self.dep, self.params, self.seed = dep, params, seed
        self.outputs: dict[int, object] = {}

    def setup(self):
        self.dep.build(self.dep.ratings(self.dep.values(0)))  # warm-up

    def issue(self, i: int):
        self.outputs[i] = self.dep.build(self.dep.ratings(self.dep.values(i + 1)))
        return self.dep.pattern.shape[1], {}

    def _rows(self, i: int, n_calls: int) -> np.ndarray:
        n_items = self.dep.pattern.shape[1]
        top = int(np.argmax(self.dep.pattern.item_counts()))
        n = kinds.per_call(self.params["check_rows"], n_calls)
        return kinds.check_rows(self.seed, i, np.arange(n_items), n, always=(top,))

    def check(self, calls) -> dict:
        ref, _ = self.dep.build_reference()
        parts = []
        done = [c.index for c in calls if c.error is None]
        for i in done:
            rows = self._rows(i, len(done))
            rowset = ref.rows(self.dep.values(i + 1), rows)
            served = kinds.compare.served_rows(self.outputs.pop(i), rows)
            parts.append(kinds.judge_rowset(served, rowset))
        return kinds.compare.merge(parts)

    def control(self, n_calls: int) -> dict:
        ref, control = self.dep.build_reference()
        parts = []
        for i in range(n_calls):
            values = self.dep.values(i + 1)
            rows = self._rows(i, n_calls)
            parts.append(kinds.judge_rowset(ref.rows(values, rows, control).served(),
                                            ref.rows(values, rows)))
        return kinds.compare.merge(parts)
