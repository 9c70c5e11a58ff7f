"""Traffic kind ``refresh``: every call recomputes the neighbour rows of the
items a batch of new ratings changed, on ratings that stay fixed.

Call i's batch is a seeded stream of new ratings, each on an item in
proportion to the item's rating count, cut where ``targets`` distinct
items have received one: in the stream, item j's first rating comes after
an exponential number of ratings of mean total / count[j], and the batch is
the ``targets`` items whose first rating comes soonest (so popular items,
with long columns, are changed more often, as in a deployment). Call i
passes them, sorted, as ``target_rows``; the warm-up call has a batch of
its own. Parameters: ``targets``, ``check_rows`` (the rows checked over all
calls, drawn from each call's batch).
"""

from __future__ import annotations

import numpy as np

from pbcore import data, kinds

WARM_UP = 1 << 30  # the warm-up batch's stream


class Traffic:
    def __init__(self, dep, params: dict, seed: int):
        self.dep, self.params, self.seed = dep, params, seed
        self.outputs: dict[int, object] = {}
        self.batches: dict[int, np.ndarray] = {}
        counts = dep.pattern.item_counts().astype(np.float64)
        with np.errstate(divide="ignore"):
            self.mean_wait = counts.sum() / counts  # inf for an item nobody rated

    def batch(self, i: int) -> np.ndarray:
        if i not in self.batches:
            r = data.rng(self.seed, data.TRAFFIC, i)
            first = r.exponential(size=self.mean_wait.shape[0]) * self.mean_wait
            n = self.params["targets"]
            self.batches[i] = np.sort(np.argpartition(first, n - 1)[:n])
        return self.batches[i]

    def setup(self):
        self.values = self.dep.values(0)
        self.ratings = self.dep.ratings(self.values)
        self.dep.build(self.ratings, self.batch(WARM_UP))

    def issue(self, i: int):
        targets = self.batch(i)
        self.outputs[i] = self.dep.build(self.ratings, targets)
        return targets.shape[0], {}

    def _rows(self, i: int, n_calls: int) -> np.ndarray:
        return kinds.check_rows(self.seed, i, self.batch(i),
                                kinds.per_call(self.params["check_rows"], n_calls))

    def check(self, calls) -> dict:
        ref, _ = self.dep.build_reference()
        done = [c.index for c in calls if c.error is None]
        rows = {i: self._rows(i, len(done)) for i in done}
        all_rows = np.concatenate([rows[i] for i in done]) if done else np.zeros(0, np.int64)
        rowset = ref.rows(self.values, all_rows)
        served = []
        for i in done:
            served += kinds.compare.served_rows(self.outputs.pop(i), rows[i])
        return kinds.judge_rowset(served, rowset)

    def control(self, n_calls: int) -> dict:
        ref, control = self.dep.build_reference()
        rows = np.concatenate([self._rows(i, n_calls) for i in range(n_calls)])
        return kinds.judge_rowset(ref.rows(self.values, rows, control).served(),
                                  ref.rows(self.values, rows))
