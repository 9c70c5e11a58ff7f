"""Traffic kind ``score_batches``: every call scores the next batch of users
against the model, top-k unseen items each.

Set-up weights the ratings with the configuration's weighting (the port's
own call) and draws the model; both stay fixed, so the port's device cache
serves the model as in a deployment. Call i scores the users at positions
[i * batch, (i + 1) * batch) of a seeded permutation of all users, taken
round the end, so every call has the same size; the warm-up call scores a
batch of its own. Parameters: ``batch``, ``check_rows`` (the users checked
over all calls, drawn from each call's batch).
"""

from __future__ import annotations

import numpy as np

from pbcore import data, kinds

WARM_UP = 1 << 30


class Traffic:
    def __init__(self, dep, params: dict, seed: int):
        self.dep, self.params, self.seed = dep, params, seed
        self.outputs: dict[int, object] = {}
        n_users = dep.pattern.shape[0]
        self.order = data.rng(seed, data.TRAFFIC).permutation(n_users)

    def batch(self, i: int) -> np.ndarray:
        n_users, b = self.order.shape[0], self.params["batch"]
        if i == WARM_UP:
            return np.sort(data.rng(self.seed, data.TRAFFIC, i).choice(n_users, b, replace=False))
        return self.order[(i * b + np.arange(b)) % n_users]

    def setup(self):
        self.values = self.dep.values(0)
        self.ratings = self.dep.ratings(self.values)
        self.weighted = self.dep.weighted(self.ratings)
        self.model = self.dep.model()
        self.model_t = self.model.T
        self._score(self.batch(WARM_UP))

    def _score(self, users):
        return self.dep.score(self.weighted, self.model_t, self.ratings, users)

    def issue(self, i: int):
        users = self.batch(i)
        self.outputs[i] = self._score(users)
        return users.shape[0], {}

    def _rows(self, i: int, n_calls: int) -> np.ndarray:
        return kinds.check_rows(self.seed, i, self.batch(i),
                                kinds.per_call(self.params["check_rows"], n_calls))

    def _reference(self):
        return self.dep.score_reference(self.values, self.model)

    def check(self, calls) -> dict:
        self.weighted = None  # the port's weights: the reference works its own
        ref, _ = self._reference()
        done = [c.index for c in calls if c.error is None]
        rows = {i: self._rows(i, len(done)) for i in done}
        all_rows = np.concatenate([rows[i] for i in done]) if done else np.zeros(0, np.int64)
        rowset = ref.rows(all_rows)
        served = []
        for i in done:
            served += kinds.compare.served_rows(self.outputs.pop(i), rows[i])
        return kinds.judge_rowset(served, rowset)

    def control(self, n_calls: int) -> dict:
        ref, control = self._reference()
        rows = np.concatenate([self._rows(i, n_calls) for i in range(n_calls)])
        return kinds.judge_rowset(ref.rows(rows, control).served(), ref.rows(rows))
