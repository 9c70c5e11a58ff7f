"""What the traffic kinds share: the interface `driver.py` calls, and the
sampling of the rows that are checked.

A traffic kind (``traffic/<kind>.py``) defines ``Traffic(dep, params,
seed)`` (the ``Deployment``, the cell's parameters, the run's seed) with:

- ``setup()``: derive this run's inputs and make the warm-up call, which
  runs every shape the window will use (set-up, counted in ``setup_s``);
- ``issue(i) -> (rows, info)``: timed call i, whose output it keeps;
- ``check(calls) -> numbers``: once the window has closed and the port's
  state is freed, the reference over the checked rows of `calls`;
- ``control(n_calls) -> numbers``: the same rows of the first n calls, with
  the reference at the control's lower precision in the program's place.
"""

from __future__ import annotations

import numpy as np

from . import compare, data


def check_rows(seed: int, call: int, pool: np.ndarray, n: int, always=()) -> np.ndarray:
    """`n` rows of call `call` to check, drawn from `pool` by the seed, with
    the rows `always` among them where the pool holds them."""
    picked = data.rng(seed, data.CHECK, call).choice(pool, size=min(n, pool.shape[0]),
                                                     replace=False)
    extra = np.setdiff1d(np.intersect1d(np.asarray(always, picked.dtype), pool), picked)
    return np.concatenate([extra, picked])[: max(n, extra.shape[0])]


def per_call(total: int, n_calls: int) -> int:
    """Rows checked a call, so that the calls together check about
    `total`."""
    return max(1, -(-total // max(n_calls, 1)))


def judge_rowset(served, rowset) -> dict:
    return compare.compare_rows(served, rowset.vals, rowset.at, rowset.scale)
