"""Each traffic kind at a tiny size on the CPU: the same seed gives the same
calls, another seed other ones, and every call serves what it says."""

import numpy as np
import pytest
from conftest import TINY

from pbcore import data, manifest
from pbcore.deploy import Deployment


def traffic(cell, seed, **params):
    wl = manifest.workload(cell)
    dep = Deployment(wl["config"], "cpu", seed, TINY)
    return manifest.traffic_kind(wl["kind"]).Traffic(dep, {**wl["params"], **params}, seed)


HALF_STARS = manifest.part("values", "half_stars")


def test_values_are_half_stars_and_follow_the_seed():
    a = HALF_STARS.Values(7, 10_000, "cpu")
    v1 = a(1)
    assert v1.dtype == np.float32 and v1.shape == (10_000,)
    assert set(np.unique(v1)) <= {x / 2 for x in range(1, 11)}
    assert np.array_equal(v1, HALF_STARS.Values(7, 10_000, "cpu")(1))
    assert not np.array_equal(v1, HALF_STARS.Values(8, 10_000, "cpu")(1))
    # versions differ at about nine ratings in ten, as independent draws do
    assert 0.85 < np.mean(v1 != a(2)) < 0.95


def test_every_version_a_run_can_call_for_is_ready_and_distinct():
    offsets = {(v * HALF_STARS.STRIDE) % HALF_STARS.SPAN for v in range(HALF_STARS.SPAN)}
    assert len(offsets) == HALF_STARS.SPAN
    a = HALF_STARS.Values(3, 1000, "cpu")
    assert a(HALF_STARS.SPAN - 1).shape == (1000,)
    assert np.shares_memory(a(5), a.buffer)  # a view: no version is made in the window


def test_a_large_seed_is_taken():
    assert HALF_STARS.Values(2**31 + 12345, 100, "cpu")(0).shape == (100,)
    assert data.derived_seed(2**40, 3) != data.derived_seed(2**40 + 1, 3)


def test_the_model_has_exactly_per_row_distinct_entries_in_each_row():
    popularity = manifest.part("models", "popularity")
    counts = np.arange(1, 301, dtype=np.int64)
    m = popularity.draw(5, counts, {"per_row": 20}, "cpu", chunk=64)
    assert m.shape == (300, 300) and m.nnz == 300 * 20
    assert all(np.unique(m.indices[m.indptr[r]:m.indptr[r + 1]]).shape[0] == 20
               for r in range(300))
    assert m.data.min() > 0 and m.data.max() <= 1
    # drawn in proportion to the counts: popular ids come up more
    hits = np.bincount(m.indices, minlength=300)
    assert hits[200:].sum() > 2 * hits[:100].sum()
    again = popularity.draw(5, counts, {"per_row": 20}, "cpu", chunk=64)
    assert np.array_equal(m.indices, again.indices)


def test_full_build_gives_every_call_a_version_of_its_own():
    t = traffic("ml32m-raw-int8.full-build", 3)
    t.setup()
    rows, info = t.issue(0)
    assert rows == t.dep.pattern.shape[1] and not info
    t.issue(40)
    assert not np.array_equal(t.dep.values(1), t.dep.values(41))
    assert t.outputs[0].shape == (t.dep.pattern.shape[1],) * 2


def test_refresh_batches_are_distinct_items_drawn_by_popularity():
    t = traffic("ml32m-raw-int8.refresh-8k", 3, targets=200)
    b0, b1 = t.batch(0), t.batch(1)
    assert b0.shape == (200,) and np.unique(b0).shape == (200,)
    assert not np.array_equal(b0, b1)
    assert np.array_equal(b0, traffic("ml32m-raw-int8.refresh-8k", 3, targets=200).batch(0))
    assert not np.array_equal(b0, traffic("ml32m-raw-int8.refresh-8k", 4, targets=200).batch(0))
    # the items new ratings reach first are the popular ones
    counts = t.dep.pattern.item_counts()
    batches = np.concatenate([t.batch(i) for i in range(20)])
    assert counts[batches].mean() > 1.5 * counts.mean()
    t.setup()
    rows, _ = t.issue(0)
    out = t.outputs[0].tocsr()
    served = np.flatnonzero(np.diff(out.indptr))
    assert rows == 200 and set(served) <= set(b0)


def test_score_batches_walk_a_permutation_of_all_users_round_the_end():
    t = traffic("ml32m-bm25-f32.score-8k", 3, batch=1000)
    n = t.dep.pattern.shape[0]
    seen = np.concatenate([t.batch(i) for i in range(-(-n // 1000))])
    assert np.unique(seen[:n]).shape == (n,)
    assert all(t.batch(i).shape == (1000,) for i in range(5))
    assert np.array_equal(t.batch(0), traffic("ml32m-bm25-f32.score-8k", 3, batch=1000).batch(0))


@pytest.mark.parametrize("cell", ["ml32m-raw-int8.full-build", "ml32m-raw-int8.refresh-8k",
                                  "ml32m-bm25-f32.score-8k"])
def test_checked_rows_come_from_the_call(cell):
    from conftest import TINY_PARAMS

    t = traffic(cell, 9, **TINY_PARAMS[cell])
    for i in range(3):
        rows = t._rows(i, 3)
        pool = t.batch(i) if hasattr(t, "batch") else np.arange(t.dep.pattern.shape[1])
        assert set(rows) <= set(pool)
        assert rows.shape[0] == np.unique(rows).shape[0]
