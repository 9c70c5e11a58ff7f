"""The comparison that decides `correct`: served top-k rows against the plain
reference's.

For each checked row the reference gives its own top-k values (sorted,
as many as the row has candidates, at most k), a row scale (its best
value's magnitude) and its value at any (row, column), -inf where the
column is no candidate (a zero product, a value under the threshold, a
filtered column). Four numbers, each over every checked row:

- ``count_off``: rows whose number of entries differs from the reference's;
- ``bad_ids``: entries on a column that is no candidate, or repeated;
- ``value_err``: the widest gap between a served value and the reference's
  value at the same column, over the row scale;
- ``topk_gap``: the widest gap, rank by rank, between the reference's values
  at the served columns (sorted) and the reference's own top-k, over the
  row scale: ties may trade places, a column that does not belong may not.

``count_off`` and ``bad_ids`` are exact (limit 0); the other two have limits
set from the program's and the control's readings (``PERF.md``).
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("count_off", "bad_ids", "value_err", "topk_gap")


def compare_rows(served, ref_top, ref_at, scales) -> dict:
    """`served`: per row (ids, values); `ref_top`: per row the reference's
    sorted top-k values; `ref_at(i, ids)`: the reference's values of row i
    at `ids`; `scales`: per row scale."""
    out = dict.fromkeys(NUMBERS, 0)
    out["value_err"] = out["topk_gap"] = 0.0
    for i, (ids, vals) in enumerate(served):
        ids = np.asarray(ids, np.int64)
        vals = np.asarray(vals, np.float64)
        top = np.asarray(ref_top[i], np.float64)
        scale = max(float(scales[i]), 1e-30)
        if ids.shape[0] != top.shape[0]:
            out["count_off"] += 1
        at = np.asarray(ref_at(i, ids), np.float64)
        bad = ~np.isfinite(at)
        out["bad_ids"] += int(bad.sum()) + int(ids.shape[0] - np.unique(ids).shape[0])
        ok = ~bad
        if ok.any():
            out["value_err"] = max(out["value_err"],
                                   float(np.max(np.abs(vals[ok] - at[ok]))) / scale)
        n = min(top.shape[0], int(ok.sum()))
        if n:
            got = np.sort(at[ok])[::-1][:n]
            out["topk_gap"] = max(out["topk_gap"], float(np.max(np.abs(got - top[:n]))) / scale)
    return out


def merge(parts: list[dict]) -> dict:
    """The numbers of several batches of rows as one."""
    out = dict.fromkeys(NUMBERS, 0)
    out["value_err"] = out["topk_gap"] = 0.0
    for p in parts:
        out["count_off"] += p["count_off"]
        out["bad_ids"] += p["bad_ids"]
        out["value_err"] = max(out["value_err"], p["value_err"])
        out["topk_gap"] = max(out["topk_gap"], p["topk_gap"])
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number is within its limit, and the numbers beside
    their limits (a missing limit fails: a number must have one)."""
    shown = {name: {"value": numbers[name], "limit": limits.get(name)} for name in NUMBERS}
    ok = all(v["limit"] is not None and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown


def served_rows(result, rows) -> list[tuple[np.ndarray, np.ndarray]]:
    """(ids, values) of `rows` of a served sparse result."""
    csr = result.tocsr()
    out = []
    for r in rows:
        s, e = csr.indptr[r], csr.indptr[r + 1]
        out.append((csr.indices[s:e].copy(), csr.data[s:e].copy()))
    return out
