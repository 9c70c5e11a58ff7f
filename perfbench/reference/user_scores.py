"""Scoring users against an item-item model, with top-k of unseen items, in
plain PyTorch (float64), the ratings weighted by BM25 first.

BM25 (similaripy's ``normalization.bm25`` defaults: rows are documents,
k1 = 1.2, b = 0.75, raw term frequency, the BM25 idf, natural log):

    idf[i]   = log((N - df[i] + 0.5) / (df[i] + 0.5))   (0 where df[i] = 0)
    norm[u]  = (1 - b) + b * len[u] / mean(len)
    w[u, i]  = idf[i] * r[u, i] (k1 + 1) / (r[u, i] + k1 norm[u])

with N the users, df[i] the users who rated item i, len[u] the sum of
user u's ratings. The score of item j for user u is

    s(u, j) = sum_i w[u, i] M[j, i]

(``dot_product(bm25(urm), M.T)``), a candidate where it is nonzero, at
least the threshold 0, and j is not among u's rated items (the call
filters seen items); the row keeps its ``k`` best. It computes the
keyword ``k`` of ``dot_product`` and bm25 at its defaults, and refuses any
other keyword, and a call that does not filter seen items.

``precision="tf32"`` is the control: both operands rounded to TF32 and
the sums taken in float32, the nearest precision below the float32 the
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import RowSet, options, tf32, topk_block

BLOCK = 64
CHUNK = 1 << 20
K1, B = 1.2, 0.75


def bm25(users: np.ndarray, items: np.ndarray, values: np.ndarray, shape) -> np.ndarray:
    """The BM25 weight of each rating, float64."""
    n_users, n_items = shape
    r = values.astype(np.float64)
    doc_len = np.bincount(users, weights=r, minlength=n_users)
    df = np.bincount(items, weights=(r > 0).astype(np.float64), minlength=n_items)
    with np.errstate(divide="ignore", invalid="ignore"):
        idf = np.where(df != 0, np.log((n_users - df + 0.5) / (df + 0.5)), 0.0)
    norm = (1.0 - B) + B * doc_len / (doc_len.sum() / n_users)
    return idf[items] * (r * (K1 + 1.0) / (r + K1 * norm[users]))


class UserScores:
    def __init__(self, pattern, values: np.ndarray, model, call: dict, cfg: dict, device):
        """`pattern`: the users x items CSR pattern (``indptr``, ``indices``,
        ``shape``) and `values` its ratings; `model`: a scipy-style CSR items
        x items (indptr, indices, data); `call`: the configuration's
        ``score``; `cfg`: the configuration (its ``weighting``)."""
        options(cfg["weighting"], "bm25", {})
        self.k = int(options(call, "dot_product", {"k": 100})["k"])
        if not call.get("filter_seen"):
            raise ValueError("this reference scores with the seen items filtered")
        self.device = torch.device(device)
        self.n_users, self.n_items = pattern.shape
        dev = self.device
        users = np.repeat(np.arange(self.n_users, dtype=np.int64), np.diff(pattern.indptr))
        items = pattern.indices.astype(np.int64)
        self.u = torch.from_numpy(users).to(dev)
        self.i = torch.from_numpy(items).to(dev)
        self.w = torch.from_numpy(bm25(users, items, values, pattern.shape)).to(dev)
        m_rows = np.repeat(np.arange(model.shape[0], dtype=np.int64), np.diff(model.indptr))
        self.mj = torch.from_numpy(m_rows).to(dev)  # M's row: the scored item j
        self.mi = torch.from_numpy(model.indices.astype(np.int64)).to(dev)  # its column i
        self.mv = torch.from_numpy(model.data.astype(np.float64)).to(dev)

    def rows(self, rows, precision: str = "exact") -> RowSet:
        """The reference's answer for the users `rows`."""
        if precision == "exact":
            dt, w, mv = torch.float64, self.w, self.mv
        elif precision == "tf32":
            dt, w, mv = torch.float32, tf32(self.w.float()), tf32(self.mv.float())
        else:
            raise ValueError(f"precision {precision!r}")
        out = RowSet(self.k)
        rows, order = np.unique(np.asarray(rows, np.int64), return_inverse=True)
        dev = self.device
        for b0 in range(0, rows.shape[0], BLOCK):
            block = torch.from_numpy(rows[b0:b0 + BLOCK]).to(dev)
            S = block.shape[0]
            lut = torch.full((self.n_users,), -1, dtype=torch.int64, device=dev)
            lut[block] = torch.arange(S, device=dev)
            pos = lut[self.u]
            sel = pos >= 0
            a = torch.zeros((S, self.n_items), dtype=dt, device=dev)
            a[pos[sel], self.i[sel]] = w[sel]
            seen = torch.zeros((S, self.n_items), dtype=torch.bool, device=dev)
            seen[pos[sel], self.i[sel]] = True
            s = torch.zeros((S, self.n_items), dtype=dt, device=dev)
            for c0 in range(0, self.mj.shape[0], CHUNK):
                j, i, m = self.mj[c0:c0 + CHUNK], self.mi[c0:c0 + CHUNK], mv[c0:c0 + CHUNK]
                s.index_add_(1, j, a[:, i] * m)
            s = s.to(torch.float64)
            val = torch.where((s != 0) & (s >= 0.0) & ~seen, s, float("-inf"))
            top_vals, top_ids = topk_block(val, self.k)
            out.add_block(val.cpu().numpy(), top_vals, top_ids)
        return out.take(order.ravel())


Reference = UserScores
