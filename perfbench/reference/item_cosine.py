"""Item-item cosine with top-k, in plain PyTorch (float64).

The item vectors are the columns of the users x items ratings matrix. For
a checked item i and every item j:

    cos(i, j) = sum_u r[u, i] r[u, j] / (||r[:, i]|| ||r[:, j]||)

a candidate where the product is nonzero and the cosine is at least the
threshold 0 (similaripy's S-Plus with l2 = 1, c1 = c2 = 0.5; the item
itself included); the row keeps its ``k`` best candidates. Of the keywords
of ``cosine`` it computes ``k`` and refuses any other (``shrink``,
``threshold``, ``binary``, ...).

``precision="int4"`` is the control: the ratings as 4-bit codes of twice
their value, clipped to [-8, 7], the nearest precision below the int8
codes the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import RowSet, options, topk_block

BLOCK = 64  # rows a block
CHUNK = 1 << 20  # ratings a step of the product


class ItemCosine:
    def __init__(self, pattern, call: dict, cfg: dict, device):
        """`pattern`: the users x items CSR pattern (``indptr``,
        ``indices``, ``shape``); `call`: the configuration's ``build``."""
        self.k = int(options(call, "cosine", {"k": 100})["k"])
        self.device = torch.device(device)
        self.n_users, self.n_items = pattern.shape
        users = np.repeat(np.arange(self.n_users, dtype=np.int64), np.diff(pattern.indptr))
        self.u = torch.from_numpy(users).to(self.device)
        self.j = torch.from_numpy(pattern.indices.astype(np.int64)).to(self.device)

    def _values(self, values: np.ndarray, precision: str):
        v = torch.from_numpy(values).to(self.device, torch.float64)
        if precision == "int4":
            v = torch.clamp(torch.round(2.0 * v), -8, 7) / 2.0
        elif precision != "exact":
            raise ValueError(f"precision {precision!r}")
        return v

    def rows(self, values: np.ndarray, rows, precision: str = "exact") -> RowSet:
        """The reference's answer for the items `rows` of the ratings with
        these values (one per rating of the pattern)."""
        v = self._values(values, precision)
        norm = torch.sqrt(torch.zeros(self.n_items, dtype=torch.float64, device=self.device)
                          .index_add_(0, self.j, v * v))
        out = RowSet(self.k)
        rows, order = np.unique(np.asarray(rows, np.int64), return_inverse=True)
        for b0 in range(0, rows.shape[0], BLOCK):
            block = torch.from_numpy(rows[b0:b0 + BLOCK]).to(self.device)
            S = block.shape[0]
            # the block's item vectors, dense (S x users)
            lut = torch.full((self.n_items,), -1, dtype=torch.int64, device=self.device)
            lut[block] = torch.arange(S, device=self.device)
            pos = lut[self.j]
            sel = pos >= 0
            a = torch.zeros((S, self.n_users), dtype=torch.float64, device=self.device)
            a[pos[sel], self.u[sel]] = v[sel]
            # dot products with every item: over each rating r[u, j]
            xy = torch.zeros((S, self.n_items), dtype=torch.float64, device=self.device)
            for c0 in range(0, self.u.shape[0], CHUNK):
                u, j, w = self.u[c0:c0 + CHUNK], self.j[c0:c0 + CHUNK], v[c0:c0 + CHUNK]
                xy.index_add_(1, j, a[:, u] * w)
            del a
            den = norm[block][:, None] * norm[None, :]
            cos = torch.where(xy != 0, xy / torch.where(den > 0, den, 1.0), 0.0)
            val = torch.where((xy != 0) & (cos >= 0.0), cos, float("-inf"))
            top_vals, top_ids = topk_block(val, self.k)
            out.add_block(val.cpu().numpy(), top_vals, top_ids)
        return out.take(order.ravel())


Reference = ItemCosine
