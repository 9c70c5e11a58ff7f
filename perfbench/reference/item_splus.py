"""Item-item S-Plus with top-k over BM25-weighted ratings, in plain PyTorch
(float64), from the published definition (similaripy v0.6.0
``similarity.py:506-592``, ``s_plus``; the weights as ``README.md:86-94``
makes them: ``bm25(urm)``, then the item model over ``urm.T``).

The ratings r are users x items; BM25 (``reference/user_scores.py::bm25``,
similaripy's defaults) gives each rating its weight w[u, i], worked out
again here from the raw ratings. The item vectors are the columns of w.
For a checked item i and every item j, with xy = sum_u w[u, i] w[u, j],
|x|^2 = sum_u w[u, i]^2 and |y|^2 = sum_u w[u, j]^2:

    tversky = t1 (|x|^2 - xy) + t2 (|y|^2 - xy) + xy
    cosine  = (|x|^2)^c1 (|y|^2)^c2
    splus(i, j) = xy / (l1 tversky + l2 cosine)        (0 where that is 0)

a candidate where xy is nonzero and the value is at least the threshold 0
(the item itself included); the row keeps its ``k`` best. At the library's
defaults (l1 = l2 = 0.5, t1 = t2 = 1, c1 = c2 = 0.5) the denominator is
0.5 (|x|^2 + |y|^2 - xy) + 0.5 |x| |y|. Of the keywords of ``s_plus`` it
computes ``k``, ``l1``, ``l2``, ``t1``, ``t2``, ``c1`` and ``c2``, and
refuses any other (``l3``, ``pop1``, ``alpha``, ``beta1``, ``shrink``,
``threshold``, ``binary``, the selectors, ...), and a weighting other than
bm25 at its defaults.

``precision="tf32"`` is the control: the weights rounded to TF32, the sums
(the products and the squared norms) and the epilogue taken in float32,
the nearest precision below the float32 the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import RowSet, options, tf32, topk_block
from reference.user_scores import bm25

BLOCK = 64  # rows a block
CHUNK = 1 << 20  # ratings a step of the product
DEFAULTS = {"k": 100, "l1": 0.5, "l2": 0.5, "t1": 1.0, "t2": 1.0, "c1": 0.5, "c2": 0.5}

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class ItemSPlus:
    def __init__(self, pattern, call: dict, cfg: dict, device):
        """`pattern`: the users x items CSR pattern (``indptr``,
        ``indices``, ``shape``); `call`: the configuration's ``build``;
        `cfg`: the configuration (its ``weighting``)."""
        options(cfg.get("weighting") or {"function": None}, "bm25", {})
        opts = options(call, "s_plus", DEFAULTS)
        self.k = int(opts["k"])
        self.l1, self.l2, self.t1, self.t2, self.c1, self.c2 = (
            float(opts[name]) for name in ("l1", "l2", "t1", "t2", "c1", "c2"))
        self.device = torch.device(device)
        self.shape = pattern.shape
        self.n_users, self.n_items = pattern.shape
        self.users = np.repeat(np.arange(self.n_users, dtype=np.int64), np.diff(pattern.indptr))
        self.items = pattern.indices.astype(np.int64)
        self.u = torch.from_numpy(self.users).to(self.device)
        self.j = torch.from_numpy(self.items).to(self.device)

    def _weights(self, values: np.ndarray, precision: str):
        w = torch.from_numpy(bm25(self.users, self.items, values, self.shape)).to(self.device)
        if precision == "exact":
            return w
        if precision == "tf32":
            return tf32(w.float())
        raise ValueError(f"precision {precision!r}")

    def rows(self, values: np.ndarray, rows, precision: str = "exact") -> RowSet:
        """The reference's answer for the items `rows` of the ratings with
        these values (one per rating of the pattern)."""
        w = self._weights(values, precision)
        dt, dev = w.dtype, self.device
        sq = torch.zeros(self.n_items, dtype=dt, device=dev).index_add_(0, self.j, w * w)
        out = RowSet(self.k)
        rows, order = np.unique(np.asarray(rows, np.int64), return_inverse=True)
        for b0 in range(0, rows.shape[0], BLOCK):
            block = torch.from_numpy(rows[b0:b0 + BLOCK]).to(dev)
            S = block.shape[0]
            # the block's item vectors, dense (S x users)
            lut = torch.full((self.n_items,), -1, dtype=torch.int64, device=dev)
            lut[block] = torch.arange(S, device=dev)
            pos = lut[self.j]
            sel = pos >= 0
            a = torch.zeros((S, self.n_users), dtype=dt, device=dev)
            a[pos[sel], self.u[sel]] = w[sel]
            # dot products with every item: over each weight w[u, j]
            xy = torch.zeros((S, self.n_items), dtype=dt, device=dev)
            for c0 in range(0, self.u.shape[0], CHUNK):
                u, j, wj = self.u[c0:c0 + CHUNK], self.j[c0:c0 + CHUNK], w[c0:c0 + CHUNK]
                xy.index_add_(1, j, a[:, u] * wj)
            del a
            x2, y2 = sq[block][:, None], sq[None, :]
            tversky = self.t1 * (x2 - xy) + self.t2 * (y2 - xy) + xy
            cosine = torch.pow(x2, self.c1) * torch.pow(y2, self.c2)
            den = self.l1 * tversky + self.l2 * cosine
            val = torch.where(den != 0, xy / torch.where(den != 0, den, 1.0), 0.0)
            xy, val = xy.to(torch.float64), val.to(torch.float64)
            val = torch.where((xy != 0) & (val >= 0.0), val, float("-inf"))
            top_vals, top_ids = topk_block(val, self.k)
            out.add_block(val.cpu().numpy(), top_vals, top_ids)
        return out.take(order.ravel())


Reference = ItemSPlus
