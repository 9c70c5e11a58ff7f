"""Item-item RP3beta with top-k, in plain PyTorch (float64), from the
published definition (similaripy v0.6.0 ``similarity.py:435-503``).

The ratings r are users x items; the call is ``rp3beta(r.T, alpha, beta,
k)``. Each side's rows are L1-normalized and raised to alpha: the items'
rows of r.T and the users' rows of r. For a checked item i and every item j:

    rp3(i, j) = sum_u (r[u, i] / R_i)^alpha (r[u, j] / C_u)^alpha / pop_j^beta

with R_i = sum_u |r[u, i]|, C_u = sum_j |r[u, j]| and pop_j = sum_u r[u, j]
(the popularity of the raw ratings, signed); a zero denominator gives 0.
A candidate where the product is nonzero and the value is at least the
threshold 0 (the item itself included); the row keeps its ``k`` best.
This is not the port's value-symmetric form (one operand
r^alpha C^(-alpha/2) on both sides, R^alpha a row-side depopularization),
so it checks that refactoring too. Of the keywords of ``rp3beta`` it
computes ``k``, ``alpha`` and ``beta`` and refuses any other (``shrink``,
``threshold``, ``binary``, ...).

``precision="tf32"`` is the control: both normalized operands rounded to
TF32 and the sums and the division taken in float32, the nearest precision
below the float32 the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import RowSet, options, tf32, topk_block

BLOCK = 64  # rows a block
CHUNK = 1 << 20  # ratings a step of the product

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class ItemRP3beta:
    def __init__(self, pattern, call: dict, cfg: dict, device):
        """`pattern`: the users x items CSR pattern (``indptr``,
        ``indices``, ``shape``); `call`: the configuration's ``build``."""
        opts = options(call, "rp3beta", {"k": 100, "alpha": 1.0, "beta": 1.0})
        self.k = int(opts["k"])
        self.alpha, self.beta = float(opts["alpha"]), float(opts["beta"])
        self.device = torch.device(device)
        self.n_users, self.n_items = pattern.shape
        users = np.repeat(np.arange(self.n_users, dtype=np.int64), np.diff(pattern.indptr))
        self.u = torch.from_numpy(users).to(self.device)
        self.j = torch.from_numpy(pattern.indices.astype(np.int64)).to(self.device)

    def _operands(self, values: np.ndarray):
        """Per rating: the item side's (r / R_i)^alpha and the user side's
        (r / C_u)^alpha; per item pop^beta. float64."""
        dev, f64 = self.device, torch.float64
        v = torch.from_numpy(values).to(dev, f64)
        item_l1 = torch.zeros(self.n_items, dtype=f64, device=dev).index_add_(0, self.j, v.abs())
        user_l1 = torch.zeros(self.n_users, dtype=f64, device=dev).index_add_(0, self.u, v.abs())
        pop = torch.zeros(self.n_items, dtype=f64, device=dev).index_add_(0, self.j, v)

        def side(norm):
            return torch.pow(torch.where(norm != 0, v / torch.where(norm != 0, norm, 1.0), 0.0),
                             self.alpha)

        return side(item_l1[self.j]), side(user_l1[self.u]), torch.pow(pop, self.beta)

    def rows(self, values: np.ndarray, rows, precision: str = "exact") -> RowSet:
        """The reference's answer for the items `rows` of the ratings with
        these values (one per rating of the pattern)."""
        p, q, den = self._operands(values)
        if precision == "exact":
            dt = torch.float64
        elif precision == "tf32":
            dt = torch.float32
            p, q, den = tf32(p.float()), tf32(q.float()), den.float()
        else:
            raise ValueError(f"precision {precision!r}")
        dev = self.device
        out = RowSet(self.k)
        rows, order = np.unique(np.asarray(rows, np.int64), return_inverse=True)
        for b0 in range(0, rows.shape[0], BLOCK):
            block = torch.from_numpy(rows[b0:b0 + BLOCK]).to(dev)
            S = block.shape[0]
            # the block's item rows of the item side, dense (S x users)
            lut = torch.full((self.n_items,), -1, dtype=torch.int64, device=dev)
            lut[block] = torch.arange(S, device=dev)
            pos = lut[self.j]
            sel = pos >= 0
            a = torch.zeros((S, self.n_users), dtype=dt, device=dev)
            a[pos[sel], self.u[sel]] = p[sel]
            # products with every item: over each rating r[u, j] of the user side
            xy = torch.zeros((S, self.n_items), dtype=dt, device=dev)
            for c0 in range(0, self.u.shape[0], CHUNK):
                u, j, w = self.u[c0:c0 + CHUNK], self.j[c0:c0 + CHUNK], q[c0:c0 + CHUNK]
                xy.index_add_(1, j, a[:, u] * w)
            del a
            val = torch.where(den != 0, xy / torch.where(den != 0, den, 1.0), 0.0)
            xy, val = xy.to(torch.float64), val.to(torch.float64)
            val = torch.where((xy != 0) & (val >= 0.0), val, float("-inf"))
            top_vals, top_ids = topk_block(val, self.k)
            out.add_block(val.cpu().numpy(), top_vals, top_ids)
        return out.take(order.ravel())


Reference = ItemRP3beta
