"""The plain references, one module per kind of call, in plain PyTorch and
NumPy. They import nothing of the port (``similaripy_tpu_torch``), nor JAX
nor the JAX package, and take nothing the port made: each works out again,
from the ratings, the model and the rows the harness hands both sides,
whatever the port derived from them (BM25 weights, norms, int8 codes).

A reference is built from its inputs, its call's entry of the
configuration (``{"function", "kwargs"}``) and the configuration, and
reads from them what it computes: ``options`` refuses a keyword it does
not compute, so a configuration that sets one needs a reference that
does, and never meets a silent default. A reference answers for a set of
rows with a ``RowSet``: per row its own
top-k (columns and values, sorted, as many as the row has candidates), a
row scale, and its value at any column (-inf where the column is no
candidate). With a lower ``precision`` it is the control put in the
program's place.
"""

from __future__ import annotations

import numpy as np

# keywords of the port's calls that choose how the port computes, not what
EXECUTION = frozenset({"compute_dtype", "precision"})


def options(call: dict, function: str, computed: dict) -> dict:
    """The keyword arguments of `call` that the reference computes,
    `computed` giving each its default; raises where `call` is not a call
    of `function` or sets a keyword beyond those and ``EXECUTION``."""
    if call["function"] != function:
        raise ValueError(f"this reference computes {function}, not {call['function']}")
    kwargs = call.get("kwargs", {})
    unknown = sorted(set(kwargs) - set(computed) - EXECUTION)
    if unknown:
        raise ValueError(f"the reference of {function} does not compute {unknown}")
    return {name: kwargs.get(name, default) for name, default in computed.items()}


class RowSet:
    """The reference's answer for some rows: dense (rows x columns) value
    blocks, -inf where a column is no candidate."""

    def __init__(self, k: int):
        self.k = k
        self.ids: list[np.ndarray] = []
        self.vals: list[np.ndarray] = []
        self.scale: list[float] = []
        self._blocks: list[np.ndarray] = []
        self._where: list[tuple[int, int]] = []

    def add_block(self, val, top_vals, top_ids) -> None:
        """`val` (rows x columns) float64 with -inf for no candidate; the
        block's top-k from torch.topk (sorted)."""
        b = len(self._blocks)
        self._blocks.append(val)
        for r in range(val.shape[0]):
            keep = np.isfinite(top_vals[r])
            self.ids.append(top_ids[r][keep].astype(np.int64))
            self.vals.append(top_vals[r][keep].astype(np.float64))
            self.scale.append(float(abs(top_vals[r][0])) if keep.any() else 1.0)
            self._where.append((b, r))

    def at(self, i: int, ids) -> np.ndarray:
        b, r = self._where[i]
        return self._blocks[b][r, np.asarray(ids, np.int64)]

    def take(self, order) -> "RowSet":
        """The rows in `order` (positions into this set; repeats allowed)."""
        out = RowSet(self.k)
        out._blocks = self._blocks
        for i in order:
            out.ids.append(self.ids[i])
            out.vals.append(self.vals[i])
            out.scale.append(self.scale[i])
            out._where.append(self._where[i])
        return out

    def served(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """The reference's own rows, as a program would serve them."""
        return list(zip(self.ids, self.vals))


def tf32(x):
    """float32 tensor rounded to TF32 (10 mantissa bits, nearest, ties to
    even), as the tensor cores read a TF32 operand."""
    import torch

    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def topk_block(val, k: int):
    """Sorted top-k of each row of a float64 torch block, on the host."""
    import torch

    kk = min(k, val.shape[1])
    top = torch.topk(val, kk, dim=1, sorted=True)
    return top.values.cpu().numpy(), top.indices.cpu().numpy()
