"""The inputs of a run, made from ``--seed``.

The sparsity pattern is fixed: the tracked ``.bench_data_1.0.npz`` (200,948
users x 84,432 items, 31,468,483 ratings at the published MovieLens-32M
shape), whose values are not read. Everything that varies comes from the
seed: the ratings on the pattern (a values kind, ``values/<kind>.py``), the
item-item model of a scoring configuration (a model kind,
``models/<kind>.py``), and the traffic's rows. Bulk draws run on the run's
device from a ``torch.Generator`` in a few large calls; the rows of the
traffic come from ``numpy.random.default_rng``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .manifest import REPO


@dataclass
class Pattern:
    """A users x items CSR pattern: where the ratings are."""

    indptr: np.ndarray  # int32 (users + 1,)
    indices: np.ndarray  # int32 (nnz,)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def csr(self, values: np.ndarray) -> sp.csr_array:
        """The ratings matrix with these values, sharing the pattern's
        arrays (no copy)."""
        return sp.csr_array((values, self.indices, self.indptr), shape=self.shape, copy=False)

    def rows_of_nnz(self) -> np.ndarray:
        return np.repeat(np.arange(self.shape[0], dtype=np.int32), np.diff(self.indptr))

    def item_counts(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.shape[1])


@functools.lru_cache(maxsize=2)
def load_pattern(path: str, users: int | None = None, items: int | None = None) -> Pattern:
    """The pattern of the npz file at `path` (relative to the repo). With
    `users` / `items`, about that many users and items, evenly strided, so
    the cut keeps the spread of degrees (rehearsals and tests only: no cell
    runs a cut pattern)."""
    with np.load(REPO / path) as z:
        indptr = z["indptr"].astype(np.int32)
        indices = z["indices"].astype(np.int32)
        shape = tuple(int(s) for s in z["shape"])
    if users is None and items is None:
        return Pattern(indptr, indices, shape)
    m = sp.csr_array((np.ones(indices.shape[0], np.float32), indices, indptr), shape=shape)
    m = m[:: max(1, shape[0] // (users or shape[0]))][:, :: max(1, shape[1] // (items or shape[1]))]
    m = m.tocsr()
    m.sort_indices()
    return Pattern(m.indptr.astype(np.int32), m.indices.astype(np.int32), m.shape)


def derived_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for the stream `tags` of run seed `seed`."""
    ss = np.random.SeedSequence([seed % 2**64, *tags])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *tags: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derived_seed(seed, *tags))
    return g


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(derived_seed(seed, *tags))


# stream tags of a run
VALUES, MODEL_IDS, TRAFFIC, CHECK = 1, 2, 3, 4
