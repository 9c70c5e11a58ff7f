"""Synthetic recommender datasets with MovieLens-like statistics.

A copy of ``similaripy_tpu/utils/synth.py`` (NumPy only), kept in the port
so that it imports nothing of the JAX package; for the same arguments it
gives the same matrix, byte for byte. The benchmarks need no download: the
ML-32M benchmark protocol runs on a synthetic user-rating matrix with the
real dataset's shape, nnz and value domain (half-star ratings), and
power-law user-activity / item-popularity profiles. Degree skew is what
drives the kernels' load imbalance and tile occupancy, so matching it
matters more than matching content.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# MovieLens-32M dimensions (reference: tests/benchmarks/README.md:194)
ML32M_USERS = 200_948
ML32M_ITEMS = 84_432
ML32M_NNZ = 32_000_204


def synthetic_urm(
    n_users: int = ML32M_USERS,
    n_items: int = ML32M_ITEMS,
    nnz: int = ML32M_NNZ,
    user_alpha: float = 1.05,
    item_alpha: float = 1.05,
    seed: int = 0,
    ratings: str = "half_stars",
) -> sp.csr_array:
    """Power-law user x item rating matrix, duplicates removed.

    Sampling is with replacement then deduped, so the delivered nnz is
    slightly below the request (like real data, duplicates concentrate on
    popular pairs).
    """
    rng = np.random.default_rng(seed)

    def zipf_weights(n, alpha):
        w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), alpha)
        return w / w.sum()

    uw = zipf_weights(n_users, user_alpha)
    iw = zipf_weights(n_items, item_alpha)

    # draw-dedupe-top-up until the target nnz is reached (popular pairs
    # collide heavily under zipf sampling, so one oversampled draw is not
    # enough)
    codes = np.empty(0, dtype=np.int64)
    for _ in range(8):
        need = nnz - codes.shape[0]
        if need <= 0:
            break
        n_draw = int(need * 1.6) + 1024
        users = rng.choice(n_users, size=n_draw, p=uw)
        items = rng.choice(n_items, size=n_draw, p=iw)
        new = users.astype(np.int64) * n_items + items
        codes = np.unique(np.concatenate([codes, new]))
    if codes.shape[0] > nnz:
        codes = rng.choice(codes, size=nnz, replace=False)
        codes.sort()
    rows = (codes // n_items).astype(np.int32)
    cols = (codes % n_items).astype(np.int32)

    if ratings == "half_stars":
        vals = rng.choice(np.arange(0.5, 5.5, 0.5), size=codes.shape[0]).astype(
            np.float32
        )
    elif ratings == "binary":
        vals = np.ones(codes.shape[0], dtype=np.float32)
    else:
        vals = rng.random(codes.shape[0], dtype=np.float32)

    return sp.csr_array((vals, (rows, cols)), shape=(n_users, n_items))
