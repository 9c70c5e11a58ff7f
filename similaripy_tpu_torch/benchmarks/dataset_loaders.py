"""Benchmark dataset loading.

Port of ``benchmarks/dataset_loaders.py``. The reference downloads
MovieLens 25M/32M and Yambda 50M/500M (reference:
tests/benchmarks/dataset_loaders.py:21-232); the port downloads nothing.
A dataset resolves in order:
  1. a local file (CSV ratings / .npz sparse) given via --data-path or
     found under ./data/<name>/ (relative to the working directory)
  2. a synthetic power-law URM with the named dataset's published shape
     and nnz (``utils/synth.py``): for ``movielens_32m`` with seed 0 the
     repository's tracked ``.bench_data_1.0.npz`` (resolved against the
     repository root, so any working directory finds it), otherwise
     generated and cached in ``similaripy_tpu_torch/_build/``
     (git-ignored).
Yambda's parquet event logs are not read (no parquet reader is required);
a ``.parquet`` path raises.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..utils.npz_cache import cached_npz
from ..utils.synth import ML32M_ITEMS, ML32M_NNZ, ML32M_USERS, synthetic_urm

PACKAGE = Path(__file__).resolve().parent.parent
REPO = PACKAGE.parent
SYNTH_DIR = PACKAGE / "_build"

# (n_users, n_items, nnz) of the datasets the reference benchmarks on
DATASETS = {
    "movielens_32m": (200_948, 84_432, 32_000_204),
    "movielens_25m": (162_541, 59_047, 25_000_095),
    "yambda_50m": (1_000_000, 9_390_623, 50_000_000),
    "synthetic_small": (20_000, 5_000, 1_000_000),
    "synthetic_medium": (100_000, 30_000, 8_000_000),
}


def _from_csv(path: str) -> sp.csr_array:
    """userId,movieId,rating[,timestamp] ratings file -> URM."""
    raw = np.loadtxt(path, delimiter=",", skiprows=1, usecols=(0, 1, 2))
    users, user_idx = np.unique(raw[:, 0].astype(np.int64), return_inverse=True)
    items, item_idx = np.unique(raw[:, 1].astype(np.int64), return_inverse=True)
    return sp.csr_array(
        (raw[:, 2].astype(np.float32), (user_idx, item_idx)),
        shape=(len(users), len(items)),
    )


def _from_npz(path: str) -> sp.csr_array:
    m = sp.load_npz(path)
    return sp.csr_array(m.tocsr())


def load_file(path: str) -> sp.csr_array:
    """Parse a local ratings file by extension: .npz sparse matrix, anything
    else a MovieLens-format CSV. A .parquet event log raises."""
    if path.endswith(".npz"):
        return _from_npz(path)
    if path.endswith(".parquet"):
        raise ValueError(
            f"{path}: the port reads no parquet event log; convert it to a "
            "sparse .npz (scipy.sparse.save_npz of the user x item matrix) or a "
            "userId,movieId,rating CSV"
        )
    return _from_csv(path)


def load_urm(
    name: str, data_path: Optional[str] = None, seed: int = 0
) -> tuple[sp.csr_array, str]:
    """Resolve a dataset by name; returns (URM, provenance string)."""
    if data_path:
        return load_file(data_path), f"file:{data_path}"

    local_dir = os.path.join("data", name)
    if os.path.isdir(local_dir):
        for fname in ("ratings.npz", "urm.npz"):
            p = os.path.join(local_dir, fname)
            if os.path.exists(p):
                return _from_npz(p), f"file:{p}"
        for fname in ("ratings.csv", "multi_event.parquet"):
            p = os.path.join(local_dir, fname)
            if os.path.exists(p):
                return load_file(p), f"file:{p}"

    if name not in DATASETS:
        raise ValueError(
            f"unknown dataset '{name}'; known: {sorted(DATASETS)} "
            "(or pass --data-path)"
        )

    n_users, n_items, nnz = DATASETS[name]
    # the ML-32M stand-in with the default seed is parameter-identical to
    # the headline bench's dataset, whose file is tracked at the repository
    # root. Gated on the FULL generator parameter tuple (not just the
    # name): an edited DATASETS entry must never serve the old matrix (the
    # requested nnz cannot be validated after the fact: the generator
    # dedups)
    if (
        name == "movielens_32m"
        and seed == 0
        and (n_users, n_items, nnz) == (ML32M_USERS, ML32M_ITEMS, ML32M_NNZ)
    ):
        cache_path = REPO / ".bench_data_1.0.npz"
    else:
        SYNTH_DIR.mkdir(parents=True, exist_ok=True)
        cache_path = SYNTH_DIR / f".synth_{name}_{seed}_{nnz}.npz"
    urm, hit = cached_npz(
        str(cache_path),
        lambda: synthetic_urm(
            n_users=n_users, n_items=n_items, nnz=nnz, seed=seed
        ),
        expect_shape=(n_users, n_items),
    )
    suffix = ", disk cache" if hit else ""
    return urm, f"synthetic:{name} (published shape{suffix})"
