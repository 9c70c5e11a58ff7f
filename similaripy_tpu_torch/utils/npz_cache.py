"""Disk cache for deterministically generated sparse matrices.

A copy of ``similaripy_tpu/utils/npz_cache.py``. The synthetic benchmark
datasets (``utils/synth.py``) cost up to ~1 min to generate at ML-32M
scale; same generator + same seed -> same matrix, so a load from disk is
exact reuse. Shared by ``benchmarks/bench.py`` and
``benchmarks/dataset_loaders.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple


def cached_npz(
    path: str,
    generate: Callable,
    expect_shape: Optional[Tuple[int, int]] = None,
    expect_nnz: Optional[int] = None,
):
    """Load a CSR matrix from `path`, else generate + best-effort save.

    A cached file that does not match `expect_shape`/`expect_nnz` (the
    generator's parameters changed since it was written) is treated as a
    miss and regenerated — never silently benchmarked.
    Returns (matrix, hit: bool). All IO failures fall back to generation.
    """
    import os

    import scipy.sparse as sp

    if os.path.exists(path):
        try:
            m = sp.csr_array(sp.load_npz(path))
            if (expect_shape is None or m.shape == tuple(expect_shape)) and (
                expect_nnz is None or m.nnz == expect_nnz
            ):
                return m, True
        except Exception:
            pass
    m = generate()
    try:
        sp.save_npz(path, sp.csr_matrix(m))
    except Exception:
        pass
    return m, False
