"""Output assembly: (T, k) top-K buffers -> SciPy COO / CSR.

Port of ``similaripy_tpu/engine/assembly.py``, NumPy/SciPy branch only
(the reference's native C++ assembly library is not part of the port).
Index width (int32 vs int64) is dispatched as in the reference
(utils.pyx:141-173).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..ops.csr import get_index_dtype


def assemble(
    vals: np.ndarray,  # (T, k) f32, -inf marks empty slots
    idx: np.ndarray,  # (T, k) int32 global column ids
    targets: np.ndarray,  # (T,) int32
    n_output_rows: int,
    n_output_cols: int,
    format_output: str,
):
    mask = vals > float("-inf")  # drops -inf and NaN slots
    flat_mask = mask.ravel()
    k = vals.shape[1]
    rows = np.repeat(targets.astype(np.int64, copy=False), k)[flat_mask]
    cols = idx.ravel()[flat_mask].astype(np.int64, copy=False)
    v = vals.ravel()[flat_mask]

    idx_dtype = get_index_dtype(max(int(v.shape[0]), n_output_cols, n_output_rows))
    rows = rows.astype(idx_dtype, copy=False)
    cols = cols.astype(idx_dtype, copy=False)

    if format_output == "coo":
        return sp.coo_array((v, (rows, cols)), shape=(n_output_rows, n_output_cols))

    # counting-sort COO -> CSR, duplicates preserved in stable row-major
    # order like the reference's coo_to_csr.h:28-71 (duplicate target_rows
    # keep one entry per occurrence instead of summing)
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(n_output_rows + 1, dtype=idx_dtype)
    np.cumsum(np.bincount(rows, minlength=n_output_rows), out=indptr[1:])
    res = sp.csr_array(
        (v[order], cols[order], indptr), shape=(n_output_rows, n_output_cols)
    )
    res.eliminate_zeros()  # reference: s_plus.pyx:423-424
    return res
