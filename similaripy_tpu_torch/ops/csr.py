"""Host-side CSR utilities (a copy of ``similaripy_tpu/ops/csr.py``).

Fast vectorized NumPy plumbing between SciPy sparse inputs and the device
tile format. Mirrors the semantics of the reference's Cython CSR helpers
(reference: similaripy/cython_code/s_plus_utils.pyx:128-166 csr_sum,
utils.pyx:28-40 index-width dispatch) without the scalar loops.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def ensure_csr_f32(matrix) -> sp.csr_array:
    """Coerce to canonical CSR: float32 data, zeros eliminated.

    The reference eliminates zeros before compute to make binary mode and
    zero-division behavior well-defined (reference: s_plus.pyx:205-211).
    The result shares the input's arrays where it can; the caller's matrix
    is never changed: an input holding explicit zeros is copied before
    they are eliminated, in place.
    """
    m = matrix.tocsr() if not isinstance(matrix, (sp.csr_array, sp.csr_matrix)) else matrix
    if not isinstance(m, (sp.csr_array, sp.csr_matrix)):
        m = sp.csr_array(m)
    data = m.data.astype(np.float32, copy=False)
    out = sp.csr_array((data, m.indices, m.indptr), shape=m.shape)
    if not data.all():
        out = out.copy()
        out.eliminate_zeros()
    return out


def sparse_bytes(matrix) -> int:
    """Bytes of the arrays of a SciPy sparse matrix: values, indices and
    pointers, or coordinates."""
    return sum(a.nbytes for a in (getattr(matrix, n, None) for n in
                                  ("data", "indices", "indptr", "row", "col"))
               if isinstance(a, np.ndarray))


def get_index_dtype(maxval: int):
    """int32 when it fits, else int64 (reference: utils.pyx:28-40)."""
    if maxval <= np.iinfo(np.int32).max:
        return np.int32
    return np.int64


def row_ids_from_indptr(indptr: np.ndarray, nnz: int | None = None) -> np.ndarray:
    """Expand a CSR indptr into a per-nnz row-id array (for segment ops)."""
    indptr = np.asarray(indptr)
    n_rows = indptr.shape[0] - 1
    counts = np.diff(indptr)
    return np.repeat(np.arange(n_rows, dtype=np.int32), counts)


def csr_row_sums(m: sp.csr_array) -> np.ndarray:
    """Row sums, float32; empty rows are 0 (reference: s_plus_utils.pyx:151-159)."""
    indptr = m.indptr
    nnz = m.data.shape[0]
    out = np.zeros(m.shape[0], dtype=np.float32)
    if nnz == 0:
        return out
    # reduceat only over non-empty row starts: every start is < nnz and the
    # starts are strictly increasing, so each segment covers exactly one
    # row's data (empty rows contribute no elements between two starts)
    nonempty = np.flatnonzero(np.diff(indptr) > 0)
    sums = np.add.reduceat(
        m.data.astype(np.float32, copy=False),
        indptr[:-1][nonempty].astype(np.int64),
    )
    out[nonempty] = sums.astype(np.float32, copy=False)
    return out


def csr_col_sums(m: sp.csr_array) -> np.ndarray:
    """Column sums via bincount (reference: s_plus_utils.pyx:160-164)."""
    out = np.bincount(
        m.indices, weights=m.data.astype(np.float64, copy=False), minlength=m.shape[1]
    )
    return out.astype(np.float32, copy=False)


def csc_quantized(m, qscale=None) -> sp.csc_array:
    """CSC view of `m`, with data optionally snapped to the int8 grid.

    When `qscale` is given, returns a NEW csc_array sharing `m`'s index
    structure but carrying rint(data * qscale) — never mutating the input.
    This matters because ``m`` may be a zero-copy transpose sharing buffers
    with the caller's matrix (preprocess keeps ``m1.T`` lazy for
    self-similarity calls), so the old in-place ``m_csc.data = ...`` pattern
    would corrupt cached inputs.
    """
    m_csc = m if isinstance(m, (sp.csc_array, sp.csc_matrix)) else m.tocsc()
    if qscale is None:
        return m_csc
    data = np.rint(m_csc.data * qscale).astype(np.float32)
    return sp.csc_array(
        (data, m_csc.indices, m_csc.indptr), shape=m_csc.shape
    )
