"""Public normalization API: normalize (l1/l2/max), tfidf, bm25, bm25plus.

Port of ``similaripy_tpu/normalization.py``, which mirrors the reference
API surface and semantics (reference: similaripy/normalization.py:91-218):
SciPy sparse in/out, `axis` handled by transposition, `inplace` semantics,
mode validation with the same mode tables. The math runs on the device as
PyTorch segment ops (ops/normalize_ops.py).

float64 inputs are computed by a NumPy twin with the same formulas, as in
the JAX package; everything else computes in f32 on `device`.
"""

from __future__ import annotations

from math import e

import numpy as np
import scipy.sparse as sps

import torch

from .ops import normalize_ops as _ops
from .ops.csr import row_ids_from_indptr
from .utils.device import resolve_device

_NORMALIZATIONS = ("l1", "l2", "max")
_TF_MODES = _ops.TF_MODES
_IDF_MODES = _ops.IDF_MODES


# ---- private helpers (behavioral spec: reference normalization.py:23-87) ----


def _to_row_view(X, axis: int, inplace: bool):
    """CSR with the normalized axis laid out as rows.

    Accepts any SciPy sparse container (float data enforced, non-float input
    recast to f32), copies unless `inplace`, and transposes when axis == 0 so
    every kernel below only ever thinks in rows.
    """
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if not sps.issparse(X):
        raise TypeError("X must be a sparse matrix")
    if X.data.dtype not in (np.float32, np.float64):
        X = sps.csr_array(X, dtype=np.float32)
    elif not inplace:
        X = X.copy()
    return (X.T if axis == 0 else X).tocsr()


def _from_row_view(X, axis: int):
    """Undo _to_row_view's transposition; always hand back CSR."""
    return (X.T if axis == 0 else X).tocsr()


def _validate_modes(tf_mode: str, idf_mode: str) -> None:
    for name, value, allowed in (
        ("tf_mode", tf_mode, _TF_MODES),
        ("idf_mode", idf_mode, _IDF_MODES),
    ):
        if value not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got '{value}'")


def _apply_data_transform(X, fn_torch, fn_numpy, device):
    """Run a data-vector transform through PyTorch on `device` (f32) or
    NumPy (f64)."""
    if X.data.shape[0] == 0:
        return X
    row_ids = row_ids_from_indptr(X.indptr)
    if X.data.dtype == np.float64:
        X.data[:] = fn_numpy(X.data, X.indices, row_ids)
    else:
        new_data = fn_torch(
            torch.from_numpy(X.data).to(device),
            torch.from_numpy(X.indices.astype(np.int64)).to(device),
            torch.from_numpy(row_ids.astype(np.int64)).to(device),
        )
        X.data[:] = new_data.cpu().numpy().astype(X.data.dtype, copy=False)
    return X


# ---- NumPy fallbacks (float64 path; same formulas) ----


def _np_normalize(norm):
    def fn(data, indices, row_ids):
        if norm == "l1":
            norms = np.bincount(row_ids, weights=np.abs(data))
        elif norm == "l2":
            norms = np.sqrt(np.bincount(row_ids, weights=data * data))
        else:  # max
            n_rows = int(row_ids[-1]) + 1 if row_ids.size else 0
            norms = np.full(n_rows, -np.inf)
            np.maximum.at(norms, row_ids, data)
            norms = np.where(norms > 0, norms, 1.0)
            return data / norms[row_ids]
        norms = np.where(norms == 0, 1.0, norms)
        return data / norms[row_ids]

    return fn


def _np_tf(data, doc_len_per_nnz, mode, log_logbase):
    if mode == "binary":
        return (data != 0).astype(data.dtype)
    if mode == "raw":
        return data
    if mode == "sqrt":
        return np.sqrt(data)
    if mode == "freq":
        return data / doc_len_per_nnz
    return np.log1p(data) / log_logbase


def _np_idf(df, n_docs, mode, log_logbase):
    with np.errstate(divide="ignore", invalid="ignore"):
        if mode == "unary":
            return np.ones_like(df)
        if mode == "base":
            return np.log(n_docs / df) / log_logbase
        if mode == "smooth":
            return np.log(n_docs / (1.0 + df)) / log_logbase
        if mode == "prob":
            return np.log((n_docs - df) / df) / log_logbase
        return np.log((n_docs - df + 0.5) / (df + 0.5)) / log_logbase


def _np_doc_stats(data, indices, row_ids, n_rows, n_cols):
    doc_len = np.bincount(row_ids, weights=data, minlength=n_rows)
    df = np.bincount(indices, weights=(data > 0).astype(data.dtype), minlength=n_cols)
    return doc_len, df


# ---- Public API (signatures mirror reference normalization.py) ----


def normalize(X, norm: str = "l2", axis: int = 1, inplace: bool = False,
              device="cuda"):
    """Normalize a sparse matrix along rows or columns using L1, L2 or max-norm.

    Reference semantics: similaripy/normalization.py:91-113.
    """
    device = resolve_device(device)
    if norm not in _NORMALIZATIONS:
        raise ValueError(f"norm must be one of {_NORMALIZATIONS}, got '{norm}'")
    X = _to_row_view(X, axis, inplace)
    n_rows = X.shape[0]

    def fn_torch(data, indices, row_ids):
        return _ops.normalize_rows(data, row_ids, n_rows, norm)

    X = _apply_data_transform(X, fn_torch, _np_normalize(norm), device)
    return _from_row_view(X, axis)


def bm25(
    X,
    axis: int = 1,
    k1: float = 1.2,
    b: float = 0.75,
    logbase: float = e,
    tf_mode: str = "raw",
    idf_mode: str = "bm25",
    inplace: bool = False,
    device="cuda",
):
    """BM25 normalization = BM25+ with delta=0 (reference: normalization.py:116-149)."""
    return _bm25_family(X, axis, k1, b, 0.0, logbase, tf_mode, idf_mode, inplace, device)


def bm25plus(
    X,
    axis: int = 1,
    k1: float = 1.2,
    b: float = 0.75,
    delta: float = 1.0,
    logbase: float = e,
    tf_mode: str = "raw",
    idf_mode: str = "bm25",
    inplace: bool = False,
    device="cuda",
):
    """BM25+ normalization (reference: normalization.py:152-187)."""
    return _bm25_family(X, axis, k1, b, delta, logbase, tf_mode, idf_mode, inplace, device)


def _bm25_family(X, axis, k1, b, delta, logbase, tf_mode, idf_mode, inplace, device):
    device = resolve_device(device)
    _validate_modes(tf_mode, idf_mode)
    X = _to_row_view(X, axis, inplace)
    n_rows, n_cols = X.shape
    if n_rows == 0:
        return _from_row_view(X, axis)

    def fn_torch(data, indices, row_ids):
        return _ops.bm25plus_data(
            data, indices, row_ids, n_rows, n_cols, k1, b, delta, tf_mode, idf_mode, logbase
        )

    def fn_numpy(data, indices, row_ids):
        log_logbase = np.log(logbase)
        doc_len, df = _np_doc_stats(data, indices, row_ids, n_rows, n_cols)
        idf_vals = np.where(df != 0, _np_idf(df, float(n_rows), idf_mode, log_logbase), 0.0)
        avg_doc_len = doc_len.sum() / n_rows
        norm_doc_len = (1.0 - b) + b * doc_len / avg_doc_len
        tf_vals = _np_tf(data, doc_len[row_ids], tf_mode, log_logbase)
        return idf_vals[indices] * (tf_vals * (k1 + 1.0) / (tf_vals + k1 * norm_doc_len[row_ids]) + delta)

    X = _apply_data_transform(X, fn_torch, fn_numpy, device)
    return _from_row_view(X, axis)


def tfidf(
    X,
    axis: int = 1,
    logbase: float = e,
    tf_mode: str = "sqrt",
    idf_mode: str = "smooth",
    inplace: bool = False,
    device="cuda",
):
    """TF-IDF normalization (reference: normalization.py:190-218)."""
    device = resolve_device(device)
    _validate_modes(tf_mode, idf_mode)
    X = _to_row_view(X, axis, inplace)
    n_rows, n_cols = X.shape

    def fn_torch(data, indices, row_ids):
        return _ops.tfidf_data(data, indices, row_ids, n_rows, n_cols, tf_mode, idf_mode, logbase)

    def fn_numpy(data, indices, row_ids):
        log_logbase = np.log(logbase)
        doc_len, df = _np_doc_stats(data, indices, row_ids, n_rows, n_cols)
        idf_vals = np.where(df != 0, _np_idf(df, float(n_rows), idf_mode, log_logbase), 0.0)
        tf_vals = _np_tf(data, doc_len[row_ids], tf_mode, log_logbase)
        return tf_vals * idf_vals[indices]

    X = _apply_data_transform(X, fn_torch, fn_numpy, device)
    return _from_row_view(X, axis)
