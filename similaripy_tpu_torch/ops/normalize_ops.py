"""Device CSR normalization kernels as PyTorch segment ops.

Port of ``similaripy_tpu/ops/normalize_ops.py``. The reference implements
these as in-place Cython loops over CSR arrays (reference:
similaripy/cython_code/normalization.pyx:97-334); here the same math is a
few segment reductions (``index_add_`` / ``scatter_reduce``) plus an
elementwise rescale of the nnz data vector.

All functions take CSR *components* (data, indices, row_ids) as tensors on
one device and return the new data vector; the sparsity pattern never
changes. `row_ids` is the per-nnz row index.

TF / IDF mode tables follow the reference exactly
(normalization.pyx:12-24,47-94):
  tf:  binary | raw | sqrt | freq | log
  idf: unary | base | smooth | prob | bm25
Note the reference's smooth IDF is log(N / (1 + df)) — the code, not the
docs, is authoritative (normalization.pyx:90-91).
"""

from __future__ import annotations

import math

import torch

TF_MODES = ("binary", "raw", "sqrt", "freq", "log")
IDF_MODES = ("unary", "base", "smooth", "prob", "bm25")


def _segment_sum(values, segment_ids, num_segments: int):
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids, values)


def normalize_rows(data, row_ids, n_rows: int, norm: str):
    """L1 / L2 / max row normalization.

    Rows whose norm is 0 (or max <= 0, matching the reference's guard at
    normalization.pyx:193-195) are left untouched.
    """
    if norm == "l1":
        norms = _segment_sum(data.abs(), row_ids, n_rows)
        scale = torch.where(norms == 0.0, torch.ones_like(norms), norms)
    elif norm == "l2":
        norms = torch.sqrt(_segment_sum(data * data, row_ids, n_rows))
        scale = torch.where(norms == 0.0, torch.ones_like(norms), norms)
    elif norm == "max":
        norms = torch.full((n_rows,), -math.inf, dtype=data.dtype, device=data.device)
        norms.scatter_reduce_(0, row_ids, data, reduce="amax", include_self=False)
        scale = torch.where(norms > 0.0, norms, torch.ones_like(norms))
    else:  # pragma: no cover - validated at API layer
        raise ValueError(norm)
    return data / scale[row_ids]


def _tf(data, doc_len_per_nnz, mode: str, log_logbase: float):
    if mode == "binary":
        return (data != 0.0).to(data.dtype)
    if mode == "raw":
        return data
    if mode == "sqrt":
        return torch.sqrt(data)
    if mode == "freq":
        return data / doc_len_per_nnz
    # log
    return torch.log1p(data) / log_logbase


def _idf(df, n_docs: float, mode: str, log_logbase: float):
    if mode == "unary":
        return torch.ones_like(df)
    if mode == "base":
        return torch.log(n_docs / df) / log_logbase
    if mode == "smooth":
        return torch.log(n_docs / (1.0 + df)) / log_logbase
    if mode == "prob":
        return torch.log((n_docs - df) / df) / log_logbase
    # bm25
    return torch.log((n_docs - df + 0.5) / (df + 0.5)) / log_logbase


def _doc_stats(data, indices, row_ids, n_rows: int, n_cols: int):
    """doc_len (row sums of raw data) and df (count of data>0 per column),
    the reference's single pass at normalization.pyx:242-246."""
    doc_len = _segment_sum(data, row_ids, n_rows)
    df = _segment_sum((data > 0.0).to(data.dtype), indices, n_cols)
    return doc_len, df


def _idf_where(df, n_rows: int, idf_mode: str, log_logbase: float):
    # idf only where df != 0 (reference: normalization.pyx:248-250);
    # columns with no positive entries keep idf 0
    idf = _idf(df, float(n_rows), idf_mode, log_logbase)
    return torch.where(df != 0.0, idf, torch.zeros_like(df))


def _log_logbase(logbase, dtype) -> float:
    # log of the base rounded to the data's dtype, as the JAX package takes
    # jnp.log(jnp.asarray(logbase, f32))
    return float(torch.log(torch.tensor(logbase, dtype=dtype)))


def tfidf_data(data, indices, row_ids, n_rows: int, n_cols: int, tf_mode: str,
               idf_mode: str, logbase):
    log_logbase = _log_logbase(logbase, data.dtype)
    doc_len, df = _doc_stats(data, indices, row_ids, n_rows, n_cols)
    idf_vals = _idf_where(df, n_rows, idf_mode, log_logbase)
    tf_vals = _tf(data, doc_len[row_ids], tf_mode, log_logbase)
    return tf_vals * idf_vals[indices]


def bm25plus_data(data, indices, row_ids, n_rows: int, n_cols: int, k1, b,
                  delta, tf_mode: str, idf_mode: str, logbase):
    """BM25+ reweighting; BM25 is the delta=0 special case
    (reference: normalization.py:144-148, normalization.pyx:260-334)."""
    log_logbase = _log_logbase(logbase, data.dtype)
    doc_len, df = _doc_stats(data, indices, row_ids, n_rows, n_cols)
    idf_vals = _idf_where(df, n_rows, idf_mode, log_logbase)
    avg_doc_len = doc_len.sum() / n_rows
    norm_doc_len = (1.0 - b) + b * doc_len / avg_doc_len
    tf_vals = _tf(data, doc_len[row_ids], tf_mode, log_logbase)
    return idf_vals[indices] * (
        tf_vals * (k1 + 1.0) / (tf_vals + k1 * norm_doc_len[row_ids]) + delta
    )
