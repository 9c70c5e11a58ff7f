"""Host-side preprocessing for the S-Plus engine.

Port of ``similaripy_tpu/engine/preprocess.py``: the same validation, error
messages, normalization vectors and selector classification, with its own
sha1 content fingerprint (the JAX package keeps that in its executor).

Validation and normalization-vector construction mirroring the reference's
Cython preprocessing (reference: similaripy/cython_code/s_plus_utils.pyx):
  - input validation (:19-125)
  - squared norms (:169-201), cosine powers (:204-228), depop (:231-278)
  - binary-mode data swap (:281-308)
  - column selector classification NONE/ARRAY/MATRIX (:311-361) and
    array-mode target column resolution (:364-421)

All vector math is vectorized NumPy (cheap, O(nnz)); the heavy compute
happens on the device in executor.py. Array-mode column filtering is realized
as a device-side column mask instead of physically dropping matrix2 entries
(the reference's `_filter_matrix_columns` two-pass drop, :424-490) — masking
a candidate column is equivalent to removing its entries before top-K and
costs nothing on the dense-tile path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import hashlib

import numpy as np
import scipy.sparse as sp

from ..ops.csr import csr_col_sums, csr_row_sums, ensure_csr_f32
from . import spans

MODE_NONE = 0
MODE_ARRAY = 1
MODE_MATRIX = 2


def validate_s_plus_inputs(
    matrix1,
    matrix2,
    weight_depop_matrix1,
    weight_depop_matrix2,
    k,
    target_rows,
    filter_cols,
    target_cols,
    verbose,
    format_output,
) -> None:
    """Same checks and messages as reference s_plus_utils.pyx:19-125."""
    if not sp.issparse(matrix1):
        raise TypeError("matrix1 must be a sparse matrix")
    if not sp.issparse(matrix2):
        raise TypeError("matrix2 must be a sparse matrix")

    if matrix1.shape[1] != matrix2.shape[0]:
        raise ValueError(
            f"Incompatible matrix shapes: matrix1.shape[1]={matrix1.shape[1]} "
            f"must equal matrix2.shape[0]={matrix2.shape[0]}"
        )

    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")

    _validate_depop("weight_depop_matrix1", weight_depop_matrix1, matrix1.shape[0])
    _validate_depop("weight_depop_matrix2", weight_depop_matrix2, matrix2.shape[1])

    if target_rows is not None and len(target_rows) > matrix1.shape[0]:
        raise ValueError(
            f"target_rows length ({len(target_rows)}) cannot exceed "
            f"matrix1.shape[0] ({matrix1.shape[0]})"
        )

    for name, cols in (("filter_cols", filter_cols), ("target_cols", target_cols)):
        if cols is None:
            continue
        if not (sp.issparse(cols) or isinstance(cols, (list, np.ndarray))):
            raise TypeError(f"{name} must be a sparse matrix, list, numpy array, or None")
        if sp.issparse(cols) and cols.data.shape[0] != 0:
            expected_shape = (matrix1.shape[0], matrix2.shape[1])
            if cols.shape != expected_shape:
                raise ValueError(
                    f"{name} shape {cols.shape} does not match expected shape {expected_shape}"
                )

    if not isinstance(verbose, (bool, np.bool_)):
        raise TypeError(f"verbose must be boolean, got {type(verbose).__name__}")

    if format_output not in ("coo", "csr"):
        raise ValueError(f"format_output must be 'coo' or 'csr', got '{format_output}'")


def _validate_depop(name: str, spec, expected_len: int) -> None:
    """A depop weight is 'none' | 'sum' | a sequence of exactly expected_len.

    Anything without a length (scalars, generators) gets the same ValueError
    as a wrong-length array rather than a bare TypeError from len().
    """
    if isinstance(spec, str):
        if spec in ("none", "sum"):
            return
        got = f"'{spec}'"
    else:
        try:
            n = len(spec)
        except TypeError:
            got = f"type {type(spec).__name__}"
        else:
            if n == expected_len:
                return
            got = f"length {n}"
    raise ValueError(
        f"{name} must be array of length {expected_len} "
        f'or one of ("none", "sum"), got {got}'
    )


@dataclass
class Selector:
    """A filter_cols / target_cols specification after classification."""

    mode: int = MODE_NONE
    matrix: Optional[sp.csr_array] = None  # MODE_MATRIX: per-row column sets
    array: Optional[np.ndarray] = None  # MODE_ARRAY: global column indices


def build_column_selector(cols) -> Selector:
    """Classify filter/target spec (reference: s_plus_utils.pyx:311-361).

    A sparse spec becomes a CSR without explicit zeros and with sorted
    indices; the caller's matrix is never changed (``tocsr()`` of a CSR is
    the caller's own object), so it is copied when there is work to do."""
    if sp.issparse(cols) and cols.data.shape[0] != 0:
        m = cols.tocsr()
        if not (m.data.all() and m.has_sorted_indices):
            if m is cols:
                m = m.copy()
            m.eliminate_zeros()
            m.sort_indices()
        return Selector(mode=MODE_MATRIX, matrix=m)
    if isinstance(cols, (list, np.ndarray)) and len(cols) != 0:
        return Selector(mode=MODE_ARRAY, array=np.asarray(cols, dtype=np.int64))
    return Selector(mode=MODE_NONE)


def compute_col_allowed(
    filter_sel: Selector, target_sel: Selector, n_cols: int
) -> Optional[np.ndarray]:
    """Global boolean column mask for ARRAY-mode selectors.

    Mirrors `_compute_target_columns` (reference: s_plus_utils.pyx:364-421):
    target array restricts, filter array excludes; out-of-range indices are
    dropped; MATRIX-mode selectors are handled per-row on device instead.
    Returns None when no ARRAY-mode selector is present.
    """
    if filter_sel.mode != MODE_ARRAY and target_sel.mode != MODE_ARRAY:
        return None
    if target_sel.mode == MODE_ARRAY:
        mask = np.zeros(n_cols, dtype=bool)
        idx = target_sel.array
        idx = idx[(idx >= 0) & (idx < n_cols)]
        mask[idx] = True
    else:
        mask = np.ones(n_cols, dtype=bool)
    if filter_sel.mode == MODE_ARRAY:
        idx = filter_sel.array
        idx = idx[(idx >= 0) & (idx < n_cols)]
        mask[idx] = False
    return mask


@dataclass
class Preprocessed:
    """Everything the executor needs, in host NumPy form."""

    m1: sp.csr_array  # R x U, f32, zeros eliminated, binarized if requested
    m2: sp.csr_array  # U x C
    targets: np.ndarray  # (T,) int32
    k: int
    # full-content digests of the coerced input matrices, computed once per
    # call so downstream caches key on them without re-hashing hundreds of
    # MB (the binary flag and kernel params join them in every cache key)
    fp1: str = ""
    fp2: str = ""
    # normalization vectors, indexed by original row / col id (or None)
    Xt: Optional[np.ndarray] = None
    Yt: Optional[np.ndarray] = None
    Xc: Optional[np.ndarray] = None
    Yc: Optional[np.ndarray] = None
    Xd: Optional[np.ndarray] = None
    Yd: Optional[np.ndarray] = None
    col_allowed: Optional[np.ndarray] = None  # (C,) bool, ARRAY-mode selectors
    filter_matrix: Optional[sp.csr_array] = None  # MATRIX-mode exclusion
    target_matrix: Optional[sp.csr_array] = None  # MATRIX-mode inclusion
    n_output_rows: int = 0
    n_output_cols: int = 0
    # power-of-two scales making each matrix's data small integers (None when
    # not integerizable) — enables the exact int8 path (executor.py)
    qscale1: Optional[float] = None
    qscale2: Optional[float] = None
    # the call came from matrix2=None, i.e. m2 is exactly m1.T: the
    # symmetric executor keys on it (symmetric.symmetric_eligible)
    self_similar: bool = False


def _fingerprint(*arrays) -> str:
    """Full-content sha1 of the given arrays (shape, dtype and every byte),
    so in-place mutation of a SciPy matrix between calls is always seen.
    A traced call records it as a ``hash`` span with the bytes hashed."""
    with spans.span("hash") as span:
        h = hashlib.sha1()
        nbytes = 0
        for a in arrays:
            if a is None:
                h.update(b"\x00none")
                continue
            a = np.asarray(a)
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            if a.size:
                h.update(np.ascontiguousarray(a))
                nbytes += a.nbytes
        if spans.ACTIVE:
            span.attrs["bytes"] = nbytes
        return h.hexdigest()


_PREP_CACHE: dict = {}
_PREP_CACHE_CAP = 4
# lookups of the preprocess cache since the last clear_prep_cache()
_PREP_COUNTS = {"hits": 0, "misses": 0}


def clear_prep_cache():
    _PREP_CACHE.clear()
    _PREP_COUNTS.update(hits=0, misses=0)


def prep_cache_len() -> int:
    return len(_PREP_CACHE)


def prep_cache_counts() -> dict:
    """Hits and misses of the host preprocess cache."""
    return dict(_PREP_COUNTS)


def _prep_cache_key(fp1, fp2, depop1, depop2, p1, p2, c1, c2, l1, l2, l3,
                    additive_shrink, binary):
    d1 = depop1 if isinstance(depop1, str) else _fingerprint(np.asarray(depop1))
    d2 = depop2 if isinstance(depop2, str) else _fingerprint(np.asarray(depop2))
    return (fp1, fp2, d1, d2, p1, p2, c1, c2, l1, l2, l3,
            additive_shrink, binary)


def preprocess(
    matrix1,
    matrix2,
    *,
    weight_depop_matrix1="none",
    weight_depop_matrix2="none",
    p1: float = 0.0,
    p2: float = 0.0,
    c1: float = 0.5,
    c2: float = 0.5,
    l1: float = 0.0,
    l2: float = 0.0,
    l3: float = 0.0,
    k: int = 100,
    additive_shrink: float = 0.0,
    binary: bool = False,
    target_rows=None,
    filter_cols=None,
    target_cols=None,
    self_similar: bool = False,
) -> Preprocessed:
    """Build all device-ready inputs (reference flow: s_plus.pyx:168-346)."""
    with spans.span("coerce"):
        m1 = ensure_csr_f32(matrix1)
    fp1 = _fingerprint(m1.indptr, m1.indices, m1.data)
    if self_similar:
        # matrix2 is exactly m1.T — keep it a zero-copy CSC transpose
        # instead of materializing a second CSR (a full O(nnz) transpose
        # sort per call on big inputs); every executor consumes m2 through
        # csc_quantized/tocsc, which is then free
        m2 = m1.T
        fp2 = fp1 + ":T"
    else:
        with spans.span("coerce"):
            m2 = ensure_csr_f32(matrix2)
        fp2 = _fingerprint(m2.indptr, m2.indices, m2.data)

    # The O(nnz) artifacts (binary transform, norm vectors, quantization
    # scales) depend only on the matrices + kernel hyperparameters, not on
    # targets/selectors — cache them across calls (production scoring
    # reuses the same matrices every batch).
    cache_key = _prep_cache_key(
        fp1, fp2, weight_depop_matrix1, weight_depop_matrix2,
        p1, p2, c1, c2, l1, l2, l3, additive_shrink, binary,
    )
    hit = _PREP_CACHE.get(cache_key)
    _PREP_COUNTS["misses" if hit is None else "hits"] += 1
    if binary:
        # distinct digests: the transformed matrices differ from the raw
        # ones even though the raw bytes (and fp) are the same
        fp1, fp2 = fp1 + ":b", fp2 + ":b"

    if hit is None:
        if binary:
            # Set theory: all non-zero values become 1.0
            # (reference: s_plus_utils.pyx:299-304); zeros already eliminated.
            m1 = sp.csr_array(
                (np.ones_like(m1.data), m1.indices, m1.indptr), shape=m1.shape
            )
            if self_similar:
                m2 = m1.T
            else:
                m2 = sp.csr_array(
                    (np.ones_like(m2.data), m2.indices, m2.indptr), shape=m2.shape
                )

        Xt = Yt = Xc = Yc = Xd = Yd = None
        # --- normalization vectors (reference: s_plus.pyx:258-269) ---
        if l1 != 0.0 or l2 != 0.0:
            m1_sq = sp.csr_array(
                (m1.data * m1.data, m1.indices, m1.indptr), shape=m1.shape
            )
            m1_sq_norms = csr_row_sums(m1_sq)
            if self_similar:
                # column sums of m1.T**2 == row sums of m1**2
                m2_sq_norms = m1_sq_norms
            else:
                m2_sq = sp.csr_array(
                    (m2.data * m2.data, m2.indices, m2.indptr), shape=m2.shape
                )
                m2_sq_norms = csr_col_sums(m2_sq)
            if l1 != 0.0:
                Xt, Yt = m1_sq_norms, m2_sq_norms
            if l2 != 0.0:
                # additive shrink enters inside the pre-power norms
                # (reference: s_plus_utils.pyx:226-227)
                Xc = np.power(m1_sq_norms + additive_shrink, c1, dtype=np.float32)
                Yc = np.power(m2_sq_norms + additive_shrink, c2, dtype=np.float32)

        if l3 != 0.0:
            Xd = _depop_vector(weight_depop_matrix1, p1, m1, axis=1)
            Yd = _depop_vector(weight_depop_matrix2, p2, m2, axis=0)

        qs1 = quantize_scale(int8_values(m1))
        qs2 = quantize_scale(int8_values(m2))
        if len(_PREP_CACHE) >= _PREP_CACHE_CAP:
            _PREP_CACHE.pop(next(iter(_PREP_CACHE)))
        _PREP_CACHE[cache_key] = (m1, m2, (Xt, Yt, Xc, Yc, Xd, Yd), (qs1, qs2))
    else:
        m1, m2, (Xt, Yt, Xc, Yc, Xd, Yd), (qs1, qs2) = hit

    n_output_rows, n_output_cols = m1.shape[0], m2.shape[1]

    # k clamp (reference: s_plus.pyx:187-188)
    k = min(int(k), n_output_cols)

    if target_rows is None:
        targets = np.arange(m1.shape[0], dtype=np.int32)
    else:
        targets = np.ascontiguousarray(np.asarray(target_rows, dtype=np.int32))

    out = Preprocessed(
        m1=m1,
        m2=m2,
        targets=targets,
        k=k,
        fp1=fp1,
        fp2=fp2,
        n_output_rows=n_output_rows,
        n_output_cols=n_output_cols,
    )
    out.Xt, out.Yt, out.Xc, out.Yc, out.Xd, out.Yd = Xt, Yt, Xc, Yc, Xd, Yd
    out.qscale1, out.qscale2 = qs1, qs2
    out.self_similar = bool(self_similar)

    # --- column selectors (reference: s_plus.pyx:284-295) ---
    filter_sel = build_column_selector(filter_cols)
    target_sel = build_column_selector(target_cols)
    out.col_allowed = compute_col_allowed(filter_sel, target_sel, n_output_cols)
    if filter_sel.mode == MODE_MATRIX:
        out.filter_matrix = filter_sel.matrix
    if target_sel.mode == MODE_MATRIX:
        out.target_matrix = target_sel.matrix

    return out


def int8_values(m) -> np.ndarray:
    """The values an int8 densify of `m` holds: its entries and, when `m`
    repeats a (row, col), the sums of the repeats too.

    The coerced CSR keeps a non-canonical input's repeated entries, and
    every densify adds them (engine/scatter.py), so the int8 gate has to
    judge the sums or a repeat could wrap past 127. A canonical matrix
    returns its data without a copy."""
    if m.has_canonical_format:
        return m.data
    summed = m.copy()
    summed.sum_duplicates()
    return np.concatenate([m.data, summed.data])


def quantize_scale(data: np.ndarray) -> Optional[float]:
    """Smallest power-of-two s such that s*data is integral with |s*d| <= 127.

    Ratings data is typically half-star (s=2) or integer/binary (s=1); count
    data small integers. A hit arms the exact int8 path (executor.py).
    """
    if data.shape[0] == 0:
        return 1.0
    if np.abs(data).max() > 127:
        return None
    for s in (1.0, 2.0, 4.0, 8.0):
        scaled = data * s
        if np.abs(scaled).max() > 127:
            return None
        # exact integrality required: near-integral data (float noise) must
        # take the float path rather than be silently snapped to integers
        if (scaled == np.rint(scaled)).all():
            return s
    return None


def _depop_vector(spec, power: float, m: sp.csr_array, axis: int) -> np.ndarray:
    """Depop weights: 'none' -> ones, 'sum' -> axis sums ** p, array -> a ** p
    (reference: s_plus_utils.pyx:253-278)."""
    if isinstance(spec, (list, np.ndarray)):
        return np.power(np.asarray(spec), power, dtype=np.float32)
    if spec == "none":
        return np.ones(m.shape[0] if axis == 1 else m.shape[1], dtype=np.float32)
    if spec == "sum":
        if axis == 1:
            sums = csr_row_sums(m)
        elif isinstance(m, (sp.csc_array, sp.csc_matrix)):
            # lazy-transpose m2 (self-similarity): column sums of a CSC are
            # the row sums of its zero-copy CSR transpose
            sums = csr_row_sums(m.T)
        else:
            sums = csr_col_sums(m)
        return np.power(sums, power, dtype=np.float32)
    raise ValueError(f"Invalid depop weight spec: {spec}")
