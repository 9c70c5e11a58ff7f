"""Public similarity API: nine KNN similarity functions over sparse matrices.

Port of ``similaripy_tpu/similarity.py``; the functions are thin wrappers
over ``s_plus``.

Each function is a thin mapping of a named similarity onto the generalized
S-Plus kernel, with parameter mappings identical to the reference
(reference: similaripy/similarity.py):

  dot_product        all weights 0 (raw product)              (:49-64)
  cosine             l2=1, c1=0.5, c2=0.5                     (:106-112)
  asymmetric_cosine  l2=1, c1=alpha, c2=1-alpha               (:169-175)
  tversky            l1=1, t1=alpha, t2=beta                  (:232-237)
  jaccard            l1=1, t1=1, t2=1                         (:291-296)
  dice               l1=1, t1=0.5, t2=0.5                     (:350-355)
  p3alpha            L1-normalize rows + data**alpha, raw dot (:410-432)
  rp3beta            p3alpha + column-popularity penalty      (:477-503)
  s_plus             full parameterization                    (:568-592)

All functions accept the reference keyword surface plus the extensions
(compute_dtype, precision, mesh, device) forwarded to the engine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as _sp

from .engine import s_plus as _engine_s_plus
from .engine import spans as _spans
from .engine import splus as _splus
from .normalization import normalize as _normalize
from .ops import card_p3 as _card_p3
from .ops.csr import sparse_bytes as _sparse_bytes
from .utils.device import resolve_device as _resolve_device


def __get_shrink_values__(shrink: float, shrink_type: str):
    """Route one scalar into exactly one of three kernel shrink params
    (reference: similarity.py:595-617)."""
    stabilized_shrink = 0.0
    bayesian_shrink = 0.0
    additive_shrink = 0.0
    if shrink_type == "stabilized":
        stabilized_shrink = shrink
    elif shrink_type == "bayesian":
        bayesian_shrink = shrink
    elif shrink_type == "additive":
        additive_shrink = shrink
    else:
        raise ValueError(
            "shrink_type must be one of 'stabilized', 'bayesian', or 'additive'"
        )
    return stabilized_shrink, bayesian_shrink, additive_shrink


def _common_kwargs(
    k,
    shrink,
    shrink_type,
    threshold,
    binary,
    target_rows,
    target_cols,
    filter_cols,
    verbose,
    format_output,
    num_threads,
    block_size,
    extensions,
):
    stabilized, bayesian, additive = __get_shrink_values__(shrink, shrink_type)
    return dict(
        k=k,
        stabilized_shrink=stabilized,
        bayesian_shrink=bayesian,
        additive_shrink=additive,
        threshold=threshold,
        binary=binary,
        target_rows=target_rows,
        target_cols=target_cols,
        filter_cols=filter_cols,
        verbose=verbose,
        format_output=format_output,
        num_threads=num_threads,
        block_size=block_size,
        **extensions,
    )


def dot_product(
    matrix1,
    matrix2=None,
    k: int = 100,
    shrink: float = 0.0,
    shrink_type: str = "stabilized",
    threshold: float = 0.0,
    binary: bool = False,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """Top-K dot product similarity between rows of matrix1 and columns of
    matrix2 (matrix1.T when matrix2 is None)."""
    return _engine_s_plus(
        matrix1,
        matrix2=matrix2,
        **_common_kwargs(
            k, shrink, shrink_type, threshold, binary, target_rows, target_cols,
            filter_cols, verbose, format_output, num_threads, block_size, extensions,
        ),
    )


def cosine(
    matrix1,
    matrix2=None,
    k: int = 100,
    shrink: float = 0.0,
    shrink_type: str = "stabilized",
    threshold: float = 0.0,
    binary: bool = False,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """Top-K cosine similarity."""
    return _engine_s_plus(
        matrix1,
        matrix2=matrix2,
        l2=1,
        c1=0.5,
        c2=0.5,
        **_common_kwargs(
            k, shrink, shrink_type, threshold, binary, target_rows, target_cols,
            filter_cols, verbose, format_output, num_threads, block_size, extensions,
        ),
    )


def asymmetric_cosine(
    matrix1,
    matrix2=None,
    alpha: float = 0.5,
    k: int = 100,
    shrink: float = 0.0,
    shrink_type: str = "stabilized",
    threshold: float = 0.0,
    binary: bool = False,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """Top-K asymmetric cosine: alpha weighs matrix1's norm, 1-alpha matrix2's."""
    return _engine_s_plus(
        matrix1,
        matrix2=matrix2,
        l2=1,
        c1=alpha,
        c2=1 - alpha,
        **_common_kwargs(
            k, shrink, shrink_type, threshold, binary, target_rows, target_cols,
            filter_cols, verbose, format_output, num_threads, block_size, extensions,
        ),
    )


def tversky(
    matrix1,
    matrix2=None,
    alpha: float = 1.0,
    beta: float = 1.0,
    k: int = 100,
    shrink: float = 0.0,
    shrink_type: str = "stabilized",
    threshold: float = 0.0,
    binary: bool = False,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """Top-K Tversky similarity (alpha/beta weigh the set differences)."""
    return _engine_s_plus(
        matrix1,
        matrix2=matrix2,
        l1=1,
        t1=alpha,
        t2=beta,
        **_common_kwargs(
            k, shrink, shrink_type, threshold, binary, target_rows, target_cols,
            filter_cols, verbose, format_output, num_threads, block_size, extensions,
        ),
    )


def jaccard(
    matrix1,
    matrix2=None,
    k: int = 100,
    shrink: float = 0.0,
    shrink_type: str = "stabilized",
    threshold: float = 0.0,
    binary: bool = False,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """Top-K Jaccard similarity (intersection over union)."""
    return _engine_s_plus(
        matrix1,
        matrix2=matrix2,
        l1=1,
        t1=1,
        t2=1,
        **_common_kwargs(
            k, shrink, shrink_type, threshold, binary, target_rows, target_cols,
            filter_cols, verbose, format_output, num_threads, block_size, extensions,
        ),
    )


def dice(
    matrix1,
    matrix2=None,
    k: int = 100,
    shrink: float = 0.0,
    shrink_type: str = "stabilized",
    threshold: float = 0.0,
    binary: bool = False,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """Top-K Dice similarity (harmonic mean of overlap and size)."""
    return _engine_s_plus(
        matrix1,
        matrix2=matrix2,
        l1=1,
        t1=0.5,
        t2=0.5,
        **_common_kwargs(
            k, shrink, shrink_type, threshold, binary, target_rows, target_cols,
            filter_cols, verbose, format_output, num_threads, block_size, extensions,
        ),
    )


def p3alpha(
    matrix1,
    matrix2=None,
    alpha: float = 1.0,
    k: int = 100,
    shrink: float = 0.0,
    shrink_type: str = "stabilized",
    threshold: float = 0.0,
    binary: bool = False,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """Top-K P3alpha: 3-step random-walk similarity; cheap Python-side
    L1-normalize + power transform, then the raw-dot kernel
    (reference: similarity.py:410-432).

    Self-similar calls with shrink == 0 are algebraically refactored into
    a VALUE-SYMMETRIC product so the fast symmetric executor applies:
    (m_iu/r_i)^a (m_ju/c_u)^a = A_iu A_ju / r_i^a with
    A_iu = m_iu^a / c_u^(a/2) — one shared operand (A, A.T) plus a
    row-side depop r^a. Same scores; the JAX package takes this form for
    its symmetric executor. The transform runs on the call's device when it
    takes the input (``_p3_value_symmetric``)."""

    def transform():
        if matrix2 is None and shrink == 0 and not binary:
            return _p3_value_symmetric(matrix1, alpha, 0.0, extensions, popularity=False)
        return _p3_general(matrix1, matrix2, alpha, extensions) + (_ON_HOST,)

    return _transformed(
        (matrix1, matrix2), transform,
        _common_kwargs(
            k, shrink, shrink_type, threshold, binary, target_rows, target_cols,
            filter_cols, verbose, format_output, num_threads, block_size, extensions,
        ),
    )


def _sparse_footprint(matrices) -> dict:
    """The entries and the bytes (values, indices, pointers) of `matrices`
    (sparse or dense; None skipped)."""
    nnz = nbytes = 0
    for m in matrices:
        if m is None:
            continue
        if _sp.issparse(m):
            nnz += m.nnz
            nbytes += _sparse_bytes(m)
        else:
            a = np.asarray(m)
            nnz += int(np.count_nonzero(a))
            nbytes += a.nbytes
    return {"nnz": int(nnz), "bytes": int(nbytes)}


# the span attrs of a transform that ran on the host
_ON_HOST = {"where": "host", "upload_bytes": 0}


def _transformed(inputs, transform, common: dict):
    """One call of a similarity that transforms its inputs before s_plus:
    `transform()` gives (matrix1, its s_plus keyword arguments, where the
    work ran), then s_plus runs on them with the `common` ones. The
    value-symmetric P3 transform runs on the call's device when that takes
    the input, every other transform on the host. With ``splus.TIMING``
    on, the call's root span opens here, the transform runs in its child
    span ``transform`` (``attrs``: the ``nnz`` and ``bytes`` of `inputs`,
    the matrices it reads; ``where``, "card" or "host", where the work ran;
    ``upload_bytes``, what went up to the device, 0 on the host path) ahead
    of s_plus's laps, and s_plus opens no second root."""
    with _spans.call(_splus.TIMING):
        with _spans.span("transform") as span:
            matrix1, kwargs, where = transform()
            if _spans.ACTIVE:
                span.attrs.update(_sparse_footprint(inputs), **where)
        return _engine_s_plus(matrix1, **kwargs, **common)


def _p3_general(matrix1, matrix2, alpha, extensions):
    """The published transform: each side's rows L1-normalized, then raised
    to alpha; returns (matrix1, {matrix2})."""
    if matrix2 is None:
        matrix2 = matrix1.T
    device = extensions.get("device", "cuda")
    matrix1 = _normalize(matrix1, norm="l1", axis=1, inplace=False, device=device)
    matrix1.data = np.power(matrix1.data, alpha)
    matrix2 = _normalize(matrix2, norm="l1", axis=1, inplace=False, device=device)
    matrix2.data = np.power(matrix2.data, alpha)
    return matrix1, {"matrix2": matrix2}


def _p3_symmetric(matrix1, alpha, pop_m2, beta):
    """p3alpha/rp3beta as a value-symmetric self-similarity call; returns
    (A, its s_plus keyword arguments).

    A = m^alpha * c^(-alpha/2) per user column (c = user interaction
    sums); the row normalization becomes a row-side depop r^alpha and
    rp3beta's popularity penalty stays the column-side depop pop^beta.
    Exact for shrink == 0 (a nonzero stabilized shrink enters the
    denominator differently in the two formulations)."""
    m = matrix1.tocsr() if _sp.issparse(matrix1) else _sp.csr_matrix(matrix1)
    r = np.asarray(np.abs(m).sum(axis=1)).ravel().astype(np.float64)
    c = np.asarray(np.abs(m).sum(axis=0)).ravel().astype(np.float64)
    a_mat = m.astype(np.float64).copy()
    a_mat.data = np.power(a_mat.data, alpha)
    with np.errstate(divide="ignore"):
        cf = np.where(c > 0, np.power(c, -alpha / 2.0), 0.0)
    a_mat = _sp.csr_matrix(a_mat.multiply(cf[None, :]), dtype=np.float32)
    depop1 = np.power(np.where(r > 0, r, 1.0), alpha).astype(np.float32)
    return a_mat, _p3_kwargs(depop1, pop_m2, beta, m.shape[0])


def _p3_kwargs(depop1, pop_m2, beta, n_rows: int) -> dict:
    """The s_plus keyword arguments of the value-symmetric form."""
    kwargs = dict(
        matrix2=None,
        weight_depop_matrix1=depop1,
        p1=1.0,
        l3=1,
    )
    if pop_m2 is not None:
        kwargs.update(weight_depop_matrix2=pop_m2, p2=beta)
    else:
        kwargs.update(weight_depop_matrix2=np.ones(n_rows, np.float32),
                      p2=1.0)
    return kwargs


def _p3_value_symmetric(matrix1, alpha, beta, extensions, popularity: bool):
    """The value-symmetric form of a p3alpha (`popularity` False) or
    rp3beta call: (A, its s_plus keyword arguments, the ``transform``
    span's ``where`` and ``upload_bytes``). On the call's device when it
    takes the input (``ops/card_p3.py``: a CSC, CSR or COO with entries and
    no repeated (row, col)); else the host form ``_p3_symmetric``, with the
    popularity from the signed sum, matching the reference's
    pop_m2 = m2.sum(axis=0) (similarity.py:479) and the general path."""
    device = _resolve_device(extensions.get("device", "cuda"))
    got = _card_p3.transform(matrix1, alpha, device, popularity)
    if got is None:
        pop = (np.asarray(matrix1.T.sum(axis=0)).ravel().astype(np.float32)
               if popularity else None)
        return _p3_symmetric(matrix1, alpha, pop, beta) + (_ON_HOST,)
    where = {"where": "card" if device.type == "cuda" else "host",
             "upload_bytes": got.upload_bytes}
    return got.a, _p3_kwargs(got.depop1, got.pop, beta, matrix1.shape[0]), where


def rp3beta(
    matrix1,
    matrix2=None,
    alpha: float = 1.0,
    beta: float = 1.0,
    k: int = 100,
    shrink: float = 0.0,
    shrink_type: str = "stabilized",
    threshold: float = 0.0,
    binary: bool = False,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """Top-K RP3beta: P3alpha with item-popularity penalization
    (reference: similarity.py:477-503). Self-similar shrink-free calls
    take the value-symmetric refactoring (see p3alpha)."""

    def transform():
        if matrix2 is None and shrink == 0 and not binary:
            return _p3_value_symmetric(matrix1, alpha, beta, extensions, popularity=True)
        pop_m2 = np.asarray((matrix1.T if matrix2 is None else matrix2).sum(axis=0)).ravel()
        m1, kwargs = _p3_general(matrix1, matrix2, alpha, extensions)
        return m1, dict(kwargs, weight_depop_matrix2=pop_m2, p2=beta, l3=1), _ON_HOST

    return _transformed(
        (matrix1, matrix2), transform,
        _common_kwargs(
            k, shrink, shrink_type, threshold, binary, target_rows, target_cols,
            filter_cols, verbose, format_output, num_threads, block_size, extensions,
        ),
    )


def s_plus(
    matrix1,
    matrix2=None,
    l1: float = 0.5,
    l2: float = 0.5,
    l3: float = 0.0,
    t1: float = 1.0,
    t2: float = 1.0,
    c1: float = 0.5,
    c2: float = 0.5,
    pop1="none",
    pop2="none",
    alpha: float = 1.0,
    beta1: float = 0.0,
    beta2: float = 0.0,
    k: int = 100,
    shrink: float = 0.0,
    shrink_type: str = "stabilized",
    threshold: float = 0.0,
    binary: bool = False,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """The S-Plus hybrid: Tversky + cosine normalization with RP3beta-style
    depopularization, fully controlled by tunable weights
    (reference: similarity.py:506-592)."""
    return _engine_s_plus(
        matrix1,
        matrix2=matrix2,
        l1=l1,
        l2=l2,
        l3=l3,
        t1=t1,
        t2=t2,
        c1=c1,
        c2=c2,
        a1=alpha,
        weight_depop_matrix1=pop1,
        weight_depop_matrix2=pop2,
        p1=beta1,
        p2=beta2,
        **_common_kwargs(
            k, shrink, shrink_type, threshold, binary, target_rows, target_cols,
            filter_cols, verbose, format_output, num_threads, block_size, extensions,
        ),
    )


def recommend(
    urm,
    model,
    k: int = 10,
    *,
    exclude_seen: bool = True,
    threshold: float = 0.0,
    target_rows=None,
    target_cols=None,
    filter_cols=None,
    verbose: bool = True,
    format_output: str = "coo",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    **extensions,
):
    """Rank the top-k items for every user of a URM with an item-item model.

    Convenience wrapper for the recommendation idiom the reference
    demonstrates (reference: README.md:86-94 and
    notebooks/movielens32m_item_item_recommender.ipynb cell 37):

        scores(u, j) = sum_i urm[u, i] * model[j, i]
                     = dot_product(urm, model.T)[u, j]

    with each user's already-seen items excluded before the top-k
    (``filter_cols=urm``). Not part of the reference's public API — it is
    sugar over :func:`dot_product` and accepts the same keyword surface.
    The exclusion runs as the exclude-seen fold
    (``engine/executor.py::_exclude_seen_fold``): the scores are taken
    against ``model.T - M*I``, which pushes every seen item far below any
    threshold >= 0 and leaves unseen items exact, so no per-row filter mask
    is built. Its gate needs every ``urm`` value > 0, a float compute type,
    the plain dot-product epilogue and a threshold >= 0; otherwise the
    exclusion runs as a per-row filter mask inside the tile kernel.

    Args:
        urm: sparse (users x items) interaction matrix.
        model: sparse (items x items) similarity, rows = target item —
            exactly what the nine similarity functions return for
            ``sim.cosine(urm.T, ...)``.
        k: recommendations per user.
        exclude_seen: mask each user's nonzero ``urm`` columns before the
            top-k (on by default). An additional sparse ``filter_cols``
            is combined with it; an array-form ``filter_cols`` cannot be
            (pass ``exclude_seen=False`` and pre-combine instead).

    Returns:
        Sparse (users x items) matrix with k scored items per computed row.
    """
    import scipy.sparse as _sp

    if model.shape[0] != model.shape[1] or model.shape[0] != urm.shape[1]:
        raise ValueError(
            f"model must be (items x items) = ({urm.shape[1]}, "
            f"{urm.shape[1]}) to match the URM's item axis, got {model.shape}"
        )
    if exclude_seen:
        if filter_cols is None:
            filter_cols = urm
        elif _sp.issparse(filter_cols):
            filter_cols = (
                filter_cols.tocsr().astype(bool) + urm.tocsr().astype(bool)
            ).astype(np.float32)
        else:
            raise ValueError(
                "exclude_seen=True cannot be combined with an array-form "
                "filter_cols; pass exclude_seen=False and include the seen "
                "items in your filter matrix instead"
            )
    return dot_product(
        urm,
        model.T.tocsr(),
        k=k,
        threshold=threshold,
        target_rows=target_rows,
        target_cols=target_cols,
        filter_cols=filter_cols,
        verbose=verbose,
        format_output=format_output,
        num_threads=num_threads,
        block_size=block_size,
        **extensions,
    )


# ---------------------------------------------------------------------------
# Shared parameter documentation (appended to every public function; the
# reference documents this surface on each of the nine functions)
# ---------------------------------------------------------------------------

_COMMON_DOC = """

    Args:
        matrix1: SciPy sparse matrix (rows are the similarity subjects).
        matrix2: optional second sparse matrix; defaults to ``matrix1.T``
            (item-item similarity). Shapes must chain:
            ``matrix1.shape[1] == matrix2.shape[0]``.
        k: neighbors kept per row (clamped to the output column count).
        shrink: shrinkage strength, routed by ``shrink_type``.
        shrink_type: 'stabilized' (added to the denominator), 'bayesian'
            (multiplies by xy^a/(xy^a + shrink)), or 'additive' (added to
            the squared norms before the cosine powers).
        threshold: minimum score kept (applied before top-K).
        binary: set-theoretic mode — every stored value becomes 1.
        target_rows: compute only these rows (list/array of row ids;
            duplicates and arbitrary order allowed).
        target_cols: restrict output columns — a list/array applies
            globally, a sparse (rows x cols) matrix applies per-row.
        filter_cols: exclude output columns — same forms as target_cols;
            pass the URM itself to mask each user's seen items.
        verbose: render the staged progress bar.
        format_output: 'coo' (default) or 'csr'.
        num_threads: accepted for API compatibility and ignored — the
            parallelism is the device grid.
        block_size: column-tile width hint. None disables tiling,
            0 (default) lets the planner choose, an int pins the width.

    Extensions (keyword-only, via ``**extensions``):
        compute_dtype: 'auto' (default — exact int8 path when both
            matrices integerize to |v| <= 127, else float32), 'float32',
            'bfloat16', or 'int8'.
        precision: 'highest' (default), 'high' or 'default'; a minimum
            guarantee. 'highest' and 'default' run float32 products in
            true f32; 'high' runs them in split-bf16x3 (hi.hi + lo.hi +
            hi.lo in bf16 on the tensor cores, summed in f32; one phase
            fewer where one side is exact in bf16, plain bf16 where both
            are), as the JAX package does.
        device: 'cuda' (default) or 'cpu'; 'cuda' without a card raises
            RuntimeError.
        mesh: a ('rows', 'cols') DeviceMesh from
            ``similaripy_tpu_torch.parallel.make_mesh`` (torch.distributed:
            NCCL on cards, gloo on the CPU). Every rank makes the same call
            and gets the whole result; ``device`` is the rank's own device.

    Returns:
        SciPy sparse matrix of shape
        ``(matrix1.shape[0], matrix2.shape[1])`` holding each computed
        row's top-k scores.
"""

for _fn in (dot_product, cosine, asymmetric_cosine, tversky, jaccard, dice,
            p3alpha, rp3beta, s_plus):
    _fn.__doc__ = (_fn.__doc__ or "") + _COMMON_DOC
del _fn
