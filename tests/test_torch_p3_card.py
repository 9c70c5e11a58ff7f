"""The value-symmetric P3 transform on the call's device (ops/card_p3.py)
against the host form it stands in for (similarity.py::_p3_symmetric):
A element for element (as ensure_csr_f32 makes the host's A, which s_plus
does), the row depop r^alpha and rp3beta's popularity, bit-equal on half
stars; on float values the popularity within a float32 ulp of the exact
sums, A and r^alpha within two; the inputs the device
leaves to the host; the public p3alpha and rp3beta calls against the host
path; the ``transform`` span's ``where`` and ``upload_bytes``. Runs on the
CPU; the last test repeats the comparison on a card and skips without one.
No JAX is needed:
    python -m pytest tests/test_torch_p3_card.py --noconftest -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu_torch as tsim
from similaripy_tpu_torch import similarity
from similaripy_tpu_torch.engine import spans, splus
from similaripy_tpu_torch.ops import card_p3
from similaripy_tpu_torch.ops.csr import ensure_csr_f32

CPU = torch.device("cpu")
BETA = 0.6


def _parts(n_rows, n_cols, nnz, seed, zeros=0, empty_row=None, empty_col=None, values="half"):
    """Distinct (row, col) pairs in no order with their values: half stars,
    signed half stars, floats or small integers; `zeros` explicit zeros, and
    one empty row and column when asked."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    if empty_row is not None:
        rows[rows == empty_row] = (empty_row + 1) % n_rows
    if empty_col is not None:
        cols[cols == empty_col] = (empty_col + 1) % n_cols
    key = rng.permutation(np.unique(rows * n_cols + cols))
    rows, cols = key // n_cols, key % n_cols
    n = rows.shape[0]
    vals = {
        "half": lambda: rng.integers(1, 11, n) * 0.5,
        "signed": lambda: rng.choice([-1.0, 1.0], n) * rng.integers(1, 11, n) * 0.5,
        "float": lambda: rng.uniform(0.01, 5.0, n),
        "int": lambda: rng.integers(1, 6, n),
    }[values]()
    vals[rng.choice(n, zeros, replace=False)] = 0
    return rows, cols, vals


def _coo(n_rows=40, n_cols=30, nnz=300, seed=0, index=np.int32, dtype=np.float32, **kw):
    rows, cols, vals = _parts(n_rows, n_cols, nnz, seed, **kw)
    return sp.coo_array((vals.astype(dtype), (rows.astype(index), cols.astype(index))),
                        shape=(n_rows, n_cols))


def _compress(c, fmt, shuffled=False):
    """The entries of the COO `c`, repeats kept, as a CSC or CSR: each
    column's (row's) entries in their order in `c` when `shuffled`, else
    sorted."""
    major, minor = (c.col, c.row) if fmt == "csc" else (c.row, c.col)
    n_major = c.shape[1] if fmt == "csc" else c.shape[0]
    order = np.argsort(major, kind="stable") if shuffled else np.lexsort((minor, major))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(major, minlength=n_major))])
    cls = sp.csc_array if fmt == "csc" else sp.csr_array
    return cls((c.data[order], minor[order], indptr.astype(c.row.dtype)), shape=c.shape)


def _compressed(fmt, shuffled=False, **kw):
    return _compress(_coo(**kw), fmt, shuffled)


def _with_repeats(fmt):
    """A matrix of `fmt` that stores one (row, col) twice."""
    c = _coo(seed=5)
    rep = sp.coo_array((np.append(c.data, np.float32(2.5)),
                        (np.append(c.row, c.row[0]), np.append(c.col, c.col[0]))), shape=c.shape)
    return rep if fmt == "coo" else _compress(rep, fmt)


# half-star (or integer) inputs: the device's results are bit-equal to the host's
EXACT = {
    "csc": lambda: _compressed("csc"),
    "csr": lambda: _compressed("csr"),
    "coo": lambda: _coo(),
    "csc_int64": lambda: _compressed("csc", index=np.int64, seed=1),
    "coo_int64": lambda: _coo(index=np.int64, seed=2),
    "csc_unsorted_rows": lambda: _compressed("csc", shuffled=True, seed=3),
    "csr_unsorted_cols": lambda: _compressed("csr", shuffled=True, seed=4),
    "csc_zeros": lambda: _compressed("csc", zeros=25, seed=6),
    "coo_zeros": lambda: _coo(zeros=25, seed=7),
    "csc_empty_row_col": lambda: _compressed("csc", empty_row=3, empty_col=7, seed=8),
    "csc_signed": lambda: _compressed("csc", values="signed", seed=9),
    "csr_int_values": lambda: _compressed("csr", values="int", dtype=np.int64, seed=10),
    "csc_bool_values": lambda: _compressed("csc", values="int", dtype=np.bool_, seed=11),
    "csc_matrix": lambda: sp.csc_matrix(_compressed("csc", zeros=5, seed=12)),
    "ratings_T": lambda: _compressed("csr", n_rows=60, n_cols=25, nnz=400, seed=13).T,
}
# float values: near the exact transform (float64 sums; _within_exact)
FLOAT = {
    "csc_float32": lambda: _compressed("csc", values="float", seed=20),
    "csr_float32": lambda: _compressed("csr", values="float", seed=21),
    "coo_float32": lambda: _coo(values="float", seed=22),
    "csc_float64": lambda: _compressed("csc", values="float", dtype=np.float64, seed=23),
}
# what the device leaves to the host
HOST_ONLY = {
    "dense": lambda: _compressed("csr", zeros=5).toarray(),
    "coo_repeats": lambda: _with_repeats("coo"),
    "csc_repeats": lambda: _with_repeats("csc"),
    "csr_repeats": lambda: _with_repeats("csr"),
    "empty": lambda: sp.csc_array((40, 30), dtype=np.float32),
}


def _host(m, alpha):
    """The host form's (A as s_plus sees it, depop1, popularity)."""
    pop = np.asarray(m.T.sum(axis=0)).ravel().astype(np.float32)
    a, kwargs = similarity._p3_symmetric(m, alpha, pop, BETA)
    return ensure_csr_f32(a), kwargs["weight_depop_matrix1"], kwargs["weight_depop_matrix2"]


def _arrays(m):
    names = ("data", "indices", "indptr") if m.format != "coo" else ("data", "row", "col")
    return [(n, getattr(m, n).copy()) for n in names]


def _assert_pattern(got, want):
    assert type(got) is sp.csr_array and got.shape == want.shape
    assert got.has_canonical_format and got.has_sorted_indices
    for name in ("indptr", "indices"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.data.dtype == want.data.dtype == np.float32


def _within_ulps(got, want, ulps=1):
    """`got` (float32) within `ulps` float32 ulps of `want`, NaN where it is NaN."""
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    w = want[ok].astype(np.float64)
    assert np.all(np.abs(got[ok] - w) <= ulps * np.spacing(np.abs(w).astype(np.float32)))


def _exact(m, alpha):
    """The transform with exact (float64) sums: (A's values in CSR order,
    depop1, popularity), each before its rounding to float32."""
    c = m.tocoo()
    v = c.data.astype(np.float64)
    r = np.bincount(c.row, np.abs(v), m.shape[0])
    s = np.bincount(c.col, np.abs(v), m.shape[1])
    pop = np.bincount(c.row, v, m.shape[0])
    cf = np.where(s > 0, np.power(np.maximum(s, 1e-300), -alpha / 2), 0.0)
    a = np.power(v, alpha) * cf[c.col]
    order = np.lexsort((c.col, c.row))
    a = a[order]
    return a[a != 0], np.power(np.where(r > 0, r, 1.0), alpha), pop


def _within_exact(got, exact):
    """The popularity, a sum rounded once, within an ulp of the exact sum;
    A and r^alpha, powers of such sums (a rounding error d of a sum becomes
    alpha * d in its power, then the power is rounded), within two."""
    a, depop1, pop = exact
    _within_ulps(got.pop, pop)
    _within_ulps(got.depop1, depop1, ulps=2)
    _within_ulps(got.a.data, a, ulps=2)


@pytest.mark.parametrize("alpha", [1.0, 0.8, 0.0])
@pytest.mark.parametrize("name", list(EXACT))
def test_device_transform_is_bit_equal_to_the_host(name, alpha):
    m = EXACT[name]()
    saved = _arrays(m)
    got = card_p3.transform(m, alpha, CPU, popularity=True)
    for n, a in saved:  # the caller's arrays as they were
        np.testing.assert_array_equal(getattr(m, n), a)
    a, depop1, pop = _host(m, alpha)
    _assert_pattern(got.a, a)
    np.testing.assert_array_equal(got.a.data, a.data)
    assert got.depop1.dtype == got.pop.dtype == np.float32
    np.testing.assert_array_equal(got.depop1, depop1)
    np.testing.assert_array_equal(got.pop, pop)
    if name == "csc_signed" and alpha == 0.8:  # negative values: NaN where the host has it
        assert np.isnan(got.a.data).any()
    if "zeros" in name:  # the power runs on the stored zeros: 0^0 = 1 keeps them
        assert (got.a.nnz == m.nnz) == (alpha == 0.0)
    if name == "csc_empty_row_col":
        assert np.diff(got.a.indptr)[3] == 0 and 7 not in got.a.indices
        assert depop1[3] == 1.0 and pop[3] == 0.0


@pytest.mark.parametrize("alpha", [1.0, 0.8])
@pytest.mark.parametrize("name", list(FLOAT))
def test_device_transform_is_near_the_exact_one_on_float_values(name, alpha):
    m = FLOAT[name]()
    saved = _arrays(m)
    got = card_p3.transform(m, alpha, CPU, popularity=True)
    for n, a in saved:
        np.testing.assert_array_equal(getattr(m, n), a)
    a, depop1, pop = _host(m, alpha)
    _assert_pattern(got.a, a)
    _within_exact(got, _exact(m, alpha))
    # the host's float32 running sums err by a few ulps themselves
    for g, w in ((got.a.data, a.data), (got.depop1, depop1), (got.pop, pop)):
        _within_ulps(g, w, ulps=4)


def test_popularity_is_left_out_unless_asked():
    m = EXACT["csc"]()
    got = card_p3.transform(m, 1.0, CPU)
    assert got.pop is None
    # the upload: the CSC's three arrays and the columns' factors
    want = m.data.nbytes + m.indices.nbytes + m.indptr.nbytes + 8 * m.shape[1]
    assert got.upload_bytes == want


def _traced(fn):
    splus.TIMING = True
    try:
        return fn()
    finally:
        splus.TIMING = False


@pytest.fixture
def _clean(monkeypatch):
    monkeypatch.setattr(splus, "TIMING", False)
    tsim.clear_caches()
    spans.clear()
    yield
    tsim.clear_caches()
    spans.clear()


def _transform_span():
    return next(s for s in spans.log() if s.name == "transform")


@pytest.mark.parametrize("name", list(HOST_ONLY))
def test_inputs_the_device_leaves_to_the_host(name, _clean, monkeypatch):
    m = HOST_ONLY[name]()
    assert card_p3.transform(m, 1.0, CPU, popularity=True) is None
    # the same entries as one canonical CSR, repeats summed as SciPy sums
    # them on the host (built first: SciPy sums a CSR's repeats in place)
    same = sp.csr_array(HOST_ONLY[name]())
    same.sum_duplicates()
    host_form = similarity._p3_symmetric
    calls = []
    monkeypatch.setattr(similarity, "_p3_symmetric", lambda *a: calls.append(1) or host_form(*a))
    kw = dict(alpha=1.0, beta=BETA, k=5, device="cpu", verbose=False)
    got = _traced(lambda: tsim.rp3beta(m, **kw))
    span = _transform_span()
    assert calls == [1] and (span.attrs["where"], span.attrs["upload_bytes"]) == ("host", 0)
    if name == "empty":
        assert got.nnz == 0
        return
    tsim.clear_caches()
    want = tsim.rp3beta(same, **kw)  # the device path
    assert calls == [1] and got.nnz == want.nnz
    np.testing.assert_allclose(_check_sum(got), _check_sum(want), rtol=1e-4)


def _ratings(users=600, items=300, seed=0):
    """Half stars, users x items, the items' popularity skewed."""
    rng = np.random.default_rng(seed)
    weight = 1.0 / np.arange(1, items + 1) ** 0.7
    rows, cols = [], []
    for u, n in enumerate(rng.integers(3, 40, users)):
        cols.append(rng.choice(items, size=n, replace=False, p=weight / weight.sum()))
        rows.append(np.full(n, u))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.integers(1, 11, rows.shape[0]).astype(np.float32) / 2
    return sp.csr_array((vals, (rows, cols)), shape=(users, items))


URM = _ratings()
SOME = np.arange(1, URM.shape[1], 7)


def _check_sum(x):
    return np.sum(np.asarray(x.sum(axis=1)).ravel() ** 2)


CALLS = {
    "p3alpha": lambda m, **kw: tsim.p3alpha(m, alpha=0.8, **kw),
    "rp3beta": lambda m, **kw: tsim.rp3beta(m, alpha=1.0, beta=BETA, **kw),
}
FORMATS = {"csc": lambda: URM.T, "csr": lambda: URM.T.tocsr(), "coo": lambda: URM.T.tocoo()}


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("targets", ["all", "some"])
@pytest.mark.parametrize("fn", list(CALLS))
def test_public_calls_equal_the_host_path(fn, targets, precision, fmt, _clean, monkeypatch):
    m = FORMATS[fmt]()
    kw = dict(k=20, precision=precision, device="cpu", verbose=False,
              target_rows=None if targets == "all" else SOME)
    got = _traced(lambda: CALLS[fn](m, **kw))
    span = _transform_span()
    assert span.attrs["where"] == "host" and span.attrs["upload_bytes"] > 0  # the CPU's torch path
    monkeypatch.setattr(card_p3, "transform", lambda *a, **k: None)
    tsim.clear_caches()
    want = CALLS[fn](m, **kw)
    assert got.nnz == want.nnz
    np.testing.assert_allclose(_check_sum(got), _check_sum(want), rtol=1e-4)
    np.testing.assert_array_equal(got.toarray(), want.toarray())  # half stars: bit-equal A


@pytest.mark.parametrize("fn", list(CALLS))
def test_a_traced_call_records_where_and_what_went_up(fn, _clean):
    m = URM.T
    _traced(lambda: CALLS[fn](m, k=10, device="cpu", verbose=False))
    span = _transform_span()
    csc_bytes = m.data.nbytes + m.indices.nbytes + m.indptr.nbytes
    assert span.attrs == {"nnz": m.nnz, "bytes": csc_bytes, "where": "host",
                          "upload_bytes": csc_bytes + 8 * m.shape[1]}
    # a call with matrix2 keeps the host transform
    spans.clear()
    _traced(lambda: tsim.p3alpha(m, URM, k=10, device="cpu", verbose=False))
    span = _transform_span()
    assert (span.attrs["where"], span.attrs["upload_bytes"]) == ("host", 0)


@pytest.mark.cuda
def test_card_transform_equals_the_host():
    """At a mid size on a card: the transform of a 20,000 x 5,000 CSC of
    1M half stars bit-equal to the host's, and recorded as run there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", torch.cuda.current_device())
    m = _compressed("csc", n_rows=20_000, n_cols=5_000, nnz=1_050_000, seed=30, zeros=500)
    saved = _arrays(m)
    for alpha in (1.0, 0.8):
        got = card_p3.transform(m, alpha, card, popularity=True)
        a, depop1, pop = _host(m, alpha)
        _assert_pattern(got.a, a)
        np.testing.assert_array_equal(got.a.data, a.data)
        np.testing.assert_array_equal(got.depop1, depop1)
        np.testing.assert_array_equal(got.pop, pop)
    for n, arr in saved:
        np.testing.assert_array_equal(getattr(m, n), arr)
    _, _, where = similarity._p3_value_symmetric(m, 1.0, BETA, {"device": "cuda"}, True)
    assert where["where"] == "card" and where["upload_bytes"] > 0
    # float values: within an ulp
    f = _compressed("csc", n_rows=20_000, n_cols=5_000, nnz=1_050_000, seed=31, values="float")
    got = card_p3.transform(f, 0.8, card, popularity=True)
    _assert_pattern(got.a, _host(f, 0.8)[0])
    _within_exact(got, _exact(f, 0.8))
