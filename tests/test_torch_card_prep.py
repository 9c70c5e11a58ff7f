"""Preprocessing on the call's device (ops/card_prep.py) against the host
path it stands in for: the coercion of a non-CSR input against
ops/csr.py::ensure_csr_f32 (element for element, dtypes and canonical
flags), the int8 gate against the host gate's loop, and the norm and
depop sums against the host's float32 sums (bit-equal where those are
exact) and float64 sums (within an ulp). Runs on the CPU; the last test
repeats the comparison on a card and skips without one. No JAX is needed:
    python -m pytest tests/test_torch_card_prep.py --noconftest -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu_torch as tsim
from similaripy_tpu_torch.engine import preprocess as prep
from similaripy_tpu_torch.ops import card_prep
from similaripy_tpu_torch.ops.csr import ensure_csr_f32

CPU = torch.device("cpu")


def _gate_loop(data):
    """The int8 gate as the host wrote it before the device path: each
    scale in turn, smallest first."""
    if data.shape[0] == 0:
        return 1.0
    if np.abs(data).max() > 127:
        return None
    for s in (1.0, 2.0, 4.0, 8.0):
        scaled = data * s
        if np.abs(scaled).max() > 127:
            return None
        if (scaled == np.rint(scaled)).all():
            return s
    return None


def _coo_parts(n_rows, n_cols, nnz, seed, repeats=0, zeros=0, empty_row=None, empty_col=None):
    """Row, col and float32 half-star value arrays, in no order: `repeats`
    repeated (row, col) pairs, `zeros` explicit zeros, and one empty row and
    column when asked."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    if empty_row is not None:
        rows[rows == empty_row] = (empty_row + 1) % n_rows
    if empty_col is not None:
        cols[cols == empty_col] = (empty_col + 1) % n_cols
    key = np.unique(rows * n_cols + cols)  # distinct pairs first
    rows, cols = key // n_cols, key % n_cols
    pick = rng.integers(0, rows.shape[0], repeats)
    rows = np.concatenate([rows, rows[pick]])
    cols = np.concatenate([cols, cols[pick]])
    vals = (rng.integers(1, 11, rows.shape[0]) * 0.5).astype(np.float32)
    vals[rng.choice(rows.shape[0], zeros, replace=False)] = 0.0
    order = rng.permutation(rows.shape[0])
    return rows[order], cols[order], vals[order]


def _csc(n_rows=40, n_cols=30, nnz=300, seed=0, index=np.int32, dtype=np.float32, **kw):
    rows, cols, vals = _coo_parts(n_rows, n_cols, nnz, seed, **kw)
    # a CSC in column order, its entries within a column left in draw order
    order = np.argsort(cols, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=n_cols))])
    return sp.csc_array((vals[order].astype(dtype), rows[order].astype(index),
                         indptr.astype(index)), shape=(n_rows, n_cols))


def _coo(n_rows=40, n_cols=30, nnz=300, seed=0, index=np.int32, dtype=np.float32, **kw):
    rows, cols, vals = _coo_parts(n_rows, n_cols, nnz, seed, **kw)
    return sp.coo_array((vals.astype(dtype), (rows.astype(index), cols.astype(index))),
                        shape=(n_rows, n_cols))


INPUTS = {
    "csc": lambda: _csc(),
    "csc_zeros_repeats_empty": lambda: _csc(repeats=25, zeros=20, empty_row=3, empty_col=7),
    "csc_int64": lambda: _csc(index=np.int64, repeats=5, zeros=5),
    "csc_float64": lambda: _csc(dtype=np.float64, zeros=4),
    "csc_int_values": lambda: _csc(dtype=np.int64, repeats=3),
    "csc_matrix": lambda: sp.csc_matrix(_csc(repeats=4, zeros=3)),
    "csc_all_zeros": lambda: sp.csc_array((np.zeros(3, np.float32), np.array([0, 2, 1]),
                                           np.array([0, 2, 3, 3])), shape=(4, 3)),
    "ratings_T": lambda: _coo(n_rows=60, n_cols=25, nnz=400, seed=3).tocsr().T,
    "coo": lambda: _coo(zeros=6, empty_row=0, empty_col=29),
    "coo_int64": lambda: _coo(index=np.int64, seed=1),
    "coo_repeats": lambda: _coo(repeats=12, zeros=3, seed=2),
    "csr": lambda: _coo(seed=4, zeros=5).tocsr(),
}
# inputs the device path leaves to the host: a CSR (no copy there) and a COO
# with repeated pairs (SciPy sums them)
HOST_ONLY = {"coo_repeats", "csr"}


def _arrays(m):
    names = ("data", "indices", "indptr") if m.format != "coo" else ("data", "row", "col")
    return [getattr(m, n).copy() for n in names], names


def _assert_same_csr(got, want):
    assert type(got) is type(want) and got.shape == want.shape
    for name in ("indptr", "indices", "data"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.has_sorted_indices == want.has_sorted_indices
    assert got.has_canonical_format == want.has_canonical_format


@pytest.mark.parametrize("name", list(INPUTS))
def test_coercion_equals_ensure_csr_f32(name):
    m = INPUTS[name]()
    saved, names = _arrays(m)
    want = ensure_csr_f32(m)
    got = card_prep.coerce(m, CPU)
    for a, n in zip(saved, names):  # the caller's arrays as they were
        np.testing.assert_array_equal(getattr(m, n), a)
    if name in HOST_ONLY:
        assert got is None
        got_m, dev = prep._coerce(m, CPU)
        assert dev is None
        _assert_same_csr(got_m, want)
        return
    out, dev = got
    _assert_same_csr(out, want)
    # the flags are set, so SciPy does not look for them again
    assert {"_has_sorted_indices", "_has_canonical_format"} <= set(vars(out))
    # the device entries are the CSR's, in its order
    np.testing.assert_array_equal(dev.rows.numpy(), np.repeat(np.arange(out.shape[0]),
                                                              np.diff(out.indptr)))
    np.testing.assert_array_equal(dev.cols.numpy(), out.indices)
    np.testing.assert_array_equal(dev.data.numpy(), out.data)
    assert dev.canonical == out.has_canonical_format
    if name == "csc_zeros_repeats_empty":
        assert not out.has_canonical_format and out.nnz < m.nnz
        assert np.diff(out.indptr)[3] == 0 and 7 not in out.indices


def test_repeats_of_a_csc_keep_their_order():
    """SciPy's tocsr keeps a column's repeated entries in their order, and
    the device's stable sort does too: values that differ tell them apart."""
    m = sp.csc_array((np.array([1.5, 2.5, 3.5, 4.0], np.float32), np.array([1, 1, 0, 1]),
                      np.array([0, 3, 4])), shape=(2, 2))
    out, dev = card_prep.coerce(m, CPU)
    _assert_same_csr(out, ensure_csr_f32(m))
    np.testing.assert_array_equal(out.data, [3.5, 1.5, 2.5, 4.0])
    assert not dev.canonical


def _gate_matrix(values, repeats=False):
    """A 3 x 4 CSC holding `values` at distinct places, or, with `repeats`,
    every value at (0, 0)."""
    values = np.asarray(values, np.float32)
    n = values.shape[0]
    if repeats:
        return sp.csc_array((values, np.zeros(n, np.int32), np.array([0, n, n, n, n])),
                            shape=(3, 4))
    cells = np.arange(n)
    return sp.coo_array((values, (cells % 3, cells // 3)), shape=(3, 4)).tocsc()


GATE_CASES = {
    "half_stars": ([0.5, 1.0, 4.5, 5.0], False),
    "integers": ([1.0, 2.0, 7.0, 127.0], False),
    "quarters": ([0.25, 1.75, 3.0], False),
    "eighths_at_the_limit": ([0.125, 15.875], False),
    "eighths_past_the_limit": ([0.125, 16.0], False),
    "over_127": ([1.0, 128.0], False),
    "negative_over_127": ([-130.0, 2.0], False),
    "halves_past_63": ([0.5, 64.0], False),
    "float_noise": ([1.0, 2.0000002, 3.0], False),
    "tiny_fraction": ([1.0, 1.0 / 16.0], False),
    "repeats_past_127": ([100.0, 100.0], True),
    "repeats_within_127": ([60.0, 60.0, 3.0], True),
    "repeats_summing_to_a_half": ([0.25, 0.25], True),
    "repeats_of_three": ([40.0, 40.0, 40.0, 0.5], True),
    "nan": ([1.0, np.nan, 2.0], False),
    "inf": ([1.0, -np.inf], False),
}


@pytest.mark.parametrize("name", list(GATE_CASES))
def test_gate_gives_the_host_scale(name):
    values, repeats = GATE_CASES[name]
    m = _gate_matrix(values, repeats)
    out, dev = card_prep.coerce(m, CPU)
    host = prep.int8_values(ensure_csr_f32(m))
    want = _gate_loop(host)
    scale, amax = card_prep.gate(dev)
    assert scale == want
    np.testing.assert_equal(amax, float(np.abs(host).max()))
    assert prep.quantize_scale(host) == want
    assert prep.quantize_scale(prep.int8_values(out)) == want


def test_gate_of_an_empty_matrix():
    empty = torch.zeros(0)
    dev = card_prep.DeviceCSR(empty.long(), empty.long(), empty, (3, 4), True)
    assert card_prep.gate(dev)[0] == _gate_loop(np.zeros(0, np.float32)) == 1.0
    assert prep.quantize_scale(np.zeros(0, np.float32)) == 1.0
    m = INPUTS["csc_all_zeros"]()
    out, dev = card_prep.coerce(m, CPU)
    assert out.nnz == 0 and card_prep.gate(dev)[0] == 1.0


@pytest.mark.parametrize("seed", range(6))
def test_host_gate_equals_the_loop_on_seeded_data(seed):
    rng = np.random.default_rng(seed)
    for scale in (1, 2, 4, 8, 16):
        data = (rng.integers(-130, 131, 500) / scale).astype(np.float32)
        assert prep.quantize_scale(data) == _gate_loop(data)
    data = rng.uniform(-3, 3, 500).astype(np.float32)
    assert prep.quantize_scale(data) is _gate_loop(data) is None
    # in chunks: one non-integral value in the last chunk only
    big = (rng.integers(-60, 61, 3 * prep._GATE_CHUNK + 7) * 0.5).astype(np.float32)
    assert prep.quantize_scale(big) == _gate_loop(big) == 2.0
    big[-1] = 0.25
    assert prep.quantize_scale(big) == _gate_loop(big) == 4.0
    big[-2] = 0.1
    assert prep.quantize_scale(big) is _gate_loop(big) is None


def _quarter_csc(seed):
    m = _csc(n_rows=50, n_cols=35, nnz=600, seed=seed, repeats=6, zeros=4)
    rng = np.random.default_rng(seed)
    m.data[:] = rng.integers(-40, 41, m.nnz) * np.float32(0.25)
    return m


def _host_sums(m, axis, square):
    """Today's host vectors: float32 running sums along rows, float64
    bincounts along columns."""
    return prep._sums(ensure_csr_f32(m), None, axis, square)


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("seed", range(3))
def test_sums_are_bit_equal_on_quarter_data(seed, axis, square):
    m = _quarter_csc(seed)
    _, dev = card_prep.coerce(m, CPU)
    got = card_prep.row_sums(dev, square) if axis == 1 else card_prep.col_sums(dev, square)
    want = _host_sums(m, axis, square)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the transposed view sums the other axis
    other = card_prep.col_sums(dev.T, square) if axis == 1 else card_prep.row_sums(dev.T, square)
    np.testing.assert_array_equal(other, want)


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_sums_are_within_an_ulp_of_float64(seed, square):
    rng = np.random.default_rng(seed)
    m = _csc(n_rows=30, n_cols=20, nnz=500, seed=seed, repeats=8)
    m.data[:] = rng.uniform(-3.0, 7.0, m.nnz).astype(np.float32)
    _, dev = card_prep.coerce(m, CPU)
    c = ensure_csr_f32(m).tocoo()
    v = c.data.astype(np.float64)
    v = v * v if square else v
    for ids, n, got in ((c.row, m.shape[0], card_prep.row_sums(dev, square)),
                        (c.col, m.shape[1], card_prep.col_sums(dev, square))):
        exact = np.bincount(ids, weights=v, minlength=n)
        ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(got.astype(np.float64) - exact) <= ulp)


PREP_CASES = {
    "cosine": dict(l2=1.0),
    "tversky_depop_sum": dict(l1=1.0, l3=1.0, weight_depop_matrix1="sum",
                              weight_depop_matrix2="sum", p1=0.5, p2=0.25),
    "s_plus_shrink": dict(l1=0.5, l2=0.5, additive_shrink=2.0, c1=0.3, c2=0.7),
    "binary_depop": dict(l2=1.0, l3=1.0, binary=True, weight_depop_matrix2="sum", p2=0.5),
}


@pytest.mark.parametrize("self_similar", [True, False])
@pytest.mark.parametrize("case", list(PREP_CASES))
def test_preprocess_on_the_device_equals_the_host(case, self_similar):
    """A whole preprocess of a CSC input: the same matrices, digests,
    vectors and scales on the device path as on the host one."""
    m1 = _quarter_csc(7)
    m2 = m1.T if self_similar else _csc(n_rows=35, n_cols=45, nnz=500, seed=8, zeros=3)
    kw = dict(PREP_CASES[case], k=5, self_similar=self_similar)
    prep.clear_prep_cache()
    host = prep.preprocess(m1, m2, **kw)
    prep.clear_prep_cache()
    dev = prep.preprocess(m1, m2, device=CPU, **kw)
    prep.clear_prep_cache()
    assert (dev.fp1, dev.fp2) == (host.fp1, host.fp2)
    assert (dev.qscale1, dev.qscale2) == (host.qscale1, host.qscale2)
    assert (dev.qmax1, dev.qmax2) == (host.qmax1, host.qmax2)
    assert None not in (dev.qmax1, dev.qmax2)
    for a, b in ((dev.m1, host.m1), (dev.m2, host.m2)):
        assert a.format == b.format
        assert a.has_canonical_format == b.has_canonical_format
        for name in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for name in ("Xt", "Yt", "Xc", "Yc", "Xd", "Yd"):
        a, b = getattr(dev, name), getattr(host, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_the_gates_largest_value_serves_the_compute_type():
    """resolve_compute_dtype judges the int8 products by the gate's largest
    magnitude as it would by a pass of its own over the values."""
    from similaripy_tpu_torch.engine.staging import resolve_compute_dtype

    for m in (_quarter_csc(3), _gate_matrix([60.0, 60.0, 3.0], repeats=True)):
        pre = prep.preprocess(m, m.T, k=2, self_similar=True, device=CPU)
        assert pre.qmax1 == pre.qmax2 == float(np.abs(prep.int8_values(pre.m1)).max())
        want = resolve_compute_dtype("auto", pre)
        pre.qmax1 = pre.qmax2 = None
        assert resolve_compute_dtype("auto", pre) == want
    prep.clear_prep_cache()


def test_a_public_call_leaves_its_csc_input_as_it_was():
    urm = _coo(n_rows=80, n_cols=30, nnz=500, seed=9, zeros=5).tocsr()
    items = urm.T
    saved, names = _arrays(items)
    got = tsim.cosine(items, k=5, device="cpu", verbose=False)
    for a, n in zip(saved, names):
        np.testing.assert_array_equal(getattr(items, n), a)
    tsim.clear_caches()
    want = tsim.cosine(ensure_csr_f32(items), k=5, device="cpu", verbose=False)
    tsim.clear_caches()
    assert (got != want).nnz == 0


@pytest.mark.cuda
def test_card_path_equals_the_host_path():
    """At a mid size on a card: the coerced CSR of a CSC with repeats and
    zeros, its gate, and its sums against the host path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(11)
    n_items, n_users, nnz = 3_000, 20_000, 1_000_000
    m = _csc(n_rows=n_items, n_cols=n_users, nnz=nnz, seed=11, repeats=2_000)
    m.data[:] = rng.integers(1, 11, m.nnz) * np.float32(0.5)
    m.data[rng.choice(m.nnz, 500, replace=False)] = 0.0
    saved, names = _arrays(m)
    out, dev = card_prep.coerce(m, card)
    assert dev.data.is_cuda
    want = ensure_csr_f32(m)
    _assert_same_csr(out, want)
    for a, n in zip(saved, names):
        np.testing.assert_array_equal(getattr(m, n), a)
    assert card_prep.gate(dev)[0] == _gate_loop(prep.int8_values(want)) == 2.0
    for square in (True, False):
        np.testing.assert_array_equal(card_prep.row_sums(dev, square),
                                      _host_sums(m, 1, square))
        np.testing.assert_array_equal(card_prep.col_sums(dev, square),
                                      _host_sums(m, 0, square))
    # float data: the gate refuses it, the sums stay within an ulp of float64
    m.data[:] = rng.uniform(0.1, 5.0, m.nnz).astype(np.float32)
    m.data[rng.choice(m.nnz, 500, replace=False)] = 0.0
    out, dev = card_prep.coerce(m, card)
    _assert_same_csr(out, ensure_csr_f32(m))
    assert card_prep.gate(dev)[0] is None
    c = out.tocoo()
    exact = np.bincount(c.row, weights=c.data.astype(np.float64) ** 2, minlength=n_items)
    got = card_prep.row_sums(dev, square=True).astype(np.float64)
    assert np.all(np.abs(got - exact) <= np.spacing(exact.astype(np.float32)))
