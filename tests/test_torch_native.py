"""The port's native host assembly (similaripy_tpu_torch/native/) against the
JAX package's native library and against the port's NumPy branch.

coo_to_csr in both index widths (duplicates kept in stable row-major
order, empty rows), topk_to_coo (-inf and NaN slots dropped), and
engine/assembly.assemble with native=True and native=False: every array
bit-equal, dtypes included. A failed build raises with the compiler's
output; the public calls take the native branch only on a card.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import similaripy_tpu_torch as tsim
from similaripy_tpu import native as jax_native
from similaripy_tpu_torch import native
from similaripy_tpu_torch.engine import assembly

IDX_DTYPES = [np.int32, np.int64]


def _random_coo(n, m, nnz, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, nnz).astype(np.int32), rng.integers(0, m, nnz).astype(np.int32),
            rng.random(nnz).astype(np.float32))


def _topk_buffers(T=60, k=7, n_cols=40, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((T, k)).astype(np.float32)
    vals[rng.random((T, k)) < 0.25] = -np.inf
    vals[rng.random((T, k)) < 0.05] = np.nan
    vals[3, :] = -np.inf  # a row with no entry
    vals[5, 2] = 0.0  # an explicit zero (eliminate_zeros drops it from CSR)
    idx = rng.integers(0, n_cols, (T, k)).astype(np.int32)
    targets = rng.permutation(T + 20)[:T].astype(np.int32)
    targets[7] = targets[8]  # a duplicate target row
    return vals, idx, targets


def _assert_arrays_equal(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("idx_dtype", IDX_DTYPES)
def test_coo_to_csr_matches_jax_native_and_scipy(idx_dtype):
    n, m, nnz = 60, 45, 500
    rows, cols, vals = _random_coo(n, m, nnz)
    got = native.coo_to_csr(rows.astype(idx_dtype), cols.astype(idx_dtype), vals, n, idx_dtype)
    ref = jax_native.coo_to_csr(rows.astype(idx_dtype), cols.astype(idx_dtype), vals, n,
                                idx_dtype)
    _assert_arrays_equal(got, ref)
    assert got[0].dtype == idx_dtype and got[1].dtype == idx_dtype
    indptr, indices, data = got
    dense = sp.csr_array((data, indices, indptr), shape=(n, m)).toarray()
    np.testing.assert_allclose(dense, sp.coo_array((vals, (rows, cols)), shape=(n, m)).toarray(),
                               atol=1e-6)


@pytest.mark.parametrize("idx_dtype", IDX_DTYPES)
def test_coo_to_csr_duplicates_and_empty_rows(idx_dtype):
    rows = np.array([3, 0, 0, 3, 1], idx_dtype)
    cols = np.array([1, 2, 2, 1, 0], idx_dtype)
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    indptr, indices, data = native.coo_to_csr(rows, cols, vals, 6, idx_dtype)
    assert indptr.tolist() == [0, 2, 3, 3, 5, 5, 5]  # rows 2, 4, 5 empty
    assert indices.tolist() == [2, 2, 0, 1, 1]  # duplicates kept, stable order
    assert data.tolist() == [2.0, 3.0, 5.0, 1.0, 4.0]
    _assert_arrays_equal((indptr, indices, data),
                         jax_native.coo_to_csr(rows, cols, vals, 6, idx_dtype))


def test_coo_to_csr_rejects_bad_input():
    rows, cols, vals = np.array([0, 5], np.int32), np.array([0, 1], np.int32), np.ones(2, np.float32)
    with pytest.raises(ValueError, match="outside"):
        native.coo_to_csr(rows, cols, vals, 5, np.int32)
    with pytest.raises(ValueError, match="int32 or int64"):
        native.coo_to_csr(rows, cols, vals, 6, np.int16)


def test_topk_to_coo_drops_inf_and_nan():
    vals = np.array([[1.0, -np.inf, 3.0], [np.nan, 5.0, -np.inf]], np.float32)
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    targets = np.array([7, 9], np.int32)
    r, c, v = native.topk_to_coo(vals, idx, targets)
    assert r.tolist() == [7, 7, 9] and c.tolist() == [0, 2, 4] and v.tolist() == [1.0, 3.0, 5.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_to_coo_matches_jax_native(seed):
    vals, idx, targets = _topk_buffers(seed=seed)
    _assert_arrays_equal(native.topk_to_coo(vals, idx, targets),
                         jax_native.topk_to_coo(vals, idx, targets))


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("idx_dtype", IDX_DTYPES)
def test_assemble_native_equals_plain(fmt, idx_dtype, monkeypatch):
    """Both branches give the same arrays; int64 indices are forced through
    the index-width dispatch (its threshold needs 2**31 entries)."""
    if idx_dtype == np.int64:
        monkeypatch.setattr(assembly, "get_index_dtype", lambda n: np.int64)
    vals, idx, targets = _topk_buffers()
    got = assembly.assemble(vals, idx, targets, 90, 40, fmt, native=True)
    ref = assembly.assemble(vals, idx, targets, 90, 40, fmt, native=False)
    fields = ("indptr", "indices", "data") if fmt == "csr" else ("row", "col", "data")
    _assert_arrays_equal([getattr(got, f) for f in fields], [getattr(ref, f) for f in fields])
    if fmt == "csr":
        assert got.indices.dtype == idx_dtype
        assert 0.0 not in got.data.tolist()  # eliminate_zeros ran


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_assemble_equals_jax_assemble(fmt):
    from similaripy_tpu.engine.assembly import assemble as jax_assemble

    vals, idx, targets = _topk_buffers(seed=3)
    ref = jax_assemble(vals, idx, targets, 90, 40, fmt)
    for branch in (True, False):
        got = assembly.assemble(vals, idx, targets, 90, 40, fmt, native=branch)
        assert (got != ref).nnz == 0 and got.nnz == ref.nnz


def test_native_calls_count_each_wrapper_call():
    vals, idx, targets = _topk_buffers()
    native.reset_counts()
    assembly.assemble(vals, idx, targets, 90, 40, "csr", native=True)
    assert native.native_calls == 2  # topk_to_coo, coo_to_csr
    assembly.assemble(vals, idx, targets, 90, 40, "coo", native=True)
    assert native.native_calls == 3
    assembly.assemble(vals, idx, targets, 90, 40, "csr", native=False)
    assert native.native_calls == 3
    native.reset_counts()
    assert native.native_calls == 0


def test_public_cpu_call_takes_the_plain_branch():
    m = sp.random_array((40, 30), density=0.2, format="csr", dtype=np.float32,
                        random_state=np.random.default_rng(2))
    native.reset_counts()
    out = tsim.cosine(m, k=5, verbose=False, device="cpu")
    assert out.nnz > 0 and native.native_calls == 0


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "simtpu.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="native build failed") as err:
        native.load()
    assert "simtpu.cpp" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_is_keyed_by_the_source(tmp_path, monkeypatch):
    src = tmp_path / "simtpu.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    first = native.library_path()
    assert first.parent == tmp_path / "build"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert native.library_path() != first
