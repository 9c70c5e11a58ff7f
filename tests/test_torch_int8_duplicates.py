"""The int8 gate judges the values the densify builds, not single entries.

A CSR that is not canonical may repeat a (row, col). The port keeps the
repeats and every densify adds them, so the exact int8 path must take the
sums into account: here two entries of 100 sum to 200, past int8's 127.
'auto' then falls back to float32 and gives SciPy's values; 'int8' raises.
This holds on all three routes: the symmetric executor, the general one and
the union-compaction one (which densifies its panels a third time).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu_torch as tsim
from similaripy_tpu_torch.engine import compact, executor
from similaripy_tpu_torch.engine.preprocess import int8_values, preprocess

torch.set_num_threads(2)

CPU = dict(device="cpu", verbose=False, threshold=float("-inf"))
EXPECT = np.array([[40009.0, 1021.0], [1021.0, 74.0]])


@pytest.fixture(autouse=True)
def _clear_caches():
    tsim.clear_caches()
    yield
    tsim.clear_caches()


def _repeats(n_cols=4):
    """Row 0 holds column 1 twice (100 + 100); SciPy sums the repeats."""
    m = sp.csr_array(
        (np.array([100, 100, 3, 5, 7], np.float32), np.array([1, 1, 2, 1, 2]),
         np.array([0, 3, 5])),
        shape=(2, n_cols),
    )
    assert not m.has_canonical_format
    np.testing.assert_array_equal((m @ m.T).toarray(), EXPECT)
    return m


def _call(route, compute_dtype, monkeypatch):
    if route == "symmetric":
        return tsim.dot_product(_repeats(), k=2, compute_dtype=compute_dtype, **CPU)
    if route == "general":
        m = _repeats()
        return tsim.dot_product(m, m.T, k=2, compute_dtype=compute_dtype, **CPU)
    monkeypatch.setattr(compact, "MODE", "on")
    m = _repeats(4096)  # an inner dimension the compaction route takes
    return tsim.dot_product(m, m.T, k=2, compute_dtype=compute_dtype, **CPU)


@pytest.mark.parametrize("route", ["symmetric", "general", "compact"])
def test_auto_falls_back_to_float32(route, monkeypatch):
    out = _call(route, "auto", monkeypatch)
    assert executor.last_route == route
    assert executor.last_plan["compute_dtype"] == "float32"
    np.testing.assert_array_equal(out.toarray(), EXPECT)


@pytest.mark.parametrize("route", ["symmetric", "general", "compact"])
@pytest.mark.parametrize("compute_dtype", ["int8", "int4"])
def test_int8_raises(route, compute_dtype, monkeypatch):
    with pytest.raises(ValueError, match="integerizable"):
        _call(route, compute_dtype, monkeypatch)


def test_repeats_within_range_stay_int8():
    """Repeats whose sums fit int8 keep the exact path, with the sums."""
    m = sp.csr_array(
        (np.array([60, 60, 3, 5, 7], np.float32), np.array([1, 1, 2, 1, 2]),
         np.array([0, 3, 5])),
        shape=(2, 4),
    )
    out = tsim.dot_product(m, k=2, compute_dtype="auto", **CPU)
    assert executor.last_plan["compute_dtype"] == "int8"
    np.testing.assert_array_equal(out.toarray(), (m @ m.T).toarray())


def test_canonical_input_is_not_copied():
    """A canonical CSR is judged on its own data, with no summed copy; a
    repeat is judged on its sum."""
    m = _repeats().copy()
    m.sum_duplicates()
    assert int8_values(m) is m.data
    m.data[m.data == 200] = 120
    assert preprocess(m, m.T, k=2).qscale1 == 1.0
    assert preprocess(_repeats(), _repeats().T, k=2).qscale1 is None
