"""The symmetric executor's "sym_coo" stacks, built on the device from the
uploaded CSC arrays (symmetric.prep_coo_symmetric ->
staging.stack_m2_tiles_device), against the host stacker they replace:
staging.stack_m2_tiles_balanced over the same item permutation, uploaded,
and staging.split_coo on NumPy for a precision='high' call. The stacks must
be equal element for element (dtype, shape, entry order), so K5 and K2 see
the same inputs. The port alone, on the CPU: no JAX is needed."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu_torch as tsim
from similaripy_tpu_torch.engine import spans, symmetric
from similaripy_tpu_torch.engine.preprocess import preprocess
from similaripy_tpu_torch.engine.staging import (
    canonical, split_coo, stack_m2_tiles_balanced, upload,
)
from similaripy_tpu_torch.ops.csr import csc_quantized

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    tsim.clear_caches()
    spans.clear()
    yield
    tsim.clear_caches()
    spans.clear()


def _items(n_items, n_users, density, seed, values="half", empty_items=()):
    """An items x users CSR: half stars, or f32 values no power-of-two scale
    makes integral; the rows `empty_items` hold no entry."""
    rng = np.random.default_rng(seed)
    m = sp.random_array((n_items, n_users), density=density, format="csr",
                        dtype=np.float32, random_state=rng)
    if values == "half":
        m.data[:] = rng.integers(1, 11, m.nnz) * 0.5
    else:
        m.data[:] = rng.uniform(0.1, 3.0, m.nnz).astype(np.float32) + np.float32(1e-3)
    if len(empty_items):
        keep = np.ones(n_items, np.float32)
        keep[list(empty_items)] = 0
        m = sp.csr_array(sp.diags_array(keep) @ m)
        m.eliminate_zeros()
    return m


def _repeated(n_items, n_users, seed):
    """An f32 items x users CSR that holds some (item, user) twice."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_items, 900)
    cols = rng.integers(0, n_users, 900)
    rows = np.concatenate([rows, rows[:150]])
    cols = np.concatenate([cols, cols[:150]])
    vals = rng.uniform(0.1, 3.0, rows.shape[0]).astype(np.float32)
    order = np.argsort(rows, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n_items))])
    m = sp.csr_array((vals[order], cols[order].astype(np.int32), indptr),
                     shape=(n_items, n_users))
    assert not m.has_canonical_format
    return m


def _host_oracle(pre, compute_dtype, tc, n_tiles_dev, u_pad, split):
    """The stacks as the host built and uploaded them: the item permutation
    written out as the executor computed it, the host stacker, NumPy's
    split."""
    C = pre.n_output_cols
    int_mode = compute_dtype in ("int8", "int4")
    m2_csc = csc_quantized(pre.m2, pre.qscale2 if int_mode else None)
    if split:
        m2_csc = canonical(m2_csc)
    col_nnz = np.diff(m2_csc.indptr)
    rank = np.argsort(-col_nnz, kind="stable")
    tile_lists = [rank[t::n_tiles_dev] for t in range(n_tiles_dev)]
    rng = np.random.default_rng(0x51A7)
    tile_lists = [lst[rng.permutation(lst.shape[0])] for lst in tile_lists]
    item_map = np.full(n_tiles_dev * tc, C, dtype=np.int64)
    for t, items in enumerate(tile_lists):
        item_map[t * tc : t * tc + items.shape[0]] = items
    coo = stack_m2_tiles_balanced(m2_csc, tile_lists, tc, u_pad)
    if split:
        coo = split_coo(*coo, u_pad, axis=0)
    return {name: upload(a, CPU) for name, a in zip(("ru", "sl", "vv"), coo)}, item_map


# (matrix, compute_dtype, tc, n_tiles_dev, split)
CASES = {
    "int8_half_stars": (lambda: _items(300, 200, 0.05, 1), "int8", 128, 3, False),
    "f32": (lambda: _items(300, 200, 0.05, 2, values="f32"), "float32", 128, 3, False),
    "split": (lambda: _items(300, 200, 0.05, 3, values="f32"), "float32", 128, 4, True),
    "padding_tiles": (lambda: _items(5, 150, 0.3, 4), "int8", 128, 8, False),
    "padding_tiles_split": (lambda: _items(5, 150, 0.3, 5, values="f32"), "float32", 128, 8,
                            True),
    "empty_columns": (lambda: _items(260, 180, 0.05, 6, empty_items=range(0, 260, 7)), "int8",
                      128, 3, False),
    # three items hold every entry: the fourth tile's items hold none
    "tile_without_entries": (lambda: _items(12, 150, 0.3, 7, empty_items=range(3, 12)),
                             "float32", 128, 4, False),
    "f32_repeated": (lambda: _repeated(140, 160, 8), "float32", 128, 3, False),
    "split_repeated": (lambda: _repeated(140, 160, 9), "float32", 128, 3, True),
}


def _pre(case):
    make, compute_dtype, tc, n_tiles_dev, split = CASES[case]
    m = make()
    pre = preprocess(m, m.T, k=10, self_similar=True)
    u_pad = max(-(-pre.m1.shape[1] // 128) * 128, 128)
    return m, pre, (compute_dtype, tc, n_tiles_dev, u_pad), split


@pytest.mark.parametrize("case", list(CASES))
def test_device_stacks_equal_the_host_stacks(case):
    m, pre, geometry, split = _pre(case)
    if geometry[0] == "int8":
        assert pre.qscale2 == 2.0
    data_before = m.data.copy()
    want, want_map = _host_oracle(pre, *geometry, split)
    got, item_map, sent = symmetric.prep_coo_symmetric(pre, *geometry, CPU, split)
    np.testing.assert_array_equal(item_map, want_map)
    assert item_map.dtype == want_map.dtype
    for name in ("ru", "sl", "vv"):
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        assert torch.equal(got[name], want[name]), name
    # the CSC's own arrays and O(items) layout vectors crossed, nothing more
    m2_csc = canonical(pre.m2.tocsc()) if split else pre.m2.tocsc()
    assert sent == m2_csc.nnz * 8 + pre.n_output_cols * 16
    # the caller's matrix is left as it was (the CPU upload shares its arrays)
    np.testing.assert_array_equal(m.data, data_before)


def test_padding_and_empty_tiles_hold_only_sentinels():
    _, pre, geometry, split = _pre("tile_without_entries")
    got, item_map, _ = symmetric.prep_coo_symmetric(pre, *geometry, CPU, split)
    u_pad = geometry[3]
    per_tile = (got["ru"] < u_pad).sum(dim=1)
    assert per_tile[-1] == 0 and per_tile.sum() == pre.m2.nnz
    empty = got["ru"] == u_pad
    assert torch.all(got["sl"][empty] == 0) and torch.all(got["vv"][empty] == 0)
    assert (item_map < pre.n_output_cols).sum() == pre.n_output_cols


@pytest.mark.parametrize("case", ["int8_half_stars", "split"])
def test_a_miss_is_a_card_build_with_its_upload_recorded(case):
    _, pre, (compute_dtype, tc, n_tiles_dev, u_pad), split = _pre(case)
    for _ in range(2):  # a miss, then a hit
        with spans.call(True):
            coo, vecs, item_map = symmetric.cached_prep_symmetric(
                pre, compute_dtype, tc, n_tiles_dev, u_pad, CPU, split)
    first, second = ([s for s in spans.log() if s.call == c and s.name == "stage"]
                     for c in sorted({s.call for s in spans.log()}))
    (stage,) = [s for s in first if s.attrs["kind"] == "sym_coo"]
    assert not second
    m2_csc = canonical(pre.m2.tocsc()) if split else pre.m2.tocsc()
    assert stage.attrs["upload_bytes"] == m2_csc.nnz * 8 + pre.n_output_cols * 16
    assert stage.attrs["host_bytes"] == item_map.nbytes
    assert stage.attrs["bytes"] == sum(t.numel() * t.element_size() for t in coo.values())
    splits = [s for s in spans.log() if s.name == "split"]
    assert len(splits) == (1 if split else 0)
    if split:
        assert splits[0].parent == stage.id
        assert splits[0].attrs["entries"] == coo["vv"].numel()
    info = tsim.cache_info()
    assert info["card_builds"] == {"sym_coo": 1}
    assert info["misses"]["sym_coo"] == 1 and info["hits"]["sym_coo"] == 1
    tsim.clear_caches()
    assert tsim.cache_info()["card_builds"] == {}


def test_the_symmetric_route_counts_one_card_build_a_new_matrix():
    m = _items(300, 200, 0.05, 10)
    for seed in (11, 12):
        m.data[:] = np.random.default_rng(seed).integers(1, 11, m.nnz) * 0.5
        tsim.cosine(m, k=10, device="cpu", verbose=False)
        tsim.cosine(m, k=10, device="cpu", verbose=False)
    info = tsim.cache_info()
    assert info["card_builds"] == {"sym_coo": 2}
    assert info["misses"]["sym_coo"] == 2 and info["hits"]["sym_coo"] == 2


@pytest.mark.parametrize("axis", [0, 1])
def test_split_coo_on_tensors_equals_split_coo_on_arrays(axis):
    rng = np.random.default_rng(13)
    n = 64
    rows = rng.integers(0, n + 8, (3, 50)).astype(np.int32)
    cols = rng.integers(0, n + 8, (3, 50)).astype(np.int32)
    vals = rng.standard_normal((3, 50)).astype(np.float32)
    want = split_coo(rows, cols, vals, n, axis)
    got = split_coo(*map(torch.from_numpy, (rows, cols, vals)), n, axis)
    for w, g in zip(want, got):
        assert isinstance(w, np.ndarray) and isinstance(g, torch.Tensor)
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)
