"""The port's general grouped executor against the JAX package's executor.

Both executors get the same state: the JAX package preprocesses each call,
and convert.preprocessed_from_reference carries its fields across. The
port runs on the CPU (its tile kernel's plain PyTorch version); the JAX
package runs as its own tests run it on the CPU. Results must have equal
nnz and check_sum within rtol 1e-4 (tests/oracles.py), across target rows,
array and matrix selectors, k larger than the tile width, the exact int8
path, the k > 1024 branch, COO and CSR output and the one-shot OOM replan.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from oracles import check_sum, generate_random_matrix
from similaripy_tpu.engine import executor as jax_executor
from similaripy_tpu.engine import preprocess as jax_preprocess
from similaripy_tpu.engine.assembly import assemble as jax_assemble
from similaripy_tpu.engine.params import SPlusParams as JaxParams
from similaripy_tpu_torch.convert import preprocessed_from_reference
from similaripy_tpu_torch.engine import executor, tile_topk
from similaripy_tpu_torch.engine.assembly import assemble
from similaripy_tpu_torch.engine.params import SPlusParams

torch.set_num_threads(2)

COSINE = dict(l2=1.0, c1=0.5, c2=0.5)
TVERSKY = dict(l1=1.0, t1=0.7, t2=0.4)


def _both(m1, m2, *, params=None, prep=None, block_size_hint=0,
          compute_dtype="float32", fmt="csr", **sel):
    """Run one call through both executors on the same preprocessed state."""
    prep = dict(prep or {})
    params = dict(params or {})
    self_similar = m2 is None
    pre = jax_preprocess.preprocess(
        m1, m1.T if self_similar else m2, self_similar=self_similar, **prep, **sel
    )
    fields = {f.name: getattr(pre, f.name) for f in dataclasses.fields(pre)}
    port_pre = preprocessed_from_reference(fields)

    jv, ji = jax_executor.execute(
        pre, JaxParams(**params), block_size_hint=block_size_hint,
        compute_dtype=compute_dtype,
    )
    pv, pi = executor.execute(
        port_pre, SPlusParams(**params), block_size_hint=block_size_hint,
        compute_dtype=compute_dtype, device="cpu",
    )
    shape = (pre.n_output_rows, pre.n_output_cols)
    ref = jax_assemble(jv, ji, pre.targets, *shape, fmt)
    got = assemble(pv, pi, port_pre.targets, *shape, fmt)
    return got, ref


def _assert_match(got, ref):
    assert got.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-4)


@pytest.fixture(scope="module")
def m():
    return generate_random_matrix(90, 70, density=0.08).tocsr()


def test_convert_carries_every_field(m):
    pre = jax_preprocess.preprocess(
        m, m.T, self_similar=True, l1=1.0, l2=1.0, l3=1.0,
        weight_depop_matrix2="sum", p2=0.5, target_rows=[3, 1, 4],
        filter_cols=m, target_cols=[0, 2, 5],
    )
    fields = {f.name: getattr(pre, f.name) for f in dataclasses.fields(pre)}
    port = preprocessed_from_reference(fields)
    for name in ("Xt", "Yt", "Xc", "Yc", "Xd", "Yd", "col_allowed", "targets"):
        np.testing.assert_array_equal(getattr(port, name), getattr(pre, name))
    for name in ("m1", "m2", "filter_matrix"):
        assert (abs(getattr(port, name) - getattr(pre, name))).sum() == 0
    assert port.target_matrix is None and pre.target_matrix is None
    for name in ("k", "n_output_rows", "n_output_cols", "qscale1", "qscale2", "self_similar"):
        assert getattr(port, name) == getattr(pre, name)


SIMILARITIES = {
    "dot": {},
    "cosine": COSINE,
    "tversky": TVERSKY,
    "s_plus_depop_pow": dict(l1=0.5, l2=0.5, l3=1.0, a1=0.8, stabilized_shrink=0.5),
    "cosine_bayes_threshold": dict(l2=1.0, bayesian_shrink=2.0, threshold=0.05),
}


@pytest.mark.parametrize("name", sorted(SIMILARITIES))
def test_self_similarity(m, name):
    p = SIMILARITIES[name]
    prep = {k: 0.5 for k in ("c1", "c2")} if "l2" in p else {}
    prep.update({k: p[k] for k in ("l1", "l2", "l3") if k in p})
    if "l3" in p:
        prep.update(weight_depop_matrix2="sum", p2=0.5)
    params = {k: v for k, v in p.items() if k not in ("c1", "c2")}
    got, ref = _both(m, None, params=params, prep=dict(prep, k=15))
    _assert_match(got, ref)


def test_target_rows_unsorted_with_duplicates(m):
    got, ref = _both(m, None, params={"l2": 1.0}, prep=dict(COSINE, k=10),
                     target_rows=[7, 3, 7, 60, 12])
    _assert_match(got, ref)


@pytest.mark.parametrize("kind", ["filter_array", "target_array", "filter_matrix",
                                  "target_matrix", "both_matrices"])
def test_selectors(m, kind):
    rng = np.random.default_rng(3)
    mask = sp.random_array((90, 90), density=0.2, format="csr", dtype=np.float32,
                           random_state=rng)
    cols = rng.choice(90, 30, replace=False).tolist()
    sel = {
        "filter_array": dict(filter_cols=cols),
        "target_array": dict(target_cols=cols),
        "filter_matrix": dict(filter_cols=mask),
        "target_matrix": dict(target_cols=mask),
        "both_matrices": dict(filter_cols=mask, target_cols=m @ m.T),
    }[kind]
    got, ref = _both(m, None, params={"l2": 1.0}, prep=dict(COSINE, k=12),
                     target_rows=list(range(0, 90, 3)), **sel)
    _assert_match(got, ref)


def test_two_matrices_with_filter(m):
    rng = np.random.default_rng(4)
    w = sp.random_array((70, 70), density=0.3, format="csr", dtype=np.float32,
                        random_state=rng)
    got, ref = _both(m, w, prep=dict(k=9), filter_cols=m)
    _assert_match(got, ref)
    seen = m.tocsr()
    for r in range(seen.shape[0]):
        row = got.indices[got.indptr[r]:got.indptr[r + 1]]
        assert not set(row) & set(seen.indices[seen.indptr[r]:seen.indptr[r + 1]])


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_k_larger_than_tile(fmt):
    # block_size 128 over 300 output columns: three tiles, k = 150 > tc
    x = generate_random_matrix(300, 60, density=0.1, seed=5).tocsr()
    got, ref = _both(x, None, params={"l2": 1.0}, prep=dict(COSINE, k=150),
                     block_size_hint=128, fmt=fmt, target_rows=list(range(40)))
    assert got.format == fmt
    _assert_match(got, ref)


def test_int8_path_is_exact():
    rng = np.random.default_rng(6)
    x = sp.random_array((120, 80), density=0.08, format="csr", dtype=np.float32,
                        random_state=rng)
    x.data = rng.choice(np.arange(0.5, 5.5, 0.5), x.nnz).astype(np.float32)
    got, ref = _both(x, None, params={"l2": 1.0}, prep=dict(COSINE, k=20),
                     compute_dtype="auto")
    assert executor.last_plan["compute_dtype"] == "int8"
    _assert_match(got, ref)
    np.testing.assert_array_equal(np.sort(got.data), np.sort(ref.data))


def test_bfloat16_compute():
    x = generate_random_matrix(80, 64, density=0.1, seed=8).tocsr()
    got, ref = _both(x, None, prep=dict(k=10), compute_dtype="bfloat16")
    _assert_match(got, ref)


def test_wide_k_branch():
    """k_pad > 1024 takes the executor's own non-kernel branch, counted
    apart from K1's routes."""
    x = generate_random_matrix(1100, 40, density=0.1, seed=9).tocsr()
    executor.wide_k_calls = 0
    tile_topk.reset_counts()
    got, ref = _both(x, None, prep=dict(k=1050), target_rows=list(range(6)))
    assert executor.wide_k_calls > 0 and tile_topk.plain_calls == 0
    _assert_match(got, ref)


def _fake_oom_once(monkeypatch, budgets):
    real = executor._execute_impl

    def flaky(pre, params, **kw):
        budgets.append(kw["budget_bytes"])
        if len(budgets) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(pre, params, **kw)

    monkeypatch.setattr(executor, "_execute_impl", flaky)


def test_oom_replans_once_at_three_quarters(m, monkeypatch):
    budgets = []
    _fake_oom_once(monkeypatch, budgets)
    got, ref = _both(m, None, params={"l2": 1.0}, prep=dict(COSINE, k=10))
    assert budgets == [budgets[0], int(budgets[0] * 0.75)]
    _assert_match(got, ref)


def test_other_errors_are_not_replanned(m, monkeypatch):
    calls = []

    def broken(pre, params, **kw):
        calls.append(kw)
        raise RuntimeError("not an allocation failure")

    monkeypatch.setattr(executor, "_execute_impl", broken)
    pre = jax_preprocess.preprocess(m, m.T, self_similar=True, k=5)
    port_pre = preprocessed_from_reference(
        {f.name: getattr(pre, f.name) for f in dataclasses.fields(pre)}
    )
    with pytest.raises(RuntimeError, match="not an allocation failure"):
        executor.execute(port_pre, SPlusParams(), device="cpu")
    assert len(calls) == 1
