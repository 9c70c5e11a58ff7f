"""precision='high' in the port: the split-bf16x3 modes of K1 and K2
against the JAX package on the CPU.

The JAX package runs f32 calls with precision='high' through its Pallas
kernels in split mode (``split_bf16x3`` stacks, 3 phases, or 2 where one
side is exact in bf16; one plain bf16 phase where both are); here it runs
them in interpret mode (SIMILARIPY_TPU_USE_PALLAS=1), as
tests/test_pallas_kernel.py does. The port must:
  - split the COO values before K5 and the panel densify, so that the
    densified [hi; lo] stacks equal split_bf16x3 of the f32 densify bit for
    bit (negative values, zeros, values within half a bf16 ulp of a power
    of two), after summing repeated entries;
  - compute K1's and K2's split products as the JAX kernels do (plain
    versions against the kernels in interpret mode, rtol 1e-5 as the f32
    cases: the same exact products, summed in another order);
  - choose the JAX package's mode (a spy on ``_split_maps`` against
    ``executor.last_plan["f32x3"]``);
  - give the JAX package's results end to end (equal nnz, check_sum within
    rtol 1e-5) and the float64 oracle's (check_sum within rtol 1e-4), on
    the symmetric route over several tiles and on the general route, for
    scoring and for recommend with the exclude-seen fold;
  - give the single device's results on a mesh of two gloo ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu as jsim
import torch_mesh_cases as mc
from oracles import check_sum, generate_random_matrix, py_cosine, py_rp3beta, py_tversky, top_k
from similaripy_tpu.engine import pallas_kernels as pk
from similaripy_tpu.engine.executor import densify as jax_densify
from similaripy_tpu_torch.engine import executor, scatter, staging, sym_topk, symmetric, tile_topk
from torch_k1_cases import SPLIT_CASES, assert_same, make_split_case, run_port_split
from torch_k2_cases import SPLIT_CASES as K2_SPLIT_CASES
from torch_k2_cases import EPILOGUES, case_id, make_inputs, torch_fn
from torch_k2_cases import assert_same as assert_same_k2

import similaripy_tpu_torch as tsim

torch.set_num_threads(2)

CPU = dict(device="cpu", verbose=False)
HIGH = dict(compute_dtype="float32", precision="high")


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SIMILARIPY_TPU_USE_PALLAS", "1")
    tsim.clear_caches()
    jsim.clear_caches()
    yield
    tsim.clear_caches()
    jsim.clear_caches()


def _bits(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)).view(np.uint32)


# values the split must carry exactly: negatives (BM25 weights some below
# 0), zeros, values within half a bf16 ulp of a power of two (the rounding
# carry runs into the exponent), exact halfway cases, and random floats.
# No -0.0: preprocessing drops stored zeros of either sign, and the
# densifies disagree on its sign bit (XLA keeps it, 0 + -0.0 is +0.0)
def _hard_values(n, seed):
    rng = np.random.default_rng(seed)
    ulp = 2.0 ** -8  # a bf16 ulp of 1
    special = np.array([0.0, 1.0, -1.0, 1 - ulp / 4, 1 - ulp / 2, 1 + ulp / 2,
                        2 - ulp / 2, -(4 - ulp), 0.5 - ulp / 8, 1 + 3 * ulp / 2,
                        2.0 ** -20, -(2.0 ** 30) * (1 - ulp / 4), 3.0e-7, -1234.5678])
    m = n - special.size
    rand = rng.standard_normal(m) * 10.0 ** rng.integers(-3, 4, m)
    return np.concatenate([special, rand]).astype(np.float32)  # n values


def test_split_bf16x3_matches_jax_bit_for_bit():
    x = _hard_values(4000, 1).reshape(-1, 5)
    got = tile_topk.split_bf16x3(torch.from_numpy(x), 1)
    ref = pk.split_bf16x3(jnp.asarray(x), axis=1)
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), _bits(ref))
    hi, lo = tile_topk.split_bf16x3_parts(torch.from_numpy(x))
    # hi is x rounded to the nearest bf16 (ties away from zero in
    # magnitude), and hi + lo is x to about 16 bits
    np.testing.assert_array_equal(hi.float().numpy(), np.asarray(jnp.asarray(ref[:, :5], jnp.float32)))
    np.testing.assert_allclose((hi.double() + lo.double()).numpy(), x, rtol=2.0 ** -16, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tile_coo_densifies_to_the_split_stack(seed):
    """K5's side: the tile stacks' COO (sentinel rows past u_pad) split
    before the scatter equals split_bf16x3 of the f32 tiles, bit for bit."""
    rng = np.random.default_rng(seed)
    g, u_pad, tc, p2 = 3, 256, 128, 900
    ru = np.full((g, p2), u_pad, np.int32)
    sl = np.zeros((g, p2), np.int32)
    vv = np.zeros((g, p2), np.float32)
    vals = _hard_values(g * p2, seed + 10)
    for t in range(g):
        n = p2 - 100 * (t + 1)
        cells = rng.choice(u_pad * tc, n, replace=False)
        ru[t, :n], sl[t, :n] = cells // tc, cells % tc
        vv[t, :n] = vals[t * p2:t * p2 + n]
    rows, cols, v2 = staging.split_coo(ru, sl, vv, u_pad, axis=0)
    got = scatter.densify_tiles(*map(torch.from_numpy, (rows, cols, v2)),
                                u_pad=2 * u_pad, tc=tc, cdt=torch.bfloat16)
    assert got.shape == (g, 2 * u_pad, tc) and got.dtype == torch.bfloat16
    for t in range(g):
        f32 = jax_densify((u_pad, tc), jnp.asarray(ru[t]), jnp.asarray(sl[t]),
                          jnp.asarray(vv[t]), jnp.float32)
        ref = pk.split_bf16x3(f32, axis=0)
        np.testing.assert_array_equal(got[t].float().numpy().view(np.uint32), _bits(ref))


def test_split_panel_coo_densifies_to_the_split_stack():
    """The panel side: the lo half at column offset u_pad."""
    rng = np.random.default_rng(4)
    trp, u_pad, n = 24, 384, 2000
    cells = rng.choice(trp * u_pad, n, replace=False)
    pr, pc = (cells // u_pad).astype(np.int32), (cells % u_pad).astype(np.int32)
    pv = _hard_values(n, 5)
    rows, cols, v2 = staging.split_coo(pr, pc, pv, u_pad, axis=1)
    got = executor.densify((trp, 2 * u_pad), *map(torch.from_numpy, (rows, cols, v2)),
                           torch.bfloat16)
    f32 = jax_densify((trp, u_pad), jnp.asarray(pr), jnp.asarray(pc), jnp.asarray(pv),
                      jnp.float32)
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  _bits(pk.split_bf16x3(f32, axis=1)))


def test_repeated_entries_are_summed_before_the_split():
    """The split of a sum is not the sum of the splits: a matrix that holds
    a (row, col) twice is made canonical first, and its split stack is then
    the split of the summed f32 densify."""
    rows = np.array([0, 0, 1, 2, 2, 2], np.int32)
    cols = np.array([1, 1, 0, 3, 3, 3], np.int32)
    vals = np.array([1 + 2.0 ** -9, 1 + 2.0 ** -9, 0.3, 1.7, 0.11, 2.0 ** -12], np.float32)
    m = sp.csr_array((vals, cols, np.array([0, 2, 3, 6])), shape=(3, 4))
    assert not m.has_canonical_format
    c = staging.canonical(m)
    assert c.nnz == 3 and m.nnz == 6  # the input is left as it was
    pr = np.repeat(np.arange(3, dtype=np.int32), np.diff(c.indptr))
    got = executor.densify((3, 8), *map(torch.from_numpy,
                                        staging.split_coo(pr, c.indices.astype(np.int32),
                                                           c.data, 4, axis=1)),
                           torch.bfloat16)
    dense = np.zeros((3, 4), np.float32)
    np.add.at(dense, (rows, cols), vals)
    ref = pk.split_bf16x3(jnp.asarray(dense), axis=1)
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), _bits(ref))
    # without the sum, the halves of the repeats add up to another stack
    pr0 = np.repeat(np.arange(3, dtype=np.int32), np.diff(m.indptr))
    raw = executor.densify((3, 8), *map(torch.from_numpy, staging.split_coo(
        pr0, m.indices.astype(np.int32), m.data, 4, axis=1)), torch.float32)
    assert not np.array_equal(raw.numpy().view(np.uint32), _bits(ref))


def test_bf16_exact_detector():
    """staging.py's bf16_exact, judged in PyTorch on what a densify
    holds (repeated entries summed)."""
    def csr(v):
        v = np.asarray(v, np.float32)
        return sp.csr_array((v, (np.zeros(v.size, int), np.arange(v.size))), shape=(1, 8))

    assert staging.bf16_exact(("t", 1), csr([1.0, 5.0, 130.0, 256.0]))
    assert not staging.bf16_exact(("t", 2), csr([0.1]))
    assert not staging.bf16_exact(("t", 3), csr([257.0]))  # 9 significant bits
    assert staging.bf16_exact(("t", 4), csr([]))
    # 255 and 2 are exact, their sum 257 is not
    dup = sp.csr_array((np.array([255.0, 2.0], np.float32), np.array([2, 2]),
                        np.array([0, 2])), shape=(1, 8))
    assert not staging.bf16_exact(("t", 5), dup)


# ---------------------------------------------------------------------------
# K1 and K2: the plain versions against the JAX kernels in split mode
# ---------------------------------------------------------------------------


def _jax_k1(split, a, d, vecs, pv, masks, carry, flags, k_pad):
    ja = pk.split_bf16x3(jnp.asarray(a), axis=1) if split in ("both", "lhs") \
        else jnp.asarray(a, jnp.bfloat16)
    jd = pk.split_bf16x3(jnp.asarray(d), axis=0) if split in ("both", "rhs") \
        else jnp.asarray(d, jnp.bfloat16)
    out = pk.fused_tile_topk(
        ja, jd, *map(jnp.asarray, vecs), jnp.asarray(pv),
        **{k: jnp.asarray(v) for k, v in masks.items()},
        carry=None if carry is None else tuple(map(jnp.asarray, carry)),
        flags=flags, k_pad=k_pad, int8_mode=False, precision=jax.lax.Precision.HIGHEST,
        split_f32=split, tm=8, kb=128, interpret=True,
    )
    return tuple(np.array(x) for x in out)


@pytest.mark.parametrize("split,carry_on,mask", SPLIT_CASES)
def test_k1_split_plain_matches_jax_kernel(split, carry_on, mask):
    case = make_split_case(split, carry_on, mask, _jax_k1)
    ref = _jax_k1(split, *case)
    tile_topk.reset_counts()
    got = run_port_split(tile_topk.fused_tile_topk, split, *case)
    assert tile_topk.plain_calls == 1 and tile_topk.kernel_launches == 0
    assert_same("f32", got, ref, case[6])


def _jax_k2(a, d, *rest, x2=None, y2=None, **kw):
    out = pk.fused_sym_topk(
        pk.split_bf16x3(jnp.asarray(a), axis=1), pk.split_bf16x3(jnp.asarray(d), axis=0),
        *map(jnp.asarray, rest),
        x2=None if x2 is None else tuple(map(jnp.asarray, x2)),
        y2=None if y2 is None else tuple(map(jnp.asarray, y2)),
        precision=jax.lax.Precision.HIGHEST, split_f32=True, interpret=True, **kw,
    )
    return tuple(np.array(x) for x in out)


@pytest.mark.parametrize("case", K2_SPLIT_CASES, ids=[case_id(c) for c in K2_SPLIT_CASES])
def test_k2_split_plain_matches_jax_kernel(case):
    args, kw = make_inputs(case, _jax_k2)
    ref = _jax_k2(*args, **kw)
    sym_topk.reset_counts()
    got = torch_fn(sym_topk.fused_sym_topk, "split")(*args, **kw)
    assert sym_topk.plain_calls == 1 and sym_topk.kernel_launches == 0
    assert_same_k2("split", got, ref, EPILOGUES[case["epi"]][0])


# ---------------------------------------------------------------------------
# the mode each call takes
# ---------------------------------------------------------------------------


def _spy_split_maps(monkeypatch):
    """Record the modes the JAX kernels trace with. The JAX package calls
    _split_maps while it traces, so its compiled programs are dropped
    first: an earlier test of the same shapes would otherwise hand this
    call a cached program and no mode."""
    jax.clear_caches()
    seen = []
    orig = pk._split_maps

    def rec(n_k, mode="both"):
        seen.append(mode)
        return orig(n_k, mode)

    monkeypatch.setattr(pk, "_split_maps", rec)
    return seen


def _int_float_pair(seed):
    """tests/test_pallas_kernel.py::_int_float_pair."""
    rng = np.random.default_rng(seed)
    urm = sp.random_array((220, 330), density=0.05, format="csr", dtype=np.float32,
                          random_state=rng)
    urm.data[:] = np.rint(urm.data * 4) + 1.0
    w = sp.random_array((330, 180), density=0.08, format="csr", dtype=np.float32,
                        random_state=rng)
    return urm, w


def _exact_130_190():
    rng = np.random.default_rng(13)
    m = sp.random_array((150, 200), density=0.06, format="csr", dtype=np.float32,
                        random_state=rng)
    m.data[:] = np.rint(m.data * 60) + 130.0
    return m


def _int_items():
    rng = np.random.default_rng(17)
    m = sp.random_array((250, 300), density=0.05, format="csr", dtype=np.float32,
                        random_state=rng)
    m.data[:] = np.rint(m.data * 4) + 1.0
    return m


MODE_CASES = {
    # integer ratings x float model: the 2-phase 'rhs' sweep
    "int_x_float": (lambda s, **kw: s.dot_product(*_int_float_pair(7), k=25, **kw),
                    "rhs", "general"),
    "float_x_int": (lambda s, **kw: s.dot_product(
        _int_float_pair(9)[1].T.tocsr(), _int_float_pair(9)[0].T.tocsr(), k=25, **kw),
        "lhs", "general"),
    "float_x_float": (lambda s, **kw: s.cosine(
        generate_random_matrix(120, 90, density=0.08).tocsr(),
        generate_random_matrix(120, 90, density=0.08).tocsr().T.tocsr(), k=10, **kw),
        "both", "general"),
    # values 130-190: exact in bf16, not int8-quantizable: one bf16 phase
    "exact_130_190": (lambda s, **kw: s.dot_product(
        _exact_130_190(), _exact_130_190().T.tocsr(), k=20, **kw), None, "general"),
    "symmetric_int": (lambda s, **kw: s.cosine(_int_items(), k=15, **kw), None, "symmetric"),
    "symmetric_float": (lambda s, **kw: s.cosine(
        generate_random_matrix(130, 90, density=0.08).tocsr(), k=10, **kw), "both",
        "symmetric"),
}


@pytest.mark.parametrize("name", list(MODE_CASES))
def test_mode_choice_matches_jax(monkeypatch, name):
    call, mode, route = MODE_CASES[name]
    seen = _spy_split_maps(monkeypatch)
    ref = call(jsim, verbose=False, **HIGH)
    assert set(seen) == ({mode} if mode else set()), seen
    got = call(tsim, **CPU, **HIGH)
    assert executor.last_route == route
    assert executor.last_plan["f32x3"] == mode
    if mode is None:  # both sides exact: the call rides bf16
        assert executor.last_plan["compute_dtype"] == "bfloat16"
    assert got.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-5)


def test_highest_and_default_stay_true_f32():
    m = generate_random_matrix(120, 90, density=0.08).tocsr()
    out = {}
    for precision in ("highest", "default"):
        out[precision] = tsim.cosine(m, m.T.tocsr(), k=10, compute_dtype="float32",
                                     precision=precision, **CPU).tocsr()
        assert executor.last_plan["f32x3"] is None
        assert executor.last_plan["compute_dtype"] == "float32"
    for a in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(out["highest"], a), getattr(out["default"], a))


# ---------------------------------------------------------------------------
# end to end against the JAX package and the float64 oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def matrix():
    return generate_random_matrix(300, 250, density=0.04).tocsr()


def _force_tiles(monkeypatch, tc=128, gt=2):
    """Several tiles on both sides: the JAX package's SYM_TC knob and the
    port's planner."""
    monkeypatch.setenv("SIMILARIPY_TPU_SYM_TC", str(tc))

    def plan(C, U, nnz, compute_dtype, budget, k_pad):
        return tc, gt, max(-(-U // 128) * 128, 128)

    monkeypatch.setattr(symmetric, "_plan", plan)


def _check(got, ref, oracle):
    got, ref = got.tocsr(), ref.tocsr()
    assert got.shape == ref.shape and got.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-5)
    np.testing.assert_allclose(check_sum(got), check_sum(oracle), rtol=1e-4)


E2E = {
    "cosine": (lambda s, m, m2, **kw: s.cosine(m, m2, k=15, **kw),
               lambda m: py_cosine(m, 15)),
    "tversky": (lambda s, m, m2, **kw: s.tversky(m, m2, alpha=0.2, beta=0.9, k=11, **kw),
                lambda m: py_tversky(m, 0.2, 0.9, 11)),
    "rp3beta": (lambda s, m, m2, **kw: s.rp3beta(m, m2, alpha=0.7, beta=0.4, k=12, **kw),
                lambda m: py_rp3beta(m, 0.7, 0.4, 12)),
}


@pytest.mark.parametrize("name", list(E2E))
def test_symmetric_route_matches_jax_and_oracle(monkeypatch, matrix, name):
    _force_tiles(monkeypatch)
    call, oracle = E2E[name]
    ref = call(jsim, matrix, None, verbose=False, **HIGH)
    sym_topk.reset_counts()
    got = call(tsim, matrix, None, **CPU, **HIGH)
    plan = executor.last_plan
    assert executor.last_route == "symmetric" and plan["f32x3"] == "both"
    assert plan["n_tiles"] >= 3 and sym_topk.plain_calls == plan["blocks"]
    _check(got, ref, oracle(matrix))


@pytest.mark.parametrize("name", list(E2E))
def test_general_route_matches_jax_and_oracle(matrix, name):
    call, oracle = E2E[name]
    m2 = matrix.T.tocsr()
    ref = call(jsim, matrix, m2, verbose=False, **HIGH)
    got = call(tsim, matrix, m2, **CPU, **HIGH)
    assert executor.last_route == "general" and executor.last_plan["f32x3"] == "both"
    _check(got, ref, oracle(matrix))


def test_scoring_matches_jax_and_oracle():
    urm, w = _int_float_pair(21)
    ref = jsim.dot_product(urm, w, k=30, verbose=False, **HIGH)
    got = tsim.dot_product(urm, w, k=30, **CPU, **HIGH)
    assert executor.last_plan["f32x3"] == "rhs"
    _check(got, ref, top_k(sp.csr_matrix(urm) @ sp.csr_matrix(w), 30))


def test_recommend_with_the_fold_matches_jax_and_oracle():
    urm, w = mc.ratings()
    ref = jsim.recommend(urm, w, k=8, verbose=False, **HIGH)
    got = tsim.recommend(urm, w, k=8, **CPU, **HIGH)
    assert executor.last_plan["f32x3"] == "rhs" and executor.last_plan["fold"] is not None
    scores = urm.toarray().astype(np.float64) @ w.toarray().astype(np.float64).T
    scores[urm.toarray() != 0] = 0.0  # the seen items are excluded
    _check(got, ref, top_k(sp.csr_array(scores), 8))


# ---------------------------------------------------------------------------
# mesh=: two gloo ranks against the port's single device
# ---------------------------------------------------------------------------


def _single(name):
    case = mc.CASES[name]
    plan0 = symmetric._plan
    symmetric._plan = mc._forced_plan(*case.plan) if case.plan else plan0
    try:
        tsim.clear_caches()
        res = case.call(tsim, **CPU).tocsr()
        return res, dict(executor.last_plan)
    finally:
        symmetric._plan = plan0


_SINGLE: dict = {}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    def meanwhile():
        for name in mc.SPLIT:
            _SINGLE[name] = _single(name)

    return mc.shared_world(tmp_path_factory, "split-world2", 2, mc.WORLD2_MESHES,
                           list(mc.SPLIT), meanwhile)


SPLIT_KEYS = [(shape, name) for shape in mc.WORLD2_MESHES for name in mc.SPLIT]


@pytest.mark.parametrize("shape,name", SPLIT_KEYS,
                         ids=[f"{r}x{c}-{name}" for (r, c), name in SPLIT_KEYS])
def test_mesh_matches_single_device(world2, shape, name):
    recs = world2[(shape, name)]
    mc.check_ranks(recs, name, 2)
    if name not in _SINGLE:
        _SINGLE[name] = _single(name)
    ref, plan = _SINGLE[name]
    got = mc.to_csr(recs[0])
    assert recs[0]["plan"]["f32x3"] == plan["f32x3"] is not None
    assert got.shape == ref.shape and got.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-5)
    mc.assert_ids_agree(got, ref)
