"""Mesh cases shared by the CPU tests of the port's sharded executors
(``tests/test_torch_sharded.py``, ``tests/test_torch_sym_sharded.py``) and
by the gloo worlds they spawn.

NumPy, SciPy and the port only: every spawned rank imports this module, and
a rank must not import JAX. ``start_world`` starts one process per rank
over a ``file://`` store (no TCP port, so parallel test workers cannot
collide) that runs the named cases on every mesh shape of that world;
``finish_world`` returns each rank's results and counters.
"""

from __future__ import annotations

import datetime
import functools
import os
import pickle
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp

WORLD4_MESHES = ((1, 4), (4, 1), (2, 2))
WORLD2_MESHES = ((1, 2), (2, 1))


# ---------------------------------------------------------------------------
# Inputs (seeded NumPy; the same arrays go to both packages)
# ---------------------------------------------------------------------------


def random_matrix(n_rows, n_cols, density, seed):
    """tests/oracles.py::generate_random_matrix, without its JAX import."""
    rng = np.random.default_rng(seed)
    return sp.random_array((n_rows, n_cols), density=density, format="csr",
                           dtype=np.float32, random_state=rng)


def rand(n, m, density=0.15, seed=3, integral=True):
    """tests/test_sym_sharded.py::_rand."""
    a = random_matrix(n, m, density, seed)
    if integral:
        a.data[:] = np.round(a.data * 4) + 1.0
    return a


def knn_model(urm, k: int):
    """An item-item cosine model (items x items, top-k per row, f32) in
    NumPy, so both packages score against the same model."""
    x = urm.toarray().astype(np.float64)
    norms = np.sqrt((x * x).sum(axis=0))
    norms[norms == 0] = 1.0
    s = (x.T @ x) / norms[:, None] / norms[None, :]
    keep = np.argsort(-s, axis=1, kind="stable")[:, :k]
    rows = np.repeat(np.arange(s.shape[0]), k)
    vals = s[rows, keep.ravel()]
    w = sp.csr_array((vals.astype(np.float32), (rows, keep.ravel())), shape=s.shape)
    w.eliminate_zeros()
    return w


@functools.lru_cache(maxsize=None)
def ratings():
    """The recommend fixture of tests/test_filter_fold.py: 240 users x 160
    items of half-star ratings, and a 30-neighbour item model."""
    rng = np.random.default_rng(3)
    urm = sp.random_array((240, 160), density=0.06, format="csr",
                          dtype=np.float32, random_state=rng)
    urm.data[:] = np.rint(urm.data * 8) / 2 + 0.5
    return urm, knn_model(urm, 30)


@functools.lru_cache(maxsize=None)
def _matrix():
    return random_matrix(500, 400, 0.03, 42)


@functools.lru_cache(maxsize=None)
def _filter_case():
    rng = np.random.default_rng(11)
    urm = sp.random_array((90, 180), density=0.05, format="csr",
                          dtype=np.float32, random_state=rng)
    w = sp.random_array((180, 180), density=1, format="csr",
                        dtype=np.float32, random_state=rng)
    return urm, w


@functools.lru_cache(maxsize=None)
def _selectors():
    m = _matrix()
    rng = np.random.default_rng(13)
    shape = (m.shape[0], m.shape[0])
    fil = sp.random_array(shape, density=0.02, format="csr", dtype=np.float32,
                          random_state=rng)
    tgt = sp.random_array(shape, density=0.3, format="csr", dtype=np.float32,
                          random_state=rng)
    return fil, tgt


@functools.lru_cache(maxsize=None)
def _multihost():
    """tests/test_multihost.py's engine inputs, with a seeded item model in
    place of one computed by either package."""
    rng = np.random.default_rng(0)
    urm = sp.random_array((300, 120), density=0.06, format="csr",
                          dtype=np.float32, random_state=rng)
    urm.data[:] = np.round(urm.data * 4) + 1.0
    return urm, knn_model(urm, 8).T.tocsr()


def _target_ids():
    rng = np.random.default_rng(3)
    n = _matrix().shape[0]
    return (rng.choice(n, size=77, replace=False).tolist(),
            rng.choice(n, size=90, replace=False).tolist())


@dataclass(frozen=True)
class Case:
    call: Callable  # call(sim, **kw) -> sparse result; kw carries verbose/mesh/device
    plan: Optional[tuple] = None  # forced symmetric (tc, gt), as the JAX env knobs
    fold: bool = True  # the exclude-seen fold on (executor.FOLD_FILTER)
    route: str = "sharded"  # the executor a mesh call takes


def _sym(call, plan=None):
    return Case(call, plan=plan, route="sym_sharded")


M = _matrix

# test_sharded.py's cases: the matrix2=None ones take the symmetric route,
# as in the JAX package; explicit matrix2 takes the grouped route
SHARDED = {
    "cosine_oracle": _sym(lambda sim, **kw: sim.cosine(M(), k=30, **kw)),
    "cosine_explicit": Case(lambda sim, **kw: sim.cosine(M(), M().T.tocsr(), k=30, **kw)),
    "dot": Case(lambda sim, **kw: sim.dot_product(M(), M().T.tocsr(), k=30, **kw)),
    "jaccard": Case(lambda sim, **kw: sim.jaccard(M(), M().T.tocsr(), k=30, **kw)),
    "asy_cosine": Case(lambda sim, **kw: sim.asymmetric_cosine(
        M(), M().T.tocsr(), alpha=0.2, k=30, **kw)),
    "rp3beta": Case(lambda sim, **kw: sim.rp3beta(
        M(), M().T.tocsr(), alpha=0.8, beta=0.4, k=30, **kw)),
    "splus": Case(lambda sim, **kw: sim.s_plus(
        M(), M().T.tocsr(), l1=0.5, l2=0.5, l3=1, t1=1, t2=1, c1=0.5, c2=0.5,
        alpha=1, beta1=0, beta2=0, pop1="none", pop2="sum", k=30, **kw)),
    "filter_cols_matrix": Case(lambda sim, **kw: sim.dot_product(
        _filter_case()[0], _filter_case()[1], k=180, filter_cols=_filter_case()[0], **kw)),
    "target_rows_cols": Case(lambda sim, **kw: sim.cosine(
        M(), k=30, target_rows=_target_ids()[0], target_cols=_target_ids()[1], **kw)),
    "selectors_matrix": Case(lambda sim, **kw: sim.cosine(
        M(), M().T.tocsr(), k=25, filter_cols=_selectors()[0],
        target_cols=_selectors()[1], **kw)),
    "uneven_rows": Case(lambda sim, **kw: sim.dot_product(
        random_matrix(131, 97, 0.05, 5), random_matrix(131, 97, 0.05, 5).T.tocsr(), k=13, **kw)),
    # more target rows than one panel batch holds (trp is at most 2,048)
    "many_rows": Case(lambda sim, **kw: sim.dot_product(
        random_matrix(4200, 50, 0.1, 9), random_matrix(50, 300, 0.2, 10), k=10, **kw)),
    "int8_grouped": Case(lambda sim, **kw: sim.cosine(
        rand(160, 90, 0.12, 21), rand(160, 90, 0.12, 21).T.tocsr(), k=12, **kw)),
    "fold_recommend": Case(lambda sim, **kw: sim.recommend(
        ratings()[0], ratings()[1], k=8, **kw)),
    "masked_recommend": Case(lambda sim, **kw: sim.recommend(
        ratings()[0], ratings()[1], k=8, **kw), fold=False),
}

# test_multihost.py's engine parity: int8 self-similarity and a filtered
# scoring call (the fold arms: the model is float)
MULTIHOST = {
    "mh_cosine": _sym(lambda sim, **kw: sim.cosine(_multihost()[0].T.tocsr(), k=8, **kw)),
    "mh_recs": Case(lambda sim, **kw: sim.dot_product(
        _multihost()[0], _multihost()[1], k=5, filter_cols=_multihost()[0], **kw)),
}

# test_sym_sharded.py's cases, with its SIMILARIPY_TPU_SYM_TC / _GT knobs
# as a forced port plan
SYM = {
    "route": _sym(lambda sim, **kw: sim.cosine(rand(30, 300, seed=3).T.tocsr(), k=9, **kw)),
    "cosine": _sym(lambda sim, **kw: sim.cosine(rand(70, 900, seed=11).T.tocsr(), k=17, **kw),
                   plan=(128, 2)),
    "sim_dot": _sym(lambda sim, **kw: sim.dot_product(rand(50, 600, seed=7).T.tocsr(), k=11, **kw),
                    plan=(128, 1)),
    "sim_cosine_shrink": _sym(lambda sim, **kw: sim.cosine(
        rand(50, 600, seed=7).T.tocsr(), shrink=5.0, k=11, **kw), plan=(128, 1)),
    "sim_asy_cosine": _sym(lambda sim, **kw: sim.asymmetric_cosine(
        rand(50, 600, seed=7).T.tocsr(), alpha=0.2, k=11, **kw), plan=(128, 1)),
    "sim_jaccard": _sym(lambda sim, **kw: sim.jaccard(rand(50, 600, seed=7).T.tocsr(), k=11, **kw),
                        plan=(128, 1)),
    "sim_tversky": _sym(lambda sim, **kw: sim.tversky(
        rand(50, 600, seed=7).T.tocsr(), alpha=0.2, beta=0.9, k=11, **kw), plan=(128, 1)),
    "sim_rp3beta": _sym(lambda sim, **kw: sim.rp3beta(
        rand(50, 600, seed=7).T.tocsr(), alpha=0.7, beta=0.4, k=11, **kw), plan=(128, 1)),
    "sim_p3alpha": _sym(lambda sim, **kw: sim.p3alpha(
        rand(50, 600, seed=7).T.tocsr(), alpha=0.8, k=11, **kw), plan=(128, 1)),
    "sim_splus": _sym(lambda sim, **kw: sim.s_plus(
        rand(50, 600, seed=7).T.tocsr(), l1=0.4, l2=0.6, t1=0.8, t2=0.8, c1=0.5, c2=0.5,
        k=11, **kw), plan=(128, 1)),
    "single_tile": _sym(lambda sim, **kw: sim.cosine(rand(30, 200, seed=17).T.tocsr(), k=5, **kw)),
    "float32": _sym(lambda sim, **kw: sim.cosine(
        rand(45, 500, seed=19, integral=False).T.tocsr(), k=8, compute_dtype="float32", **kw),
        plan=(128, 2)),
    "edge_k1": _sym(lambda sim, **kw: sim.jaccard(
        rand(30, 280, seed=23).T.tocsr(), k=1, binary=True, **kw), plan=(128, 1)),
    "edge_k10000": _sym(lambda sim, **kw: sim.jaccard(
        rand(30, 280, seed=23).T.tocsr(), k=10_000, binary=True, **kw), plan=(128, 1)),
    "no_duplicates": _sym(lambda sim, **kw: sim.dot_product(
        rand(80, 640, density=0.4, seed=17).T.tocsr(), k=30, **kw), plan=(128, 2)),
}

CASES = {**SHARDED, **MULTIHOST, **SYM}


# ---------------------------------------------------------------------------
# The gloo world
# ---------------------------------------------------------------------------


def _forced_plan(tc, gt):
    def plan(C, U, nnz, compute_dtype, budget, k_pad):
        return tc, gt, max(-(-U // 128) * 128, 128)

    return plan


def _plain_dict(d: dict) -> dict:
    return {k: v for k, v in d.items() if isinstance(v, (int, float, str, tuple, type(None)))}


def run_rank(rank, world, store, out_dir, meshes, names):
    """One rank: every case of `names` on every mesh shape of `meshes`;
    writes {(mesh, name): record} to out_dir/rank<rank>.pkl."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    import similaripy_tpu_torch as sim
    from similaripy_tpu_torch.engine import executor, scatter, sym_topk, symmetric, tile_topk
    from similaripy_tpu_torch.parallel import make_mesh
    from similaripy_tpu_torch.parallel import mesh as pmesh

    plan0 = symmetric._plan
    out = {}
    try:
        for shape in meshes:
            mesh = make_mesh(*shape)
            for name in names:
                case = CASES[name]
                symmetric._plan = _forced_plan(*case.plan) if case.plan else plan0
                executor.FOLD_FILTER = case.fold
                sim.clear_caches()
                for mod in (tile_topk, sym_topk, scatter, pmesh):
                    mod.reset_counts()
                res = case.call(sim, verbose=False, device="cpu", mesh=mesh).tocsr()
                out[(shape, name)] = dict(
                    data=res.data, indices=res.indices, indptr=res.indptr, shape=res.shape,
                    route=executor.last_route, plan=_plain_dict(executor.last_plan),
                    k1_plain=tile_topk.plain_calls, k1_kernel=tile_topk.kernel_launches,
                    k2_plain=sym_topk.plain_calls, k2_kernel=sym_topk.kernel_launches,
                    k5_plain=scatter.plain_calls, k5_kernel=scatter.kernel_launches,
                    collectives=pmesh.collectives,
                )
    finally:
        symmetric._plan = plan0
        executor.FOLD_FILTER = True
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def start_world(out_dir, world: int, meshes, names):
    """Spawn `world` ranks over gloo that run the cases; returns a handle
    for ``finish_world`` (the caller may work meanwhile)."""
    import torch.multiprocessing as mp

    out_dir = str(out_dir)
    ctx = mp.spawn(run_rank, args=(world, os.path.join(out_dir, "store"), out_dir,
                                   tuple(meshes), tuple(names)),
                   nprocs=world, join=False)
    return ctx, out_dir, world


def finish_world(handle, timeout: float = 240.0) -> dict:
    """Wait for the ranks and return {(mesh, name): [record of rank 0,
    rank 1, ...]}. A rank's failure raises; a world that does not finish
    within `timeout` seconds is killed."""
    ctx, out_dir, world = handle
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a gloo world of {world} ranks did not finish in {timeout} s")
    per_rank = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            per_rank.append(pickle.load(f))
    return {key: [pr[key] for pr in per_rank] for key in per_rank[0]}


def shared_world(tmp_path_factory, tag: str, world: int, meshes, names, meanwhile) -> dict:
    """The results of one gloo world, run once per test session: under
    pytest-xdist the workers that collect a module share one run through a
    file lock beside their temporary directories (the first runs the world,
    the others wait and read its results). `meanwhile()` runs while the
    ranks compute (the JAX side), or while this worker waits."""
    import fcntl

    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:  # one process: nothing to share
        handle = start_world(tmp_path_factory.mktemp(tag), world, meshes, names)
        meanwhile()
        return finish_world(handle)
    root = tmp_path_factory.getbasetemp().parent / f"mesh-{uid}"
    root.mkdir(exist_ok=True)
    done = root / f"{tag}.pkl"
    with open(root / f"{tag}.lock", "w") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:  # another worker runs the world
            meanwhile()
            fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            handle = start_world(tmp_path_factory.mktemp(tag), world, meshes, names)
            meanwhile()
            results = finish_world(handle)
            tmp = root / f"{tag}.pkl.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(results, f)
            os.replace(tmp, done)
            return results
    meanwhile()
    with open(done, "rb") as f:
        return pickle.load(f)


def to_csr(rec):
    return sp.csr_array((rec["data"], rec["indices"], rec["indptr"]), shape=rec["shape"])


def sorted_rows(x):
    """(values, ids) of a CSR's rows, each sorted by value descending (ties
    by id) and padded to the widest row with -inf and -1."""
    x = x.tocsr()
    counts = np.diff(x.indptr)
    rows = np.repeat(np.arange(x.shape[0]), counts)
    order = np.lexsort((x.indices, -x.data.astype(np.float64), rows))
    pos = np.arange(x.nnz) - x.indptr[rows]
    width = int(counts.max(initial=0))
    v = np.full((x.shape[0], width), -np.inf)
    i = np.full((x.shape[0], width), -1, np.int64)
    v[rows, pos] = x.data[order]
    i[rows, pos] = x.indices[order]
    return v, i


def untied(v, rel):
    """The (rows, width) mask of `sorted_rows` values that are clear, by a
    relative gap `rel`, of their row neighbours and, in the widest rows
    (which the top-k may have cut), of the row's last value: where the
    chosen column id does not depend on how a top-k breaks ties."""
    ok = np.isfinite(v)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(v, axis=1)) > rel * np.maximum(np.abs(v[:, 1:]), 1e-30)
        ok[:, 1:] &= gap
        ok[:, :-1] &= gap
        width = np.isfinite(v).sum(axis=1)
        last = np.where(width > 0, v[np.arange(v.shape[0]), np.maximum(width - 1, 0)], 0.0)
        cut = (width == v.shape[1])[:, None]
        ok &= ~(cut & (np.abs(v - last[:, None]) <= rel * np.abs(last[:, None])))
    return ok


def assert_ids_agree(got, ref, rel=1e-3, rtol=1e-4) -> int:
    """Both results give every untied entry (``untied`` on `ref`, gap
    `rel`) the same column id, at values within `rtol`; returns how many
    entries were compared. The rows must have equal nnz."""
    gv, gi = sorted_rows(got)
    rv, ri = sorted_rows(ref)
    assert np.array_equal(np.isfinite(gv), np.isfinite(rv)), "nnz per row differs"
    ok = untied(rv, rel)
    np.testing.assert_allclose(gv[ok], rv[ok], rtol=rtol, err_msg="values at untied entries")
    bad = np.argwhere(ok & (gi != ri))
    assert bad.shape[0] == 0, f"{bad.shape[0]} untied entries differ in id, first (row, rank) {bad[:3].tolist()}"
    return int(ok.sum())


# ---------------------------------------------------------------------------
# Checks (the test modules add the JAX package's side)
# ---------------------------------------------------------------------------


def reference(sim, name, mesh=None):
    """Case `name` through another package's public API (the JAX package in
    the tests), with the case's plan and fold settings as that package's
    environment knobs."""
    case = CASES[name]
    env = {}
    if case.plan:
        env["SIMILARIPY_TPU_SYM_TC"], env["SIMILARIPY_TPU_SYM_GT"] = map(str, case.plan)
    if not case.fold:
        env["SIMILARIPY_TPU_FOLD_FILTER"] = "0"
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        sim.clear_caches()
        kw = {} if mesh is None else {"mesh": mesh}
        return case.call(sim, verbose=False, **kw).tocsr()
    finally:
        sim.clear_caches()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_ranks(recs, name, world):
    """Every rank returned the same result over the route the case takes,
    launched no kernel (the CPU runs the plain versions) and issued the
    launches and collectives its plan counts."""
    from similaripy_tpu_torch.engine.sym_sharded import schedule_anatomy

    case = CASES[name]
    r0 = recs[0]
    for rank, rec in enumerate(recs):
        for key in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(rec[key], r0[key], err_msg=f"rank {rank} {key}")
        assert rec["route"] == case.route, (rank, rec["route"])
        assert rec["k1_kernel"] == rec["k2_kernel"] == rec["k5_kernel"] == 0
        plan = rec["plan"]
        if case.route == "sym_sharded":
            an = schedule_anatomy(n_tiles=plan["n_tiles"], gt=plan["gt"], N=world)
            assert rec["k2_plain"] == an["k2_blocks"][rank] == plan["blocks"], rank
            assert rec["k5_plain"] == an["k5_scatters"][rank], rank
            assert rec["collectives"] == an["collectives"][rank], rank
            assert rec["k1_plain"] == 0
        else:
            rows, cols = plan["mesh"]
            own = plan["n_groups"] * plan["g_tiles"]
            assert rec["k1_plain"] == plan["n_panels"] * own == plan["k1_launches"], rank
            assert rec["k5_plain"] == plan["n_groups"], rank
            assert rec["collectives"] == (1 + (rows > 1) + (cols > 1)) * (world > 1), rank
            assert rec["k2_plain"] == 0
    if case.route == "sym_sharded":
        # the ranks' blocks partition the schedule
        assert sum(r["k2_plain"] for r in recs) == sum(
            schedule_anatomy(n_tiles=r0["plan"]["n_tiles"], gt=r0["plan"]["gt"], N=1)["k2_blocks"])


# ---------------------------------------------------------------------------
# precision='high' on f32 data (tests/test_torch_split.py): the split-bf16x3
# modes on both routes, held against the port's single device
# ---------------------------------------------------------------------------

HIGH = dict(compute_dtype="float32", precision="high")


def _float_pair():
    """Integer ratings and a float model (tests/test_pallas_kernel.py's
    _int_float_pair): a scoring call on them takes the 'rhs' mode."""
    urm = rand(90, 120, density=0.06, seed=31)
    return urm, random_matrix(120, 80, 0.08, 32)


SPLIT = {
    "high_sym_cosine": _sym(lambda sim, **kw: sim.cosine(
        rand(45, 500, seed=19, integral=False).T.tocsr(), k=8, **HIGH, **kw), plan=(128, 2)),
    "high_sym_tversky": _sym(lambda sim, **kw: sim.tversky(
        rand(45, 500, seed=19, integral=False).T.tocsr(), alpha=0.2, beta=0.9, k=8, **HIGH,
        **kw), plan=(128, 1)),
    "high_cosine_explicit": Case(lambda sim, **kw: sim.cosine(
        M(), M().T.tocsr(), k=30, **HIGH, **kw)),
    "high_scoring_rhs": Case(lambda sim, **kw: sim.dot_product(
        _float_pair()[0], _float_pair()[1], k=12, **HIGH, **kw)),
    "high_scoring_lhs": Case(lambda sim, **kw: sim.dot_product(
        _float_pair()[1].T.tocsr(), _float_pair()[0].T.tocsr(), k=12, **HIGH, **kw)),
    "high_recommend_fold": Case(lambda sim, **kw: sim.recommend(
        ratings()[0], ratings()[1], k=8, **HIGH, **kw)),
}

CASES.update(SPLIT)
