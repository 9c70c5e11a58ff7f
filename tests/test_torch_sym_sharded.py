"""The port's sharded symmetric executor (``engine/sym_sharded.py``) on
gloo worlds of CPU processes, against the JAX package.

The counterparts of tests/test_sym_sharded.py: the route, cosine over a
multi-pair triangle, every similarity family (asymmetric col-side
re-runs included) on a ragged triangle, a single tile (most ranks idle),
float32, the edges of k, and no neighbour delivered twice across ranks.
The JAX test's tile knobs (SIMILARIPY_TPU_SYM_TC / _GT) become a forced
port plan (``tests/torch_mesh_cases.py``). One module fixture spawns a
world of 4 ranks that runs every case on the meshes (1, 4), (4, 1) and
(2, 2). Each case checks that every rank returned the same result, that
each rank's K2 blocks, K5 scatters and collectives equal
``schedule_anatomy``'s counts for the plan, and that the result equals the
JAX package's on one device (equal nnz, check_sum within rtol 1e-4); the
JAX package's mesh of the same shape, on conftest's 8 virtual CPU devices,
is held against the multi-pair cosine on every shape and the
asymmetric tversky on (2, 2) (its mesh programs compile for seconds each). The JAX package's TPU-only cases
(Pallas interpret mode, split-bf16x3, its sharded densify knob) have no
counterpart.
"""

import jax
import numpy as np
import pytest

import similaripy_tpu as jsim
import torch_mesh_cases as mc
from oracles import check_sum
from similaripy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from similaripy_tpu_torch.engine import symmetric
from similaripy_tpu_torch.engine.sym_sharded import pair_schedule, schedule_anatomy

_JAX: dict = {}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return mc.shared_world(tmp_path_factory, "sym-world4", 4, mc.WORLD4_MESHES,
                           list(mc.SYM), lambda: [_jax(n) for n in mc.SYM])


def _jax(name, shape=None):
    if (name, shape) not in _JAX:
        mesh = None
        if shape is not None:
            mesh = jax_make_mesh(rows=shape[0], cols=shape[1],
                                 devices=jax.devices()[: shape[0] * shape[1]])
        _JAX[(name, shape)] = mc.reference(jsim, name, mesh)
    return _JAX[(name, shape)]


def _same(got, ref):
    assert got.shape == ref.shape
    assert got.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-4)


def _ids(keys):
    return [f"{r}x{c}-{name}" for (r, c), name in keys]


KEYS = [(shape, name) for shape in mc.WORLD4_MESHES for name in mc.SYM]


@pytest.mark.parametrize("shape,name", KEYS, ids=_ids(KEYS))
def test_matches_jax(world4, shape, name):
    recs = world4[(shape, name)]
    mc.check_ranks(recs, name, 4)
    got = mc.to_csr(recs[0])
    _same(got, _jax(name))
    mc.assert_ids_agree(got, _jax(name))
    plan = recs[0]["plan"]
    if mc.CASES[name].plan:
        assert (plan["tc"], plan["gt"]) == mc.CASES[name].plan
    if name in ("sim_asy_cosine", "sim_tversky"):
        assert plan["asym"]
    if name == "float32":
        assert plan["compute_dtype"] == "float32"
    if name == "no_duplicates":
        # a block computed on two ranks would repeat a column in a row
        for r in range(got.shape[0]):
            cols = got.indices[got.indptr[r]:got.indptr[r + 1]]
            assert len(set(cols.tolist())) == cols.shape[0], r


JAX_MESH = [(shape, "cosine") for shape in mc.WORLD4_MESHES] + [((2, 2), "sim_tversky")]


@pytest.mark.parametrize("shape,name", JAX_MESH, ids=_ids(JAX_MESH))
def test_matches_jax_mesh(world4, shape, name):
    """check_sum against the JAX package's mesh of the same shape, as
    tests/test_sym_sharded.py compares it. At some tile knobs (tc 128 with
    gt 1 over 600 items, gt 2 over 500) that mesh returns neighbours under
    a repeated column id (tversky: 6,600 entries, 5,640 distinct on its
    (1, 4) mesh; its single-device results have none), so nnz is compared
    with the JAX mesh on the multi-pair cosine only, and with the JAX
    single device on every case (test_matches_jax). The port's mesh results
    repeat no id."""
    got = mc.to_csr(world4[(shape, name)][0])
    ref = _jax(name, shape)
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-4)
    if name == "cosine":
        assert got.nnz == ref.nnz
    for r in range(got.shape[0]):
        cols = got.indices[got.indptr[r]:got.indptr[r + 1]]
        assert len(set(cols.tolist())) == cols.shape[0], r


@pytest.mark.parametrize("n_tiles,gt", [(8, 2), (9, 3), (5, 1), (1, 1), (12, 4)])
@pytest.mark.parametrize("N", [1, 2, 3, 4, 8])
def test_schedule_partitions_the_single_device_sweep(n_tiles, gt, N):
    """Every step of the single-device pair sweep goes to exactly one rank:
    the ranks' K2 blocks sum to the single-device count, and the steps are
    dealt within one of even."""
    sched = pair_schedule(n_tiles, gt, N)
    single = pair_schedule(n_tiles, gt, 1)
    assert [(p, [(t, n) for t, n, _ in s]) for p, s in sched] == \
        [(p, [(t, n) for t, n, _ in s]) for p, s in single]
    an = schedule_anatomy(n_tiles=n_tiles, gt=gt, N=N)
    assert sum(an["k2_blocks"]) == symmetric._triangle_counts(n_tiles, gt)[0]
    steps = [sum(1 for _p, s in sched for _t, _n, r in s if r == rank) for rank in range(N)]
    assert max(steps) - min(steps) <= 1
    assert an["collectives"] == [(1 + an["pairs"]) if N > 1 else 0] * N
