"""The port's grouped sharded route (the router ``engine/executor.py::execute``
with ``mesh=``, into ``execute_grouped``) on gloo worlds of CPU processes,
against the JAX package.

The counterparts of tests/test_sharded.py (oracle cosine, the similarities,
a filter_cols matrix, target rows and columns, uneven rows; with an
explicit matrix2, so the grouped route runs) and of test_multihost.py's
engine parity, plus the exclude-seen fold on a mesh. One module fixture
spawns a world of 4 ranks that runs every case on the meshes (1, 4),
(4, 1) and (2, 2), and one of 2 ranks on (1, 2) and (2, 1)
(``tests/torch_mesh_cases.py``). Each case checks that every rank returned
the same result, that the launch counters equal the plan's counts, and
that the result equals the JAX package's on one device (equal nnz,
check_sum within rtol 1e-4); the JAX package's own mesh of the same shape,
on conftest's 8 virtual CPU devices, is held against the port on one
grouped case per shape (its mesh programs compile for seconds each;
tests/test_torch_sym_sharded.py holds the symmetric route against it).
"""

import jax
import numpy as np
import pytest

import similaripy_tpu as jsim
import similaripy_tpu_torch as tsim
import torch_mesh_cases as mc
from oracles import check_sum
from similaripy_tpu.parallel.mesh import make_mesh as jax_make_mesh

_JAX: dict = {}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return mc.shared_world(tmp_path_factory, "sharded-world4", 4, mc.WORLD4_MESHES,
                           list(mc.SHARDED), lambda: [_jax(n) for n in mc.SHARDED])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return mc.shared_world(tmp_path_factory, "sharded-world2", 2, mc.WORLD2_MESHES,
                           list(mc.MULTIHOST), lambda: [_jax(n) for n in mc.MULTIHOST])


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


KEYS4 = [(shape, name) for shape in mc.WORLD4_MESHES for name in mc.SHARDED]
KEYS2 = [(shape, name) for shape in mc.WORLD2_MESHES for name in mc.MULTIHOST]


@pytest.mark.parametrize("shape,name", KEYS4, ids=_ids(KEYS4))
def test_world4_matches_jax(world4, shape, name):
    recs = world4[(shape, name)]
    mc.check_ranks(recs, name, 4)
    got = mc.to_csr(recs[0])
    _same(got, _jax(name))
    mc.assert_ids_agree(got, _jax(name))
    plan = recs[0]["plan"]
    if name in ("fold_recommend", "filter_cols_matrix"):
        assert plan["fold"] is not None
    elif mc.CASES[name].route == "sharded":
        assert plan["fold"] is None
    if name == "int8_grouped":
        assert plan["compute_dtype"] == "int8"


@pytest.mark.parametrize("shape,name", KEYS2, ids=_ids(KEYS2))
def test_world2_engine_parity(world2, shape, name):
    """test_multihost.py's engine parity: int8 self-similarity, and a
    filtered scoring call whose rows never hold a seen item."""
    recs = world2[(shape, name)]
    mc.check_ranks(recs, name, 2)
    got = mc.to_csr(recs[0])
    _same(got, _jax(name))
    mc.assert_ids_agree(got, _jax(name))
    if name == "mh_recs":
        assert recs[0]["plan"]["fold"] is not None
        seen = mc._multihost()[0].tocsr()
        for r in range(seen.shape[0]):
            row = set(got.indices[got.indptr[r]:got.indptr[r + 1]])
            assert not row & set(seen.indices[seen.indptr[r]:seen.indptr[r + 1]]), r
    else:
        assert recs[0]["plan"]["compute_dtype"] == "int8"


JAX_MESH = [(shape, name) for shape in mc.WORLD4_MESHES for name in ("fold_recommend",)]
JAX_MESH += [(shape, "mh_recs") for shape in mc.WORLD2_MESHES]


@pytest.mark.parametrize("shape,name", JAX_MESH, ids=_ids(JAX_MESH))
def test_matches_jax_mesh(world4, world2, shape, name):
    recs = (world4 if shape in mc.WORLD4_MESHES else world2)[(shape, name)]
    _same(mc.to_csr(recs[0]), _jax(name, shape))


def test_filter_index_sets_match_single_device(world4):
    """Per-row seen-item masking survives the distributed top-k merge: the
    index set of every row equals the JAX package's single-device one
    (random float scores, so no ties)."""
    ref = _jax("filter_cols_matrix")
    for shape in mc.WORLD4_MESHES:
        got = mc.to_csr(world4[(shape, "filter_cols_matrix")][0])
        for u in range(got.shape[0]):
            np.testing.assert_array_equal(
                np.sort(got.indices[got.indptr[u]:got.indptr[u + 1]]),
                np.sort(ref.indices[ref.indptr[u]:ref.indptr[u + 1]]),
                err_msg=f"{shape} row {u}")


def test_fold_and_masked_equal_on_every_mesh(world4):
    for shape in mc.WORLD4_MESHES:
        a = mc.to_csr(world4[(shape, "fold_recommend")][0])
        b = mc.to_csr(world4[(shape, "masked_recommend")][0])
        assert a.nnz == b.nnz
        np.testing.assert_allclose(check_sum(a), check_sum(b), rtol=1e-6)


def test_several_panel_batches(world4):
    """4,200 target rows: three panel batches on the (1, 4) mesh, two on
    (2, 2), one on (4, 1)."""
    batches = {shape: world4[(shape, "many_rows")][0]["plan"]["n_panels"]
               for shape in mc.WORLD4_MESHES}
    assert batches == {(1, 4): 3, (4, 1): 1, (2, 2): 2}


def test_make_mesh_needs_a_process_group():
    from similaripy_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="process group"):
        tsim.cosine(mc.rand(20, 30), k=3, verbose=False, device="cpu", mesh=object())


def test_collectives_of_a_cuda_group(monkeypatch):
    """The NCCL branch of the collectives, which the gloo worlds here never
    take: a fake three-rank group of device type 'cuda'. The group's device
    is the rank's current card; all_gather hands the collective the mesh
    dimension's group and returns the members in rank order, on the input's
    device; agree_min reduces a tuple in one collective."""
    import torch

    from similaripy_tpu_torch.parallel import mesh as pmesh

    class CudaMesh:
        device_type = "cuda"
        mesh_dim_names = ("rows", "cols")

        def get_group(self, axis):
            return f"group-{axis}"

    mesh = CudaMesh()
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert pmesh.comm_device(mesh) == torch.device("cuda", 2)
    # no card here: the collectives take CPU tensors in its place
    monkeypatch.setattr(pmesh, "comm_device", lambda m: torch.device("cpu"))
    seen = []

    def all_gather(out, src, group=None):
        seen.append(group)
        for r, o in enumerate(out):
            o.copy_(src + 10 * r)

    def all_reduce(t, op=None):
        seen.append(op)
        t.sub_(torch.tensor([3, 7], dtype=t.dtype))

    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda group=None: 3)
    monkeypatch.setattr(pmesh.dist, "all_gather", all_gather)
    monkeypatch.setattr(pmesh.dist, "all_reduce", all_reduce)
    pmesh.reset_counts()
    parts = pmesh.all_gather(torch.arange(4, dtype=torch.int32), mesh, "cols")
    assert [p.tolist() for p in parts] == [[0, 1, 2, 3], [10, 11, 12, 13], [20, 21, 22, 23]]
    assert pmesh.agree_min((100, -4), mesh) == (97, -11)
    assert seen == ["group-cols", pmesh.dist.ReduceOp.MIN]
    assert pmesh.collectives == 2
