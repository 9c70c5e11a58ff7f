"""The port's data helpers and dataset loaders against the JAX package's.

utils/synth.py gives the same matrix byte for byte as the JAX package's
generator; utils/npz_cache.py treats a stale shape as a miss;
benchmarks/dataset_loaders.load_urm resolves a CSV, an npz, a
data/<name>/ directory and the synthetic fallback to the same matrices as
benchmarks/dataset_loaders.py. The port downloads nothing and reads no
parquet event log.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import scipy.sparse as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
sys.path.insert(0, REPO)

import benchmarks.dataset_loaders as jdl  # noqa: E402
from similaripy_tpu.utils.synth import synthetic_urm as jax_synthetic_urm  # noqa: E402
from similaripy_tpu_torch.benchmarks import dataset_loaders as tdl  # noqa: E402
from similaripy_tpu_torch.utils import npz_cache, synth  # noqa: E402

SHAPES = [(300, 120, 3_000, 0), (1_000, 500, 20_000, 9), (64, 1_000, 5_000, 3)]


def _assert_same_matrix(got, ref):
    got, ref = sp.csr_array(got), sp.csr_array(ref)
    assert got.shape == ref.shape
    for f in ("indptr", "indices", "data"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ratings", ["half_stars", "binary", "uniform"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{u}x{i}" for u, i, _, _ in SHAPES])
def test_synthetic_urm_equals_jax_byte_for_byte(shape, ratings):
    n_users, n_items, nnz, seed = shape
    kw = dict(n_users=n_users, n_items=n_items, nnz=nnz, seed=seed, ratings=ratings)
    got, ref = synth.synthetic_urm(**kw), jax_synthetic_urm(**kw)
    _assert_same_matrix(got, ref)
    assert got.nnz == nnz


def test_ml32m_constants_equal_jax():
    from similaripy_tpu.utils import synth as jsynth

    assert (synth.ML32M_USERS, synth.ML32M_ITEMS, synth.ML32M_NNZ) == (
        jsynth.ML32M_USERS, jsynth.ML32M_ITEMS, jsynth.ML32M_NNZ)
    assert tdl.DATASETS == jdl.DATASETS


def test_cached_npz_hit_and_stale_shape_miss(tmp_path):
    p = str(tmp_path / "c.npz")
    calls = []

    def gen(shape):
        def make():
            calls.append(shape)
            return sp.random_array(shape, density=0.5, format="csr", dtype=np.float32,
                                   random_state=0)
        return make

    m1, hit1 = npz_cache.cached_npz(p, gen((4, 6)), expect_shape=(4, 6))
    m2, hit2 = npz_cache.cached_npz(p, gen((4, 6)), expect_shape=(4, 6))
    assert (hit1, hit2) == (False, True) and len(calls) == 1
    assert (m1 != m2).nnz == 0
    # the expected shape changed: the cached file is stale, never served
    m3, hit3 = npz_cache.cached_npz(p, gen((8, 6)), expect_shape=(8, 6))
    assert not hit3 and m3.shape == (8, 6) and len(calls) == 2
    # a stale nnz is a miss too
    _, hit4 = npz_cache.cached_npz(p, gen((8, 6)), expect_shape=(8, 6), expect_nnz=m3.nnz + 1)
    assert not hit4 and len(calls) == 3


def test_load_urm_csv_equals_jax():
    path = os.path.join(FIXTURES, "ratings.csv")
    got, src = tdl.load_urm("movielens_32m", data_path=path)
    ref, ref_src = jdl.load_urm("movielens_32m", data_path=path)
    _assert_same_matrix(got, ref)
    assert src == ref_src == f"file:{path}"


def test_load_urm_npz_equals_jax(tmp_path):
    m = sp.random_array((30, 20), density=0.2, format="csr", dtype=np.float32,
                        random_state=np.random.default_rng(3))
    path = str(tmp_path / "urm.npz")
    sp.save_npz(path, sp.csr_matrix(m))
    got, _ = tdl.load_urm("anything", data_path=path)
    _assert_same_matrix(got, jdl.load_urm("anything", data_path=path)[0])
    _assert_same_matrix(got, m)


@pytest.mark.parametrize("fname", ["ratings.csv", "ratings.npz", "urm.npz"])
def test_load_urm_local_data_dir_equals_jax(fname, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("data/movielens_32m")
    if fname.endswith(".csv"):
        shutil.copy(os.path.join(FIXTURES, "ratings.csv"), f"data/movielens_32m/{fname}")
    else:
        m = sp.random_array((12, 9), density=0.3, format="csr", dtype=np.float32,
                            random_state=np.random.default_rng(4))
        sp.save_npz(f"data/movielens_32m/{fname}", sp.csr_matrix(m))
    got, src = tdl.load_urm("movielens_32m")
    ref, ref_src = jdl.load_urm("movielens_32m")
    _assert_same_matrix(got, ref)
    assert src == ref_src == f"file:{os.path.join('data', 'movielens_32m', fname)}"


def test_load_urm_synthetic_fallback_equals_jax(tmp_path, monkeypatch):
    """synthetic_small at its published shape, generated by both loaders
    (the JAX loader's disk cache bypassed, the port's in tmp_path); the
    port's second call is served from its cache."""
    import similaripy_tpu.utils.npz_cache as jcache

    monkeypatch.setattr(jcache, "cached_npz", lambda path, gen, **kw: (gen(), False))
    monkeypatch.setattr(tdl, "SYNTH_DIR", tmp_path / "synth")
    got, src = tdl.load_urm("synthetic_small", seed=2)
    ref, _ = jdl.load_urm("synthetic_small", seed=2)
    _assert_same_matrix(got, ref)
    assert got.shape == tdl.DATASETS["synthetic_small"][:2]
    assert src == "synthetic:synthetic_small (published shape)"
    cached = list((tmp_path / "synth").glob("*.npz"))
    assert [p.name for p in cached] == [".synth_synthetic_small_2_1000000.npz"]
    again, src2 = tdl.load_urm("synthetic_small", seed=2)
    _assert_same_matrix(again, got)
    assert src2.endswith("disk cache)")


def test_movielens_32m_seed_0_reads_the_tracked_file(monkeypatch, tmp_path):
    """The ML-32M stand-in resolves to the tracked .bench_data_1.0.npz at
    the repository root, from any working directory; another seed does not."""
    seen = []

    def fake_cached_npz(path, gen, expect_shape=None, **kw):
        seen.append((path, expect_shape))
        return sp.csr_array(expect_shape, dtype=np.float32), True

    monkeypatch.setattr(tdl, "cached_npz", fake_cached_npz)
    monkeypatch.setattr(tdl, "SYNTH_DIR", tmp_path / "synth")
    monkeypatch.chdir(tmp_path)
    tdl.load_urm("movielens_32m")
    tdl.load_urm("movielens_32m", seed=1)
    assert seen[0] == (os.path.join(REPO, ".bench_data_1.0.npz"), (200_948, 84_432))
    assert seen[1][0] == str(tmp_path / "synth" / ".synth_movielens_32m_1_32000204.npz")


def test_parquet_and_unknown_dataset_raise(tmp_path):
    with pytest.raises(ValueError, match="parquet"):
        tdl.load_file(str(tmp_path / "multi_event.parquet"))
    with pytest.raises(ValueError, match="unknown dataset"):
        tdl.load_urm("nope")
    assert not hasattr(tdl, "_has_egress")
