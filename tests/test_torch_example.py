"""The port's item-item recommender example against the JAX package's.

``similaripy_tpu_torch/examples/item_item_recommender.py`` runs the same
pipeline as ``examples/item_item_recommender.py`` (split, BM25, item-item
model, filtered scoring, NDCG@10 / recall@10, tuning, item map): the split
gives the same train matrix byte for byte and the held-out set the JAX
script means to build (its own is shifted by an in-place array update),
the evaluation the same scores, ``main`` the same model and
recommendations (equal nnz, ``check_sum`` within rtol 1e-4) and scores on
the same held-out set (within 2e-3: a tie may move one user's hit) for
each model, and the tuning the same (alpha, beta) draws. The notebook matches its generator,
runs end to end on the CPU and imports nothing of JAX. The float64 rp3beta
oracle of ``chip_smoke.py``'s phase example is held against the port's
rp3beta here.
"""

import ast
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from similaripy_tpu_torch.examples import item_item_recommender as tex
from similaripy_tpu_torch.utils.synth import synthetic_urm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_EXAMPLES = os.path.join(REPO, "similaripy_tpu_torch", "examples")
NB_PATH = os.path.join(PORT_EXAMPLES, "item_item_recommender.ipynb")
SMALL = ["--users", "1200", "--items", "300", "--nnz", "12000"]
MODELS = ["cosine", "asymmetric_cosine", "rp3beta", "s_plus"]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the JAX script, loaded under its own name (its directory is not a package)
jex = _load("jax_item_item_recommender", os.path.join(REPO, "examples",
                                                       "item_item_recommender.py"))
smoke = _load("chip_smoke_for_example_tests", os.path.join(REPO, "chip_smoke.py"))


def check_sum(x) -> float:
    """tests/oracles.py::check_sum: tie-robust scalar of a top-k matrix."""
    aux = np.asarray(sp.csr_array(x).sum(axis=1), dtype=np.float64).ravel()
    return float(np.sum(aux**2))


def _same_csr(a, b):
    a, b = sp.csr_array(a), sp.csr_array(b)
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


class _Recorder:
    """Stands in for the JAX package inside the JAX script: every call
    passes through, the last result of each public name is kept."""

    def __init__(self, mod):
        self._mod = mod
        self.out = {}

    def __getattr__(self, name):
        fn = getattr(self._mod, name)
        if not callable(fn):
            return fn

        def call(*args, **kwargs):
            self.out[name] = fn(*args, **kwargs)
            return self.out[name]
        return call


def _lines(text, prefix):
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def _train_nnz(text):
    return re.search(r"^train nnz=([0-9,]+), held-out", text, re.M).group(1)


def _run_jax(monkeypatch, argv):
    rec = _Recorder(jex.sim)
    monkeypatch.setattr(jex, "sim", rec)
    assert jex.main(argv) == 0
    return rec.out


def _codes(m):
    m = sp.csr_array(m).tocoo()
    return np.sort(m.coords[0].astype(np.int64) * m.shape[1] + m.coords[1])


@pytest.mark.parametrize("shape", [(1200, 300, 12_000, 0), (500, 80, 4_000, 5)],
                         ids=["1200x300", "500x80"])
def test_holdout_split_matches_jax(shape):
    """train is the JAX script's byte for byte; test holds exactly the
    ratings train lacks, n of each user with more than n + 1 (the JAX
    script's test is built after its in-place eliminate_zeros has shifted
    the index array it shares with train, so it holds other items: see
    test_jax_split_held_out_set_is_shifted)."""
    n_users, n_items, nnz, seed = shape
    urm = synthetic_urm(n_users=n_users, n_items=n_items, nnz=nnz, seed=seed)
    counts = np.diff(urm.indptr)
    for n_holdout, split_seed in ((2, 7), (1, 11)):
        train, test = tex.holdout_split(urm, n_holdout=n_holdout, seed=split_seed)
        ref_train, _ = jex.holdout_split(urm.copy(), n_holdout=n_holdout, seed=split_seed)
        _same_csr(train, ref_train)
        np.testing.assert_array_equal(_codes(test), np.setdiff1d(_codes(urm), _codes(train)))
        assert test.dtype == np.float32 and np.all(test.data == 1.0)
        np.testing.assert_array_equal(
            np.diff(test.indptr), np.where(counts > n_holdout + 1, n_holdout, 0))


def test_holdout_split_leaves_its_input_alone():
    urm = synthetic_urm(n_users=600, n_items=100, nnz=6_000, seed=1)
    before = urm.copy()
    train, test = tex.holdout_split(urm)
    assert train.nnz + test.nnz == urm.nnz and test.nnz > 0
    _same_csr(urm, before)


def test_jax_split_held_out_set_is_shifted():
    """Why the port's test set differs from the JAX script's: there train
    shares urm's index arrays, eliminate_zeros compacts them in place, and
    test then reads the shifted array, so some held-out items are items
    still in train (which filtered scoring can never recommend) or items
    the user never rated. The port copies the arrays."""
    urm = synthetic_urm(n_users=1200, n_items=300, nnz=12_000, seed=0)
    train, test = jex.holdout_split(urm.copy())
    in_train = sp.csr_array(test, dtype=bool).multiply(sp.csr_array(train, dtype=bool))
    assert in_train.count_nonzero() > 0
    train_p, test_p = tex.holdout_split(urm)
    assert sp.csr_array(test_p, dtype=bool).multiply(
        sp.csr_array(train_p, dtype=bool)).count_nonzero() == 0


def test_ndcg_and_recall_equal():
    rng = np.random.default_rng(3)
    urm = synthetic_urm(n_users=400, n_items=120, nnz=5_000, seed=2)
    _, test = tex.holdout_split(urm)
    recs = sp.random_array((400, 120), density=0.08, format="csr", dtype=np.float32,
                           random_state=rng)
    for n in (5, 10):
        assert tex.ndcg_and_recall_at(recs, test, n=n) == jex.ndcg_and_recall_at(
            recs, test, n=n)


@pytest.mark.parametrize("model", MODELS)
def test_main_matches_jax(model, monkeypatch, capsys):
    ref = _run_jax(monkeypatch, SMALL + ["--model", model])
    jax_out = capsys.readouterr().out
    assert tex.main(SMALL + ["--model", model, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    run = tex.last_run
    # the data lines agree (the held-out count differs: the JAX script's
    # test set is shifted, see test_jax_split_held_out_set_is_shifted)
    assert _lines(out, "URM:") == _lines(jax_out, "URM:")
    assert _train_nnz(out) == _train_nnz(jax_out)
    assert re.search(rf"^{model} similarity: [0-9.]+s, nnz=", out, re.M)
    W_ref, recs_ref = ref[model], ref["dot_product"]
    for got, want in ((run["W"], W_ref), (run["recs"], recs_ref)):
        assert got.nnz == want.nnz
        np.testing.assert_allclose(check_sum(got), check_sum(want), rtol=1e-4)
    # both packages' recommendations scored against the same held-out set
    ndcg, recall = jex.ndcg_and_recall_at(recs_ref, run["test"], n=10)
    assert abs(run["ndcg"] - ndcg) <= 2e-3 and abs(run["recall"] - recall) <= 2e-3
    assert sorted(run["seconds"]) == sorted(
        ["load", "split", "bm25", "model", "scoring", "evaluation"])
    # no recommended item was seen in train
    recs = run["recs"].tocsr()
    picked = sp.csr_array((np.ones(recs.nnz), recs.indices, recs.indptr), shape=recs.shape)
    assert picked.multiply(sp.csr_array(run["train"], dtype=bool)).count_nonzero() == 0


TRIAL = re.compile(r"^  trial (\d+): alpha=([0-9.]+) beta=([0-9.]+) -> NDCG@10 ([0-9.]+)$",
                   re.M)


def test_tuning_draws_match_jax(monkeypatch, capsys):
    """Without Optuna both take the seeded random search: main draws the
    same (alpha, beta), and the tuner's trials on the same split score
    within 2e-3 of the JAX tuner's."""
    monkeypatch.setitem(sys.modules, "optuna", None)
    _run_jax(monkeypatch, SMALL + ["--tune", "2"])
    ref = TRIAL.findall(capsys.readouterr().out)
    assert tex.main(SMALL + ["--tune", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = TRIAL.findall(out)
    assert len(got) == len(ref) == 2
    assert [g[:3] for g in got] == [r[:3] for r in ref]  # trial number, alpha, beta
    assert "random-search (optuna not installed)" in out
    assert re.search(r"^tuned:  NDCG@10 = ", out, re.M)
    assert set(tex.last_run["tuned"]["params"]) == {"alpha", "beta"}

    run = tex.last_run
    train, test = run["train"], run["test"]
    best = tex.tune_hyperparams(train, run["train_w"], test, 100, 3, device="cpu")
    got = TRIAL.findall(capsys.readouterr().out)
    jax_train_w = jex.sim.normalization.bm25(train, axis=1, k1=1.2, b=0.75)
    best_ref = jex.tune_hyperparams(train, jax_train_w, test, 100, 3)
    ref = TRIAL.findall(capsys.readouterr().out)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g[:3] == r[:3]
        assert abs(float(g[3]) - float(r[3])) <= 2e-3
    assert best == best_ref


def test_data_path_csv(tmp_path, monkeypatch, capsys):
    """--data-path on a MovieLens-format CSV, in a subprocess, against the
    JAX script on the same file."""
    urm = synthetic_urm(n_users=400, n_items=150, nnz=8000, seed=11)
    coo = urm.tocoo()
    csv = tmp_path / "ratings.csv"
    with open(csv, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for u, i, v in zip(coo.coords[0], coo.coords[1], coo.data):
            # real MovieLens ids are arbitrary ints; offset to prove the remap
            f.write(f"{u + 1},{i * 7 + 3},{v},1147880044\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    argv = ["--data-path", str(csv), "--model", "cosine", "--k", "20"]
    proc = subprocess.run(
        [sys.executable, "-m", "similaripy_tpu_torch.examples.item_item_recommender",
         *argv, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert f"loading ratings from {csv}" in proc.stdout
    _run_jax(monkeypatch, argv)
    jax_out = capsys.readouterr().out
    assert _lines(proc.stdout, "URM:") == _lines(jax_out, "URM:")
    assert _train_nnz(proc.stdout) == _train_nnz(jax_out)
    assert re.search(r"^NDCG@10 = [0-9.]+   recall@10 = [0-9.]+$", proc.stdout, re.M)


def test_parquet_path_raises(tmp_path):
    with pytest.raises(ValueError, match="parquet"):
        tex.main(["--data-path", str(tmp_path / "events.parquet"), "--device", "cpu"])


def test_cuda_without_a_card_raises_before_loading(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the data path does not exist: the device check comes first
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.main(["--data-path", str(tmp_path / "missing.npz")])


def test_viz_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "items.png"
    assert tex.main(SMALL + ["--model", "cosine", "--viz", str(out), "--device", "cpu"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_rp3beta_oracle_of_the_smoke_holds_on_the_cpu():
    """chip_smoke.py's float64 rp3beta oracle (both sides l1-normalised and
    raised to alpha, columns over popularity^beta) and its filtered scoring
    oracle against the port's calls on the CPU: the symmetric and the
    general route, two (alpha, beta)."""
    import similaripy_tpu_torch as sim

    urm = synthetic_urm(n_users=1200, n_items=300, nnz=12_000, seed=4)
    train, _ = tex.holdout_split(urm)
    train_w = sim.bm25(train, device="cpu")
    rows = np.arange(0, 300, 7)
    users = np.arange(0, train.shape[0], 13)
    for alpha, beta in ((1.0, 0.6), (0.7, 0.3)):
        m1, m2 = smoke._rp3beta_oracle(train.T, alpha, beta)
        expect = smoke._oracle_rows(m1, m2, rows, 50, l2=False)
        W = sim.rp3beta(train.T, alpha=alpha, beta=beta, k=50, verbose=False, device="cpu")
        smoke._check_oracle("rp3beta", W, rows, expect)
        Wg = sim.rp3beta(train.T, alpha=alpha, beta=beta, k=50, verbose=False, device="cpu",
                         target_rows=rows[::-1].copy())
        smoke._check_oracle("rp3beta, general route", Wg, rows, expect)
        recs = sim.dot_product(train_w, W.T, k=10, filter_cols=train, verbose=False,
                               format_output="csr", device="cpu")
        smoke._check_oracle("scoring", recs, users,
                            smoke._oracle_rows(train_w, W.T, users, 10, l2=False, filt=train))
    # the oracle fails on a wrong beta
    m1, m2 = smoke._rp3beta_oracle(train.T, 1.0, 0.0)
    with pytest.raises(AssertionError):
        smoke._check_oracle("rp3beta, beta 0", W, rows,
                            smoke._oracle_rows(m1, m2, rows, 50, l2=False))


# ---------------------------------------------------------------------------
# The notebook
# ---------------------------------------------------------------------------


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in ("jax", "jaxlib", "similaripy_tpu", "benchmarks"))


def test_notebook_in_sync_with_generator():
    nbformat = pytest.importorskip("nbformat")
    from similaripy_tpu_torch.examples import make_notebook

    on_disk = nbformat.read(NB_PATH, as_version=4)
    regen = make_notebook.build()
    assert [(c.cell_type, c.source) for c in on_disk.cells] == [
        (c.cell_type, c.source) for c in regen.cells]
    # committed without outputs
    assert all(not c.get("outputs") for c in on_disk.cells if c.cell_type == "code")


def test_notebook_imports_nothing_of_jax():
    import json

    with open(NB_PATH) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    assert cells[0]["source"] == ['DEVICE = "cuda"  # or "cpu"']
    calls = 0
    for c in cells:
        src = "".join(c["source"])
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                if isinstance(node, ast.Call) and any(
                        kw.arg == "device" for kw in node.keywords):
                    calls += 1
                continue
            assert not [n for n in names if _forbidden(n)], src
    assert calls == 6  # every public call passes device=DEVICE


def test_make_notebook_imports_without_nbformat(monkeypatch):
    monkeypatch.setitem(sys.modules, "nbformat", None)
    mod = _load("make_notebook_without_nbformat", os.path.join(PORT_EXAMPLES,
                                                               "make_notebook.py"))
    with pytest.raises(ImportError):
        mod.build()


def test_notebook_executes_end_to_end_on_the_cpu():
    nbformat = pytest.importorskip("nbformat")
    nbclient = pytest.importorskip("nbclient")

    nb = nbformat.read(NB_PATH, as_version=4)
    at = next(i for i, c in enumerate(nb.cells) if c.source.startswith("DEVICE = "))
    nb.cells.insert(at + 1, nbformat.v4.new_code_cell('DEVICE = "cpu"'))
    client = nbclient.NotebookClient(
        nb, timeout=600, kernel_name="python3",
        resources={"metadata": {"path": PORT_EXAMPLES}},
    )
    client.execute()
    text = "".join(o.get("text", "") for c in nb.cells for o in c.get("outputs", [])
                   if o.get("output_type") == "stream")
    assert "NDCG@10" in text
    assert "rp3beta similarity" in text
