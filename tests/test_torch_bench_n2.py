"""The port's N-card harness (``similaripy_tpu_torch/benchmarks/bench_n2.py``)
on the CPU: the smoke on two gloo ranks in both stages exits 0 with the
mesh result equal to the single device's, the report carries the JAX
harness's keys, the single-device result equals the JAX package's cosine
on the same matrix, and asking for cards that are not there exits 3
without falling back to the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX harness's report (benchmarks/bench_n2.py)
JAX_KEYS = {"mode", "stage", "backend", "n", "k", "geometry", "best_s", "measured_speedup",
            "measured_efficiency", "modeled_speedup", "modeled_efficiency",
            "modeled_seconds", "check_sum_ok"}


def _run(args, tmp_path, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.run(
        [sys.executable, "-m", "similaripy_tpu_torch.benchmarks.bench_n2", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=str(tmp_path))


def _check_sum(x) -> float:
    aux = np.asarray(sp.csr_array(x).sum(axis=1), dtype=np.float64).ravel()
    return float(np.sum(aux**2))


@pytest.mark.parametrize("stage", ["similarity", "scoring"])
def test_cpu_smoke_on_two_gloo_ranks(stage, tmp_path):
    out = tmp_path / "n2.json"
    proc = _run(["--n", "2", "--smoke", "--device", "cpu", "--rounds", "1",
                 "--stage", stage, "--out", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rep = json.loads(out.read_text())
    assert JAX_KEYS <= set(rep)
    assert rep["mode"] == "smoke" and rep["stage"] == stage and rep["backend"] == "cpu"
    assert rep["check_sum_ok"] is True and rep["n"] == 2 and rep["card"] is None
    assert set(rep["best_s"]) == {"1", "2"}
    assert rep["nnz"]["1"] == rep["nnz"]["2"]
    assert rep["check_sum"]["2"] == pytest.approx(rep["check_sum"]["1"], rel=1e-5)
    assert "check_sum OK" in proc.stdout
    if stage == "scoring":
        # no schedule model for the grouped executor: measured numbers only
        assert rep["modeled_efficiency"] is None and rep["modeled_seconds"] is None
        return
    assert set(rep["modeled_seconds"]) == {"1", "2"}
    assert rep["plan"]["compute_dtype"] == "int8"

    # the single-device result against the JAX package on the same matrix
    import similaripy_tpu as jsim
    from similaripy_tpu.utils.synth import synthetic_urm

    urm = synthetic_urm(n_users=3000, n_items=800, nnz=40_000, seed=0)
    ref = jsim.cosine(urm.T.tocsr(), k=100, verbose=False)
    assert rep["geometry"] == {"C": 800, "U": 3000, "nnz": int(urm.nnz)}
    assert rep["nnz"]["1"] == ref.nnz
    np.testing.assert_allclose(rep["check_sum"]["1"], _check_sum(ref), rtol=1e-4)


def test_cuda_without_enough_cards_exits_3(tmp_path):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    out = tmp_path / "n2.json"
    proc = _run(["--n", str(have + 1), "--out", str(out)], tmp_path, timeout=120)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert f"need {have + 1} cards, have {have}" in proc.stdout
    assert not out.exists()
