"""The port's benchmark suite (similaripy_tpu_torch/benchmarks/) on the CPU,
against the JAX package's scripts in benchmarks/.

run_benchmarks in both stages, with the results of the JAX runner on the
same data; BenchmarkResult, the timing arithmetic and
format_summary_table equal to the originals'; system_info without a card
(and nvidia-smi); a port report read by the unchanged
benchmarks/compare_benchmarks.py; the port's compare_benchmarks printing
what the original prints; bench_gate end to end; and the kernel stamp's
hash (a .cu edit and a code edit of a geometry source change it, a comment
edit and the build directory do not).
"""

import dataclasses
import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import benchmark as jbm  # noqa: E402
import compare_benchmarks as jcb  # noqa: E402
import run_benchmarks as jrb  # noqa: E402
from similaripy_tpu_torch.benchmarks import bench_gate  # noqa: E402
from similaripy_tpu_torch.benchmarks import benchmark as tbm  # noqa: E402
from similaripy_tpu_torch.benchmarks import compare_benchmarks as tcb  # noqa: E402
from similaripy_tpu_torch.benchmarks import kernel_stamp  # noqa: E402
from similaripy_tpu_torch.benchmarks import run_benchmarks as trb  # noqa: E402

CPU = ["--device", "cpu"]


def _npz(tmp_path, shape=(200, 80), seed=7):
    rng = np.random.default_rng(seed)
    m = sp.random_array(shape, density=0.1, format="csr", dtype=np.float32, random_state=rng)
    m.data = rng.choice(np.arange(0.5, 5.5, 0.5), m.nnz).astype(np.float32)
    path = tmp_path / "urm.npz"
    sp.save_npz(str(path), sp.csr_matrix(m))
    return str(path)


def _result(cls, name, mean, thr):
    r = cls(name=name, k=100, rounds=2)
    r.times_s, r.mean_s, r.std_s, r.best_s = [mean, mean], mean, 0.0, mean
    r.throughput_items_s, r.output_nnz, r.avg_neighbors = thr, 1000, 10.0
    return r


def test_benchmark_result_fields_equal_the_original():
    assert ([(f.name, f.type) for f in dataclasses.fields(tbm.BenchmarkResult)]
            == [(f.name, f.type) for f in dataclasses.fields(jbm.BenchmarkResult)])


def test_format_summary_table_equals_the_original():
    rows = [("cosine", 1.5, 666.0), ("scoring[rp3beta]", 12.25, 16404.2), ("dot", 0.01, 1e6)]
    got = trb.format_summary_table([_result(tbm.BenchmarkResult, *r) for r in rows])
    ref = jrb.format_summary_table([_result(jbm.BenchmarkResult, *r) for r in rows])
    assert got == ref


@pytest.mark.parametrize("stage", ["similarity", "scoring"])
def test_timing_arithmetic_equals_the_original(stage, monkeypatch):
    """The same calls on the same clock give the same result fields."""
    m = sp.random_array((30, 20), density=0.2, format="csr", dtype=np.float32, random_state=0)

    class Out:
        nnz = 57

    def run(module):
        ticks = iter(np.cumsum([0.0, 1.5, 0.1, 2.5, 0.1, 1.0]).tolist())
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
        fn = getattr(module, f"benchmark_{stage}")
        res = fn(lambda x, k, verbose: Out(), m, name="x", k=5, rounds=3, warmup=1)
        monkeypatch.undo()
        return res.to_dict()

    assert run(tbm) == run(jbm)


def test_system_info_without_a_card(monkeypatch):
    def no_smi(*a, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(tbm.subprocess, "run", no_smi)
    info = tbm.system_info("cpu")
    assert info["backend"] == "cpu" and info["devices"] == ["cpu"]
    assert info["torch"] == torch.__version__ and "gpu_power_limit" not in info
    assert "python" in info and "platform" in info and "numpy" in info
    assert tbm.nvidia_smi("name") is None


def test_system_info_on_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(tbm, "nvidia_smi", lambda query, index=0: "700.00 W")
    info = tbm.system_info(torch.device("cuda", 0))
    assert info["backend"] == "cuda"
    assert info["devices"] == ["NVIDIA H100 80GB HBM3"]
    assert info["gpu_power_limit"] == "700.00 W"


def _run(tmp_path, *argv):
    out_dir = str(tmp_path / "reports")
    assert trb.main([*argv, "--output-dir", out_dir, *CPU]) == 0
    return sorted(glob.glob(os.path.join(out_dir, "*.json")))


def test_similarity_stage_matches_the_jax_runner(tmp_path, capsys):
    npz = _npz(tmp_path)
    common = ["--dataset", "synthetic_small", "--data-path", npz, "--k", "20", "--rounds", "1",
              "--warmup", "0"]
    (path,) = _run(tmp_path, *common)
    rep = json.load(open(path))
    assert sorted(rep) == ["dataset", "k", "provenance", "results", "rounds", "stage", "system"]
    assert rep["stage"] == "similarity" and rep["system"]["backend"] == "cpu"
    assert jrb.main(common + ["--output-dir", str(tmp_path / "jax")]) == 0
    (jpath,) = glob.glob(str(tmp_path / "jax" / "*.json"))
    jrep = json.load(open(jpath))
    for key in ("dataset", "stage", "provenance", "k", "rounds"):
        assert rep[key] == jrep[key]
    assert [r["name"] for r in rep["results"]] == ["dot_product", "cosine", "rp3beta"]
    for got, ref in zip(rep["results"], jrep["results"]):
        assert sorted(got) == sorted(ref)
        for key in ("name", "k", "rounds", "n_rows", "n_cols", "input_nnz", "output_nnz",
                    "avg_neighbors", "density"):
            assert got[key] == ref[key], key
    assert "items/s" in capsys.readouterr().out


def test_scoring_stage_end_to_end(tmp_path, capsys):
    """--stage scoring builds the model untimed, scores all users with
    filter_cols=urm and writes a stage-tagged report; its output equals the
    JAX runner's on the same data."""
    npz = _npz(tmp_path)
    common = ["--dataset", "synthetic_small", "--data-path", npz, "--stage", "scoring",
              "--similarities", "cosine", "--k", "20", "--scoring-k", "5", "--rounds", "1",
              "--warmup", "0", "--precision", "high"]
    (path,) = _run(tmp_path, *common)
    assert os.path.basename(path).startswith("benchmark_synthetic_small_scoring_")
    assert "users/s" in capsys.readouterr().out
    rep = json.load(open(path))
    (res,) = rep["results"]
    assert rep["stage"] == "scoring" and res["name"] == "scoring[cosine]"
    assert (res["n_rows"], res["n_cols"], res["k"]) == (200, 80, 5)
    assert 0 < res["output_nnz"] <= 200 * 5
    assert jrb.main(common + ["--output-dir", str(tmp_path / "jax")]) == 0
    (jpath,) = glob.glob(str(tmp_path / "jax" / "*.json"))
    assert json.load(open(jpath))["results"][0]["output_nnz"] == res["output_nnz"]


def test_profile_dir_writes_a_trace(tmp_path):
    npz = _npz(tmp_path)
    _run(tmp_path, "--data-path", npz, "--similarities", "cosine", "--k", "10", "--rounds", "1",
         "--warmup", "0", "--profile-dir", str(tmp_path / "prof"))
    trace = json.load(open(tmp_path / "prof" / "cosine.json"))
    assert trace["traceEvents"]


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trb.main(["--data-path", _npz(tmp_path), "--output-dir", str(tmp_path)])


def test_the_original_compare_reads_port_reports(tmp_path, capsys):
    npz = _npz(tmp_path)
    for _ in range(2):
        paths = _run(tmp_path, "--data-path", npz, "--similarities", "dot_product", "cosine",
                     "--k", "10", "--rounds", "2", "--warmup", "0")
    assert len(paths) == 2
    capsys.readouterr()
    bench_dir = str(tmp_path / "reports")
    assert jcb.main(paths + ["--bench-dir", bench_dir]) == 0
    out = capsys.readouterr().out
    assert "DOT_PRODUCT" in out and "COSINE" in out and "same system" in out
    assert jcb.main(["--list", "--bench-dir", bench_dir]) == 0
    assert "2 report(s)" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["--list"], ["--latest", "3"]],
                         ids=["pair", "list", "latest"])
def test_port_compare_prints_what_the_original_prints(argv, tmp_path, capsys):
    for i, (t, backend) in enumerate(((3.0, "cpu"), (2.0, "cuda"), (1.0, "cuda"))):
        rep = {"dataset": "a", "k": 100, "rounds": 1, "system": {"backend": backend},
               "results": [_result(jbm.BenchmarkResult, "cosine", t, 100.0 / t).to_dict()]}
        (tmp_path / f"benchmark_a_{i}.json").write_text(json.dumps(rep))
    if not argv:
        argv = [str(tmp_path / "benchmark_a_0.json"), str(tmp_path / "benchmark_a_2.json"),
                "--max-regression", "0.1"]
    argv = argv + ["--bench-dir", str(tmp_path)]
    rc = tcb.main(argv)
    got = capsys.readouterr().out
    assert rc == jcb.main(argv)
    assert got == capsys.readouterr().out


def test_bench_gate_end_to_end(tmp_path, capsys):
    """bootstrap -> compared against a (forged) slower baseline: pass -> a
    forged faster baseline trips the gate -> another backend class is never
    compared."""
    npz = _npz(tmp_path, shape=(300, 120), seed=5)
    out_dir = str(tmp_path / "reports")
    gate = ["--dataset", "synthetic_small", "--data-path", npz, "--similarities",
            "dot_product", "--k", "10", "--rounds", "1", "--warmup", "0", "--output-dir",
            out_dir, *CPU]

    def forge(scale):
        latest = sorted(glob.glob(os.path.join(out_dir, "*.json")))[-1]
        rep = json.load(open(latest))
        for r in rep["results"]:
            r["mean_s"] *= scale
            r["throughput_items_s"] /= scale
        json.dump(rep, open(latest, "w"))

    assert bench_gate.main(gate) == 0
    assert "PASS (bootstrap)" in capsys.readouterr().out
    forge(100.0)
    assert bench_gate.main(gate) == 0
    assert "comparing against" in capsys.readouterr().out
    forge(1 / 100.0)
    assert bench_gate.main(gate) == 1
    assert "REGRESSION" in capsys.readouterr().out
    for p in glob.glob(os.path.join(out_dir, "*.json")):
        rep = json.load(open(p))
        rep["system"]["backend"] = "cuda"
        json.dump(rep, open(p, "w"))
    assert bench_gate.main(gate) == 0
    assert "PASS (bootstrap)" in capsys.readouterr().out


def test_same_machine_class_needs_backend_and_devices():
    a = {"system": {"backend": "cuda", "devices": ["NVIDIA H100 80GB HBM3"]}}
    assert bench_gate._same_machine_class(a, json.loads(json.dumps(a)))
    assert not bench_gate._same_machine_class(a, {"system": {"backend": "cpu",
                                                             "devices": ["cpu"]}})
    assert not bench_gate._same_machine_class(
        a, {"system": {"backend": "cuda", "devices": ["NVIDIA A100"]}})


def _package_copy(tmp_path):
    """The files the stamp hashes, copied into a package-shaped directory."""
    src = kernel_stamp.PACKAGE
    dst = tmp_path / "pkg"
    shutil.copytree(src / "csrc", dst / "csrc")
    (dst / "benchmarks").mkdir(parents=True)
    shutil.copy(src / "benchmarks" / "kernel_check.py", dst / "benchmarks")
    (dst / "engine").mkdir()
    for rel in kernel_stamp.GEOMETRY_SOURCES:
        shutil.copy(src / rel, dst / rel)
    return dst


def test_kernel_hash_tracks_sources(tmp_path):
    pkg = _package_copy(tmp_path)
    base = kernel_stamp.kernel_hash(pkg)
    assert base == kernel_stamp.kernel_hash()
    assert [p.name for p in kernel_stamp.raw_sources(pkg)] == sorted(
        p.name for p in (pkg / "csrc").glob("*.cu")) + sorted(
        p.name for p in (pkg / "csrc").glob("*.cuh")) + ["kernel_check.py"]
    # the build directory is not hashed
    (pkg / "_build").mkdir()
    (pkg / "_build" / "libsplus_kernels_x.so").write_bytes(b"\0")
    assert kernel_stamp.kernel_hash(pkg) == base
    # a comment and a docstring edit of a geometry source: unchanged
    ex = pkg / "engine" / "executor.py"
    text = ex.read_text()
    ex.write_text('"""Edited docstring."""\n# a new comment\n' + text.split('"""', 2)[2])
    assert kernel_stamp.kernel_hash(pkg) == base
    # a code edit: changed
    ex.write_text(ex.read_text() + "\nNEW_TILE_CONSTANT = 128\n")
    assert kernel_stamp.kernel_hash(pkg) != base
    ex.write_text(text)
    assert kernel_stamp.kernel_hash(pkg) == base
    # any byte of a kernel source: changed
    cu = pkg / "csrc" / "scatter.cu"
    cu.write_bytes(cu.read_bytes() + b"// a comment\n")
    assert kernel_stamp.kernel_hash(pkg) != base


def test_stamp_write_read_current(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_stamp, "STAMP_PATH", tmp_path / "_build" / "kernel_check.stamp")
    assert kernel_stamp.read_stamp() is None and not kernel_stamp.stamp_is_current()
    kernel_stamp.write_stamp("full", "cuda")
    stamp = kernel_stamp.read_stamp()
    assert stamp["hash"] == kernel_stamp.kernel_hash()
    assert (stamp["mode"], stamp["backend"]) == ("full", "cuda")
    assert kernel_stamp.stamp_is_current()
    monkeypatch.setattr(kernel_stamp, "kernel_hash", lambda package=None: "deadbeef")
    assert not kernel_stamp.stamp_is_current()


def test_stamp_lives_in_the_build_directory():
    assert kernel_stamp.STAMP_PATH.parent == kernel_stamp.PACKAGE / "_build"
