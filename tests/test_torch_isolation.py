"""The port stands alone: it and chip_smoke.py import neither JAX nor the
JAX package, build their kernels with plain nvcc, and refuse to run on a
card that is not there."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu_torch as tsim

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "similaripy_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
SOURCES = sorted(PORT.rglob("*.py")) + [SMOKE]


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in ("jax", "jaxlib", "similaripy_tpu", "benchmarks"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_imports_and_runs_with_jax_blocked():
    """In a fresh interpreter where importing jax or similaripy_tpu fails,
    the package imports, chip_smoke.py loads, and a small call runs."""
    script = textwrap.dedent(f"""
        import importlib.util, sys
        sys.modules["jax"] = None
        sys.modules["similaripy_tpu"] = None
        import numpy as np, scipy.sparse as sp
        import similaripy_tpu_torch as sim
        spec = importlib.util.spec_from_file_location("chip_smoke", {str(SMOKE)!r})
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        m = sp.random_array((40, 30), density=0.1, format="csr", dtype=np.float32,
                            random_state=np.random.default_rng(0))
        out = sim.cosine(sim.bm25(m, device="cpu").T, k=5, verbose=False, device="cpu")
        assert out.nnz > 0
        leaked = [n for n in sys.modules if n == "jax" and sys.modules[n] is not None
                  or n.startswith(("jax.", "jaxlib", "similaripy_tpu."))]
        assert not leaked, leaked
        print("isolated ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "isolated ok" in proc.stdout


def test_benchmarks_import_with_jax_blocked():
    """The probe and benchmark modules import, and the kernel-check sweep's
    P1 probe runs, where importing jax or similaripy_tpu fails."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["similaripy_tpu"] = None
        sys.modules["benchmarks"] = None
        import similaripy_tpu_torch.benchmarks.compare_checkouts
        import similaripy_tpu_torch.benchmarks.kernel_check as kc
        import similaripy_tpu_torch.benchmarks.micro_int4
        import similaripy_tpu_torch.benchmarks.micro_tile_kernel
        import similaripy_tpu_torch.benchmarks.probes
        import similaripy_tpu_torch.benchmarks.tlhs_transpose_cost
        assert kc.probe_transposed_lhs("int8", "cpu") == ("ok", True)
        leaked = [n for n in sys.modules if n == "jax" and sys.modules[n] is not None
                  or n.startswith(("jax.", "jaxlib", "similaripy_tpu.", "benchmarks."))]
        assert not leaked, leaked
        print("isolated ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "isolated ok" in proc.stdout


def test_bench_modules_import_with_jax_blocked():
    """The benchmark entry points, the suite, the kernel stamp, the data
    helpers and the native assembly import, and the native library builds
    and runs, where importing jax, similaripy_tpu or the top-level
    benchmarks fails."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["similaripy_tpu"] = None
        sys.modules["benchmarks"] = None
        import numpy as np
        import similaripy_tpu_torch.benchmarks.bench
        import similaripy_tpu_torch.benchmarks.bench_gate
        import similaripy_tpu_torch.benchmarks.benchmark
        import similaripy_tpu_torch.benchmarks.compare_benchmarks
        import similaripy_tpu_torch.benchmarks.dataset_loaders
        import similaripy_tpu_torch.benchmarks.kernel_stamp as ks
        import similaripy_tpu_torch.benchmarks.run_benchmarks
        import similaripy_tpu_torch.utils.npz_cache
        from similaripy_tpu_torch import native
        from similaripy_tpu_torch.utils.synth import synthetic_urm
        assert synthetic_urm(n_users=50, n_items=20, nnz=100).nnz == 100
        assert len(ks.kernel_hash()) == 16
        r, c, v = native.topk_to_coo(np.ones((2, 3), np.float32), np.zeros((2, 3), np.int32),
                                     np.arange(2, dtype=np.int32))
        assert v.shape == (6,) and native.native_calls == 1
        leaked = [n for n in sys.modules if n == "jax" and sys.modules[n] is not None
                  or n.startswith(("jax.", "jaxlib", "similaripy_tpu.", "benchmarks."))]
        assert not leaked, leaked
        print("isolated ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "isolated ok" in proc.stdout


def test_kernel_builds_with_plain_nvcc():
    """Build route: nvcc into a plain C library, loaded with ctypes; no
    PyTorch extension headers, no torch.utils.cpp_extension."""
    from similaripy_tpu_torch.engine import build

    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert [p.name for p in sources] == [
        "gather.cu", "panel_topk.cu", "probe_int_mma.cu", "probe_tlhs.cu", "scatter.cu",
        "sym_topk.cu", "tile_topk.cu",
    ]
    assert build.sources() == sources
    for path in sources + sorted((PORT / "csrc").glob("*.cuh")):
        assert "torch/extension.h" not in path.read_text(), path
    for path in sources:
        assert 'extern "C"' in path.read_text(), path
    for path in PORT.rglob("*.py"):
        assert "cpp_extension" not in path.read_text(), path
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build.library_path().parent == PORT / "_build"


ENTRY_POINTS = {
    "s_plus": lambda m: tsim.s_plus(m, verbose=False, device="cuda"),
    "cosine": lambda m: tsim.cosine(m, verbose=False, device="cuda"),
    "cosine_default_device": lambda m: tsim.cosine(m, verbose=False),
    "recommend": lambda m: tsim.recommend(m, (m.T @ m).tocsr(), verbose=False),
    "p3alpha": lambda m: tsim.p3alpha(m, m.T, verbose=False),
    "bm25": lambda m: tsim.bm25(m),
    "tfidf": lambda m: tsim.tfidf(m, device="cuda"),
    "normalize": lambda m: tsim.normalize(m),
}


def _small():
    return sp.random_array((20, 10), density=0.2, format="csr", dtype=np.float32,
                           random_state=np.random.default_rng(1))


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cuda_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](_small())


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the smoke would run for real")
    proc = subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_mesh_is_not_ported():
    """mesh= is ported now (engine/sharded.py); a mesh call without the
    initialized process group raises instead of running on one device."""
    with pytest.raises(RuntimeError, match="process group"):
        tsim.cosine(_small(), verbose=False, device="cpu", mesh=object())
