"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports nothing of the port either: each is loaded in a fresh
process with those top-level names blocked, compared whole
(``similaripy_tpu_torch`` begins with ``similaripy_tpu`` and is not it)."""

import subprocess
import sys
import textwrap

from pbcore import guard, manifest

HARNESS = ["pbcore.manifest", "pbcore.window", "pbcore.data", "pbcore.roofline",
           "pbcore.trace", "pbcore.compare", "pbcore.guard", "pbcore.deploy",
           "pbcore.kinds", "pbcore.driver", "calibrate", "faults", "run", "rehearse"]


def load_blocked(blocked, modules, extra=""):
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(manifest.BENCH_DIR)!r}, {str(manifest.REPO)!r}]
        from pbcore.guard import Blocker
        sys.meta_path.insert(0, Blocker({sorted(blocked)!r}))
        import importlib
        for m in {modules!r}:
            importlib.import_module(m)
        {extra}
        from pbcore.guard import forbidden_loaded
        print("LOADED", forbidden_loaded(forbidden={sorted(blocked)!r}))
    """)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_loaded(["similaripy_tpu_torch", "similaripy_tpu_torch.engine",
                                   "jaxtyping"]) == []
    assert guard.forbidden_loaded(["similaripy_tpu.engine", "jax._src", "flax"]) == [
        "flax", "jax._src", "similaripy_tpu.engine"]


def test_the_harness_and_the_port_load_without_jax():
    extra = """
        import similaripy_tpu_torch
        from pbcore.deploy import Deployment
        from pbcore import manifest
        for name in ("full_build", "refresh", "score_batches"):
            manifest.traffic_kind(name)
        manifest.part("values", "half_stars")
        manifest.part("models", "popularity")
        for m in manifest.benchmark()["per_layer"]:
            manifest.metric_reader(m["name"])
    """
    r = load_blocked(guard.FORBIDDEN, HARNESS, textwrap.indent(textwrap.dedent(extra), "        "))
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout


def test_the_reference_loads_without_the_port():
    blocked = set(guard.FORBIDDEN) | {"similaripy_tpu_torch"}
    extra = """
        from pbcore import manifest
        for name in ("item_cosine", "user_scores"):
            manifest.reference(name)
    """
    r = load_blocked(blocked, ["reference"], textwrap.indent(textwrap.dedent(extra), "        "))
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout


def test_the_blocker_does_block():
    r = load_blocked({"similaripy_tpu"}, ["similaripy_tpu"])
    assert r.returncode != 0 and "may not be imported" in r.stderr


def test_no_benchmark_file_reads_the_jax_era_tools():
    for path in manifest.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for word in ("kernel_check", "ensure_kernel_stamp", "bench.py", "BENCH_r0",
                     "import jax", "similaripy_tpu.", "from similaripy_tpu "):
            assert word not in text, (path.name, word)
