"""The engine of the port reads as one stack: each module imports only
modules below it.

    splus -> executor (the router, and the grouped executor)
          -> symmetric | compact (the other two executors)
          -> staging | cache (host staging, the device cache)
          -> the kernel wrappers, spans, preprocess

Parsed with ``ast``, so nothing is imported. A sibling engine module is
imported at module level only; the one exemption is the lazy load of the
built kernel library (``from .build import ...``) inside a launch wrapper,
which must not build anything when a module is imported.
"""

import ast
from pathlib import Path

import pytest

ENGINE = Path(__file__).resolve().parent.parent / "similaripy_tpu_torch" / "engine"
MODULES = sorted(p.stem for p in ENGINE.glob("*.py") if p.stem != "__init__")
EXECUTORS = ("executor", "symmetric", "compact")
LAZY = {"build"}


def _siblings(node) -> set:
    """The engine modules an import statement names."""
    if isinstance(node, ast.ImportFrom):
        if node.level == 1:
            if node.module is None:  # from . import a, b
                return {alias.name for alias in node.names}
            return {node.module.split(".")[0]}
        if node.level == 0 and (node.module or "").startswith("similaripy_tpu_torch.engine"):
            parts = node.module.split(".")
            if len(parts) > 2:
                return {parts[2]}
            return {alias.name for alias in node.names}
        return set()
    if isinstance(node, ast.Import):
        prefix = "similaripy_tpu_torch.engine."
        return {a.name[len(prefix):].split(".")[0] for a in node.names
                if a.name.startswith(prefix)}
    return set()


def _imports(name: str):
    """(sibling, inside_a_function, line) of every import of a sibling."""
    tree = ast.parse((ENGINE / f"{name}.py").read_text())
    local = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            local.update(id(n) for n in ast.walk(fn) if n is not fn)
    return [
        (sibling, id(node) in local, node.lineno)
        for node in ast.walk(tree)
        for sibling in _siblings(node)
        if sibling in MODULES
    ]


def test_the_engine_modules_are_found():
    assert {"executor", "symmetric", "compact", "cache", "staging", "splus"} <= set(MODULES)
    assert "sharded" not in MODULES


@pytest.mark.parametrize("name", ["symmetric", "compact", "cache", "staging"])
def test_lower_modules_do_not_import_the_router(name):
    bad = [(s, line) for s, _, line in _imports(name) if s == "executor"]
    assert not bad, f"{name}.py imports executor: {bad}"


@pytest.mark.parametrize("name, other", [("symmetric", "compact"), ("compact", "symmetric")])
def test_executors_do_not_import_each_other(name, other):
    bad = [line for s, _, line in _imports(name) if s == other]
    assert not bad, f"{name}.py imports {other} at lines {bad}"


@pytest.mark.parametrize("name", ["cache", "staging"])
def test_shared_layers_import_no_executor(name):
    bad = [(s, line) for s, _, line in _imports(name) if s in EXECUTORS]
    assert not bad, f"{name}.py imports an executor: {bad}"


@pytest.mark.parametrize("name", MODULES)
def test_no_function_local_sibling_import(name):
    bad = [(s, line) for s, local, line in _imports(name) if local and s not in LAZY]
    assert not bad, f"{name}.py imports siblings inside a function: {bad}"


def test_the_checks_see_local_and_router_imports(tmp_path, monkeypatch):
    """The parser flags what the tests above forbid."""
    (tmp_path / "a.py").write_text(
        "from . import executor\n"
        "def f():\n    from .symmetric import execute_symmetric\n"
        "def g():\n    from .build import load\n"
    )
    monkeypatch.setitem(globals(), "ENGINE", tmp_path)
    monkeypatch.setitem(globals(), "MODULES", ["a", "build", "executor", "symmetric"])
    assert sorted(_imports("a")) == [("build", True, 5), ("executor", False, 1),
                                     ("symmetric", True, 3)]
