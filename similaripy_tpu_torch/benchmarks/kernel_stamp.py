"""Sweep stamp for the port's CUDA kernels.

Port of ``benchmarks/kernel_stamp.py``. The CPU tests run the kernels'
plain versions only, so an edit of a kernel is checked on a card by
``benchmarks/kernel_check.py``. Its ``main`` writes a stamp keyed on a hash
of the kernel sources after a sweep on a card passes, and
``benchmarks/bench.py`` refuses to time kernels whose sources changed since:
it runs the quick sweep first (``bench.ensure_kernel_stamp``). A kernel edit
therefore cannot reach a recorded benchmark number without a passing sweep
on the card.

The hash takes the raw bytes of every ``csrc/*.cu``, every ``csrc/*.cuh``
and ``benchmarks/kernel_check.py`` (a widened sweep must run again), and a
docstring- and comment-insensitive dump of the code of the geometry
sources: the executors and their staging helpers, which decide the shapes
the kernels are asked to run (tile widths, carry depths, ...), and the
kernels' launch wrappers. A comment edit there forces no sweep; any code
edit, a tile constant included, does. The stamp lives in ``similaripy_tpu_torch/_build/``, as
the built libraries do.
"""

from __future__ import annotations

import ast
import hashlib
import json
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
STAMP_PATH = PACKAGE / "_build" / "kernel_check.stamp"

GEOMETRY_SOURCES = (
    "engine/executor.py", "engine/symmetric.py", "engine/compact.py", "engine/staging.py",
    "engine/sym_sharded.py",
    "engine/tile_topk.py", "engine/sym_topk.py", "engine/panel_topk.py", "engine/gather.py",
    "engine/scatter.py",
)


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            body = getattr(node, "body", None)
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _code_hash_bytes(path: Path) -> bytes:
    """Comment/docstring-insensitive content of a Python source file."""
    raw = path.read_bytes()
    try:
        tree = _strip_docstrings(ast.parse(raw))
        return ast.dump(tree, annotate_fields=False).encode()
    except SyntaxError:  # unparsable: fall back to raw bytes
        return raw


def raw_sources(package: Path = PACKAGE) -> list[Path]:
    """The files hashed byte for byte, in sorted order (never ``_build/``)."""
    csrc = package / "csrc"
    return (sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
            + [package / "benchmarks" / "kernel_check.py"])


def kernel_hash(package: Path = PACKAGE) -> str:
    h = hashlib.sha256()
    for path in raw_sources(package):
        h.update(path.relative_to(package).as_posix().encode())
        h.update(path.read_bytes())
    for rel in GEOMETRY_SOURCES:
        h.update(_code_hash_bytes(package / rel))
    return h.hexdigest()[:16]


def read_stamp() -> dict | None:
    try:
        with open(STAMP_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_stamp(mode: str, backend: str) -> None:
    STAMP_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(STAMP_PATH, "w") as f:
        json.dump(
            {
                "hash": kernel_hash(),
                "mode": mode,
                "backend": backend,
                "time": time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime()),
            },
            f,
            indent=2,
        )
        f.write("\n")


def stamp_is_current() -> bool:
    stamp = read_stamp()
    return stamp is not None and stamp.get("hash") == kernel_hash()
