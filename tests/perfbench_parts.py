"""The benchmark's parts that the port's tests hold a cell's results to,
loaded by path (perfbench/ is not a package): a plain reference, the
comparison that decides `correct` (pbcore/compare.py), a cell's
workload and configuration files, and the per-layer readers with the
package `pbcore` they import. Imports neither JAX nor the port."""

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent / "perfbench"


def _load(name: str, path: Path, package: bool = False):
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=[str(path.parent)] if package else None)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the references import their package by the name "reference"
if "reference" not in sys.modules:
    sys.modules["reference"] = _load("reference", BENCH / "reference" / "__init__.py", True)

COMPARE = _load("pb_compare", BENCH / "pbcore" / "compare.py")


def reference(module: str):
    """The module reference/<module>.py."""
    return _load(f"pb_reference_{module}", BENCH / "reference" / f"{module}.py")


def limits(cell: str) -> dict:
    """The limits of `correct` in cell `cell`."""
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())["limits"]


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _register_pbcore():
    """The benchmark's package `pbcore`, under the name its readers import."""
    if "pbcore" not in sys.modules:
        sys.modules["pbcore"] = _load("pbcore", BENCH / "pbcore" / "__init__.py", True)


def pbcore(part: str):
    """The module pbcore/<part>.py."""
    _register_pbcore()
    return importlib.import_module(f"pbcore.{part}")


def reader(family: str):
    """The per-layer reader metrics/<family>.py."""
    _register_pbcore()
    return _load(f"pb_metric_{family}", BENCH / "metrics" / f"{family}.py")
