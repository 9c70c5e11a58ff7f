"""Where the files of a cell are, found by the names in ``BENCHMARK.json``.

- a cell: ``workloads/<cell>.json`` (its configuration, traffic mix, traffic
  kind and parameters, the rows it checks and the limits of its numbers);
- a configuration: ``configs/<config>.json``, the values kind
  (``values/<kind>.py``) and model kind (``models/<kind>.py``) it names, and
  the reference modules it names under ``reference/``;
- a traffic kind: ``traffic/<kind>.py``;
- a per-layer metric: the reader of its family, ``metrics/<family>.py``,
  the family being the part of the metric's name before the first dot
  (``host_s.build`` and ``host_s.score`` share ``metrics/host_s.py``).

Adding any of them is adding files and ``BENCHMARK.json`` entries; no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = REPO) -> dict:
    return _json(root / "BENCHMARK.json")


def checked_name(name: str) -> str:
    """`name` if it is a valid name (it also becomes a file name)."""
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name (letters, digits, _ . -)")
    return name


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "workloads" / f"{checked_name(name)}.json")


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "configs" / f"{checked_name(name)}.json")


def load_file(path: Path, module_name: str):
    """Import the Python file `path` as a module of its own."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def part(folder: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<folder>/<name>.py``: a traffic kind (``traffic``), a
    values kind (``values``), a model kind (``models``), a reference
    (``reference``) or a metric family's reader (``metrics``)."""
    module = f"pb_{folder}_" + checked_name(name).replace(".", "_").replace("-", "_")
    return load_file(bench_dir / folder / f"{name}.py", module)


def traffic_kind(kind: str, bench_dir: Path = BENCH_DIR):
    return part("traffic", kind, bench_dir)


def reference(name: str, bench_dir: Path = BENCH_DIR):
    return part("reference", name, bench_dir)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The reader of per-layer metric `name`: its family's."""
    return part("metrics", checked_name(name).split(".", 1)[0], bench_dir)


def metrics_of(cell: str, bench: dict, section: str) -> list[dict]:
    """The entries of `section` ('end_to_end' or 'per_layer') that `cell`
    reports: those whose `workloads` list it, and those without the key."""
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]


def cell_entry(cell: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"{cell!r} is not a workload of BENCHMARK.json")
