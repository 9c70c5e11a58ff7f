"""Single-benchmark execution and metrics.

Port of ``benchmarks/benchmark.py`` (reference:
tests/benchmarks/benchmark.py:18-214): capture system info, time only the
similarity (or scoring) call, compute throughput and output statistics.
``BenchmarkResult`` and the arithmetic of ``benchmark_similarity`` and
``benchmark_scoring`` are the original's. ``profile_dir`` takes a
``torch.profiler`` trace of the timed rounds (``export_chrome_trace``).
"""

from __future__ import annotations

import os
import platform
import statistics
import subprocess
import time
from contextlib import nullcontext
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

import numpy as np
import scipy
import torch


def nvidia_smi(query: str, index: int = 0) -> Optional[str]:
    """`nvidia-smi --query-gpu=<query> --format=csv,noheader` for card
    `index`, or None where nvidia-smi is absent or fails."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or index >= len(lines):
        return None
    return lines[index].strip()


def system_info(device=None) -> dict:
    """Hardware/software provenance for reports (reference:
    tests/benchmarks/benchmark.py:18-85). `backend` is the type of
    `device` (by default "cuda" where a card is available, else "cpu"); a
    field that cannot be read is left out."""
    info = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "processor": platform.processor() or platform.machine(),
        "torch": torch.__version__,
    }
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    info["backend"] = dev.type
    if dev.type == "cuda" and torch.cuda.is_available():
        info["devices"] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
        limit = nvidia_smi("power.limit", dev.index or 0)
        if limit:
            info["gpu_power_limit"] = limit
    else:
        info["devices"] = ["cpu"]
    if torch.version.cuda:
        info["cuda"] = torch.version.cuda
    info["numpy"] = np.__version__
    info["scipy"] = scipy.__version__
    try:
        git = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        if git.returncode == 0:
            info["git"] = git.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info


def _validate_rounds(rounds: int, warmup: int) -> None:
    # rounds=0 would crash statistics.mean on an empty list (and warmup=0
    # too would leave `out` None); fail fast with a clear message instead
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")


@dataclass
class BenchmarkResult:
    name: str
    k: int
    rounds: int
    times_s: list = field(default_factory=list)
    mean_s: float = 0.0
    std_s: float = 0.0
    best_s: float = 0.0
    throughput_items_s: float = 0.0
    n_rows: int = 0
    n_cols: int = 0
    input_nnz: int = 0
    output_nnz: int = 0
    avg_neighbors: float = 0.0
    density: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)


def _profiler(profile_dir: Optional[str], name: str):
    """A torch.profiler context that writes `<profile_dir>/<name>.json`
    (a Chrome trace) on exit; a null context without `profile_dir`."""
    if not profile_dir:
        return nullcontext()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def export(prof):
        prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))

    return profile(activities=activities, on_trace_ready=export)


def _time_rounds(fn: Callable, matrix, res: BenchmarkResult, warmup: int,
                 profile_dir: Optional[str], **kwargs) -> BenchmarkResult:
    """Warm up, then time `res.rounds` calls of `fn(matrix, k=res.k,
    **kwargs)`; fills the times and statistics of `res` (throughput: rows
    per second of the mean round)."""
    out = None
    for _ in range(warmup):
        out = fn(matrix, k=res.k, verbose=False, **kwargs)

    with _profiler(profile_dir, res.name):
        for _ in range(res.rounds):
            t0 = time.perf_counter()
            # the public calls return a SciPy matrix on the host, so each
            # call has ended on the card when it returns: no extra
            # synchronisation is needed around it
            out = fn(matrix, k=res.k, verbose=False, **kwargs)
            res.times_s.append(time.perf_counter() - t0)

    res.mean_s = statistics.mean(res.times_s)
    res.std_s = statistics.stdev(res.times_s) if res.rounds > 1 else 0.0
    res.best_s = min(res.times_s)
    res.throughput_items_s = res.n_rows / res.mean_s
    res.output_nnz = int(out.nnz)
    res.avg_neighbors = out.nnz / max(res.n_rows, 1)
    return res


def benchmark_similarity(
    sim_fn: Callable,
    matrix,
    *,
    name: str,
    k: int = 100,
    rounds: int = 3,
    warmup: int = 1,
    profile_dir: Optional[str] = None,
    **kwargs,
) -> BenchmarkResult:
    """Time `sim_fn(matrix, k=k, **kwargs)` like the reference does
    (reference: tests/benchmarks/benchmark.py:160-189): wall-clock around
    the call only, dataset prep excluded, rounds averaged."""
    _validate_rounds(rounds, warmup)
    res = BenchmarkResult(name=name, k=k, rounds=rounds)
    res.n_rows, res.n_cols = matrix.shape[0], matrix.shape[0]
    res.input_nnz = matrix.nnz
    res.density = matrix.nnz / float(matrix.shape[0] * matrix.shape[1])
    return _time_rounds(sim_fn, matrix, res, warmup, profile_dir, **kwargs)


def benchmark_scoring(
    score_fn: Callable,
    urm,
    *,
    name: str,
    k: int = 10,
    rounds: int = 3,
    warmup: int = 1,
    profile_dir: Optional[str] = None,
    **kwargs,
) -> BenchmarkResult:
    """Time the recommendation SCORING stage: `score_fn(urm, k=k)` ranks
    items for every user row of the URM (the reference pipeline's second
    half — reference: notebooks/movielens32m_item_item_recommender.ipynb
    cell 37 and README.md:86-94: `dot_product(urm, W.T, k,
    filter_cols=urm)`). Throughput is USERS scored per second; the
    similarity-model build is the caller's (untimed) responsibility."""
    _validate_rounds(rounds, warmup)
    res = BenchmarkResult(name=name, k=k, rounds=rounds)
    res.n_rows, res.n_cols = urm.shape
    res.input_nnz = urm.nnz
    res.density = urm.nnz / float(urm.shape[0] * urm.shape[1])
    return _time_rounds(score_fn, urm, res, warmup, profile_dir, **kwargs)
