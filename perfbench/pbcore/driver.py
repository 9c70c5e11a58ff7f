"""One run of one cell: set-up, the measured window, the trace's reduction,
the check against the reference, and the result line.

``run.py`` calls ``run_cell`` on the card. The rehearsal (``rehearse.py``)
and the tests call it on the CPU at a tiny size; such a result says
``"platform": "cpu"`` and is never a cell's number.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass

from . import compare, guard, manifest, trace
from .deploy import Deployment
from .window import run_closed_loop


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


@dataclass
class Run:
    result: dict  # the result line
    traffic: object  # the cell's traffic, its checked rows and inputs kept


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
             scale: dict | None = None, params: dict | None = None,
             t_process: float | None = None, root=manifest.REPO,
             bench_dir=manifest.BENCH_DIR, out=None, err=None) -> Run:
    """Run `cell`; prints the per-call line, then the compared numbers to
    `err` as its last lines, then the result line to `out`. Raises where no
    result may be printed."""
    import torch

    out = out or sys.stdout
    err = err or sys.stderr
    t_process = time.perf_counter() if t_process is None else t_process
    bench = manifest.benchmark(root)
    manifest.cell_entry(cell, bench)
    wl = manifest.workload(cell, bench_dir)
    dep = Deployment(wl["config"], device, seed, scale, bench_dir)
    kind = manifest.traffic_kind(wl["kind"], bench_dir)
    traffic = kind.Traffic(dep, {**wl["params"], **(params or {})}, seed)
    from similaripy_tpu_torch.engine import executor, splus

    on_card = torch.device(device).type == "cuda"

    splus.TIMING = traced
    traffic.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    recorder = profiler = None
    if traced:
        recorder = trace.LaunchRecorder().install()
        if on_card:
            profiler = trace.DeviceProfiler().start()

    def issue(i):
        rows, info = traffic.issue(i)
        if traced:
            info.update(route=executor.last_route, laps=dict(splus.last_laps),
                        stages=dict(executor.last_plan.get("stages") or {}))
        return rows, info

    try:
        window = run_closed_loop(issue, seconds)
    finally:
        if profiler is not None:
            profiler.stop()
        if recorder is not None:
            recorder.remove()
        splus.TIMING = False
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    per_layer, tdata = {}, None
    if traced:
        tdata = trace.TraceData(window.calls, window.t_start, window.t_end,
                                profiler.intervals() if profiler else [],
                                recorder.least_times())
        for m in manifest.metrics_of(cell, bench, "per_layer"):
            value = manifest.metric_reader(m["name"], bench_dir).read(tdata)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}

    # the port's state goes before the reference runs
    import similaripy_tpu_torch as sim

    sim.clear_caches()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    numbers = traffic.check(window.calls)
    ok, shown = compare.judge(numbers, wl["limits"])
    correct = ok and window.failed == 0

    if traced:
        metrics = per_layer
    else:
        metrics = {}
        for m in manifest.metrics_of(cell, bench, "end_to_end"):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == wl["rate_metric"]:
                value = window.rate()
            else:
                raise KeyError(f"{cell} cannot report the end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if on_card:
        dev["power"] = _power_limit()
    result = {"correct": bool(correct), "attempted": len(window.calls),
              "failed": window.failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = (trace.busy_seconds(tdata.device, tdata.t_start, tdata.t_end)
                         if tdata.device else 0.0)
        dev["window_s"] = tdata.window_s
        if tdata.device:
            result["breakdown"] = tdata.breakdown()
    result["checks"] = shown

    loaded = guard.forbidden_loaded()
    if loaded:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {loaded}")
    calls = [[c.index, c.seconds, c.rows] + ([c.error] if c.error else [])
             for c in window.calls]
    print(json.dumps({"cell": cell, "seed": seed, "setup_s": setup_s, "window_s": window.span,
                      "calls": calls}), file=out, flush=True)
    if traced:
        print(json.dumps({"laps": [c.info.get("laps") for c in window.calls],
                          "routes": [c.info.get("route") for c in window.calls]}),
              file=out, flush=True)
    for name, v in shown.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return Run(result, traffic)
