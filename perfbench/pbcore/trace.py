"""What a ``--trace 1`` run records, and its reduction to numbers.

- Launch records: the benchmark's own wrappers around the module
  attributes ``sym_topk.fused_sym_topk`` (K2), ``tile_topk.fused_tile_topk``
  (K1) and ``panel_topk.fused_panel_topk`` (K3), which the executors call
  through the module. Each launch's least time (``roofline.py``) is worked
  out from its operand shapes once the window has closed.
- Host laps: ``splus.TIMING`` fills ``splus.last_laps`` (validate,
  preprocess, execute (wall), assembly) of every call; the executors'
  ``last_route`` and ``last_plan`` are copied after each call.
- Device intervals: ``torch.profiler`` over the window, every kernel, copy
  and set on the card, put on the host clock by an annotation whose start
  is read on both clocks.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

from . import roofline

LAPS = ("validate", "preprocess", "execute (wall)", "assembly")
HOST_LAPS = ("validate", "preprocess", "assembly")
# the kernels' names in csrc/ (K1 and K3 share tile_kernels.cuh: a window
# that runs both cannot tell their launches apart by name)
KERNEL_NAMES = {
    "K2": re.compile(r"(?<!\w)(sym_simt_kernel|sym_s8_kernel|sym_wgmma_kernel|merge_kernel)(?!\w)"),
    "K1": re.compile(r"(?<!\w)(tile_s8_kernel|tile_simt_kernel|tile_bf16_kernel|"
                     r"tile_wgmma_kernel|topk_kernel)(?!\w)"),
}
KERNEL_NAMES["K3"] = KERNEL_NAMES["K1"]
ANCHOR = "perfbench.clock_anchor"
MARKER = "spin_kernel"  # torch.cuda._sleep: the profiler drops a window's first record


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _nbytes(*ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts if t is not None))


class LaunchRecorder:
    """Wraps K1, K2 and K3 while it is installed and keeps one record per
    launch: the kernel, the host time of the call and what its least time
    needs. Values that live on the device (K2's block position) are kept
    as tensors and read after the window, so recording adds no sync."""

    def __init__(self):
        self.launches: list[dict] = []
        self._saved = []

    def install(self):
        from similaripy_tpu_torch.engine import panel_topk, sym_topk, tile_topk

        for module, attr, kernel in ((sym_topk, "fused_sym_topk", "K2"),
                                     (tile_topk, "fused_tile_topk", "K1"),
                                     (panel_topk, "fused_panel_topk", "K3")):
            original = getattr(module, attr)
            self._saved.append((module, attr, original))
            setattr(module, attr, self._wrap(original, kernel))
        return self

    def remove(self):
        for module, attr, original in reversed(self._saved):
            setattr(module, attr, original)
        self._saved.clear()

    def _wrap(self, original, kernel):
        record = getattr(self, f"_record_{kernel}")

        def wrapper(*args, **kwargs):
            self.launches.append({"kernel": kernel, "t": time.perf_counter(),
                                  **record(*args, **kwargs)})
            return original(*args, **kwargs)

        wrapper.__wrapped__ = original
        return wrapper

    @staticmethod
    def _record_K2(a, d, *args, k, tc, split_f32=False, **kwargs):
        pvec = args[11]  # x_t .. cci, then pvec_ext
        depth = d.shape[0] // 2 if split_f32 else d.shape[0]
        sw = a.shape[0] * a.shape[2] if a.dim() == 3 else a.shape[0]
        return {"dtype": _dtype_name(a), "sw": sw, "u_pad": depth, "tc": tc,
                "k_pad": -(-k // 8) * 8, "phases": roofline.PHASES[bool(split_f32)],
                "operand_bytes": _nbytes(a, d), "pvec": pvec}

    @staticmethod
    def _record_K1(m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed=None,
                   fmask=None, tmask=None, carry=None, *, k_pad, split_f32=False, **kwargs):
        phases = roofline.PHASES[split_f32 if split_f32 is not True else "both"]
        depth = m1_dense.shape[1] // (2 if phases == 3 or split_f32 == "lhs" else 1)
        return {"dtype": _dtype_name(d), "trp": m1_dense.shape[0], "u_pad": depth,
                "tc": d.shape[1], "k_pad": k_pad, "phases": phases,
                "operand_bytes": _nbytes(m1_dense, d),
                "mask_bytes": _nbytes(allowed, fmask, tmask)}

    @staticmethod
    def _record_K3(a, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, bias=None, allowed=None,
                   fmask=None, tmask=None, *, k_pad, tc, **kwargs):
        return {"dtype": _dtype_name(a), "tm": a.shape[0], "K": a.shape[1], "cg": d.shape[1],
                "tc": tc, "k_pad": k_pad, "operand_bytes": _nbytes(a, d),
                "bias_bytes": _nbytes(bias), "mask_bytes": _nbytes(allowed, fmask, tmask)}

    def least_times(self) -> list[dict]:
        """Every launch as {kernel, t, least_s}."""
        out = []
        for r in self.launches:
            if r["kernel"] == "K2":
                pv = r["pvec"].detach().cpu().tolist()
                t, a0 = int(pv[12]), int(pv[13])
                n_live = min(max((t - a0 + 1) * r["tc"], 0), r["sw"])
                ops, nbytes = roofline.k2_launch(r["sw"], r["u_pad"], r["tc"], r["k_pad"],
                                                 n_live, r["phases"], r["operand_bytes"])
            elif r["kernel"] == "K1":
                ops, nbytes = roofline.k1_launch(r["trp"], r["u_pad"], r["tc"], r["k_pad"],
                                                 r["phases"], r["operand_bytes"], r["mask_bytes"])
            else:
                ops, nbytes = roofline.k3_launch(r["tm"], r["K"], r["cg"], r["tc"], r["k_pad"],
                                                 r["operand_bytes"], r["bias_bytes"],
                                                 r["mask_bytes"])
            dtype = "bfloat16" if r.get("phases", 1) > 1 else r["dtype"]
            out.append({"kernel": r["kernel"], "t": r["t"],
                        "least_s": roofline.least_seconds(ops, nbytes, dtype)})
        return out


class DeviceProfiler:
    """torch.profiler around the window; `intervals()` gives every device
    activity as (name, start, end) on the host's perf_counter clock."""

    def __init__(self):
        self.prof = None
        self._anchor_host = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda._sleep(1000)  # the marker launch
        torch.cuda.synchronize()
        with record_function(ANCHOR):
            self._anchor_host = time.perf_counter()
        return self

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def intervals(self) -> list[tuple[str, float, float]]:
        events = _kineto_events(self.prof)
        anchor = [e for e in events if e[0] == ANCHOR and not e[3]]
        if not anchor:
            raise RuntimeError("the profiler kept no record of the clock anchor")
        offset = self._anchor_host - anchor[0][1]
        return [(name, start + offset, end + offset)
                for name, start, end, on_device in events
                if on_device and MARKER not in name]


def _kineto_events(prof) -> list[tuple[str, float, float, bool]]:
    """(name, start s, end s, on the card) of every profiler event, in the
    profiler's own clock, from its raw kineto records."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        out.append((e.name(), start, start + e.duration_ns() * 1e-9, e.device_type() == cuda))
    return out


# ---------------------------------------------------------------------------
# reduction
# ---------------------------------------------------------------------------


def clip(intervals, t0: float, t1: float):
    return [(n, max(s, t0), min(e, t1)) for n, s, e in intervals if e > t0 and s < t1]


def merged(intervals) -> list[tuple[float, float]]:
    """The union of the intervals, as disjoint sorted spans."""
    spans = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return [(s, e) for s, e in spans]


def busy_seconds(intervals, t0: float, t1: float) -> float:
    return sum(e - s for s, e in merged(clip(intervals, t0, t1)))


def gaps(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The spans of [t0, t1] in which nothing ran on the card."""
    out, t = [], t0
    for s, e in merged(clip(intervals, t0, t1)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < t1:
        out.append((t, t1))
    return out


def seconds_by_name(intervals, t0: float, t1: float, pattern=None) -> dict:
    out: dict = {}
    for n, s, e in clip(intervals, t0, t1):
        if pattern is None or pattern.search(n):
            out[n] = out.get(n, 0.0) + (e - s)
    return out


@dataclass
class TraceData:
    """What the per-layer readers read: the window's calls (each with its
    laps, route and plan in `info`), the device intervals and the launches'
    least times."""

    calls: list
    t_start: float
    t_end: float
    device: list = field(default_factory=list)
    launches: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def ok_calls(self, route: str | None = None) -> list:
        return [c for c in self.calls if c.error is None
                and (route is None or c.info.get("route") == route)]

    def mean_lap(self, laps, route: str | None = None):
        calls = [c for c in self.ok_calls(route) if c.info.get("laps")]
        if not calls:
            return None
        return sum(sum(c.info["laps"].get(lap, 0.0) for lap in laps) for c in calls) / len(calls)

    def mean_stage(self, stage: str, route: str):
        """Mean of the executor's `stage` seconds (last_plan["stages"])."""
        vals = [c.info["stages"][stage] for c in self.ok_calls(route)
                if stage in (c.info.get("stages") or {})]
        return sum(vals) / len(vals) if vals else None

    def roofline_pct(self, kernel: str):
        """Least time of `kernel`'s launches in the window over the device
        time of its kernels; None where it did not run, or where K1 and K3
        both ran (they share kernel names)."""
        ran = {r["kernel"] for r in self.launches if self.t_start <= r["t"] <= self.t_end}
        if kernel not in ran or (kernel in ("K1", "K3") and {"K1", "K3"} <= ran):
            return None
        least = sum(r["least_s"] for r in self.launches
                    if r["kernel"] == kernel and self.t_start <= r["t"] <= self.t_end)
        spent = sum(seconds_by_name(self.device, self.t_start, self.t_end,
                                    KERNEL_NAMES[kernel]).values())
        return 100.0 * least / spent if spent > 0 else None

    def idle_pct(self):
        if not self.device:
            return None
        return 100.0 * (1.0 - busy_seconds(self.device, self.t_start, self.t_end) / self.window_s)

    def lap_at(self, t: float) -> str:
        """The host lap running at time t."""
        for c in self.calls:
            if c.t_issue <= t <= c.t_done:
                edge = c.t_issue
                for lap in LAPS:
                    edge += c.info.get("laps", {}).get(lap, 0.0)
                    if t <= edge:
                        return lap
                return "call, after its laps"
        return "between calls"

    def breakdown(self, top: int = 10) -> dict:
        by_name = seconds_by_name(self.device, self.t_start, self.t_end)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps(self.device, self.t_start, self.t_end), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[self.lap_at((s + e) / 2), e - s] for s, e in idle]}
