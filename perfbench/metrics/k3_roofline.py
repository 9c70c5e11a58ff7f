"""k3_roofline.<cell kind>: K3's share of its roofline (engine/panel_topk.py,
csrc/panel_topk.cu): the least time of every launch in the window
(``pbcore/roofline.py``, from the operand shapes the benchmark's wrapper
recorded) over the device time of K3's kernels by name in the profiler's
trace. Nothing where K3 did not run."""


def read(trace):
    return trace.roofline_pct("K3")
