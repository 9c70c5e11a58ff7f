"""k2_roofline.<cell kind>: K2's share of its roofline (engine/sym_topk.py,
csrc/sym_topk.cu): the least time of every launch in the window
(``pbcore/roofline.py``, from the operand shapes the benchmark's wrapper
recorded) over the device time of K2's kernels by name in the profiler's
trace. Nothing where K2 did not run."""


def read(trace):
    return trace.roofline_pct("K2")
