"""k1_roofline.<cell kind>: K1's share of its roofline (engine/tile_topk.py,
csrc/tile_topk.cu): the least time of every launch in the window
(``pbcore/roofline.py``, from the operand shapes the benchmark's wrapper
recorded) over the device time of K1's kernels by name in the profiler's
trace. Nothing where K1 did not run."""


def read(trace):
    return trace.roofline_pct("K1")
