"""Faults planted under the timed path, to show that `correct` catches them.

Each wraps ``splus.execute``, the port's executors as the public calls
reach them (they return each target row's top-k values and ids):

- ``stale``: every call after the first returns the first call's answer,
  as a step that leaves its state unchanged would;
- ``half``: half of the batch's rows left out (they come back empty);
- ``altered``: each row's best answer altered where it is produced (its
  column id moved to the next column).

The cells run on one card, so there is no exchange between cards to leave
out. The tests plant them at a tiny size (``tests/test_pb_correct.py``),
``calibrate.py --faults`` at a cell's own size on the card; the benchmark's
runs never do.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("stale", "half", "altered")


def _faulty(execute, fault: str):
    first = []

    def run(pre, *args, **kwargs):
        vals, idx = execute(pre, *args, **kwargs)
        if fault == "stale":
            if first and first[0][0].shape == vals.shape:
                return first[0][0].copy(), first[0][1].copy()
            first.append((vals.copy(), idx.copy()))
        elif fault == "half":
            vals = vals.copy()
            vals[1::2] = -np.inf
        elif fault == "altered":
            idx = idx.copy()
            idx[:, 0] = (idx[:, 0] + 1) % pre.n_output_cols
        return vals, idx

    return run


@contextlib.contextmanager
def planted(fault: str | None):
    """Plant `fault` (one of FAULTS) for the duration; None plants
    nothing."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    from similaripy_tpu_torch.engine import splus

    original = splus.execute
    splus.execute = _faulty(original, fault)
    try:
        yield
    finally:
        splus.execute = original
