"""sym_sweep_s.<cell kind>: mean seconds of the symmetric executor's pair
sweep a call (``engine/symmetric.py``, ``last_plan["stages"]["sweep_s"]``:
K5 and K2, synchronised each pair). Nothing where no call took the
symmetric route."""


def read(trace):
    return trace.mean_stage("sweep_s", route="symmetric")
