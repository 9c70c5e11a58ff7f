"""grouped_exec_s.<cell kind>: mean seconds of the execute lap of the calls
the general executor ran (``engine/executor.py::execute_grouped``: staging,
K5, K1; ``splus.TIMING``). Nothing where none did."""


def read(trace):
    return trace.mean_lap(("execute (wall)",), route="general")
