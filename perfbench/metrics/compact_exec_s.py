"""compact_exec_s.<cell kind>: mean seconds of the execute lap of the calls
the compaction executor ran (``engine/compact.py``: staging, K4, the hot
prefix's product, K3, K5; ``splus.TIMING``). Nothing where none did."""


def read(trace):
    return trace.mean_lap(("execute (wall)",), route="compact")
