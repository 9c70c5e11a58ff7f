"""host_s.<cell kind>: mean seconds a call spends on the host in the port's
laps validate, preprocess and assembly (``engine/splus.py``,
``splus.TIMING``), over the window's calls. Moves its cells' rate."""
from pbcore.trace import HOST_LAPS


def read(trace):
    return trace.mean_lap(HOST_LAPS)
