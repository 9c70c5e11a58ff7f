"""stage_s.<cell kind>: mean seconds a call spends staging the device
cache's misses, the port's ``stage`` spans (host stacking and upload in
``engine/symmetric.py``, ``engine/compact.py`` and
``engine/executor.py``), over the calls that start in the window; a call
that hits every cache adds 0. Moves its cells' rate. Nothing where no
such span ran."""
from pbcore import spanlog


def read(trace):
    return spanlog.mean_per_call(trace, "stage")
