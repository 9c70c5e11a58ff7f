"""split_s.<cell kind>: mean seconds a call spends splitting COO values
into their bf16 [hi; lo] halves for ``precision='high'``, the port's
``split`` spans (``engine/executor.py::split_coo``, inside a device-cache
miss's ``stage``), over the calls that start in the window. Moves its
cells' rate. Nothing where no such span ran."""
from pbcore import spanlog


def read(trace):
    return spanlog.mean_per_call(trace, "split")
