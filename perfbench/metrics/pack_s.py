"""pack_s.<cell kind>: mean seconds a call spends copying the symmetric
executor's finished rows out, the port's ``pack`` spans
(``engine/symmetric.py``, one a pair: both sides' merge, the copy to the
host, the scatter into the call's output), over the calls whose root span
starts in the window. Moves its cells' rate. Nothing where no such span
ran."""
from pbcore import spanlog


def read(trace):
    return spanlog.mean_per_call(trace, "pack")
