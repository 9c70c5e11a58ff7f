"""hash_s.<cell kind>: mean seconds a call spends on content fingerprints,
the port's ``hash`` spans (``engine/preprocess.py::_fingerprint``: sha1
over every byte of the inputs, in preprocess and in the executors' cache
keys), over the calls that start in the window. Moves its cells' rate.
Nothing where no such span ran."""
from pbcore import spanlog


def read(trace):
    return spanlog.mean_per_call(trace, "hash")
