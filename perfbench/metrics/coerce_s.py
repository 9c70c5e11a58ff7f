"""coerce_s.<cell kind>: mean seconds a call spends turning its inputs into
float32 CSR, the port's ``coerce`` spans (``ops/csr.py::ensure_csr_f32``
in ``engine/preprocess.py``; a transpose of every rating for a CSC input),
over the calls that start in the window. Moves its cells' rate. Nothing
where no such span ran."""
from pbcore import spanlog


def read(trace):
    return spanlog.mean_per_call(trace, "coerce")
