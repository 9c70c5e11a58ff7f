"""transform_s.<cell kind>: mean seconds a call spends in a public
function's host transform before ``s_plus`` (p3alpha, rp3beta: the L1
sums, the powers and the CSR rebuild of ``similarity.py``), the port's
``transform`` spans, over the calls that start in the window. Moves its
cells' rate. Nothing where no such span ran."""
from pbcore import spanlog


def read(trace):
    return spanlog.mean_per_call(trace, "transform")
