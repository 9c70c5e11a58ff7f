"""The value-symmetric P3 transform of p3alpha and rp3beta on the call's
device, as torch ops.

``similarity.py::_p3_symmetric`` turns a self-similar, shrink-free call
into one shared operand A = m^alpha * c^(-alpha/2) (c the column sums of
|m|) and a row-side depop r^alpha (r the row sums of |m|); rp3beta adds the
popularity, the signed row sums. ``transform`` does the same work on the
call's device: the caller's arrays go up (``card_prep.csr_entries``), are
put in CSR order there, summed and transformed entry by entry, and only
the float32 CSR of A and the O(rows) vectors come back. One implementation
serves a card and the CPU.

What it gives equals the host form's result as ``ensure_csr_f32`` makes it
(explicit zeros dropped, which s_plus does with the host form's A):

- the power is taken on every stored entry, zeros too (0^0 is 1), and the
  zeros are dropped after it;
- the sums accumulate in float64. Where the host sums in float32 (SciPy
  sums float32 values in float32) they are rounded once to float32: equal
  to the host's wherever its running sums are exact (half stars), within
  an ulp of the exact sums elsewhere. Integer and float64 values keep
  float64 sums, as the host's integer and float64 sums are;
- the O(rows) and O(columns) powers (c^(-alpha/2), r^alpha) run in NumPy
  on the host, as the host form computes them, and c's factors go up.

It refuses (None) a dense input, an empty matrix, and repeated (row, col)
entries, which SciPy sums on the host in the caller's dtype, in an order
of its own, before the host form's sums and powers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from . import card_prep

class P3Parts(NamedTuple):
    """The transform's results on the host."""

    a: sp.csr_array  # A, float32, canonical, no explicit zeros
    depop1: np.ndarray  # r^alpha (r == 0 taken as 1), float32
    pop: Optional[np.ndarray]  # the signed row sums, float32 (rp3beta)
    upload_bytes: int  # what went up to the device


def _sum(ids: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float64, device=v.device).index_add_(0, ids, v)


def transform(matrix, alpha, device, popularity: bool = False) -> Optional[P3Parts]:
    """The value-symmetric P3 transform of `matrix` on `device`
    (``similarity.py::_p3_symmetric``), with the popularity vector when
    asked; None where the device does not take the input: anything but a
    CSC, CSR or COO with entries, values torch holds and int32/int64
    indices (``card_prep.takes_entries``), or a matrix found to repeat a
    (row, col) once up. The caller's arrays are read, never written."""
    if not card_prep.takes_entries(matrix):
        return None
    got = card_prep.csr_entries(matrix, device)
    if got is None:
        return None
    rows, cols, vals, sent = got
    if matrix.format != "coo" and card_prep.repeats(rows, cols):
        return None  # SciPy sums them on the host
    n_rows, n_cols = matrix.shape
    f64 = torch.float64
    # |m| in the caller's dtype, as np.abs takes it (bool and unsigned as they are)
    mag = (vals.abs() if vals.dtype.is_signed else vals).to(f64)
    sums = [_sum(rows, mag, n_rows), _sum(cols, mag, n_cols)]
    del mag
    if popularity:
        sums.append(_sum(rows, vals.to(f64), n_rows))
    if matrix.data.dtype == np.float32:
        sums = [s.to(torch.float32).to(f64) for s in sums]
    r, c, *pop = card_prep._to_host(*sums)
    del sums
    # the host form's O(rows) and O(columns) powers, in NumPy
    with np.errstate(divide="ignore"):
        cf = np.where(c > 0, np.power(c, -alpha / 2.0), 0.0)
    depop1 = np.power(np.where(r > 0, r, 1.0), alpha).astype(np.float32)
    cf_dev = card_prep._upload(cf, device)
    a = vals.to(f64, copy=True)  # a copy: vals may share the caller's array
    del vals
    a.pow_(float(alpha))
    a.mul_(cf_dev.index_select(0, cols))
    data = a.to(torch.float32)
    del a, cf_dev
    keep = data != 0
    if not bool(keep.all()):
        rows, cols, data = rows[keep], cols[keep], data[keep]
    del keep
    idx = card_prep.index_dtype(matrix)
    indptr = torch.searchsorted(rows, torch.arange(n_rows + 1, device=device, dtype=rows.dtype))
    out = sp.csr_array(tuple(card_prep._to_host(data, cols.to(idx), indptr.to(idx))),
                       shape=(n_rows, n_cols))
    out.has_sorted_indices = True
    out.has_canonical_format = True
    return P3Parts(out, depop1, pop[0].astype(np.float32) if pop else None, sent + cf.nbytes)
