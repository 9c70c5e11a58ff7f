"""Preprocessing passes of a call on its device, as torch ops.

A non-CSR input (``ratings.T``, a CSC, above all) crosses to the call's
device as the caller's own arrays and is put in CSR order there
(``coerce``); the int8 gate (``gate``) and the squared-norm and
depop sums (``row_sums``, ``col_sums``) then run as reductions over those
device tensors, and only the coerced CSR and the O(rows) vectors come
back. One implementation serves a card and the CPU. The CSR ordering of
the uploaded entries (``csr_entries``) also serves the P3 transform
(``ops/card_p3.py``).

Each pass gives what the host path gives (``ops/csr.py::ensure_csr_f32``,
``engine/preprocess.py``):

- ``coerce`` equals ``ensure_csr_f32`` element for element: SciPy's CSR
  order, repeated entries of a CSC kept in the order SciPy keeps them,
  float32 values, explicit zeros dropped, the same index dtype, and the
  canonical flags set to what SciPy would find. A COO whose (row, col)
  pairs repeat is left to SciPy, which sums the repeats;
- ``gate`` returns the host gate's scale;
- the sums accumulate in float64 and round once to float32: bit-equal to
  the host's float32 running sums wherever those are exact (half stars),
  within an ulp of the exact sums elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

# the int8 gate's power-of-two scales, smallest first
SCALES = (1.0, 2.0, 4.0, 8.0)

_INT32_MAX = np.iinfo(np.int32).max
# value dtypes torch holds as they are; the device casts them to float32
_VALUE_DTYPES = frozenset(np.dtype(t) for t in (
    np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64,
    np.float16, np.float32, np.float64,
))
_INDEX_DTYPES = frozenset((np.dtype(np.int32), np.dtype(np.int64)))


@dataclass
class DeviceCSR:
    """The entries of a coerced matrix on the device: the row, column and
    float32 value of each, with repeated (row, col) pairs next to each
    other (CSR order, or its transpose by ``T``)."""

    rows: torch.Tensor
    cols: torch.Tensor
    data: torch.Tensor
    shape: tuple
    canonical: bool  # no (row, col) repeats

    @property
    def T(self) -> "DeviceCSR":
        return DeviceCSR(self.cols, self.rows, self.data, self.shape[::-1], self.canonical)

    def ones(self) -> "DeviceCSR":
        """The same pattern with every value 1 (binary mode)."""
        return DeviceCSR(self.rows, self.cols, torch.ones_like(self.data), self.shape,
                         self.canonical)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writeable buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _to_host(*tensors) -> list:
    """The tensors as NumPy arrays. From a card the copies land in pinned
    buffers, which run several times faster than pageable ones; PyTorch's
    caching host allocator reuses a buffer once its array is freed."""
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
           for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [t.numpy() for t in out]


def _takes(matrix) -> bool:
    """Whether ``coerce`` handles `matrix`: a 2-D CSC or COO with entries,
    values torch holds and native int32/int64 indices."""
    return getattr(matrix, "format", None) in ("csc", "coo") and takes_entries(matrix)


def takes_entries(matrix) -> bool:
    """Whether ``csr_entries`` handles `matrix`: a 2-D CSC, CSR or COO with
    entries, values torch holds and native int32/int64 indices."""
    fmt = getattr(matrix, "format", None)
    if fmt not in ("csc", "csr", "coo") or matrix.ndim != 2 or matrix.nnz == 0:
        return False
    return (matrix.data.dtype in _VALUE_DTYPES
            and all(a.dtype in _INDEX_DTYPES for a in _index_arrays(matrix)))


def _index_arrays(matrix) -> tuple:
    if matrix.format in ("csc", "csr"):
        return matrix.indptr, matrix.indices
    return matrix.row, matrix.col


def index_dtype(matrix) -> torch.dtype:
    """The index dtype of SciPy's tocsr of `matrix`, which ensure_csr_f32's
    constructor then judges as it judges this one's."""
    wide = (any(a.dtype == np.int64 for a in _index_arrays(matrix))
            or max(matrix.nnz, matrix.shape[1]) > _INT32_MAX)
    return torch.int64 if wide else torch.int32


def _key_order(rows: torch.Tensor, cols: torch.Tensor, n_cols: int):
    """(the stable order of the entries by (row, col), the sorted keys)."""
    key = rows.long() * n_cols + cols.long()
    order = torch.argsort(key, stable=True)
    return order, key[order]


def repeats(rows: torch.Tensor, cols: torch.Tensor) -> bool:
    """Whether entries in CSR order repeat a (row, col)."""
    return bool(((rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])).any())


def csr_entries(matrix, device) -> Optional[tuple]:
    """The entries of a CSC, CSR or COO `matrix` (``takes_entries``),
    uploaded to `device` from the caller's own arrays and put in SciPy's
    CSR order: (rows, cols, values in the caller's dtype, the bytes
    uploaded); None for a COO whose (row, col) pairs repeat (SciPy sums
    those) and for a matrix too large to key by (row, col) where it has to.

    A CSC's repeated entries keep their order, as SciPy's tocsr keeps them;
    a CSR keeps its entries as they are unless a row's columns are out of
    order, when a stable sort by (row, col) puts them in order. On the CPU
    the tensors of a CSR taken as it is share the caller's arrays: the
    caller's arrays are never written, so neither may the tensors be."""
    n_rows, n_cols = matrix.shape
    if matrix.format == "coo":
        if n_rows * n_cols > 1 << 62:
            return None
        host = (matrix.row, matrix.col, matrix.data)
        rows, cols, vals = (_upload(a, device) for a in host)
        order, key = _key_order(rows, cols, n_cols)
        if bool((key[1:] == key[:-1]).any()):
            return None  # SciPy sums the repeats of a COO: the host does it
        del key
    else:
        nnz = int(matrix.indptr[-1])
        host = (matrix.indptr, matrix.indices[:nnz], matrix.data[:nnz])
        ptr, minor, vals = (_upload(a, device) for a in host)
        major = torch.repeat_interleave(
            torch.arange(ptr.shape[0] - 1, device=device, dtype=minor.dtype), ptr.diff(),
            output_size=nnz)
        del ptr
        if matrix.format == "csc":
            rows, cols = minor, major
            # a stable sort by row keeps each row's entries in column order and
            # a column's repeats in their order, as SciPy's tocsr does
            order = torch.argsort(rows, stable=True)
        else:
            rows, cols = major, minor
            order = None
            if bool(((rows[1:] == rows[:-1]) & (cols[1:] < cols[:-1])).any()):
                if n_rows * n_cols > 1 << 62:
                    return None
                order, _ = _key_order(rows, cols, n_cols)
        del minor, major
    if order is not None:  # one at a time, each copy freed as it is replaced
        rows = rows[order]
        cols = cols[order]
        vals = vals[order]
        del order
    return rows, cols, vals, sum(int(a.nbytes) for a in host)


def coerce(matrix, device) -> Optional[tuple[sp.csr_array, DeviceCSR]]:
    """`matrix` as ``ensure_csr_f32`` makes it, built on `device` from the
    caller's own arrays, with its entries left there; None where the device
    does not take it (a CSR, whose host path copies nothing, an empty
    matrix, another format or dtype, or a COO that repeats a (row, col)).

    The caller's arrays are read, never written."""
    if not _takes(matrix):
        return None
    got = csr_entries(matrix, device)
    if got is None:
        return None
    rows, cols, vals, _ = got
    n_rows, n_cols = matrix.shape
    data = vals.to(torch.float32)
    del vals
    keep = data != 0
    if not bool(keep.all()):
        rows, cols, data = rows[keep], cols[keep], data[keep]
    del keep
    # sorted columns within each row: canonical unless a (row, col) repeats
    canonical = not repeats(rows, cols)
    idx = index_dtype(matrix)
    indptr = torch.searchsorted(rows, torch.arange(n_rows + 1, device=device, dtype=rows.dtype))
    out = sp.csr_array(tuple(_to_host(data, cols.to(idx), indptr.to(idx))), shape=(n_rows, n_cols))
    out.has_sorted_indices = True
    out.has_canonical_format = canonical
    return out, DeviceCSR(rows, cols, data, (n_rows, n_cols), canonical)


def scale_from(amax: float, integral_at) -> Optional[float]:
    """The int8 gate's rule: the smallest s of ``SCALES`` at which every
    value times s is an integer, provided ``amax * s <= 127`` (`amax` the
    largest magnitude); None when there is none.

    ``integral_at(s)`` tells whether the values times s are integers; it is
    asked at 8 first, since values that are not integers at 8 are integers
    at no smaller s."""
    if amax > 127 or not integral_at(8.0):
        return None
    s = next(s for s in SCALES if integral_at(s))
    return None if amax * s > 127 else s


def _repeat_sums(m: DeviceCSR) -> torch.Tensor:
    """The float32 sum of each run of repeated (row, col) entries."""
    same = (m.rows[1:] == m.rows[:-1]) & (m.cols[1:] == m.cols[:-1])
    run = torch.cat([same.new_ones(1), ~same]).cumsum(0) - 1
    sums = torch.zeros(int(run[-1]) + 1, dtype=torch.float32, device=m.data.device)
    sums.index_add_(0, run, m.data)
    counts = torch.bincount(run)
    return sums[counts > 1]


def gate(m: DeviceCSR) -> tuple[Optional[float], float]:
    """The int8 gate of the coerced matrix, judged by reductions on the
    device over the values a densify holds (its entries and the sums of
    repeated entries): (``preprocess.quantize_scale(int8_values(m))``, the
    largest magnitude among those values)."""
    vals = m.data if m.canonical else torch.cat([m.data, _repeat_sums(m)])
    if vals.numel() == 0:
        return 1.0, 0.0
    checks = [vals.abs().max()]
    for s in SCALES:
        scaled = vals * s
        checks.append((scaled == torch.round(scaled)).all().to(vals.dtype))
    amax, *integral = torch.stack(checks).tolist()
    return scale_from(amax, lambda s: bool(integral[SCALES.index(s)])), amax


def _sums(ids: torch.Tensor, data: torch.Tensor, n: int, square: bool) -> np.ndarray:
    v = data.double()
    if square:
        v = v * v  # exact: a float32 square fits a float64
    out = torch.zeros(n, dtype=torch.float64, device=data.device).index_add_(0, ids, v)
    return out.to(torch.float32).cpu().numpy()


def row_sums(m: DeviceCSR, square: bool = False) -> np.ndarray:
    """Row sums of the values (or of their squares), float32 on the host."""
    return _sums(m.rows, m.data, m.shape[0], square)


def col_sums(m: DeviceCSR, square: bool = False) -> np.ndarray:
    """Column sums of the values (or of their squares), float32 on the host."""
    return _sums(m.cols, m.data, m.shape[1], square)
