"""Native (C++) host assembly: the port of ``similaripy_tpu/native/``.

``simtpu.cpp`` holds the two host kernels of the output assembly
(``engine/assembly.py``): the counting-sort COO -> CSR in int32 and int64
(``coo_to_csr``) and the extraction of COO triples from the executor's
(T, k) top-K buffers, dropping -inf and NaN slots (``topk_to_coo``).

The library is built at first use, never at import, from the repository's
source only: ``g++ -O3 -shared -fPIC`` (``c++`` where there is no ``g++``)
into ``similaripy_tpu_torch/_build/`` under a name keyed by a hash of the
source and the flags, and loaded with ``ctypes``, as ``engine/build.py``
builds and loads the CUDA kernels. Unlike the JAX package's, a failed build
raises with the compiler's output: nothing falls back quietly. The NumPy
branch of ``engine/assembly.py`` is the plain version (``native=False``).

``native_calls`` counts the calls into the library (one per wrapper call);
``reset_counts`` sets it to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "simtpu.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

native_calls = 0
_LIB = None


def reset_counts() -> None:
    global native_calls
    native_calls = 0


def _count() -> None:
    global native_calls
    native_calls += 1


def library_path() -> Path:
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsimtpu_{digest.hexdigest()[:16]}.so"


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH; it builds "
                       "similaripy_tpu_torch's native assembly")


def build() -> Path:
    """Compile the library unless one for this source exists; returns its
    path. A failed build raises with the compiler's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = Path(tmp_dir) / out.name
        cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The library, built if needed, with every signature declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.coo_to_csr32.argtypes = [ctypes.c_int, i64, p, p, p, p, p, p]
        lib.coo_to_csr32.restype = None
        lib.coo_to_csr64.argtypes = [i64, i64, p, p, p, p, p, p]
        lib.coo_to_csr64.restype = None
        lib.topk_to_coo.argtypes = [i64, i64, p, p, p, p, p, p]
        lib.topk_to_coo.restype = i64
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def coo_to_csr(rows, cols, vals, n_rows: int, idx_dtype):
    """Counting-sort COO -> CSR (duplicates preserved, row-major, stable)
    with `idx_dtype` (int32 or int64) indices; returns (indptr, indices,
    data). Every row id must lie in [0, n_rows)."""
    idx_dtype = np.dtype(idx_dtype)
    if idx_dtype not in (np.int32, np.int64):
        raise ValueError(f"idx_dtype must be int32 or int64, got {idx_dtype}")
    lib = load()
    nnz = int(vals.shape[0])
    rows = np.ascontiguousarray(rows, dtype=idx_dtype)
    cols = np.ascontiguousarray(cols, dtype=idx_dtype)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    if rows.shape != (nnz,) or cols.shape != (nnz,):
        raise ValueError(f"rows {rows.shape}, cols {cols.shape} and vals ({nnz},) differ")
    if nnz and (int(rows.min()) < 0 or int(rows.max()) >= n_rows):
        raise ValueError(f"a row id lies outside [0, {n_rows})")
    indptr = np.zeros(n_rows + 1, dtype=idx_dtype)
    indices = np.empty(nnz, dtype=idx_dtype)
    data = np.empty(nnz, dtype=np.float32)
    fn = lib.coo_to_csr32 if idx_dtype == np.int32 else lib.coo_to_csr64
    _count()
    fn(n_rows, nnz, _ptr(rows), _ptr(cols), _ptr(vals), _ptr(indptr), _ptr(indices),
       _ptr(data))
    return indptr, indices, data


def topk_to_coo(vals, idx, targets):
    """COO triples (rows, cols, vals) of the (T, k) top-K buffers in
    row-major order, -inf and NaN slots dropped; panel row i becomes output
    row targets[i]. Ids are int32, as the executor's are."""
    lib = load()
    T, k = vals.shape
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    targets = np.ascontiguousarray(targets, dtype=np.int32)
    if idx.shape != (T, k) or targets.shape != (T,):
        raise ValueError(f"vals {vals.shape}, idx {idx.shape} and targets {targets.shape} "
                         "do not match")
    out_rows = np.empty(T * k, dtype=np.int32)
    out_cols = np.empty(T * k, dtype=np.int32)
    out_vals = np.empty(T * k, dtype=np.float32)
    _count()
    n = lib.topk_to_coo(T, k, _ptr(vals), _ptr(idx), _ptr(targets), _ptr(out_rows),
                        _ptr(out_cols), _ptr(out_vals))
    return out_rows[:n], out_cols[:n], out_vals[:n]
