"""Build and load the hand-written CUDA kernels.

``csrc/tile_topk.cu`` is compiled by ``nvcc`` straight into a shared library
with a plain C interface and loaded with ``ctypes``. No PyTorch header takes
part, so a build takes seconds, not minutes. The library goes into
``similaripy_tpu_torch/_build/`` (git-ignored) under a name keyed by a hash
of the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. It is built at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "tile_topk.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc was not found on PATH or under CUDA_HOME; the CUDA toolkit "
            "is needed to build similaripy_tpu_torch's kernels"
        )
    return path


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtile_topk_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for this source exists; returns
    its path. A failed build raises with nvcc's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every signature declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tile_product.argtypes = [i, p, p, i, i, i, p, p, p, p, p, p, p, p, p, p, i, p, p]
        lib.tile_product.restype = i
        lib.tile_topk_rows.argtypes = [p, i, i, i, p, p, p, p, p, p]
        lib.tile_topk_rows.restype = i
        lib.tile_error_string.argtypes = [i]
        lib.tile_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
