"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` (K1 ``tile_topk.cu``, K2 ``sym_topk.cu``, K3
``panel_topk.cu``, K4 ``gather.cu``, K5 ``scatter.cu``, and the hardware
probes P1 ``probe_tlhs.cu`` and P2 ``probe_int_mma.cu``, with the shared
``csrc/*.cuh`` headers, ``hopper.cuh``'s wgmma and TMA primitives,
``mn_products.cuh``'s products of K2 and P1 and the probes' K-major pass
``kmajor.cuh`` among them) is compiled by
``nvcc`` into one shared library with a plain C interface, loaded with
``ctypes``. No PyTorch header takes part, so a build takes seconds, not
minutes; the sources compile in parallel, one ``nvcc`` each, and are then
linked. The bf16 products' tensor maps are encoded by the driver's
``cuTensorMapEncodeTiled``, reached through the CUDA runtime's driver
entry point, so the library links nothing beyond the runtime. The library
goes into ``similaripy_tpu_torch/_build/`` (git-ignored)
under a name keyed by a hash of the sources, the headers and the flags, so
an edited source is rebuilt and a stale library is never loaded. It is
built at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_LIB = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libsplus_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands together; raise with the output of the first that
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. A failed build raises with nvcc's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [Path(tmp_dir) / f"{src.stem}.o" for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources(), objs)])
        tmp = Path(tmp_dir) / out.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every signature declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tile_product.argtypes = [i, p, p, i, i, i, p, p, p, p, p, p, p, p, p, p, i, p, p, p]
        lib.tile_product.restype = i
        lib.tile_product_attrs.argtypes = [i, i, p]
        lib.tile_product_attrs.restype = i
        lib.tile_topk_rows.argtypes = [p, i, i, i, p, p, p, p, p, p]
        lib.tile_topk_rows.restype = i
        lib.sym_product.argtypes = [i, p, p, i, i, i, p, p, i, p, p, p, p]
        lib.sym_product.restype = i
        lib.sym_product_attrs.argtypes = [i, p]
        lib.sym_product_attrs.restype = i
        lib.sym_merge.argtypes = [i, p, i, i, i, p, p, p, p, p, p, p]
        lib.sym_merge.restype = i
        lib.densify_tiles.argtypes = [i, p, p, p, i, i, i, i, p, p]
        lib.densify_tiles.restype = i
        lib.panel_product.argtypes = [i, p, p, p, i, i, i, p, p, p, p, p, p, p, p, p, p, i, p, p, p]
        lib.panel_product.restype = i
        lib.panel_topk_rows.argtypes = [p, i, i, i, i, p, p, p, p]
        lib.panel_topk_rows.restype = i
        lib.gather_rows.argtypes = [p, ctypes.c_longlong, ctypes.c_longlong, p, i, p, p]
        lib.gather_rows.restype = i
        lib.probe_tlhs.argtypes = [i, p, p, i, i, i, p, p, p, p, p]
        lib.probe_tlhs.restype = i
        lib.probe_s8_product.argtypes = [p, p, i, i, i, p, p]
        lib.probe_s8_product.restype = i
        lib.kmajor_pass.argtypes = [i, p, i, i, p, p]
        lib.kmajor_pass.restype = i
        lib.probe_int_mma.argtypes = [i, p, p, i, i, i, i, p, p, p, p, p]
        lib.probe_int_mma.restype = i
        lib.tile_error_string.argtypes = [i]
        lib.tile_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: {load().tile_error_string(err).decode()}")
