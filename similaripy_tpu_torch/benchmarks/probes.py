"""The hardware probes P1 and P2: wrappers of their hand-written kernels,
each beside its plain PyTorch version.

P1, ``transposed_lhs_product(a, b)``: ``a[K, M]^T . b[K, N]``, the product
whose lhs is contracted on its dimension 0, with a and b row-major as
given (port of ``benchmarks/tpu_kernel_check.py::_probe_transposed_lhs``;
kernel ``csrc/probe_tlhs.cu``). int8 gives int32, bf16 and f32 give f32.

P2, ``int_rate_product(a, b, steps, mode)``: ``steps * a[M, K] . b[K, N]``
in int32, multiplied as int8 or as int4 (port of
``benchmarks/micro_int4.py::_kernel``; kernel ``csrc/probe_int_mma.cu``).
In mode ``"s4"`` each value keeps its low four bits, as an int4 cast does.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
runs the plain version. The plain versions are float64 products cast to
the accumulator type: exact while every partial sum stays below 2**53 in
magnitude, and the int32 results fit while they stay below 2**31. Each
counter object (``tlhs_counts``, ``int_mma_counts``) has
``kernel_launches``, ``plain_calls`` and ``reset_counts()``; the module's
``reset_counts()`` resets both.
"""

from __future__ import annotations

import torch

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
RATE_MODES = {"int8": 0, "s4": 1}


class _Counts:
    """Launches of one kernel and calls of its plain version."""

    def __init__(self):
        self.reset_counts()

    def reset_counts(self) -> None:
        self.kernel_launches = 0
        self.plain_calls = 0


tlhs_counts = _Counts()
int_mma_counts = _Counts()


def reset_counts() -> None:
    tlhs_counts.reset_counts()
    int_mma_counts.reset_counts()


def _accumulator(dtype):
    return torch.int32 if dtype == torch.int8 else torch.float32


def _f64_product(x, y, out_dtype):
    return (x.to(torch.float64) @ y.to(torch.float64)).to(out_dtype)


def _check_pair(a, b, dims, dtypes):
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in dtypes:
        raise ValueError(f"operand dtypes {a.dtype}, {b.dtype}; expected one of {dtypes}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[dims[0]] != b.shape[dims[1]]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do not chain")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the probes run on cuda or cpu, not {a.device}")


def _launch(counts, name, fn, *args):
    from ..engine.build import check

    check(fn(*args), name)
    counts.kernel_launches += 1


def transposed_lhs_product_plain(a, b):
    """``a.T @ b`` in float64, cast to the accumulator type."""
    _check_pair(a, b, (0, 0), tuple(_MODES))
    tlhs_counts.plain_calls += 1
    return _f64_product(a.T, b, _accumulator(a.dtype))


def transposed_lhs_product(a, b):
    """P1: ``a[K, M]^T . b[K, N]`` (M x N); f32 for f32 and bf16 operands,
    int32 for int8."""
    _check_pair(a, b, (0, 0), tuple(_MODES))
    if a.device.type == "cpu":
        return transposed_lhs_product_plain(a, b)
    from ..engine.build import load

    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the operands must be contiguous")
    (K, M), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=_accumulator(a.dtype), device=a.device)
    lib = load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _launch(tlhs_counts, "probe_tlhs", lib.probe_tlhs, _MODES[a.dtype], a.data_ptr(),
                b.data_ptr(), K, M, N, out.data_ptr(), stream)
    return out


def _as_s4(x):
    """The values an int4 cast keeps: the low four bits, sign-extended."""
    return ((x.to(torch.int32) + 8) & 15) - 8


def int_rate_product_plain(a, b, steps: int, mode: str = "int8"):
    """``steps * a @ b`` in float64 (after the s4 cast in mode "s4"), cast
    to int32."""
    _check_rate(a, b, steps, mode)
    int_mma_counts.plain_calls += 1
    if mode == "s4":
        a, b = _as_s4(a), _as_s4(b)
    return (_f64_product(a, b, torch.float64) * steps).to(torch.int32)


def int_rate_product(a, b, steps: int, mode: str = "int8"):
    """P2: ``steps * a[M, K] . b[K, N]`` (M x N int32), multiplied as int8
    or, in mode "s4", as int4."""
    _check_rate(a, b, steps, mode)
    if a.device.type == "cpu":
        return int_rate_product_plain(a, b, steps, mode)
    from ..engine.build import load

    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the operands must be contiguous")
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    lib = load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _launch(int_mma_counts, "probe_int_mma", lib.probe_int_mma, RATE_MODES[mode],
                a.data_ptr(), b.data_ptr(), M, K, N, int(steps), out.data_ptr(), stream)
    return out


def _check_rate(a, b, steps, mode):
    _check_pair(a, b, (1, 0), (torch.int8,))
    if mode not in RATE_MODES:
        raise ValueError(f"mode must be one of {sorted(RATE_MODES)}, got {mode!r}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
