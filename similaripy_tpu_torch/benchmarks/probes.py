"""The hardware probes P1 and P2: wrappers of their hand-written kernels,
each beside its plain PyTorch version.

P1, ``transposed_lhs_product(a, b)``: ``a[K, M]^T . b[K, N]``, the product
whose lhs is contracted on its dimension 0, with a and b row-major as
given (port of ``benchmarks/tpu_kernel_check.py::_probe_transposed_lhs``;
kernel ``csrc/probe_tlhs.cu``). int8 gives int32, bf16 and f32 give f32.
int8 runs the K-major pass (``csrc/kmajor.cuh``) on both operands into a
workspace, then ``wgmma`` s8; bf16 and f32 run K2's products
(``csrc/mn_products.cuh``) where their rows are 16-byte multiples, else
the kernels of the first port (``TLHS_KERNELS``).

P2, ``int_rate_product(a, b, steps, mode)``: ``steps * a[M, K] . b[K, N]``
in int32, multiplied as int8 or as int4 (port of
``benchmarks/micro_int4.py::_kernel``; kernel ``csrc/probe_int_mma.cu``).
In mode ``"s4"`` each value keeps its low four bits, as an int4 cast does.
int8 runs the K-major pass (a padded, b transposed) and ``wgmma`` s8, s4
``mma.sync`` (``RATE_KERNELS``).

``kmajor_pass(x, transpose)`` is the pass alone (``x[K, R]`` to
``xt[R, k_pad]``, or ``x[R, K]`` padded), and ``s8_kmajor_product(at, bt,
M, N)`` P1's int8 product alone on its output: the pieces of a P1 int8
call, for timing and testing apart.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
runs the plain version. The plain versions are float64 products cast to
the accumulator type: exact while every partial sum stays below 2**53 in
magnitude, and the int32 results fit while they stay below 2**31. Each
counter object (``tlhs_counts``, ``int_mma_counts``, ``kmajor_counts``)
has ``kernel_launches`` (one per call that launched its kernels),
``plain_calls``, ``product_launches`` (by product kernel), ``last_kernel``
(the product kernel of the last launch), ``pass_launches`` (the K-major
passes a call ran) and ``reset_counts()``; the module's ``reset_counts()``
resets all three.
"""

from __future__ import annotations

import torch

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
RATE_MODES = {"int8": 0, "s4": 1}
# the product kernels, in the order of csrc/probe_tlhs.cu's TlhsKernel and
# csrc/probe_int_mma.cu's RateKernel
TLHS_KERNELS = ("simt", "simt cp.async ring", "mma.sync bf16", "wgmma bf16", "wgmma s8")
RATE_KERNELS = ("wgmma s8", "mma.sync s4")
KMAJOR_KERNELS = ("kmajor pass",)
K_STEP = 128  # the K-major pass pads K to a multiple of this


class _Counts:
    """Launches of one probe's kernels and calls of its plain version."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.reset_counts()

    def reset_counts(self) -> None:
        self.kernel_launches = 0
        self.plain_calls = 0
        self.pass_launches = 0
        self.product_launches = dict.fromkeys(self.kernels, 0)
        self.last_kernel = None

    def count(self, kind: int, passes: int = 0) -> None:
        self.kernel_launches += 1
        self.pass_launches += passes
        self.last_kernel = self.kernels[kind]
        self.product_launches[self.last_kernel] += 1


tlhs_counts = _Counts(TLHS_KERNELS)
int_mma_counts = _Counts(RATE_KERNELS)
kmajor_counts = _Counts(KMAJOR_KERNELS)


def reset_counts() -> None:
    tlhs_counts.reset_counts()
    int_mma_counts.reset_counts()
    kmajor_counts.reset_counts()


def k_pad(K: int) -> int:
    """K rounded up to a multiple of K_STEP: the K-major pass's row length."""
    return -(-K // K_STEP) * K_STEP


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


def _launch(counts, name, fn, *args, passes=0):
    """Launch through the C entry `fn`, whose last argument receives the
    product kernel taken; count it."""
    import ctypes

    from ..engine.build import check

    kind = ctypes.c_int(-1)
    check(fn(*args, ctypes.byref(kind)), name)
    counts.count(kind.value, passes)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _workspace(rows, K, device):
    """A K-major pass's output, (rows, k_pad(K)) int8; None when empty."""
    return torch.empty((rows, k_pad(K)), dtype=torch.int8, device=device) if K else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_int8(*xs):
    for x in xs:
        if x.dtype != torch.int8 or x.dim() != 2:
            raise ValueError(f"expected a 2D int8 tensor, got {x.dtype} {tuple(x.shape)}")
    if len({x.device for x in xs}) != 1:
        raise ValueError("operands on different devices")


def kmajor_pass_plain(x, transpose: bool = True):
    """``x[K, R]`` as ``(R, k_pad(K))`` (transposed, zero-padded), or
    ``x[R, K]`` zero-padded to ``(R, k_pad(K))``."""
    _check_int8(x)
    kmajor_counts.plain_calls += 1
    xt = x.t() if transpose else x
    return torch.nn.functional.pad(xt, (0, k_pad(xt.shape[1]) - xt.shape[1])).contiguous()


def kmajor_pass(x, transpose: bool = True):
    """The K-major pass (``csrc/kmajor.cuh``) alone; the plain version on
    the CPU."""
    _check_int8(x)
    if x.device.type == "cpu":
        return kmajor_pass_plain(x, transpose)
    from ..engine.build import check, load

    if not x.is_contiguous():
        raise ValueError("the operand must be contiguous")
    K, R = x.shape if transpose else x.shape[::-1]
    xt = torch.empty((R, k_pad(K)), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        check(load().kmajor_pass(int(transpose), x.data_ptr(), K, R, xt.data_ptr(), _stream(x)),
              "kmajor_pass")
    kmajor_counts.count(0)
    return xt


def s8_kmajor_product_plain(at, bt, M: int, N: int):
    """``at[:M] . bt[:N]^T`` in float64, cast to int32."""
    _check_int8(at, bt)
    tlhs_counts.plain_calls += 1
    return _f64_product(at[:M], bt[:N].T, torch.int32)


def s8_kmajor_product(at, bt, M: int, N: int):
    """P1's int8 product alone, on the K-major pass's output ``at (M,
    k_pad)`` and ``bt (N, k_pad)``: ``wgmma`` s8 into an (M, N) int32."""
    _check_int8(at, bt)
    if at.device.type == "cpu":
        return s8_kmajor_product_plain(at, bt, M, N)
    from ..engine.build import check, load

    if at.shape != (M, at.shape[1]) or bt.shape != (N, at.shape[1]) or at.shape[1] % K_STEP:
        raise ValueError(f"expected (M, k_pad) and (N, k_pad), got {tuple(at.shape)}, "
                         f"{tuple(bt.shape)}")
    if not (at.is_contiguous() and bt.is_contiguous()):
        raise ValueError("the operands must be contiguous")
    out = torch.empty((M, N), dtype=torch.int32, device=at.device)
    lib = load()
    with torch.cuda.device(at.device):
        check(lib.probe_s8_product(at.data_ptr(), bt.data_ptr(), at.shape[1], M, N,
                                   out.data_ptr(), _stream(at)), "probe_s8_product")
    tlhs_counts.count(TLHS_KERNELS.index("wgmma s8"))  # the entry's only kernel
    return out


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
    int8 = a.dtype == torch.int8
    ws_a = _workspace(M, K, a.device) if int8 else None
    ws_b = _workspace(N, K, a.device) if int8 else None
    lib = load()
    with torch.cuda.device(a.device):
        _launch(tlhs_counts, "probe_tlhs", lib.probe_tlhs, _MODES[a.dtype], a.data_ptr(),
                b.data_ptr(), K, M, N, out.data_ptr(), _ptr(ws_a), _ptr(ws_b), _stream(a),
                passes=2 if int8 and K else 0)
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
    int8 = mode == "int8"
    ws_a = _workspace(M, K, a.device) if int8 else None
    ws_b = _workspace(N, K, a.device) if int8 else None
    lib = load()
    with torch.cuda.device(a.device):
        _launch(int_mma_counts, "probe_int_mma", lib.probe_int_mma, RATE_MODES[mode],
                a.data_ptr(), b.data_ptr(), M, K, N, int(steps), out.data_ptr(), _ptr(ws_a),
                _ptr(ws_b), _stream(a), passes=2 if int8 and K else 0)
    return out


def _check_rate(a, b, steps, mode):
    _check_pair(a, b, (1, 0), (torch.int8,))
    if mode not in RATE_MODES:
        raise ValueError(f"mode must be one of {sorted(RATE_MODES)}, got {mode!r}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
