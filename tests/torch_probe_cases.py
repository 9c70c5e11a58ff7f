"""Shared cases of the hardware probes P1 (transposed-lhs product) and P2
(int8/int4 rate product): the CPU tests hold the plain versions against
the JAX package, the card tests and chip_smoke.py the kernels against the
plain versions. Inputs are made with numpy from a seed."""

import numpy as np

# P1: (K, M, N). The probe's own shape, ragged edges in every dimension
# (rows that are not 4- or 8-element aligned), one-row/column outputs and
# an empty contraction.
P1_SHAPES = [
    (512, 256, 1024),
    (77, 130, 300),
    (1000, 37, 129),
    (5, 1, 3),
    (33, 200, 17),
    (300, 129, 131),
    (0, 16, 24),
]
P1_DTYPES = ["int8", "bfloat16", "float32"]

# P2: (M, K, N, steps)
P2_CASES = [
    (32, 64, 48, 3),
    (64, 2048, 64, 5),
    (100, 130, 70, 2),
    (17, 1000, 9, 1),
]
P2_MODES = ["int8", "s4"]
# P2 on values whose s4 cast wraps: (M, K, N, steps)
P2_WRAP_CASES = [(32, 64, 48, 3), (100, 130, 70, 2)]


def p1_inputs(K, M, N, seed=0, full_range=False):
    """int64 (K x M) and (K x N): values in [-5, 5] (every mode exact), or
    the whole int8 range."""
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if full_range else (-5, 6)
    return rng.integers(lo, hi, (K, M)), rng.integers(lo, hi, (K, N))


def p2_inputs(M, K, N, seed=0):
    """int8 (M x K) and (K x N) in [-7, 7]: the s4 cast loses nothing."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-7, 8, (M, K)).astype(np.int8),
            rng.integers(-7, 8, (K, N)).astype(np.int8))


def p2_wrap_inputs(M, K, N, seed=0):
    """int8 (M x K) and (K x N) in [-8, 9]: the s4 cast wraps 8 and 9 to -8
    and -7, and -8 is the nibble without a positive twin."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 10, (M, K)).astype(np.int8),
            rng.integers(-8, 10, (K, N)).astype(np.int8))


# P1 in f32 on non-integer data: (K, M, N), the probe's shape and a ragged one
P1_F32_RANDN_SHAPES = [(512, 256, 1024), (1000, 37, 129)]


def p1_randn(K, M, N, seed=0):
    """float32 (K x M) and (K x N), standard normal: most products round."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, M)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def f32_tolerance(K):
    """The largest mean scaled error (see f32_scaled_errors) an f32 product
    of depth K may show: 2**-24 * sqrt(K). A product that adds in f32, one
    term after another, shows about a fifth of it on standard-normal data
    (0.21 * 2**-24 * sqrt(K), by a numpy emulation of fmaf at K 512 and
    200,960); one whose operands are rounded to TF32 first shows ~2.2e-4
    at any depth, 8x the tolerance at K 200,960 and 170x at K 512."""
    return 2.0**-24 * K**0.5


def f32_scaled_errors(torch, got, a, b):
    """For the f32 result ``got`` of a^T . b: the mean and the max over the
    outputs of |got - exact| / sqrt(sum_k a_km^2 b_kn^2), the size of a
    sum's rounding errors; and the mean of the same for a product whose
    operands were rounded to TF32 (10 mantissa bits) and then added exactly,
    which is what a TF32 tensor-core kernel would make at best."""
    a64, b64 = a.double(), b.double()
    exact = a64.T @ b64
    scale = ((a64 * a64).T @ (b64 * b64)).sqrt().clamp_min(1e-300)
    err = (got.double() - exact).abs() / scale

    def tf32(x):
        return ((x.float().view(torch.int32) + 0x1000) & -8192).view(torch.float32).double()

    tf32_err = (tf32(a).T @ tf32(b) - exact).abs() / scale
    return float(err.mean()), float(err.max()), float(tf32_err.mean())


def shape_id(shape):
    return "x".join(str(s) for s in shape)
