"""K1: the fused similarity tile with exact per-row top-k.

Port of ``similaripy_tpu/engine/pallas_kernels.py::fused_tile_topk`` (kernel
body ``_kernel``, epilogue ``_epilogue_val``). For one row panel against
one column tile:

    xy   = m1_dense @ d               f32 FMA | bf16 -> f32 | int8 -> exact int32
    val  = S-Plus epilogue(xy)        masks fold into the candidate test
    out  = top-k_pad of each row      ids col_base + col, sorted descending,
                                      merged with a carried top-k_pad if given

``fused_tile_topk`` keeps the JAX function's arguments and layout: it
returns ``(vals, idx)`` of shape (k_pad, trp). On CUDA tensors it launches
the hand-written kernel of ``csrc/tile_topk.cu`` (two launches: product with
the fused epilogue, then the per-row top-k) or raises; on CPU tensors it
runs ``fused_tile_topk_plain``, the same function in plain PyTorch.

Ties follow the TPU kernel: within a tile the lowest column first, and tile
entries before carry entries; with a carry, only tile values strictly above
the carry's kth enter (pallas_kernels.py:323-374). Ids of -inf slots are
arbitrary, as in the reference; the executor drops those slots.

``kernel_launches`` and ``plain_calls`` count the two routes (one per call).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .params import PVEC_COL_BASE, PVEC_LEN

NEG_INF = float("-inf")

# Deeper carries take the executor's non-kernel branch, as the reference's
# fused path hands k_pad > 1024 to XLA (executor.py:1416-1425).
MAX_KERNEL_K_PAD = 1024

kernel_launches = 0
plain_calls = 0

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FLAG_BITS = (1, 2, 4, 8, 16, 32)  # static_flags() order, as in the .cu file

# int8 products run as float64 on the plain path (exact below 2**53);
# columns are taken in chunks so the f64 copy of a wide tile stays small
_PLAIN_INT8_COLS = 2048


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def splus_epilogue(xy, candidate, x_t, x_c, x_d, y_t, y_c, y_d, pvec, flags):
    """The S-Plus epilogue on a dense (rows x cols) xy tile (port of
    executor.py:53 splus_epilogue). `pvec` is a sequence of Python floats;
    non-candidates and sub-threshold cells become -inf."""
    use_l1, use_l2, use_l3, use_pow, use_bayes, use_denominator = flags
    a1, l1, l2, l3, t1, t2, stab, bayes, threshold = pvec[:9]

    xy_p = torch.pow(xy, a1) if use_pow else xy
    if use_denominator:
        denom = torch.full_like(xy, stab)
        if use_l1:
            denom = denom + l1 * (
                t1 * (x_t[:, None] - xy) + t2 * (y_t[None, :] - xy) + xy
            )
        if use_l2:
            denom = denom + l2 * (x_c[:, None] * y_c[None, :])
        if use_l3:
            denom = denom + l3 * (x_d[:, None] * y_d[None, :])
        val = torch.where(denom != 0.0, xy_p / denom, torch.zeros_like(xy))
        if use_bayes:
            val = val * (xy_p / (xy_p + bayes))
    else:
        val = xy  # raw product, un-powered (reference: s_plus.h:131,144)

    keep = candidate & (val >= threshold)
    return torch.where(keep, val, torch.full_like(val, NEG_INF))


def _product_plain(a, d, int8_mode: bool, bias=None):
    """bias + a @ d as f32: float64 for int8 (exact, the int32 bias
    included), f32 otherwise; TF32 is kept off on the card so "f32" means
    true f32."""
    if int8_mode:
        a64 = a.to(torch.float64)
        cols = []
        for c0 in range(0, d.shape[1], _PLAIN_INT8_COLS):
            c1 = c0 + _PLAIN_INT8_COLS
            xy = a64 @ d[:, c0:c1].to(torch.float64)
            if bias is not None:
                xy = xy + bias[:, c0:c1].to(torch.float64)
            cols.append(xy.to(torch.float32))
        return torch.cat(cols, dim=1)
    with full_f32_matmul():
        xy = a.to(torch.float32) @ d.to(torch.float32)
    return xy if bias is None else bias + xy


@contextlib.contextmanager
def full_f32_matmul():
    """f32 products inside run as true f32 whatever the caller set: TF32
    off for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def tile_scores_plain(m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext,
                      allowed, fmask, tmask, *, flags, int8_mode, bias=None):
    """The (trp, tc) masked epilogue scores of bias + m1_dense @ d, -inf
    where dropped."""
    pv = pvec_ext.tolist()
    xy = _product_plain(m1_dense, d, int8_mode, bias)
    if int8_mode:
        xy = xy * pv[9]  # inv_scale
    candidate = xy != 0.0
    if allowed is not None:
        candidate = candidate & (allowed != 0)[None, :]
    if fmask is not None:
        candidate = candidate & (fmask == 0)
    if tmask is not None:
        candidate = candidate & (tmask != 0)
    return splus_epilogue(xy, candidate, x_t, x_c, x_d, y_t, y_c, y_d, pv, flags)


def select_topk_plain(val, carry, k_pad: int, col_base: int):
    """(k_pad, trp) top-k of `val` rows, merged with `carry` if given; stable
    sorts give the TPU kernel's tie order."""
    trp, tc = val.shape
    if carry is not None:
        cv, ci = carry
        val = torch.where(val > cv[k_pad - 1][:, None], val, torch.full_like(val, NEG_INF))
    vals, pos = torch.sort(val, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k_pad], (pos[:, :k_pad] + col_base).to(torch.int32)
    if tc < k_pad:
        fill = (trp, k_pad - tc)
        vals = torch.cat([vals, torch.full(fill, NEG_INF, device=val.device)], dim=1)
        idx = torch.cat(
            [idx, torch.full(fill, col_base, dtype=torch.int32, device=val.device)], dim=1
        )
    if carry is not None:
        mv = torch.cat([vals, cv.T], dim=1)
        mi = torch.cat([idx, ci.T], dim=1)
        mv, pos = torch.sort(mv, dim=1, descending=True, stable=True)
        vals, idx = mv[:, :k_pad], torch.gather(mi, 1, pos[:, :k_pad])
    return vals.T.contiguous(), idx.T.contiguous()


def _plain(m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed,
           fmask, tmask, carry, *, flags, k_pad, int8_mode):
    val = tile_scores_plain(
        m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed, fmask,
        tmask, flags=flags, int8_mode=int8_mode,
    )
    return select_topk_plain(val, carry, k_pad, int(pvec_ext[PVEC_COL_BASE]))


def fused_tile_topk_plain(m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext,
                          allowed=None, fmask=None, tmask=None, carry=None, *,
                          flags: tuple, k_pad: int, int8_mode: bool):
    """`fused_tile_topk` in plain PyTorch, on any device."""
    global plain_calls
    plain_calls += 1
    return _plain(
        m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed, fmask,
        tmask, carry, flags=flags, k_pad=k_pad, int8_mode=int8_mode,
    )


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_tile_topk(
    m1_dense,  # (trp, u_pad) f32 | bf16 | int8
    d,  # (u_pad, tc) same dtype
    x_t,  # (trp,) f32
    x_c,
    x_d,
    y_t,  # (tc,) f32
    y_c,
    y_d,
    pvec_ext,  # (16,) f32 — build_pvec + col_base at [10]
    allowed=None,  # (tc,) uint8
    fmask=None,  # (trp, tc) uint8, 1 = filtered out
    tmask=None,  # (trp, tc) uint8, 1 = allowed target
    carry=None,  # (cv, ci) of (k_pad, trp) f32 / int32
    *,
    flags: tuple,
    k_pad: int,
    int8_mode: bool,
    precision=None,
    split_f32=False,
    tm=None,
    kb=None,
    interpret=False,
):
    """Returns (vals, idx) of shape (k_pad, trp): per-row top-k_pad of the
    fused similarity tile, sorted descending, ids global via col_base.

    `precision`, `tm`, `kb` and `interpret` are the JAX function's TPU
    knobs; they are accepted for the same call signature and change
    nothing here (f32 always runs as true f32). The split-bf16x3 modes
    (`split_f32`) are not ported yet."""
    if split_f32:
        raise NotImplementedError("split_f32 (the bf16x3 sweep) is not ported yet")
    if m1_dense.device.type == "cpu":
        return fused_tile_topk_plain(
            m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed,
            fmask, tmask, carry, flags=flags, k_pad=k_pad, int8_mode=int8_mode,
        )
    if m1_dense.device.type != "cuda":
        raise ValueError(f"fused_tile_topk runs on cuda or cpu, not {m1_dense.device}")
    return _launch(
        m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed, fmask,
        tmask, carry, flags=flags, k_pad=k_pad, int8_mode=int8_mode,
    )


def _launch(m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed,
            fmask, tmask, carry, *, flags, k_pad, int8_mode):
    global kernel_launches
    from .build import load

    dev = m1_dense.device
    trp, u_pad = m1_dense.shape
    tc = d.shape[1]
    dtype = m1_dense.dtype
    if dtype not in _MODES or (dtype == torch.int8) != bool(int8_mode):
        raise ValueError(f"operand dtype {dtype} does not fit int8_mode={int8_mode}")
    if not 0 < k_pad <= MAX_KERNEL_K_PAD:
        raise ValueError(f"k_pad={k_pad} is outside the kernel's 1..{MAX_KERNEL_K_PAD}")
    f32, u8 = torch.float32, torch.uint8
    _check("m1_dense", m1_dense, (trp, u_pad), dtype, dev)
    _check("d", d, (u_pad, tc), dtype, dev)
    for name, v in (("x_t", x_t), ("x_c", x_c), ("x_d", x_d)):
        _check(name, v, (trp,), f32, dev)
    for name, v in (("y_t", y_t), ("y_c", y_c), ("y_d", y_d)):
        _check(name, v, (tc,), f32, dev)
    _check("pvec_ext", pvec_ext, (PVEC_LEN,), f32, dev)
    if allowed is not None:
        _check("allowed", allowed, (tc,), u8, dev)
    if fmask is not None:
        _check("fmask", fmask, (trp, tc), u8, dev)
    if tmask is not None:
        _check("tmask", tmask, (trp, tc), u8, dev)
    if carry is not None:
        _check("carry values", carry[0], (k_pad, trp), f32, dev)
        _check("carry ids", carry[1], (k_pad, trp), torch.int32, dev)

    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scores = torch.empty((trp, tc), dtype=f32, device=dev)
    vals = torch.empty((k_pad, trp), dtype=f32, device=dev)
    idx = torch.empty((k_pad, trp), dtype=torch.int32, device=dev)
    flag_bits = sum(b for b, on in zip(_FLAG_BITS, flags) if on)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.tile_product(
            _MODES[dtype], ptr(m1_dense), ptr(d), trp, u_pad, tc,
            ptr(x_t), ptr(x_c), ptr(x_d), ptr(y_t), ptr(y_c), ptr(y_d),
            ptr(pvec_ext), ptr(allowed), ptr(fmask), ptr(tmask), flag_bits,
            ptr(scores), stream,
        )
        if err == 0:
            cv, ci = carry if carry is not None else (None, None)
            err = lib.tile_topk_rows(
                ptr(scores), trp, tc, k_pad, ptr(pvec_ext), ptr(cv), ptr(ci),
                ptr(vals), ptr(idx), stream,
            )
    if err != 0:
        raise RuntimeError(
            f"tile_topk kernel launch failed: {lib.tile_error_string(err).decode()} "
            f"(trp={trp}, u_pad={u_pad}, tc={tc}, k_pad={k_pad}, dtype={dtype})"
        )
    kernel_launches += 1
    return vals, idx


def product_attrs(dtype, bias: bool = False) -> dict:
    """Registers and local (spill) bytes a thread, shared memory a block and
    resident blocks per SM of the product kernel that `dtype` (float32,
    bfloat16 or int8) runs for 16-byte aligned operands; `bias` asks for
    K3's kernel with the hot-prefix bias. Needs a card."""
    from .build import check, load

    out = (ctypes.c_int * 4)()
    check(load().tile_product_attrs(_MODES[dtype], int(bias), out),
          f"tile_product_attrs({dtype}, bias={bias})")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), out))
