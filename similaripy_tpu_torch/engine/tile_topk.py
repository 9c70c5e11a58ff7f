"""K1: the fused similarity tile with exact per-row top-k.

Port of ``similaripy_tpu/engine/pallas_kernels.py::fused_tile_topk`` (kernel
body ``_kernel``, epilogue ``_epilogue_val``). For one row panel against
one column tile:

    xy   = m1_dense @ d               f32 FMA | bf16 -> f32 | int8 -> exact int32
                                      | split-bf16x3 -> 3 or 2 bf16 phases in f32
    val  = S-Plus epilogue(xy)        masks fold into the candidate test
    out  = top-k_pad of each row      ids col_base + col, sorted descending,
                                      merged with a carried top-k_pad if given

``fused_tile_topk`` keeps the JAX function's arguments and layout: it
returns ``(vals, idx)`` of shape (k_pad, trp). On CUDA tensors it launches
the hand-written kernel of ``csrc/tile_topk.cu`` (two launches: product with
the fused epilogue, then the per-row top-k) or raises; on CPU tensors it
runs ``fused_tile_topk_plain``, the same function in plain PyTorch.

``precision='high'`` on f32 data runs the split-bf16x3 modes
(``split_f32``, pallas_kernels.py:575): ``split_bf16x3`` cuts each f32
operand into a bf16 [hi; lo] stack along the contraction axis, and the
product sums hi.hi + lo.hi + hi.lo ('both'), or a.d_hi + a.d_lo ('rhs',
the panel exact in bf16), or a_hi.d + a_lo.d ('lhs', the tile exact), in
f32: XLA's HIGH precision on bf16 tensor cores.

Ties follow the TPU kernel: within a tile the lowest column first, and tile
entries before carry entries; with a carry, only tile values strictly above
the carry's kth enter (pallas_kernels.py:323-374). Ids of -inf slots are
arbitrary, as in the reference; the executor drops those slots.

``kernel_launches`` and ``plain_calls`` count the two routes (one per call);
``product_launches`` counts the product kernel each launch took, by name
(``PRODUCT_KERNELS``): bf16 and the split modes take ``wgmma bf16`` for
16-byte aligned operands (every executor launch), plain bf16 with narrower
rows ``mma.sync bf16``.
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
# the product kernels a launch may take, in the order of ProductKernel
# (csrc/splus_epilogue.cuh)
PRODUCT_KERNELS = ("simt", "mma.sync s8", "mma.sync bf16", "wgmma bf16", "wgmma s8")
product_launches = dict.fromkeys(PRODUCT_KERNELS, 0)

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the kernel's split-bf16x3 modes (Mode in csrc/splus_epilogue.cuh)
SPLIT_MODES = {"both": 3, "rhs": 4, "lhs": 5}
_FLAG_BITS = (1, 2, 4, 8, 16, 32)  # static_flags() order, as in the .cu file

# int8 products run as float64 on the plain path (exact below 2**53);
# columns are taken in chunks so the f64 copy of a wide tile stays small
_PLAIN_INT8_COLS = 2048


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0
    product_launches.update(dict.fromkeys(PRODUCT_KERNELS, 0))


def count_product(counts: dict, kind) -> None:
    """One launch of the product kernel that `kind` (a ctypes int the
    launch filled, ProductKernel) names, into `counts`."""
    counts[PRODUCT_KERNELS[kind.value]] += 1


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


def split_bf16x3_parts(x):
    """(hi, lo) bf16 halves of f32 `x` (pallas_kernels.py:112 split_bf16x3):
    hi rounds x to the nearest bf16 by an integer carry and mask on its
    bits (+0x8000, then the low 16 bits cleared), and lo = bf16(x - hi),
    where x - hi is exact in f32. hi + lo carries about 16 of the 24 bits,
    and the lo.lo product that the phases drop is below 2**-16 of x.y.
    Finite inputs well below f32's largest, as the engine's are."""
    hi_f = ((x.contiguous().view(torch.int32) + 0x8000) & -0x10000).view(torch.float32)
    return hi_f.to(torch.bfloat16), (x - hi_f).to(torch.bfloat16)


def split_bf16x3(x, axis: int):
    """f32 -> the [hi; lo] bf16 stack along `axis` (split_bf16x3_parts)."""
    return torch.cat(split_bf16x3_parts(x), dim=axis)


def split_mode(split_f32):
    """The JAX functions' `split_f32` (False, True, 'both', 'rhs' or 'lhs')
    as None or one of SPLIT_MODES."""
    if split_f32 is False or split_f32 is None:
        return None
    mode = "both" if split_f32 is True else split_f32
    if mode not in SPLIT_MODES:
        raise ValueError(f"unknown split mode {split_f32!r}")
    return mode


def _split_product_plain(a, d, split: str):
    """a . d over split-bf16x3 stacks: each phase an f32 product of
    bf16-valued f32 operands (the products are exact), summed in the JAX
    kernel's phase order (_split_maps)."""
    a, d = a.to(torch.float32), d.to(torch.float32)
    a_lo = d_lo = None
    if split in ("both", "lhs"):
        a, a_lo = a.chunk(2, dim=1)
    if split in ("both", "rhs"):
        d, d_lo = d.chunk(2, dim=0)
    with full_f32_matmul():
        xy = a @ d
        if a_lo is not None:
            xy = xy + a_lo @ d
        if d_lo is not None:
            xy = xy + a @ d_lo
    return xy


def _product_plain(a, d, int8_mode: bool, bias=None, split=None):
    """bias + a @ d as f32: float64 for int8 (exact, the int32 bias
    included), the phases of a split mode (`split`), f32 otherwise; TF32 is
    kept off on the card so "f32" means true f32."""
    if split is not None:
        return _split_product_plain(a, d, split)
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
                      allowed, fmask, tmask, *, flags, int8_mode, bias=None, split=None):
    """The (trp, tc) masked epilogue scores of bias + m1_dense @ d, -inf
    where dropped."""
    pv = pvec_ext.tolist()
    xy = _product_plain(m1_dense, d, int8_mode, bias, split)
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
           fmask, tmask, carry, *, flags, k_pad, int8_mode, split_f32=False):
    val = tile_scores_plain(
        m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed, fmask,
        tmask, flags=flags, int8_mode=int8_mode, split=split_mode(split_f32),
    )
    return select_topk_plain(val, carry, k_pad, int(pvec_ext[PVEC_COL_BASE]))


def fused_tile_topk_plain(m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext,
                          allowed=None, fmask=None, tmask=None, carry=None, *,
                          flags: tuple, k_pad: int, int8_mode: bool, split_f32=False):
    """`fused_tile_topk` in plain PyTorch, on any device."""
    global plain_calls
    plain_calls += 1
    return _plain(
        m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed, fmask,
        tmask, carry, flags=flags, k_pad=k_pad, int8_mode=int8_mode, split_f32=split_f32,
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
    m1_dense,  # (trp, u_pad) f32 | bf16 | int8; (trp, 2 u_pad) bf16 split stack
    d,  # (u_pad, tc) same dtype; (2 u_pad, tc) bf16 split stack
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
    split_f32=False,
):
    """Returns (vals, idx) of shape (k_pad, trp): per-row top-k_pad of the
    fused similarity tile, sorted descending, ids global via col_base.

    With `split_f32` (True or 'both', 'rhs', 'lhs') the operands are bf16
    stacks: `split_bf16x3` of the f32 side(s) along the contraction axis,
    a plain bf16 cast of the side that bf16 holds exactly (module
    docstring)."""
    split = split_mode(split_f32)
    if m1_dense.device.type == "cpu":
        return fused_tile_topk_plain(
            m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed,
            fmask, tmask, carry, flags=flags, k_pad=k_pad, int8_mode=int8_mode,
            split_f32=split or False,
        )
    if m1_dense.device.type != "cuda":
        raise ValueError(f"fused_tile_topk runs on cuda or cpu, not {m1_dense.device}")
    return _launch(
        m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed, fmask,
        tmask, carry, flags=flags, k_pad=k_pad, int8_mode=int8_mode, split=split,
    )


def _launch(m1_dense, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed,
            fmask, tmask, carry, *, flags, k_pad, int8_mode, split):
    global kernel_launches
    from .build import load

    dev = m1_dense.device
    trp = m1_dense.shape[0]
    tc = d.shape[1]
    dtype = m1_dense.dtype
    if dtype not in _MODES or (dtype == torch.int8) != bool(int8_mode):
        raise ValueError(f"operand dtype {dtype} does not fit int8_mode={int8_mode}")
    if not 0 < k_pad <= MAX_KERNEL_K_PAD:
        raise ValueError(f"k_pad={k_pad} is outside the kernel's 1..{MAX_KERNEL_K_PAD}")
    f32, u8 = torch.float32, torch.uint8
    mode = _MODES[dtype]
    a_k = d_k = u_pad = d.shape[0]
    if split is not None:
        if dtype != torch.bfloat16:
            raise ValueError(f"split mode {split!r} takes bf16 stacks, not {dtype}")
        mode = SPLIT_MODES[split]
        u_pad = d_k // 2 if split in ("both", "rhs") else d_k
        a_k = 2 * u_pad if split in ("both", "lhs") else u_pad
        # the split kernels copy 16 bytes at a time (the executor's shapes)
        if u_pad % 8 or tc % 8 or m1_dense.data_ptr() % 16 or d.data_ptr() % 16:
            raise ValueError(
                f"split mode {split!r} needs u_pad and tc multiples of 8 and 16-byte "
                f"aligned operands (u_pad={u_pad}, tc={tc})"
            )
    _check("m1_dense", m1_dense, (trp, a_k), dtype, dev)
    _check("d", d, (d_k, tc), dtype, dev)
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

    kind = ctypes.c_int(-1)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.tile_product(
            mode, ptr(m1_dense), ptr(d), trp, u_pad, tc,
            ptr(x_t), ptr(x_c), ptr(x_d), ptr(y_t), ptr(y_c), ptr(y_d),
            ptr(pvec_ext), ptr(allowed), ptr(fmask), ptr(tmask), flag_bits,
            ptr(scores), stream, ctypes.byref(kind),
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
            f"(trp={trp}, u_pad={u_pad}, tc={tc}, k_pad={k_pad}, dtype={dtype}, split={split})"
        )
    kernel_launches += 1
    count_product(product_launches, kind)
    return vals, idx


def attrs_dict(out) -> dict:
    """A product kernel's attributes as the C side fills them: four counts
    and the kernel (ProductKernel), by name."""
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm")
    return {**dict(zip(keys, out[:4])), "kernel": PRODUCT_KERNELS[out[4]]}


def product_attrs(dtype, bias: bool = False, split=None) -> dict:
    """Registers and local (spill) bytes a thread, shared memory a block,
    resident blocks per SM and the name of the product kernel that `dtype`
    (float32, bfloat16 or int8) runs for 16-byte aligned operands; `bias`
    asks for K3's kernel with the hot-prefix bias, `split` ('both', 'rhs',
    'lhs') for a split-bf16x3 mode. Needs a card."""
    from .build import check, load

    mode = SPLIT_MODES[split] if split else _MODES[dtype]
    out = (ctypes.c_int * 5)()
    check(load().tile_product_attrs(mode, int(bias), out),
          f"tile_product_attrs({dtype}, bias={bias}, split={split})")
    return attrs_dict(out)
