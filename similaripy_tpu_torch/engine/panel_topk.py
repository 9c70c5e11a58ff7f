"""K3: the union-compacted panel with a per-(row, tile) exact top-k.

Port of ``similaripy_tpu/engine/pallas_kernels.py::fused_panel_topk`` (kernel
body ``_panel_kernel``, epilogue ``_epilogue_val``). For one panel of target
rows against a column group of n_tiles tiles, tc columns each:

    xy   = bias + a @ d           bias: the hot-prefix partial scores (f32,
                                  or int32 in int8 mode), or none
    val  = S-Plus epilogue(xy)    masks fold into the candidate test
    out  = top-k_pad of each row within each tile, no carry; ids
           pvec_ext[10] + t*tc + col, sorted descending, ties to the lowest
           column (the TPU kernel's argmax extraction)

``fused_panel_topk`` keeps the JAX function's arguments and layout: it
returns ``(vals, idx)`` of shape (n_tiles, k_pad, TM). On CUDA tensors it
launches the hand-written kernel of ``csrc/panel_topk.cu`` (two launches:
the product with the bias and the fused epilogue, then the per-(row, tile)
top-k) or raises; on CPU tensors it runs ``fused_panel_topk_plain``, the
same function in plain PyTorch. Ids of -inf slots are arbitrary, as in the
reference; the executor drops those slots.

``kernel_launches`` and ``plain_calls`` count the two routes (one per call);
``product_launches`` the product kernel each launch took, by name
(``tile_topk.PRODUCT_KERNELS``).
"""

from __future__ import annotations

import ctypes

import torch

from .params import PVEC_COL_BASE, PVEC_LEN
from .tile_topk import _FLAG_BITS, _MODES, MAX_KERNEL_K_PAD, PRODUCT_KERNELS, _check
from .tile_topk import count_product, select_topk_plain, tile_scores_plain

kernel_launches = 0
plain_calls = 0
product_launches = dict.fromkeys(PRODUCT_KERNELS, 0)


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0
    product_launches.update(dict.fromkeys(PRODUCT_KERNELS, 0))


def fused_panel_topk_plain(a, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, bias=None,
                           allowed=None, fmask=None, tmask=None, *, flags: tuple,
                           k_pad: int, tc: int, int8_mode: bool):
    """`fused_panel_topk` in plain PyTorch, on any device."""
    global plain_calls
    plain_calls += 1
    val = tile_scores_plain(
        a, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, allowed, fmask, tmask,
        flags=flags, int8_mode=int8_mode, bias=bias,
    )
    col_base = int(pvec_ext[PVEC_COL_BASE])
    tiles = [
        select_topk_plain(val[:, t * tc:(t + 1) * tc], None, k_pad, col_base + t * tc)
        for t in range(d.shape[1] // tc)
    ]
    return torch.stack([v for v, _ in tiles]), torch.stack([i for _, i in tiles])


def fused_panel_topk(
    a,  # (TM, K) f32 | bf16 | int8 — compact panel lhs
    d,  # (K, cg) same dtype — gathered cold rows (or the full inner dim)
    x_t,  # (TM,) f32
    x_c,
    x_d,
    y_t,  # (cg,) f32
    y_c,
    y_d,
    pvec_ext,  # (16,) f32 — build_pvec + group col offset at [10]
    bias=None,  # (TM, cg) f32, int32 in int8 mode — hot-prefix partial scores
    allowed=None,  # (cg,) uint8
    fmask=None,  # (TM, cg) uint8, 1 = filtered out
    tmask=None,  # (TM, cg) uint8, 1 = allowed target
    *,
    flags: tuple,
    k_pad: int,
    tc: int,
    int8_mode: bool,
):
    """Returns (vals, idx) of shape (n_tiles, k_pad, TM): the top-k_pad of
    each row within each tc-wide tile of the group, sorted descending, ids
    global via pvec_ext[10] + tile offset. f32 always runs as true f32."""
    if a.device.type == "cpu":
        return fused_panel_topk_plain(
            a, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, bias, allowed, fmask, tmask,
            flags=flags, k_pad=k_pad, tc=tc, int8_mode=int8_mode,
        )
    if a.device.type != "cuda":
        raise ValueError(f"fused_panel_topk runs on cuda or cpu, not {a.device}")
    return _launch(a, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, bias, allowed, fmask,
                   tmask, flags=flags, k_pad=k_pad, tc=tc, int8_mode=int8_mode)


def _launch(a, d, x_t, x_c, x_d, y_t, y_c, y_d, pvec_ext, bias, allowed, fmask, tmask,
            *, flags, k_pad, tc, int8_mode):
    global kernel_launches
    from .build import check, load

    dev = a.device
    tm, K = a.shape
    cg = d.shape[1]
    dtype = a.dtype
    if dtype not in _MODES or (dtype == torch.int8) != bool(int8_mode):
        raise ValueError(f"operand dtype {dtype} does not fit int8_mode={int8_mode}")
    if not 0 < k_pad <= MAX_KERNEL_K_PAD:
        raise ValueError(f"k_pad={k_pad} is outside the kernel's 1..{MAX_KERNEL_K_PAD}")
    if tc <= 0 or cg % tc:
        raise ValueError(f"the group width {cg} is not a multiple of tc={tc}")
    f32, u8 = torch.float32, torch.uint8
    _check("a", a, (tm, K), dtype, dev)
    _check("d", d, (K, cg), dtype, dev)
    for name, v in (("x_t", x_t), ("x_c", x_c), ("x_d", x_d)):
        _check(name, v, (tm,), f32, dev)
    for name, v in (("y_t", y_t), ("y_c", y_c), ("y_d", y_d)):
        _check(name, v, (cg,), f32, dev)
    _check("pvec_ext", pvec_ext, (PVEC_LEN,), f32, dev)
    if bias is not None:
        _check("bias", bias, (tm, cg), torch.int32 if int8_mode else f32, dev)
    if allowed is not None:
        _check("allowed", allowed, (cg,), u8, dev)
    if fmask is not None:
        _check("fmask", fmask, (tm, cg), u8, dev)
    if tmask is not None:
        _check("tmask", tmask, (tm, cg), u8, dev)

    n_tiles = cg // tc
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scores = torch.empty((tm, cg), dtype=f32, device=dev)
    vals = torch.empty((n_tiles, k_pad, tm), dtype=f32, device=dev)
    idx = torch.empty((n_tiles, k_pad, tm), dtype=torch.int32, device=dev)
    flag_bits = sum(b for b, on in zip(_FLAG_BITS, flags) if on)
    kind = ctypes.c_int(-1)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.panel_product(
            _MODES[dtype], ptr(a), ptr(d), ptr(bias), tm, K, cg,
            ptr(x_t), ptr(x_c), ptr(x_d), ptr(y_t), ptr(y_c), ptr(y_d),
            ptr(pvec_ext), ptr(allowed), ptr(fmask), ptr(tmask), flag_bits,
            ptr(scores), stream, ctypes.byref(kind),
        )
        if err == 0:
            err = lib.panel_topk_rows(
                ptr(scores), tm, tc, n_tiles, k_pad, ptr(pvec_ext), ptr(vals), ptr(idx),
                stream,
            )
    check(err, f"panel_topk (TM={tm}, K={K}, cg={cg}, tc={tc}, k_pad={k_pad}, {dtype})")
    kernel_launches += 1
    count_product(product_launches, kind)
    return vals, idx
