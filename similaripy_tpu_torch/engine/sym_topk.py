"""K2: one block of the symmetric executor, feeding both top-k directions.

Port of ``similaripy_tpu/engine/pallas_kernels.py::fused_sym_topk`` (kernel
body ``_sym_kernel``, epilogue ``_epilogue_val``). An anchor group of
sw = gt * tc item rows, starting at tile a0, meets inner tile t:

    xy   = anchors . d                 the shared user axis contracted
    row  anchor rows of tile rt <= t take tile t's columns (ids col_base +
         col) into their carried top-k_pad: only values above rkth enter,
         the lowest column first among ties, tile entries before the carry;
         rows of tile rt > t pass their carry through
    col  for rt < t, tile t's columns take those anchor rows (ids row_base +
         row) into theirs: the carry ahead of an equal new entry, the lowest
         row first among new ones; with x2 / y2 the epilogue re-runs with
         X at the tile's items and Y at the anchor's (asymmetric epilogues)

``fused_sym_topk`` keeps the JAX function's arguments and layout: anchors
``(sw, u_pad)`` or ``(gt, u_pad, tc)``, returns ``rvals, ridx (k_pad_r,
sw)`` and ``cvals, cidx (k_pad_c, tc)``; ``pvec_ext`` holds [10] col_base,
[11] row_base, [12] t, [13] a0. On CUDA tensors it launches the kernels of
``csrc/sym_topk.cu`` (the product with the fused epilogue: bf16, the split
mode and int8 by ``wgmma`` on operands that TMA brings, f32 by SIMT FMA fed
by a ring of ``cp.async`` copies; then the row-side and the col-side merge)
or raises; on CPU tensors it runs ``fused_sym_topk_plain``, the same
function in plain PyTorch, in any of these layouts. The kernels take tc a
multiple of 128 (the executor's tiles) and 16-byte aligned operands, and
raise on anything else. 8-bit ``wgmma`` reads K-major operands only, so
the int8 kernel takes the anchors as a contiguous ``(sw, u_pad)`` stack and
``d`` as the ``(u_pad, tc)`` transposed view, strides ``(1, u_pad)``, of a
contiguous ``(tc, u_pad)`` tile (``scatter.densify_tiles(...,
layout="kmajor")`` writes both), u_pad a multiple of 16, and raises on any
other layout rather than copy an operand.

``precision='high'`` on f32 data runs the split-bf16x3 mode (``split_f32``,
pallas_kernels.py:1067-1094): both operands are bf16 [hi; lo] stacks along
the user axis (``tile_topk.split_bf16x3``), and the product sums hi.hi +
lo.hi + hi.lo in f32 (a self-similarity's two sides are the same float
matrix, so the one-sided modes never apply).

``kernel_launches`` and ``plain_calls`` count the two routes (one per call);
``product_launches`` the product kernel each launch took, by name
(``tile_topk.PRODUCT_KERNELS``); ``asym_launches`` the launches that carried
the asymmetric column side (``x2``/``y2``).
"""

from __future__ import annotations

import ctypes

import torch

from .params import PVEC_LEN
from .tile_topk import _FLAG_BITS, _MODES, PRODUCT_KERNELS, SPLIT_MODES, _check
from .tile_topk import _split_product_plain, attrs_dict, count_product, full_f32_matmul
from .tile_topk import splus_epilogue

NEG_INF = float("-inf")

# the product kernels take each anchor tile in blocks of 128 rows (and the
# inner tile in blocks of 128 or 256 columns, zero-filled past tc): tc must
# be a multiple of 128
KERNEL_TILE = 128

# deeper carries take the symmetric executor's counted plain branch, as the
# reference hands k_pad > 1024 to XLA (symmetric.py:913-920)
MAX_KERNEL_K_PAD = 1024

kernel_launches = 0
plain_calls = 0
product_launches = dict.fromkeys(PRODUCT_KERNELS, 0)
asym_launches = 0

# int8 products run in float64 on the plain path (exact below 2**53), over
# slabs of the user axis so that the f64 copies stay small
_PLAIN_INT8_USERS = 16384


def reset_counts() -> None:
    global kernel_launches, plain_calls, asym_launches
    kernel_launches = 0
    plain_calls = 0
    asym_launches = 0
    product_launches.update(dict.fromkeys(PRODUCT_KERNELS, 0))


def sym_k_pads(k: int, tc: int, sw: int) -> tuple[int, int]:
    """(row-side, col-side) carry depths. Both are k rounded up to 8: each
    plane accumulates candidates over the whole sweep, so one block's width
    (tc columns, sw rows) is no cap (pallas_kernels.py:1006)."""
    k_pad = -(-k // 8) * 8
    return k_pad, k_pad


def _bounds(pv, tc: int, sw: int) -> tuple[int, int, int, int]:
    """(col_base, row_base, live rows, col-side rows) of a block."""
    t, a0 = int(pv[12]), int(pv[13])
    n_live = min(max((t - a0 + 1) * tc, 0), sw)
    n_col = min(max((t - a0) * tc, 0), sw)
    return int(pv[10]), int(pv[11]), n_live, n_col


def _anchor_tiles(a, tc: int):
    """The anchors as (gt, u_pad, tc) tiles (views, no copy)."""
    if a.dim() == 3:
        return a
    sw, u_pad = a.shape
    return a.view(sw // tc, tc, u_pad).transpose(1, 2)


def _product_plain(a, d, n_rows: int, tc: int, int8_mode: bool, split: bool = False):
    """(n_rows, tc) xy of the first n_rows anchor rows: float64 for int8
    (exact), the three phases hi.hi + lo.hi + hi.lo of the split stacks in
    the JAX kernel's order (each an f32 product of bf16-valued operands,
    exact products), true f32 otherwise (TF32 kept off on the card)."""
    tiles = _anchor_tiles(a, tc)
    blocks = []
    with full_f32_matmul():
        for g in range(-(-n_rows // tc)):
            lhs = tiles[g].transpose(0, 1)  # (tc, u_pad), or (tc, 2 u_pad) split
            if int8_mode:
                acc = torch.zeros((tc, d.shape[1]), dtype=torch.float64, device=d.device)
                for u0 in range(0, d.shape[0], _PLAIN_INT8_USERS):
                    u1 = u0 + _PLAIN_INT8_USERS
                    acc += lhs[:, u0:u1].to(torch.float64) @ d[u0:u1].to(torch.float64)
                blocks.append(acc.to(torch.float32))
            elif split:
                blocks.append(_split_product_plain(lhs, d, "both"))
            else:
                blocks.append(lhs.to(torch.float32) @ d.to(torch.float32))
    return torch.cat(blocks)[:n_rows]


def merge_plain(val, cv, ci, kth, k_pad: int, id_base: int, new_first: bool):
    """(k_pad, rows) merge of each row of `val` (values above `kth` only,
    sorted by value then lowest position, ids id_base + position) with the
    sorted carry (cv, ci) (k_pad, rows); ties go to the new entries when
    `new_first`, else to the carry. Stable sorts give the TPU order."""
    n = val.shape[1]
    val = torch.where(val > kth[:, None], val, torch.full_like(val, NEG_INF))
    vals, pos = torch.sort(val, dim=1, descending=True, stable=True)
    m = min(n, k_pad)
    nv, ni = vals[:, :m], (pos[:, :m] + id_base).to(torch.int32)
    parts_v, parts_i = [nv, cv.T], [ni, ci.T]
    if not new_first:
        parts_v.reverse()
        parts_i.reverse()
    mv, order = torch.sort(torch.cat(parts_v, dim=1), dim=1, descending=True, stable=True)
    mi = torch.gather(torch.cat(parts_i, dim=1), 1, order[:, :k_pad])
    return mv[:, :k_pad].T.contiguous(), mi.T.contiguous()


def _plain(a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth, ccv, cci,
           pvec_ext, *, flags, k, tc, int8_mode, x2=None, y2=None, split_f32=False):
    pv = pvec_ext.tolist()
    sw = crv.shape[1]
    k_pad_r, k_pad_c = sym_k_pads(k, tc, sw)
    col_base, row_base, n_live, n_col = _bounds(pv, tc, sw)
    rvals, ridx = crv.clone(), cri.clone()
    cvals, cidx = ccv.clone(), cci.clone()
    if n_live == 0:
        return rvals, ridx, cvals, cidx
    xy = _product_plain(a, d, n_live, tc, int8_mode, bool(split_f32))
    if int8_mode:
        xy = xy * pv[9]  # inv_scale
    cand = xy != 0.0
    val = splus_epilogue(xy, cand, x_t[:n_live], x_c[:n_live], x_d[:n_live],
                         y_t, y_c, y_d, pv, flags)
    rv, ri = merge_plain(val, crv[:, :n_live], cri[:, :n_live], rkth[:n_live, 0],
                         k_pad_r, col_base, new_first=True)
    rvals[:, :n_live], ridx[:, :n_live] = rv, ri
    if n_col > 0:
        if x2 is not None:
            # the col delivery's target is the tile's item, its candidate
            # the anchor's: the epilogue with the X/Y roles swapped
            val_c = splus_epilogue(xy[:n_col].T, cand[:n_col].T, *x2,
                                   *(v[:n_col] for v in y2), pv, flags)
        else:
            val_c = val[:n_col].T
        cvals, cidx = merge_plain(val_c, ccv, cci, ccv[k_pad_c - 1], k_pad_c,
                                  row_base, new_first=False)
    return rvals, ridx, cvals, cidx


def fused_sym_topk_plain(a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth,
                         ccv, cci, pvec_ext, *, flags: tuple, k: int, tc: int,
                         int8_mode: bool, x2=None, y2=None, split_f32=False):
    """`fused_sym_topk` in plain PyTorch, on any device."""
    global plain_calls
    plain_calls += 1
    return _plain(a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth, ccv, cci,
                  pvec_ext, flags=flags, k=k, tc=tc, int8_mode=int8_mode, x2=x2, y2=y2,
                  split_f32=split_f32)


def fused_sym_topk(
    a,  # (sw, u_pad) or (gt, u_pad, tc) f32 | bf16 | int8 — the anchors
    #     (u_pad doubled for the bf16 split stacks; int8 on a card:
    #     a contiguous (sw, u_pad) stack)
    d,  # (u_pad, tc) same dtype — inner tile t (int8 on a card: the
    #     transposed view of a contiguous (tc, u_pad) tile)
    x_t,  # (sw,) f32 — X at the anchor's items
    x_c,
    x_d,
    y_t,  # (tc,) f32 — Y at the tile's items
    y_c,
    y_d,
    crv,  # (k_pad_r, sw) f32 — row-side carry
    cri,  # (k_pad_r, sw) int32
    rkth,  # (sw, 1) f32 — each anchor row's carry kth
    ccv,  # (k_pad_c, tc) f32 — col-side carry
    cci,  # (k_pad_c, tc) int32
    pvec_ext,  # (16,) f32 — build_pvec + [10] col_base [11] row_base [12] t [13] a0
    *,
    flags: tuple,
    k: int,
    tc: int,
    int8_mode: bool,
    x2=None,  # asymmetric epilogue: (xt, xc, xd) at the tile's items (tc,)
    y2=None,  # asymmetric epilogue: (yt, yc, yd) at the anchor's items (sw,)
    split_f32=False,
):
    """Returns (rvals, ridx, cvals, cidx): the row-side carry merged with
    this block's columns and the col-side carry merged with its anchor
    rows (module docstring).

    With `split_f32` both operands are bf16 [hi; lo] stacks along the user
    axis."""
    split_f32 = bool(split_f32)
    if (x2 is None) != (y2 is None):
        raise ValueError("x2 and y2 go together (the asymmetric epilogue)")
    if a.device.type == "cpu":
        return fused_sym_topk_plain(
            a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth, ccv, cci,
            pvec_ext, flags=flags, k=k, tc=tc, int8_mode=int8_mode, x2=x2, y2=y2,
            split_f32=split_f32,
        )
    if a.device.type != "cuda":
        raise ValueError(f"fused_sym_topk runs on cuda or cpu, not {a.device}")
    return _launch(a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth, ccv, cci,
                   pvec_ext, flags=flags, k=k, tc=tc, int8_mode=int8_mode, x2=x2, y2=y2,
                   split=split_f32)


def _s8_operands(a, d, tc: int) -> tuple[int, int]:
    """(sw, u_pad) of the int8 kernel's K-major operands: the anchors a
    contiguous (sw, u_pad) stack, d the (u_pad, tc) transposed view of a
    contiguous (tc, u_pad) tile, u_pad a multiple of 16 (the row stride
    that TMA takes). Raises on any other layout: no operand is copied."""
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError(
            "int8 anchors go to the kernel K-major, as a contiguous (sw, u_pad) stack; "
            f"got shape {tuple(a.shape)}, strides {a.stride()}")
    sw, u_pad = a.shape
    if tuple(d.shape) != (u_pad, tc) or d.stride() != (1, u_pad):
        raise ValueError(
            f"the int8 tile goes to the kernel K-major, as the ({u_pad}, {tc}) view with "
            f"strides (1, {u_pad}) of a contiguous ({tc}, {u_pad}) tile; got shape "
            f"{tuple(d.shape)}, strides {d.stride()}")
    if sw % tc:
        raise ValueError(f"sw={sw} anchor rows do not split into tc={tc} tiles")
    if u_pad % 16:
        raise ValueError(f"u_pad={u_pad} is not a multiple of 16 (the int8 kernel's row stride)")
    return sw, u_pad


def _launch(a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth, ccv, cci,
            pvec_ext, *, flags, k, tc, int8_mode, x2, y2, split):
    global kernel_launches, asym_launches
    from .build import check, load

    dev, dtype = a.device, a.dtype
    if dtype not in _MODES or (dtype == torch.int8) != bool(int8_mode):
        raise ValueError(f"operand dtype {dtype} does not fit int8_mode={int8_mode}")
    if split and dtype != torch.bfloat16:
        raise ValueError(f"the split mode takes bf16 stacks, not {dtype}")
    mode = SPLIT_MODES["both"] if split else _MODES[dtype]
    if tc % KERNEL_TILE:
        raise ValueError(f"tc={tc} is not a multiple of the kernel's {KERNEL_TILE}-wide blocks")
    if dtype == torch.int8:
        sw, u_pad = _s8_operands(a, d, tc)
        _check("a", a, (sw, u_pad), dtype, dev)
        _check("d.T", d.T, (tc, u_pad), dtype, dev)
    else:
        if a.dim() == 2:
            # a row panel: the kernel reads the executor's tile layout, so the
            # panel is copied into it (the executor always passes tiles)
            sw, u_pad = a.shape
            if sw % tc:
                raise ValueError(f"sw={sw} anchor rows do not split into tc={tc} tiles")
            a = a.view(sw // tc, tc, u_pad).transpose(1, 2).contiguous()
        gt, a_k, tc_a = a.shape
        if tc_a != tc:
            raise ValueError(f"anchor tiles are {tc_a} wide, tc={tc}")
        u_pad = a_k // 2 if split else a_k  # the kernel's K: one half's depth
        sw = gt * tc
        _check("a", a, a.shape, dtype, dev)
        _check("d", d, (a_k, tc), dtype, dev)
    k_pad_r, k_pad_c = sym_k_pads(k, tc, sw)
    if not 0 < k_pad_r <= MAX_KERNEL_K_PAD:
        raise ValueError(f"k_pad={k_pad_r} is outside the kernel's 1..{MAX_KERNEL_K_PAD}")
    f32, i32 = torch.float32, torch.int32
    for name, v in (("x_t", x_t), ("x_c", x_c), ("x_d", x_d)):
        _check(name, v, (sw,), f32, dev)
    for name, v in (("y_t", y_t), ("y_c", y_c), ("y_d", y_d)):
        _check(name, v, (tc,), f32, dev)
    _check("crv", crv, (k_pad_r, sw), f32, dev)
    _check("cri", cri, (k_pad_r, sw), i32, dev)
    _check("rkth", rkth, (sw, 1), f32, dev)
    _check("ccv", ccv, (k_pad_c, tc), f32, dev)
    _check("cci", cci, (k_pad_c, tc), i32, dev)
    _check("pvec_ext", pvec_ext, (PVEC_LEN,), f32, dev)
    for name, v in (("a", a), ("d", d)):
        if v.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (the kernel copies 16 bytes at a time)")
    vecs = [x_t, x_c, x_d, y_t, y_c, y_d]
    if x2 is not None:
        for name, v in zip(("x2t", "x2c", "x2d"), x2):
            _check(name, v, (tc,), f32, dev)
        for name, v in zip(("y2t", "y2c", "y2d"), y2):
            _check(name, v, (sw,), f32, dev)
        vecs += [*x2, *y2]
    # twelve pointers: X, Y, then the asymmetric X2, Y2 or nulls
    vec_array = (ctypes.c_void_p * 12)(*[v.data_ptr() for v in vecs])

    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scores_r = torch.empty((sw, tc), dtype=f32, device=dev)
    scores_c = torch.empty((tc, sw), dtype=f32, device=dev)
    rvals = torch.empty((k_pad_r, sw), dtype=f32, device=dev)
    ridx = torch.empty((k_pad_r, sw), dtype=i32, device=dev)
    cvals = torch.empty((k_pad_c, tc), dtype=f32, device=dev)
    cidx = torch.empty((k_pad_c, tc), dtype=i32, device=dev)
    flag_bits = sum(b for b, on in zip(_FLAG_BITS, flags) if on)
    what = (f"fused_sym_topk (sw={sw}, u_pad={u_pad}, tc={tc}, k_pad={k_pad_r}, {dtype}, "
            f"split={split})")
    kind = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        check(lib.sym_product(mode, a.data_ptr(), d.data_ptr(), sw, u_pad, tc,
                              vec_array, pvec_ext.data_ptr(), flag_bits,
                              scores_r.data_ptr(), scores_c.data_ptr(), stream,
                              ctypes.byref(kind)), what)
        check(lib.sym_merge(1, scores_r.data_ptr(), sw, tc, k_pad_r, pvec_ext.data_ptr(),
                            rkth.data_ptr(), crv.data_ptr(), cri.data_ptr(),
                            rvals.data_ptr(), ridx.data_ptr(), stream), what)
        check(lib.sym_merge(0, scores_c.data_ptr(), sw, tc, k_pad_c, pvec_ext.data_ptr(),
                            None, ccv.data_ptr(), cci.data_ptr(),
                            cvals.data_ptr(), cidx.data_ptr(), stream), what)
    kernel_launches += 1
    asym_launches += x2 is not None
    count_product(product_launches, kind)
    return rvals, ridx, cvals, cidx


def product_attrs(dtype, split: bool = False) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared memory a
    block, resident blocks per SM and the name of the product kernel that
    `dtype` (float32, bfloat16 or int8) runs, or with `split` the
    split-bf16x3 one; needs a card."""
    from .build import check, load

    mode = SPLIT_MODES["both"] if split else _MODES[dtype]
    out = (ctypes.c_int * 5)()
    check(load().sym_product_attrs(mode, out), f"sym_product_attrs({dtype}, split={split})")
    return attrs_dict(out)
