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
``csrc/sym_topk.cu`` (the product with the fused epilogue: int8 by
``mma.sync`` on the tensor cores, f32 and bf16 by SIMT FMA, both fed by a
ring of ``cp.async`` copies; then the row-side and the col-side merge) or
raises; on CPU tensors it runs ``fused_sym_topk_plain``, the same function
in plain PyTorch. The kernels take tc a multiple of 128 (the executor's
tiles) and 16-byte aligned operands, and raise on anything else.

``kernel_launches`` and ``plain_calls`` count the two routes (one per call).
"""

from __future__ import annotations

import ctypes

import torch

from .params import PVEC_LEN
from .tile_topk import _MODES, _FLAG_BITS, _check, splus_epilogue

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

# int8 products run in float64 on the plain path (exact below 2**53), over
# slabs of the user axis so that the f64 copies stay small
_PLAIN_INT8_USERS = 16384


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


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


def _product_plain(a, d, n_rows: int, tc: int, int8_mode: bool):
    """(n_rows, tc) xy of the first n_rows anchor rows: float64 for int8
    (exact), true f32 otherwise (TF32 kept off on the card)."""
    tiles = _anchor_tiles(a, tc)
    blocks = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for g in range(-(-n_rows // tc)):
            lhs = tiles[g].transpose(0, 1)  # (tc, u_pad)
            if int8_mode:
                acc = torch.zeros((tc, d.shape[1]), dtype=torch.float64, device=d.device)
                for u0 in range(0, d.shape[0], _PLAIN_INT8_USERS):
                    u1 = u0 + _PLAIN_INT8_USERS
                    acc += lhs[:, u0:u1].to(torch.float64) @ d[u0:u1].to(torch.float64)
                blocks.append(acc.to(torch.float32))
            else:
                blocks.append(lhs.to(torch.float32) @ d.to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
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
           pvec_ext, *, flags, k, tc, int8_mode, x2=None, y2=None):
    pv = pvec_ext.tolist()
    sw = crv.shape[1]
    k_pad_r, k_pad_c = sym_k_pads(k, tc, sw)
    col_base, row_base, n_live, n_col = _bounds(pv, tc, sw)
    rvals, ridx = crv.clone(), cri.clone()
    cvals, cidx = ccv.clone(), cci.clone()
    if n_live == 0:
        return rvals, ridx, cvals, cidx
    xy = _product_plain(a, d, n_live, tc, int8_mode)
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
                         int8_mode: bool, x2=None, y2=None):
    """`fused_sym_topk` in plain PyTorch, on any device."""
    global plain_calls
    plain_calls += 1
    return _plain(a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth, ccv, cci,
                  pvec_ext, flags=flags, k=k, tc=tc, int8_mode=int8_mode, x2=x2, y2=y2)


def fused_sym_topk(
    a,  # (sw, u_pad) or (gt, u_pad, tc) f32 | bf16 | int8 — the anchors
    d,  # (u_pad, tc) same dtype — inner tile t
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
    precision=None,
    x2=None,  # asymmetric epilogue: (xt, xc, xd) at the tile's items (tc,)
    y2=None,  # asymmetric epilogue: (yt, yc, yd) at the anchor's items (sw,)
    split_f32=False,
    interpret=False,
):
    """Returns (rvals, ridx, cvals, cidx): the row-side carry merged with
    this block's columns and the col-side carry merged with its anchor
    rows (module docstring).

    `precision` and `interpret` are the JAX function's TPU knobs; they are
    accepted for the same call signature and change nothing here (f32
    always runs as true f32). The split-bf16x3 mode (`split_f32`) is not
    ported."""
    if split_f32:
        raise NotImplementedError("split_f32 (the bf16x3 sweep) is not ported")
    if (x2 is None) != (y2 is None):
        raise ValueError("x2 and y2 go together (the asymmetric epilogue)")
    if a.device.type == "cpu":
        return fused_sym_topk_plain(
            a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth, ccv, cci,
            pvec_ext, flags=flags, k=k, tc=tc, int8_mode=int8_mode, x2=x2, y2=y2,
        )
    if a.device.type != "cuda":
        raise ValueError(f"fused_sym_topk runs on cuda or cpu, not {a.device}")
    return _launch(a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth, ccv, cci,
                   pvec_ext, flags=flags, k=k, tc=tc, int8_mode=int8_mode, x2=x2, y2=y2)


def _launch(a, d, x_t, x_c, x_d, y_t, y_c, y_d, crv, cri, rkth, ccv, cci,
            pvec_ext, *, flags, k, tc, int8_mode, x2, y2):
    global kernel_launches
    from .build import check, load

    dev, dtype = a.device, a.dtype
    if dtype not in _MODES or (dtype == torch.int8) != bool(int8_mode):
        raise ValueError(f"operand dtype {dtype} does not fit int8_mode={int8_mode}")
    if a.dim() == 2:
        # a row panel: the kernel reads the executor's tile layout, so the
        # panel is copied into it (the executor always passes tiles)
        sw, u_pad = a.shape
        if sw % tc:
            raise ValueError(f"sw={sw} anchor rows do not split into tc={tc} tiles")
        a = a.view(sw // tc, tc, u_pad).transpose(1, 2).contiguous()
    gt, u_pad, tc_a = a.shape
    if tc_a != tc:
        raise ValueError(f"anchor tiles are {tc_a} wide, tc={tc}")
    if tc % KERNEL_TILE:
        raise ValueError(f"tc={tc} is not a multiple of the kernel's {KERNEL_TILE}-wide blocks")
    sw = gt * tc
    k_pad_r, k_pad_c = sym_k_pads(k, tc, sw)
    if not 0 < k_pad_r <= MAX_KERNEL_K_PAD:
        raise ValueError(f"k_pad={k_pad_r} is outside the kernel's 1..{MAX_KERNEL_K_PAD}")
    f32, i32 = torch.float32, torch.int32
    _check("a", a, a.shape, dtype, dev)
    _check("d", d, (u_pad, tc), dtype, dev)
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
    what = f"fused_sym_topk (sw={sw}, u_pad={u_pad}, tc={tc}, k_pad={k_pad_r}, {dtype})"
    with torch.cuda.device(dev):
        check(lib.sym_product(_MODES[dtype], a.data_ptr(), d.data_ptr(), sw, u_pad, tc,
                              vec_array, pvec_ext.data_ptr(), flag_bits,
                              scores_r.data_ptr(), scores_c.data_ptr(), stream), what)
        check(lib.sym_merge(1, scores_r.data_ptr(), sw, tc, k_pad_r, pvec_ext.data_ptr(),
                            rkth.data_ptr(), crv.data_ptr(), cri.data_ptr(),
                            rvals.data_ptr(), ridx.data_ptr(), stream), what)
        check(lib.sym_merge(0, scores_c.data_ptr(), sw, tc, k_pad_c, pvec_ext.data_ptr(),
                            None, ccv.data_ptr(), cci.data_ptr(),
                            cvals.data_ptr(), cidx.data_ptr(), stream), what)
    kernel_launches += 1
    return rvals, ridx, cvals, cidx


def product_attrs(dtype) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared memory a
    block and resident blocks per SM of the product kernel that `dtype`
    (float32, bfloat16 or int8) runs; needs a card."""
    from .build import check, load

    out = (ctypes.c_int * 4)()
    check(load().sym_product_attrs(_MODES[dtype], out), f"sym_product_attrs({dtype})")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), out))
