"""K5: per-tile padded COO into dense tiles.

Port of ``similaripy_tpu/engine/pallas_kernels.py::mxu_scatter`` (kernel
body ``_mxu_scatter_kernel``). The TPU kernel scatters binned COO through
one-hot matmuls; what it computes is a scatter-add into a dense tile, and
that is what this module does:

    densify_tiles(ru, sl, vv, u_pad=, tc=, cdt=)    (G, p2) -> (G, u_pad, tc)
    densify_tiles(..., layout="kmajor")              (G, p2) -> (G, tc, u_pad)

Entries whose user lies outside ``[0, u_pad)`` are padding sentinels and
land nowhere; duplicates sum, as ``mxu_scatter`` and ``executor.densify``
sum them. The K-major layout holds each slot's users contiguous, the
layout that 8-bit ``wgmma`` reads (K2's int8 operands): the kernel writes
it with the roles of user and slot swapped, which its bounds test drops
alike. On CUDA tensors it launches the kernel of ``csrc/scatter.cu``
(which zero-fills the stack itself, then adds one entry per thread) or
raises; on CPU tensors it runs ``densify_tiles_plain``, the same function
through ``index_put_(accumulate=True)``. The TPU's binning (user-degree
permutation, 512 x 512 bins) exists only to feed the one-hot matmuls and is
not ported.

``kernel_launches`` and ``plain_calls`` count the two routes (one per call).
"""

from __future__ import annotations

import math

import torch

kernel_launches = 0
plain_calls = 0

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def densify(shape, rows, cols, vals, cdt):
    """Scatter a padded COO into a dense tile of dtype `cdt`.

    Entries whose row lies outside `shape` are the padding sentinels and
    are dropped; duplicates sum, as SciPy sums them."""
    n_rows, n_cols = shape[-2], shape[-1]
    keep = rows < n_rows
    flat = rows[keep].to(torch.int64) * n_cols + cols[keep].to(torch.int64)
    out = torch.zeros(math.prod(shape), dtype=cdt, device=rows.device)
    out.index_put_((flat,), vals[keep].to(cdt), accumulate=True)
    return out.view(shape)


def densify_tiles_plain(ru, sl, vv, *, u_pad: int, tc: int, cdt, layout: str = "mn"):
    """`densify_tiles` in plain PyTorch, on any device."""
    global plain_calls
    plain_calls += 1
    _check_layout(layout)
    g = ru.shape[0]
    tile_ids = torch.arange(g, device=ru.device, dtype=torch.int64)[:, None]
    # fold the tile id into the row so one scatter fills the whole stack; a
    # padding sentinel (user >= u_pad) goes to a row out of range, since
    # densify drops entries by row only
    if layout == "kmajor":
        rows = torch.where(ru < u_pad, sl + tile_ids * tc, g * tc)
        return densify((g * tc, u_pad), rows.ravel(), ru.ravel(), vv.ravel(),
                       cdt).view(g, tc, u_pad)
    rows = torch.where(ru < u_pad, ru + tile_ids * u_pad, g * u_pad)
    return densify((g * u_pad, tc), rows.ravel(), sl.ravel(),
                   vv.ravel(), cdt).view(g, u_pad, tc)


def densify_tiles(ru, sl, vv, *, u_pad: int, tc: int, cdt, layout: str = "mn"):
    """Dense tiles of dtype `cdt` (f32, bf16 or int8) from per-tile padded
    COO: users `ru` (int32, sentinel >= u_pad), slots `sl` (int32) and
    values `vv` (f32; the quantized integers for int8), each (G, p2).
    `layout` "mn" gives (G, u_pad, tc), "kmajor" (G, tc, u_pad)."""
    if ru.device.type == "cpu":
        return densify_tiles_plain(ru, sl, vv, u_pad=u_pad, tc=tc, cdt=cdt, layout=layout)
    if ru.device.type != "cuda":
        raise ValueError(f"densify_tiles runs on cuda or cpu, not {ru.device}")
    return _launch(ru, sl, vv, u_pad=u_pad, tc=tc, cdt=cdt, layout=layout)


def _check_layout(layout: str) -> None:
    if layout not in ("mn", "kmajor"):
        raise ValueError(f"densify_tiles writes layout 'mn' or 'kmajor', not {layout!r}")


def _launch(ru, sl, vv, *, u_pad, tc, cdt, layout):
    global kernel_launches
    from .build import check, load

    _check_layout(layout)
    if cdt not in _MODES:
        raise ValueError(f"densify_tiles stores f32, bf16 or int8, not {cdt}")
    dev = ru.device
    if ru.dim() != 2:
        raise ValueError(f"ru has shape {tuple(ru.shape)}, expected (G, p2)")
    for name, t, dt in (("ru", ru, torch.int32), ("sl", sl, torch.int32),
                        ("vv", vv, torch.float32)):
        if t.device != dev or t.dtype != dt or t.shape != ru.shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dt} tensor of shape {tuple(ru.shape)} "
                f"on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    g, p2 = ru.shape
    # K-major: the kernel's rows are the slots and its columns the users
    rows, cols, n_rows, n_cols = (sl, ru, tc, u_pad) if layout == "kmajor" else (ru, sl, u_pad, tc)
    out = torch.empty((g, n_rows, n_cols), dtype=cdt, device=dev)  # the kernel zero-fills
    if g == 0:
        return out
    lib = load()
    with torch.cuda.device(dev):
        err = lib.densify_tiles(
            _MODES[cdt], rows.data_ptr(), cols.data_ptr(), vv.data_ptr(), g, p2, n_rows, n_cols,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, f"densify_tiles (G={g}, p2={p2}, u_pad={u_pad}, tc={tc}, {cdt}, {layout})")
    kernel_launches += 1
    return out
