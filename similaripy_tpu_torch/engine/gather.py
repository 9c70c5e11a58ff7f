"""K4: copy chosen rows of a dense device table into a compact buffer.

Port of ``similaripy_tpu/engine/gather.py::row_gather_words`` (kernel body
``_gather_kernel``). The compaction executor (``compact.py``) gathers each
panel's cold union rows out of the densified (u_pad, cg) group table; the
compact (n, cg) buffer is K3's inner dimension:

    row_gather(table, idx)    (u_pad, cg) x (n,) -> (n, cg)

On CUDA tensors it launches the kernel of ``csrc/gather.cu`` (one block per
gathered row, 16-byte loads and stores) or raises; on CPU tensors it runs
``row_gather_plain``, ``torch.index_select``. The TPU kernel's flat
int32-word views, its 4096-byte row alignment and its DMA depth work around
Mosaic's layout limits and are not ported: the card reads the 2-D table
directly.

``kernel_launches`` and ``plain_calls`` count the two routes (one per call).
"""

from __future__ import annotations

import torch

kernel_launches = 0
plain_calls = 0

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def row_gather_plain(table, idx):
    """`row_gather` in plain PyTorch, on any device."""
    global plain_calls
    plain_calls += 1
    return torch.index_select(table, 0, idx)


def row_gather(table, idx):
    """(n, cg) rows `idx` (int32, in [0, u_pad)) of the 2-D row-major
    table (u_pad, cg) of f32, bf16 or int8."""
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"row_gather runs on cuda or cpu, not {table.device}")
    return _launch(table, idx)


def _launch(table, idx):
    global kernel_launches
    from .build import check, load

    if table.dtype not in _DTYPES:
        raise ValueError(f"row_gather copies f32, bf16 or int8 tables, not {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous 2-D tensor, got {tuple(table.shape)}")
    if (idx.dim() != 1 or idx.dtype != torch.int32 or idx.device != table.device
            or not idx.is_contiguous()):
        raise ValueError(
            f"idx must be a contiguous 1-D int32 tensor on {table.device}; got "
            f"{idx.dtype} {tuple(idx.shape)} on {idx.device}"
        )
    n = idx.shape[0]
    u_pad, cg = table.shape
    out = torch.empty((n, cg), dtype=table.dtype, device=table.device)
    if n == 0 or cg == 0:
        return out
    lib = load()
    with torch.cuda.device(table.device):
        err = lib.gather_rows(
            table.data_ptr(), u_pad, cg * table.element_size(), idx.data_ptr(), n,
            out.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream,
        )
    check(err, f"row_gather (n={n}, u_pad={u_pad}, cg={cg}, {table.dtype})")
    kernel_launches += 1
    return out
