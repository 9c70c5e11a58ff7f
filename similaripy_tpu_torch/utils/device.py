"""Device selection and the device-memory budget for tile planning.

Counterpart of ``similaripy_tpu/utils/env.py``. Every public entry point of
the port takes ``device`` (default ``"cuda"``) and resolves it here: a CUDA
request on a machine without a usable card raises instead of quietly
running on the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

# Device memory the planner never hands to tile groups: the CUDA context,
# cuBLAS workspaces and the allocator's fragmentation live here.
CUDA_RESERVE_BYTES = 2 << 30

# The CPU budget keeps the tests' buffers small (the same 2 GiB the JAX
# package plans with on its CPU backend).
CPU_BUDGET_BYTES = 2 << 30


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "similaripy_tpu_torch: device='cuda' was requested but no "
                "CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def hbm_budget_bytes(device: torch.device) -> int:
    """Bytes of device memory the planner may fill.

    On a card: what CUDA reports free, plus what PyTorch's caching
    allocator holds but does not use (a previous call's tiles), less
    ``CUDA_RESERVE_BYTES``."""
    if device.type != "cuda":
        return CPU_BUDGET_BYTES
    free, _total = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return max(int(free + cached - CUDA_RESERVE_BYTES), 1 << 30)
