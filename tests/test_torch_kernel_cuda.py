"""K1's CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA card, nvcc and the kernel build; without a card
they skip. They import no JAX, so they also run on a machine without it:
    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q
(`--noconftest` because the suite's conftest imports JAX).
"""

import pytest
import torch

from similaripy_tpu_torch.engine import tile_topk
from torch_k1_cases import CASES, assert_same, make_case, run_port


def _plain_on_card(mode, a, d, vecs, pv, masks, carry, flags, k_pad):
    return run_port(tile_topk.fused_tile_topk_plain, mode, a, d, vecs, pv, masks,
                    carry, flags, k_pad, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,carry_on,mask", CASES)
def test_kernel_matches_plain(mode, carry_on, mask):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    case = make_case(mode, carry_on, mask, _plain_on_card)
    tile_topk.reset_counts()
    got = run_port(tile_topk.fused_tile_topk, mode, *case, device="cuda")
    assert tile_topk.kernel_launches == 1
    ref = _plain_on_card(mode, *case)
    assert_same(mode, got, ref, case[6])
