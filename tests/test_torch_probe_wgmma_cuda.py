"""The probes' Hopper products on the card: the K-major pass
(csrc/kmajor.cuh), P1 (csrc/probe_tlhs.cu) on its new product kernels
(wgmma s8 after the pass, K2's wgmma bf16 and cp.async SIMT products) and
P2 (csrc/probe_int_mma.cu) on wgmma s8, each against its plain version.

These tests need a CUDA card, nvcc and the kernel build; without a card
they skip. They import no JAX, so they also run on a machine without it:
    python -m pytest tests/test_torch_probe_wgmma_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from similaripy_tpu_torch.benchmarks import probes
from torch_probe_cases import P2_CASES, p1_inputs, p2_inputs, shape_id

_DT = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}
# the product kernel each dtype takes at shapes whose rows are 16-byte multiples
NEW_KERNEL = {"int8": "wgmma s8", "bfloat16": "wgmma bf16", "float32": "simt cp.async ring"}

# (K, R): aligned and ragged in R and in K, K past one 128-byte slab and
# shorter than one, one row
KMAJOR_SHAPES = [(512, 256), (128, 128), (77, 130), (300, 129), (1, 1), (1000, 37),
                 (2049, 64), (256, 4112)]
# P1 at shapes every new kernel takes (M and N multiples of 8): K ending
# mid-slab for every ring, a block past M and N, odd column-block counts (a
# padding block in the last cluster pair), the probe's shape
P1_ALIGNED = [(512, 256, 1024), (77, 136, 264), (300, 128, 384), (1, 8, 8), (129, 512, 136),
              (2048, 256, 256), (0, 16, 24)]
# P2 beyond P2_CASES: the probe's shape, steps 0 and 1, chunks of several
# slabs, one row
P2_EXTRA = [(512, 2048, 512, 1), (512, 2048, 512, 0), (64, 40_000, 64, 1), (1, 300, 1, 2),
            (128, 128, 128, 7)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [True, False], ids=["transpose", "pad"])
@pytest.mark.parametrize("shape", KMAJOR_SHAPES, ids=shape_id)
def test_kmajor_pass_matches_pad(shape, transpose):
    """The pass alone: x^T (or x) zero-padded to k_pad, bit for bit, on
    full-range int8."""
    _need_card()
    K, R = shape
    rng = np.random.default_rng(K + R)
    x_n = rng.integers(-128, 128, (K, R) if transpose else (R, K)).astype(np.int8)
    x = torch.from_numpy(x_n).cuda()
    probes.reset_counts()
    got = probes.kmajor_pass(x, transpose)
    torch.cuda.synchronize()
    assert probes.kmajor_counts.kernel_launches == 1 and probes.kmajor_counts.plain_calls == 0
    k_pad = probes.k_pad(K)
    assert got.shape == (R, k_pad) and k_pad % 128 == 0
    xt = x.t() if transpose else x
    assert torch.equal(got, torch.nn.functional.pad(xt, (0, k_pad - K)))


# (dtype, full_range): full-range values only in int8 (bf16 and f32 sums
# of their products round past 2**24)
P1_DATA = [("int8", False), ("bfloat16", False), ("float32", False), ("int8", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,full_range", P1_DATA, ids=["-".join(map(str, d)) for d in P1_DATA])
@pytest.mark.parametrize("shape", P1_ALIGNED, ids=shape_id)
def test_p1_takes_its_new_kernel_and_matches_plain(shape, dtype, full_range):
    """P1 on 16-byte rows takes the new product kernel of its dtype and is
    bit-equal to the plain version on integer data."""
    _need_card()
    a_i, b_i = p1_inputs(*shape, seed=sum(shape), full_range=full_range)
    a = torch.from_numpy(a_i).cuda().to(_DT[dtype])
    b = torch.from_numpy(b_i).cuda().to(_DT[dtype])
    probes.reset_counts()
    got = probes.transposed_lhs_product(a, b)
    torch.cuda.synchronize()
    c = probes.tlhs_counts
    assert c.kernel_launches == 1 and c.plain_calls == 0
    assert c.product_launches[NEW_KERNEL[dtype]] == 1 and c.last_kernel == NEW_KERNEL[dtype]
    assert c.pass_launches == (2 if dtype == "int8" and shape[0] else 0)
    ref = probes.transposed_lhs_product_plain(a, b)
    assert got.dtype == ref.dtype and got.shape == (shape[1], shape[2])
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 130, 300), (513, 129, 33), (300, 136, 264)],
                         ids=shape_id)
def test_p1_s8_product_alone_matches_plain(shape):
    """The int8 product on the pass's output, apart from the passes."""
    _need_card()
    K, M, N = shape
    a_i, b_i = p1_inputs(*shape, seed=7, full_range=True)
    a = torch.from_numpy(a_i).cuda().to(torch.int8)
    b = torch.from_numpy(b_i).cuda().to(torch.int8)
    at, bt = probes.kmajor_pass(a), probes.kmajor_pass(b)
    probes.reset_counts()
    got = probes.s8_kmajor_product(at, bt, M, N)
    torch.cuda.synchronize()
    assert probes.tlhs_counts.product_launches["wgmma s8"] == 1
    assert torch.equal(got, probes.s8_kmajor_product_plain(at, bt, M, N))
    assert torch.equal(got.cpu(), torch.from_numpy((a_i.T @ b_i).astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", P2_CASES + P2_EXTRA, ids=shape_id)
def test_p2_int8_on_wgmma_matches_oracle(case):
    """P2 int8 takes wgmma s8 and equals the oracle times steps, bit for
    bit."""
    _need_card()
    M, K, N, steps = case
    a_n, b_n = p2_inputs(M, K, N, seed=M + K)
    a, b = torch.from_numpy(a_n).cuda(), torch.from_numpy(b_n).cuda()
    probes.reset_counts()
    got = probes.int_rate_product(a, b, steps, "int8")
    torch.cuda.synchronize()
    c = probes.int_mma_counts
    assert c.kernel_launches == 1 and c.plain_calls == 0
    assert c.product_launches["wgmma s8"] == 1 and c.pass_launches == 2
    assert torch.equal(got, probes.int_rate_product_plain(a, b, steps, "int8"))
    oracle = (a_n.astype(np.int64) @ b_n.astype(np.int64)) * steps
    assert np.array_equal(got.cpu().numpy(), oracle)


@pytest.mark.cuda
def test_p2_s4_stays_on_mma_sync():
    _need_card()
    a_n, b_n = p2_inputs(64, 2048, 64, seed=1)
    a, b = torch.from_numpy(a_n).cuda(), torch.from_numpy(b_n).cuda()
    probes.reset_counts()
    got = probes.int_rate_product(a, b, 3, "s4")
    torch.cuda.synchronize()
    assert probes.int_mma_counts.product_launches == {"wgmma s8": 0, "mma.sync s4": 1}
    assert probes.int_mma_counts.pass_launches == 0
    assert torch.equal(got, probes.int_rate_product_plain(a, b, 3, "s4"))
