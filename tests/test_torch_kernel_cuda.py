"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (tile_topk), K2 (sym_topk), K3 (panel_topk), K4 (gather), K5
(scatter), and the probes P1 (probe_tlhs) and P2 (probe_int_mma).

These tests need a CUDA card, nvcc and the kernel build; without a card
they skip. They import no JAX, so they also run on a machine without it:
    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q
(`--noconftest` because the suite's conftest imports JAX).
"""

import numpy as np
import pytest
import torch

from similaripy_tpu_torch.benchmarks import probes
from similaripy_tpu_torch.engine import gather, panel_topk, scatter, sym_topk, tile_topk
from torch_k1_cases import CASES, assert_same, make_case, run_port
from torch_k2_cases import CARD_CASES as K2_CARD_CASES
from torch_k2_cases import CASES as K2_CASES
from torch_k2_cases import EPILOGUES, case_id, make_inputs, torch_fn
from torch_k2_cases import assert_same as assert_same_k2
from torch_k3_cases import CARD_CASES as K3_CARD_CASES
from torch_k3_cases import CASES as K3_CASES
from torch_k3_cases import GATHER_CASES, assert_same_panel, gather_inputs
from torch_k3_cases import case_id as k3_id
from torch_k3_cases import make_case as make_k3
from torch_k3_cases import run_port as run_k3
from torch_probe_cases import (P1_DTYPES, P1_F32_RANDN_SHAPES, P1_SHAPES, P2_CASES, P2_MODES,
                               P2_WRAP_CASES, f32_scaled_errors, f32_tolerance, p1_inputs, p1_randn,
                               p2_inputs, p2_wrap_inputs, shape_id)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _plain_on_card(mode, a, d, vecs, pv, masks, carry, flags, k_pad):
    return run_port(tile_topk.fused_tile_topk_plain, mode, a, d, vecs, pv, masks,
                    carry, flags, k_pad, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,carry_on,mask", CASES)
def test_kernel_matches_plain(mode, carry_on, mask):
    _need_card()
    case = make_case(mode, carry_on, mask, _plain_on_card)
    tile_topk.reset_counts()
    got = run_port(tile_topk.fused_tile_topk, mode, *case, device="cuda")
    assert tile_topk.kernel_launches == 1
    ref = _plain_on_card(mode, *case)
    assert_same(mode, got, ref, case[6])


K2_ALL = K2_CASES + K2_CARD_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_ALL, ids=[case_id(c) for c in K2_ALL])
def test_sym_kernel_matches_plain(case):
    _need_card()
    plain = torch_fn(sym_topk.fused_sym_topk_plain, case["mode"], device="cuda")
    args, kw = make_inputs(case, plain)
    sym_topk.reset_counts()
    got = torch_fn(sym_topk.fused_sym_topk, case["mode"], device="cuda")(*args, **kw)
    torch.cuda.synchronize()
    assert sym_topk.kernel_launches == 1 and sym_topk.plain_calls == 0
    assert_same_k2(case["mode"], got, plain(*args, **kw), EPILOGUES[case["epi"]][0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("dup", [False, True])
def test_scatter_kernel_matches_plain(mode, dup):
    """Sentinel padding lands nowhere; unique entries land bit-exactly; an
    entry repeated once sums exactly (two addends, any order)."""
    _need_card()
    rng = np.random.default_rng(7 + dup)
    g, u_pad, tc, p2 = 3, 2048, 1024, 40_000
    ru = np.full((g, p2), u_pad, np.int32)
    sl = np.zeros((g, p2), np.int32)
    vv = np.zeros((g, p2), np.float32)
    for t in range(g):
        n = p2 - 1000 * (t + 1)
        cells = rng.choice(u_pad * tc, n, replace=False)
        if dup:
            cells[n // 2:] = cells[: n - n // 2]
        ru[t, :n], sl[t, :n] = cells // tc, cells % tc
        vv[t, :n] = (rng.integers(-6, 7, n) if mode == "int8"
                     else torch.from_numpy(rng.random(n).astype(np.float32)).bfloat16().float())
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[mode]
    args = [torch.from_numpy(a).cuda() for a in (ru, sl, vv)]
    scatter.reset_counts()
    got = scatter.densify_tiles(*args, u_pad=u_pad, tc=tc, cdt=dt)
    torch.cuda.synchronize()
    assert scatter.kernel_launches == 1 and scatter.plain_calls == 0
    ref = scatter.densify_tiles_plain(*args, u_pad=u_pad, tc=tc, cdt=dt)
    assert got.dtype == dt and got.shape == (g, u_pad, tc)
    assert torch.equal(got, ref)


K3_ALL = [c + (None,) for c in K3_CASES] + K3_CARD_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_ALL, ids=[k3_id(c) for c in K3_ALL])
def test_panel_kernel_matches_plain(case):
    _need_card()
    mode, bias_on, mask, card_shape = case
    inputs = make_k3(mode, bias_on, mask, card_shape)
    panel_topk.reset_counts()
    got = run_k3(panel_topk.fused_panel_topk, mode, *inputs, device="cuda")
    torch.cuda.synchronize()
    assert panel_topk.kernel_launches == 1 and panel_topk.plain_calls == 0
    ref = run_k3(panel_topk.fused_panel_topk_plain, mode, *inputs, device="cuda")
    assert_same_panel(mode, got, ref, inputs[6])


@pytest.mark.cuda
@pytest.mark.parametrize("mode,u_pad,cg,n", GATHER_CASES)
def test_gather_kernel_matches_plain(mode, u_pad, cg, n):
    _need_card()
    table, idx = gather_inputs(mode, u_pad, cg, n)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[mode]
    t, i = torch.from_numpy(table).cuda().to(dt), torch.from_numpy(idx).cuda()
    gather.reset_counts()
    got = gather.row_gather(t, i)
    torch.cuda.synchronize()
    assert gather.kernel_launches == 1 and gather.plain_calls == 0
    assert got.dtype == dt and torch.equal(got, gather.row_gather_plain(t, i))


_P1_DT = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", P1_DTYPES)
@pytest.mark.parametrize("shape", P1_SHAPES, ids=[shape_id(s) for s in P1_SHAPES])
def test_probe_tlhs_kernel_matches_plain(dtype, shape):
    """P1 bit-equal to its plain version (values in [-5, 5]: exact in
    every mode)."""
    _need_card()
    a_i, b_i = p1_inputs(*shape, seed=sum(shape))
    a = torch.from_numpy(a_i).cuda().to(_P1_DT[dtype])
    b = torch.from_numpy(b_i).cuda().to(_P1_DT[dtype])
    probes.reset_counts()
    got = probes.transposed_lhs_product(a, b)
    torch.cuda.synchronize()
    assert probes.tlhs_counts.kernel_launches == 1 and probes.tlhs_counts.plain_calls == 0
    ref = probes.transposed_lhs_product_plain(a, b)
    assert got.dtype == ref.dtype and got.shape == (shape[1], shape[2])
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 130, 300), (513, 129, 33)], ids=shape_id)
def test_probe_tlhs_full_range_int8(shape):
    _need_card()
    a_i, b_i = p1_inputs(*shape, seed=5, full_range=True)
    a = torch.from_numpy(a_i).cuda().to(torch.int8)
    b = torch.from_numpy(b_i).cuda().to(torch.int8)
    got, ref = probes.transposed_lhs_product(a, b), probes.transposed_lhs_product_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(ref.cpu(), torch.from_numpy((a_i.T @ b_i).astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", P1_F32_RANDN_SHAPES, ids=[shape_id(s) for s in P1_F32_RANDN_SHAPES])
def test_probe_tlhs_f32_randn(shape):
    """P1 f32 on non-integer data: its mean scaled error stays within the
    f32 tolerance, which a TF32 (or bf16) product would exceed."""
    _need_card()
    a_n, b_n = p1_randn(*shape, seed=sum(shape))
    a, b = torch.from_numpy(a_n).cuda(), torch.from_numpy(b_n).cuda()
    got = probes.transposed_lhs_product(a, b)
    mean, worst, tf32_mean = f32_scaled_errors(torch, got, a, b)
    tol = f32_tolerance(shape[0])
    assert mean <= tol, (mean, worst, tol)
    assert tf32_mean > 8 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", P2_WRAP_CASES, ids=[shape_id(c) for c in P2_WRAP_CASES])
def test_probe_int_mma_s4_wrap(case):
    """s4 on values in [-8, 9]: the kernel's nibble packing wraps 8 and 9
    and sign-extends -8 as the int4 cast does."""
    _need_card()
    M, K, N, steps = case
    a_n, b_n = p2_wrap_inputs(M, K, N, seed=M)
    a, b = torch.from_numpy(a_n).cuda(), torch.from_numpy(b_n).cuda()
    got = probes.int_rate_product(a, b, steps, "s4")
    assert torch.equal(got, probes.int_rate_product_plain(a, b, steps, "s4"))
    s4 = [((x.astype(np.int64) + 8) & 15) - 8 for x in (a_n, b_n)]
    assert np.array_equal(got.cpu().numpy(), (s4[0] @ s4[1]) * steps)
    assert not np.array_equal(s4[0], a_n)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", P2_MODES)
@pytest.mark.parametrize("case", P2_CASES, ids=[shape_id(c) for c in P2_CASES])
def test_probe_int_mma_kernel_matches_plain(mode, case):
    _need_card()
    M, K, N, steps = case
    a_n, b_n = p2_inputs(M, K, N, seed=M + K)
    a, b = torch.from_numpy(a_n).cuda(), torch.from_numpy(b_n).cuda()
    probes.reset_counts()
    got = probes.int_rate_product(a, b, steps, mode)
    torch.cuda.synchronize()
    assert probes.int_mma_counts.kernel_launches == 1
    assert probes.int_mma_counts.plain_calls == 0
    assert torch.equal(got, probes.int_rate_product_plain(a, b, steps, mode))
    oracle = (a_n.astype(np.int64) @ b_n.astype(np.int64)) * steps
    assert np.array_equal(got.cpu().numpy(), oracle)
