"""K3 of the port (similaripy_tpu_torch.engine.panel_topk) against the JAX
kernel it replaces (similaripy_tpu.engine.pallas_kernels.fused_panel_topk,
run in interpret mode at its own TM = 256 and KB = 768 blocks).

On CPU tensors the port's fused_panel_topk runs its plain PyTorch version,
so these tests hold that version to the TPU kernel in every precision mode
(f32, bf16, int8), with and without the hot-prefix bias, under each mask,
with several epilogue flag sets. int8 is exact (through `pow`, within
torch_k3_cases.POW_RTOL_CPU: the two math libraries round pow apart); f32 and bf16 values agree to rtol 1e-5
(the sums run in another order); ids are compared where the values are not
tied. The CUDA kernel itself is held against the plain version on the card
(chip_smoke.py and test_torch_kernel_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similaripy_tpu.engine.pallas_kernels import fused_panel_topk as jax_panel_topk
from similaripy_tpu_torch.engine import panel_topk
from torch_k3_cases import (
    CASES, POW_RTOL_CPU, TM, assert_same_panel, case_id, make_case, run_port,
)

torch.set_num_threads(2)


def _run_jax(mode, a, d, vecs, pv, bias, masks, flags, k_pad, tc):
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[mode]
    out = jax_panel_topk(
        jnp.asarray(a, dt), jnp.asarray(d, dt), *map(jnp.asarray, vecs), jnp.asarray(pv),
        bias=None if bias is None else jnp.asarray(bias),
        **{k: jnp.asarray(v) for k, v in masks.items()},
        flags=flags, k_pad=k_pad, tc=tc, int8_mode=mode == "int8",
        precision=jax.lax.Precision.HIGHEST, interpret=True,
    )
    return tuple(np.array(x) for x in out)


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_plain_matches_jax_kernel(case):
    mode, bias_on, mask = case
    inputs = make_case(mode, bias_on, mask)
    ref = _run_jax(mode, *inputs)
    panel_topk.reset_counts()
    got = run_port(panel_topk.fused_panel_topk, mode, *inputs)
    assert panel_topk.plain_calls == 1 and panel_topk.kernel_launches == 0
    assert np.isfinite(ref[0]).any()
    assert_same_panel(mode, got, ref, inputs[6], pow_rtol=POW_RTOL_CPU)


def test_ties_lowest_column_per_tile():
    """Equal scores in a tile: the lowest column first, as the TPU kernel's
    argmax extraction gives them; every tile keeps its own top-k."""
    K, tc = 768, 128
    a = np.zeros((TM, K), np.float32)
    a[:, 0] = 1.0
    d = np.zeros((K, 2 * tc), np.float32)
    d[0, [3, 5, 9, tc + 7, tc + 2]] = 2.0
    d[0, 1] = 1.0
    ones_r, ones_c = np.ones(TM, np.float32), np.ones(2 * tc, np.float32)
    vecs = [ones_r, ones_r, ones_r, ones_c, ones_c, ones_c]
    pv = np.zeros(16, np.float32)
    pv[[0, 4, 5, 9]] = 1.0
    pv[10] = 1000
    args = (a, d, vecs, pv, None, {}, (False,) * 6, 4, tc)
    ref = _run_jax("f32", *args)
    got = run_port(panel_topk.fused_panel_topk, "f32", *args)
    np.testing.assert_array_equal(got[0], ref[0])
    fin = np.isfinite(ref[0])
    np.testing.assert_array_equal(got[1][fin], ref[1][fin])
    assert got[1][0, :, 0].tolist()[:3] == [1003, 1005, 1009]
    assert got[1][1, :2, 0].tolist() == [1000 + tc + 2, 1000 + tc + 7]


def test_int8_bias_beyond_f32_integers_stays_exact():
    """An int32 bias above 2**24 plus the int8 product is summed exactly
    and rounded to f32 once, before the inverse-scale multiply, as the TPU
    kernel does; the JAX kernel agrees bit for bit."""
    rng = np.random.default_rng(3)
    K, tc = 768, 128
    a = rng.integers(-5, 6, (TM, K)).astype(np.int8)
    d = rng.integers(-5, 6, (K, tc)).astype(np.int8)
    bias = (rng.integers(1, 50, (TM, tc)) + (1 << 25)).astype(np.int32)
    ones_r, ones_c = np.ones(TM, np.float32), np.ones(tc, np.float32)
    pv = np.zeros(16, np.float32)
    pv[[0, 4, 5, 9]] = 1.0
    pv[8] = -np.inf  # raw dot, no threshold
    args = (a, d, [ones_r] * 3 + [ones_c] * 3, pv, bias, {}, (False,) * 6, 8, tc)
    got = run_port(panel_topk.fused_panel_topk, "int8", *args)
    exact = (bias.astype(np.int64) + a.astype(np.int64) @ d.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(got[0][0], -np.sort(-exact, axis=1)[:, :8].T)
    np.testing.assert_array_equal(got[0], _run_jax("int8", *args)[0])
