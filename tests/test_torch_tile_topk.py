"""K1 of the port (similaripy_tpu_torch.engine.tile_topk) against the JAX
kernel it replaces (similaripy_tpu.engine.pallas_kernels.fused_tile_topk,
run in interpret mode with small tm/kb blocks).

On CPU tensors the port's fused_tile_topk runs its plain PyTorch version,
so these tests hold that version to the TPU kernel in every precision mode
(f32, bf16, int8) x carry x mask, with several epilogue flag sets. int8 is
exact (up to the last bit of `pow`, see torch_k1_cases.POW_RTOL); f32 and
bf16 values agree to rtol 1e-5 (the sums run in another order); ids are
compared where the values are not tied. The CUDA kernel itself is held
against the plain version on the card (chip_smoke.py and
test_torch_kernel_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similaripy_tpu.engine.pallas_kernels import fused_tile_topk as jax_tile_topk
from similaripy_tpu_torch.engine import tile_topk
from torch_k1_cases import CASES, assert_same, make_case, run_port, run_port_split

torch.set_num_threads(2)


def _run_jax(mode, a, d, vecs, pv, masks, carry, flags, k_pad):
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[mode]
    out = jax_tile_topk(
        jnp.asarray(a, dt), jnp.asarray(d, dt), *map(jnp.asarray, vecs), jnp.asarray(pv),
        **{k: jnp.asarray(v) for k, v in masks.items()},
        carry=None if carry is None else tuple(map(jnp.asarray, carry)),
        flags=flags, k_pad=k_pad, int8_mode=mode == "int8",
        precision=jax.lax.Precision.HIGHEST, tm=8, kb=128, interpret=True,
    )
    return tuple(np.array(x) for x in out)


@pytest.mark.parametrize("mode,carry_on,mask", CASES)
def test_plain_matches_jax_kernel(mode, carry_on, mask):
    case = make_case(mode, carry_on, mask, _run_jax)
    ref = _run_jax(mode, *case)
    tile_topk.reset_counts()
    got = run_port(tile_topk.fused_tile_topk, mode, *case)
    assert tile_topk.plain_calls == 1 and tile_topk.kernel_launches == 0
    assert_same(mode, got, ref, case[6])


def test_plain_ties_lowest_column_then_tile_before_carry():
    """Equal scores: the lowest column first within a tile, and a tile entry
    ahead of an equal carried entry (pallas_kernels.py:323-374)."""
    a = np.ones((8, 128), np.float32)
    d = np.zeros((128, 16), np.float32)
    d[0, [3, 5, 9]] = 2.0  # three equal scores
    d[0, 1] = 1.0
    ones8, ones16 = np.ones(8, np.float32), np.ones(16, np.float32)
    vecs = [ones8, ones8, ones8, ones16, ones16, ones16]
    pv = np.zeros(16, np.float32)
    pv[[0, 4, 5, 9]] = 1.0
    pv[10] = 100
    flags = (False,) * 6
    cv = np.tile(np.array([[3.0], [2.0], [2.0], [-np.inf]], np.float32), (1, 8))
    ci = np.tile(np.array([[7], [8], [9], [0]], np.int32), (1, 8))
    for carry in (None, (cv, ci)):
        ref = _run_jax("f32", a, d, vecs, pv, {}, carry, flags, 4)
        got = run_port(tile_topk.fused_tile_topk, "f32", a, d, vecs, pv, {}, carry, flags, 4)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1][np.isfinite(ref[0])], ref[1][np.isfinite(ref[0])])
    # with the carry: its 3.0, then the tile's 2.0s by column, ahead of
    # the carry's own 2.0s
    assert got[1][:, 0].tolist() == [7, 103, 105, 109]


def test_split_modes_are_not_ported():
    """The split-bf16x3 modes, once refused here, are ported: on CPU
    tensors each runs the plain version (held against the JAX kernel in
    test_torch_split.py), and an unknown mode raises."""
    a, d, vecs, pv, masks, carry, flags, k_pad = make_case("f32", False, "none", None)
    for split in ("both", "rhs", "lhs"):
        tile_topk.reset_counts()
        vals, idx = run_port_split(tile_topk.fused_tile_topk, split, a, d, vecs, pv, masks,
                                   carry, flags, k_pad)
        assert tile_topk.plain_calls == 1 and tile_topk.kernel_launches == 0
        assert vals.shape == idx.shape == (k_pad, a.shape[0])
    with pytest.raises(ValueError):
        tile_topk.fused_tile_topk(
            torch.from_numpy(a), torch.from_numpy(d), *map(torch.from_numpy, vecs),
            torch.from_numpy(pv), flags=flags, k_pad=k_pad, int8_mode=False,
            split_f32="middle",
        )
