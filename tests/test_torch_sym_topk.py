"""K2 of the port (similaripy_tpu_torch.engine.sym_topk) against the JAX
kernel it replaces (similaripy_tpu.engine.pallas_kernels.fused_sym_topk,
run in interpret mode).

On CPU tensors the port's fused_sym_topk runs its plain PyTorch version, so
these tests hold that version to the TPU kernel in every precision mode
(f32, bf16, int8), for the symmetric and the asymmetric epilogue, for a
block whose anchor rows are partly diagonal and partly dead, one partly
live and partly diagonal, and one fully live, with cold and warm carries,
anchors as tiles or as a row panel, and k > tc. int8 is exact (up to the
last bit of `pow`, torch_k1_cases.POW_RTOL); f32 and bf16 agree to rtol
1e-5; ids are compared where the values are not tied. The CUDA kernel is
held against the plain version on the card (test_torch_kernel_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similaripy_tpu.engine.pallas_kernels import fused_sym_topk as jax_sym_topk
from similaripy_tpu_torch.engine import sym_topk
from torch_k2_cases import CASES, EPILOGUES, SPLIT_CASES, assert_same, case_id, make_inputs
from torch_k2_cases import torch_fn

torch.set_num_threads(2)


def _run_jax(a, d, *rest, x2=None, y2=None, **kw):
    dt = {np.dtype(np.int8): jnp.int8}.get(a.dtype, jnp.float32)
    if kw.get("bf16"):
        dt = jnp.bfloat16
    kw.pop("bf16", None)
    out = jax_sym_topk(
        jnp.asarray(a, dt), jnp.asarray(d, dt), *map(jnp.asarray, rest),
        x2=None if x2 is None else tuple(map(jnp.asarray, x2)),
        y2=None if y2 is None else tuple(map(jnp.asarray, y2)),
        precision=jax.lax.Precision.HIGHEST, interpret=True, **kw,
    )
    return tuple(np.array(x) for x in out)


def _jax_fn(mode):
    def call(*args, **kw):
        return _run_jax(*args, bf16=mode == "bf16", **kw)

    return call


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_plain_matches_jax_kernel(case):
    args, kw = make_inputs(case, _jax_fn(case["mode"]))
    ref = _jax_fn(case["mode"])(*args, **kw)
    sym_topk.reset_counts()
    got = torch_fn(sym_topk.fused_sym_topk, case["mode"])(*args, **kw)
    assert sym_topk.plain_calls == 1 and sym_topk.kernel_launches == 0
    assert_same(case["mode"], got, ref, EPILOGUES[case["epi"]][0])


def test_ties_row_side_tile_first_col_side_carry_first():
    """Equal scores: the row side puts the lowest column first and tile
    entries ahead of an equal carried entry; the col side keeps a carried
    entry ahead of an equal new one and puts the lowest row first among
    the new ones (pallas_kernels.py:880-1002)."""
    tc, gt, u = 128, 1, 768
    a = np.zeros((gt, u, tc), np.float32)
    a[0, 0, [3, 5, 9]] = 1.0  # anchor rows 3, 5, 9 hold one user
    d = np.zeros((u, tc), np.float32)
    d[0, [2, 4]] = 2.0  # tile columns 2 and 4 share it: xy = 2 for each pair
    ones_a, ones_t = np.ones(tc, np.float32), np.ones(tc, np.float32)
    pv = np.zeros(16, np.float32)
    pv[[0, 4, 5, 9]] = 1.0
    pv[10:14] = (3 * tc, 1 * tc, 3, 1)  # t = 3, a0 = 1: rows feed both sides
    flags = (False,) * 6
    k_pad = 8
    crv = np.full((k_pad, tc), -np.inf, np.float32)
    cri = np.zeros((k_pad, tc), np.int32)
    crv[0], cri[0] = 2.0, 7  # a carried 2.0 in every anchor row
    ccv = np.full((k_pad, tc), -np.inf, np.float32)
    cci = np.zeros((k_pad, tc), np.int32)
    ccv[0], cci[0] = 2.0, 11  # and in every tile column
    args = (a, d, ones_a, ones_a, ones_a, ones_t, ones_t, ones_t, crv, cri,
            np.full((tc, 1), -np.inf, np.float32), ccv, cci, pv)
    kw = dict(flags=flags, k=k_pad, tc=tc, int8_mode=False)
    ref = _run_jax(*args, **kw)
    got = torch_fn(sym_topk.fused_sym_topk, "f32")(*args, **kw)
    assert_same("f32", got, ref, flags)
    for g, r in zip(got, ref):
        fin = np.isfinite(ref[0] if g.shape == ref[0].shape else ref[2])
        np.testing.assert_array_equal(g[fin], r[fin])
    # row 3: the tile's columns 2 and 4 (ids 3*tc + col), then the carry
    assert got[1][:3, 3].tolist() == [3 * tc + 2, 3 * tc + 4, 7]
    # column 2: the carry, then anchor rows 3, 5, 9 (ids 1*tc + row)
    assert got[3][:4, 2].tolist() == [11, tc + 3, tc + 5, tc + 9]


def test_split_mode_is_not_ported():
    """The split-bf16x3 mode, once refused here, is ported: on CPU tensors
    it runs the plain version (held against the JAX kernel in
    test_torch_split.py)."""
    case = SPLIT_CASES[0]
    args, kw = make_inputs(case, torch_fn(sym_topk.fused_sym_topk_plain, "split"))
    sym_topk.reset_counts()
    out = torch_fn(sym_topk.fused_sym_topk, "split")(*args, **kw)
    assert sym_topk.plain_calls == 1 and sym_topk.kernel_launches == 0
    assert out[0].shape == args[8].shape and out[2].shape == args[11].shape


def test_sym_k_pads_are_k_deep():
    """Both carries are k deep, not capped at one block's width (the
    regression tests/test_symmetric.py::test_pallas_k_exceeds_tile_width
    guards in the JAX package)."""
    assert sym_topk.sym_k_pads(200, 128, 256) == (200, 200)
    assert sym_topk.sym_k_pads(17, 4096, 8192) == (24, 24)


def test_cuda_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises; it is
    never handed to the plain version."""
    args, kw = make_inputs(CASES[0], torch_fn(sym_topk.fused_sym_topk_plain, "f32"))
    meta = [torch.from_numpy(np.ascontiguousarray(x)).to("meta") for x in args]
    sym_topk.reset_counts()
    with pytest.raises(ValueError, match="cuda or cpu"):
        sym_topk.fused_sym_topk(*meta, **kw)
    assert sym_topk.plain_calls == 0


@pytest.mark.parametrize("layout", ["mn-3d", "anchors-strided", "tile-contiguous",
                                    "tile-not-viewed", "u-not-16"])
def test_int8_kernel_route_takes_kmajor_operands_only(layout):
    """The int8 kernel reads K-major operands only: a contiguous (sw,
    u_pad) anchor stack and the (u_pad, tc) view, strides (1, u_pad), of a
    contiguous (tc, u_pad) tile, u_pad a multiple of 16. The kernel route
    raises on any other layout before it launches or copies anything."""
    tc, gt, u = 128, 2, 64
    sw = gt * tc
    a_k = torch.zeros((sw, u), dtype=torch.int8)
    d_k = torch.zeros((tc, u), dtype=torch.int8).T
    a, d = {
        "mn-3d": (a_k.view(gt, tc, u).transpose(1, 2).contiguous(), d_k.contiguous()),
        "anchors-strided": (torch.zeros((sw, 2 * u), dtype=torch.int8)[:, :u], d_k),
        "tile-contiguous": (a_k, d_k.contiguous()),
        "tile-not-viewed": (a_k, d_k.T),
        "u-not-16": (torch.zeros((sw, 40), dtype=torch.int8),
                     torch.zeros((tc, 40), dtype=torch.int8).T),
    }[layout]
    vecs = [torch.ones(sw)] * 3 + [torch.ones(tc)] * 3
    k_pad = 16
    carries = [torch.full((k_pad, sw), -np.inf), torch.zeros((k_pad, sw), dtype=torch.int32),
               torch.full((sw, 1), -np.inf), torch.full((k_pad, tc), -np.inf),
               torch.zeros((k_pad, tc), dtype=torch.int32)]
    with pytest.raises(ValueError, match="K-major|multiple of 16"):
        sym_topk._launch(a, d, *vecs, *carries, torch.zeros(16), flags=EPILOGUES["sym"][0],
                         k=k_pad, tc=tc, int8_mode=True, x2=None, y2=None, split=False)
