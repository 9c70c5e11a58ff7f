"""K5 of the port (similaripy_tpu_torch.engine.scatter.densify_tiles)
against the JAX package: its mxu_scatter kernel (interpret mode, fed the
JAX package's own binning of the same COO) and its executor.densify.

On CPU tensors densify_tiles runs its plain PyTorch version. Per-tile COO
with sentinel padding (user == u_pad) goes in; dense (G, u_pad, tc) tiles
come out, exactly equal, or in the K-major layout (G, tc, u_pad) that K2's
int8 product takes, their transpose. The CUDA kernel is held against the plain version
on the card (test_torch_kernel_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from similaripy_tpu.engine import executor as jax_executor
from similaripy_tpu.engine.pallas_kernels import mxu_scatter
from similaripy_tpu.engine.symmetric import _bin_tiles_mxu, _lpt_user_perm
from similaripy_tpu_torch.engine import scatter

torch.set_num_threads(2)

G, U_PAD, TC, P2 = 3, 1024, 512, 1536
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}


def _coo(mode, seed, dup=False):
    """(G, P2) users, slots, values: unique (user, slot) pairs per tile (or
    with repeated pairs when `dup`), sentinel-padded to P2."""
    rng = np.random.default_rng(seed)
    ru = np.full((G, P2), U_PAD, np.int32)
    sl = np.zeros((G, P2), np.int32)
    vv = np.zeros((G, P2), np.float32)
    for g in range(G):
        n = int(rng.integers(P2 // 2, P2 - 64))
        cells = rng.choice(U_PAD * TC, n, replace=False)
        if dup:
            cells[n // 2:] = cells[: n - n // 2]
        ru[g, :n], sl[g, :n] = cells // TC, cells % TC
        if mode == "int8":
            vv[g, :n] = rng.integers(1, 7, n) * rng.choice([-1, 1], n)
        else:
            vv[g, :n] = rng.random(n) + 0.1
            if mode == "bf16":  # values a bf16 tile holds exactly
                vv[g] = torch.from_numpy(vv[g]).bfloat16().float().numpy()
    return ru, sl, vv


def _port(mode, ru, sl, vv):
    scatter.reset_counts()
    out = scatter.densify_tiles(
        torch.from_numpy(ru), torch.from_numpy(sl), torch.from_numpy(vv),
        u_pad=U_PAD, tc=TC, cdt=TORCH[mode],
    )
    assert scatter.plain_calls == 1 and scatter.kernel_launches == 0
    assert out.shape == (G, U_PAD, TC) and out.dtype == TORCH[mode]
    return out.float().numpy()


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_plain_matches_mxu_scatter(mode):
    ru, sl, vv = _coo(mode, seed=1)
    ps, bv, cnt = _bin_tiles_mxu(ru, sl, vv, U_PAD, TC, mode == "int8")
    got = _port(mode, ru, sl, vv)
    for g in range(G):
        ref = mxu_scatter(jnp.asarray(ps[g]), jnp.asarray(bv[g]), jnp.asarray(cnt[g]),
                          u_pad=U_PAD, tc=TC, out_dtype=JAX[mode], interpret=True)
        # mxu_scatter's tile lives in the binning's permuted user order
        perm = _lpt_user_perm(ru, U_PAD)
        np.testing.assert_array_equal(got[g], np.asarray(ref, np.float32)[perm])


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_plain_matches_executor_densify(mode):
    ru, sl, vv = _coo(mode, seed=2)
    got = _port(mode, ru, sl, vv)
    for g in range(G):
        ref = jax_executor.densify((U_PAD, TC), jnp.asarray(ru[g]), jnp.asarray(sl[g]),
                                   jnp.asarray(vv[g]), JAX[mode])
        np.testing.assert_array_equal(got[g], np.asarray(ref, np.float32))


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_duplicates_sum_like_scipy(mode):
    """A CSR that is not canonical keeps repeated entries
    (ops/csr.py::ensure_csr_f32 does not sum them); the densify sums them,
    as SciPy's products do. Each repeated pair here occurs twice, so the
    f32 sum is exact in any order."""
    ru, sl, vv = _coo(mode, seed=3, dup=True)
    got = _port(mode, ru, sl, vv)
    for g in range(G):
        keep = ru[g] < U_PAD
        ref = sp.coo_array((vv[g][keep].astype(np.float64), (ru[g][keep], sl[g][keep])),
                           shape=(U_PAD, TC)).toarray()
        np.testing.assert_array_equal(got[g], ref.astype(np.float32))


def test_cuda_tensor_never_falls_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises; it is
    never handed to the plain version."""
    ru, sl, vv = (torch.from_numpy(a) for a in _coo("f32", seed=4))
    meta = [t.to("meta") for t in (ru, sl, vv)]
    scatter.reset_counts()
    with pytest.raises(ValueError, match="cuda or cpu"):
        scatter.densify_tiles(*meta, u_pad=U_PAD, tc=TC, cdt=torch.float32)
    assert scatter.plain_calls == 0


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("dup", [False, True])
def test_kmajor_layout_is_the_transposed_tile(mode, dup):
    """layout="kmajor" writes (G, tc, u_pad): each slot's users contiguous,
    the transpose of the (G, u_pad, tc) tiles, sentinels and repeated
    entries included."""
    ru, sl, vv = (torch.from_numpy(a) for a in _coo(mode, seed=5 + dup, dup=dup))
    kw = dict(u_pad=U_PAD, tc=TC, cdt=TORCH[mode])
    mn = scatter.densify_tiles(ru, sl, vv, **kw)
    km = scatter.densify_tiles(ru, sl, vv, layout="kmajor", **kw)
    assert km.shape == (G, TC, U_PAD) and km.dtype == TORCH[mode] and km.is_contiguous()
    assert torch.equal(km, mn.transpose(1, 2))


def test_kmajor_sentinels_land_nowhere_and_int8_wraps():
    """A sentinel (user u_pad) with a nonzero slot would land in the next
    slot's row if user and slot simply swapped places, since densify drops
    entries by row only; here it lands nowhere. Repeats wrap in int8 as
    PyTorch's int8 addition does (100 + 100 = -56), in both layouts."""
    ru = torch.tensor([[U_PAD, U_PAD, 7, 7, 3]], dtype=torch.int32)
    sl = torch.tensor([[5, TC - 1, 2, 2, 0]], dtype=torch.int32)
    vv = torch.tensor([[9.0, 9.0, 100.0, 100.0, -4.0]])
    kw = dict(u_pad=U_PAD, tc=TC, cdt=torch.int8)
    km = scatter.densify_tiles_plain(ru[:, :2], sl[:, :2], vv[:, :2], layout="kmajor", **kw)
    assert km.shape == (1, TC, U_PAD) and not km.any()
    km = scatter.densify_tiles_plain(ru, sl, vv, layout="kmajor", **kw)
    mn = scatter.densify_tiles_plain(ru, sl, vv, **kw)
    assert torch.equal(km, mn.transpose(1, 2))
    assert km[0, 2, 7] == -56 and km[0, 0, 3] == -4 and int(km.count_nonzero()) == 2


def test_unknown_layout_raises():
    ru, sl, vv = (torch.from_numpy(a) for a in _coo("f32", seed=6))
    with pytest.raises(ValueError, match="layout"):
        scatter.densify_tiles(ru, sl, vv, u_pad=U_PAD, tc=TC, cdt=torch.float32, layout="km")
