"""K3 (panel_topk) and K4 (gather) test cases shared by the CPU parity tests
(against the JAX kernels), the card tests and chip_smoke.py (kernel against
its plain version). NumPy and PyTorch only: the card's machine has no JAX."""

import numpy as np
import torch

from similaripy_tpu_torch.convert import pvec_from_reference
from torch_k1_cases import FLAG_SETS, POW_RTOL, TORCH_DTYPES, not_tied, operands

TM = 256  # the JAX kernel's panel height (pallas_kernels.TM)
MODES = ("f32", "bf16", "int8")
MASKS = ("none", "allowed", "filter", "target")
# (K, tc, n_tiles, k_pad): K a multiple of the JAX kernel's KB = 768; the
# last has k_pad > tc
SHAPES = [(768, 128, 2, 8), (1536, 256, 2, 40), (768, 128, 3, 136)]
# int8 values through `pow` against the JAX kernel on the CPU: PyTorch's
# vectorized CPU pow (SLEEF, within 1 ulp) and XLA's (within half an ulp)
# round apart, and the quotient that follows carries it on (measured: 3 ulp,
# relative 2.44e-7, on 1 of 59,059 values), just past POW_RTOL (2**-22):
# four ulp of f32 there. On the card kernel and plain agree at POW_RTOL.
POW_RTOL_CPU = 2.0**-21
CASES = [(mode, bias_on, mask) for mode in MODES for bias_on in (False, True)
         for mask in MASKS]
# card only: K of several KB blocks that is no multiple of the kernel's
# 16-unit slabs, wide groups, and the executor's widest tile
CARD_SHAPES = [(2304 + 40, 256, 5, 100), (768, 2048, 2, 104), (4608, 4096, 1, 16)]
CARD_CASES = [(mode, True, mask, si) for si in range(len(CARD_SHAPES))
              for mode, mask in zip(MODES, ("allowed", "filter", "target"))]
# card only, the edges of the product's copy ring (3 slabs of 32 f32 / 64
# bf16 K rows, of 128 int8 K bytes): K shorter than the ring and than one
# slab (K 40, without the bias, so K1's product); K ending mid-ring and
# mid-slab (K 1,000) with int8 A rows 8 bytes off 16-byte alignment and an
# odd group width (tc 135 x 3), so that each mode takes its narrowest copies
CARD_SHAPES += [(40, 128, 2, 8), (1000, 135, 3, 24)]
CARD_CASES += [(mode, bias_on, mask, si)
               for si, bias_on in ((3, False), (4, True))
               for mode, mask in zip(MODES, ("filter", "target", "allowed"))]
# int8 over all of [-128, 127] (none zero) with an int32 bias near its
# extremes: |bias| within 1,000 of 2**31 - 1 - K * 128**2, the largest
# that no sum can carry past int32
CARD_FULL_RANGE = len(CARD_SHAPES)
CARD_SHAPES.append((768, 256, 2, 40))
CARD_CASES.append(("int8", True, "none", CARD_FULL_RANGE))
# bf16 with the bias on the wgmma kernel's edges: K ending mid-slab (16
# slabs of 64 K rows and 40) and a group width past a 128-wide block (600)
CARD_SHAPES.append((1064, 200, 3, 40))
CARD_CASES.append(("bf16", True, "filter", len(CARD_SHAPES) - 1))


def case_id(case) -> str:
    return "-".join(str(x) for x in case)


def make_case(mode, bias_on, mask, card_shape=None):
    """Inputs for one call, as numpy: operands, vectors, pvec, bias and
    masks."""
    mi, ki = MODES.index(mode), MASKS.index(mask)
    rng = np.random.default_rng(100 + 10 * mi + 2 * ki + bias_on)
    if card_shape is None:
        K, tc, n_tiles, k_pad = SHAPES[(mi + ki + bias_on) % len(SHAPES)]
    else:
        K, tc, n_tiles, k_pad = CARD_SHAPES[card_shape]
    cg = tc * n_tiles
    full_range = card_shape is not None and card_shape == CARD_FULL_RANGE
    flags, p = FLAG_SETS[(ki + 2 * bias_on + mi) % len(FLAG_SETS)]
    a, d, vecs = operands(rng, mode, TM, K, cg, full_range)
    if mode == "int8" and not full_range:  # mostly positive products, so thresholds keep some
        a, d = np.abs(a), np.abs(d)
    pv = np.zeros(16, np.float32)
    pv[:9] = p
    pv[9] = 0.25 if mode == "int8" else 1.0
    pv[10] = 5 * cg  # the group's column offset
    bias = None
    if bias_on:
        live = rng.random((TM, cg)) < 0.4
        if full_range:
            top = 2**31 - 1 - K * 128**2
            bias = rng.integers(top - 1000, top + 1, (TM, cg)) * rng.choice([-1, 1], (TM, cg))
            bias = bias.astype(np.int32)
        elif mode == "int8":
            bias = (rng.integers(-300, 301, (TM, cg)) * live).astype(np.int32)
        else:
            bias = (rng.random((TM, cg)) * 20 * live).astype(np.float32)
        # the hot prefix counts in the row norms, as in a real call
        vecs[0] = vecs[0] + np.abs(bias.astype(np.float32)).max(1)
    if mode == "int8":  # the norms of the scaled-back values (pv[9] = 1/s**2)
        vecs[0], vecs[3] = vecs[0] * pv[9], vecs[3] * pv[9]
    vecs[1], vecs[4] = np.sqrt(vecs[0]), np.sqrt(vecs[3])
    masks = {}
    if mask == "allowed":
        masks["allowed"] = (rng.random(cg) < 0.7).astype(np.uint8)
    elif mask == "filter":
        masks["fmask"] = (rng.random((TM, cg)) < 0.4).astype(np.uint8)
    elif mask == "target":
        masks["tmask"] = (rng.random((TM, cg)) < 0.4).astype(np.uint8)
    return a, d, vecs, pv, bias, masks, flags, k_pad, tc


def run_port(fn, mode, a, d, vecs, pv, bias, masks, flags, k_pad, tc, device="cpu"):
    dt = TORCH_DTYPES[mode]
    dev = torch.device(device)
    vals, idx = fn(
        torch.from_numpy(a).to(dev).to(dt), torch.from_numpy(d).to(dev).to(dt),
        *(torch.from_numpy(v).to(dev) for v in vecs), pvec_from_reference(pv, dev),
        bias=None if bias is None else torch.from_numpy(bias).to(dev),
        **{k: torch.from_numpy(v).to(dev) for k, v in masks.items()},
        flags=flags, k_pad=k_pad, tc=tc, int8_mode=mode == "int8",
    )
    return vals.cpu().numpy(), idx.cpu().numpy()


def as_k_rows(v):
    """(n_tiles, k_pad, TM) -> (k_pad, n_tiles * TM): one column per
    (tile, row), the layout torch_k1_cases.assert_same compares."""
    return v.transpose(1, 0, 2).reshape(v.shape[1], -1)


def assert_same_panel(mode, got, ref, flags, pow_rtol=POW_RTOL):
    """Per (tile, row), K1's comparison (torch_k1_cases.assert_same): equal
    finite slots; int8 bit-equal, or within `pow_rtol` through `pow`;
    f32/bf16 within rtol 1e-5 (sums in another order); ids equal where
    values are untied. The last slot is compared by value only: its lower
    neighbour is the best value left out, which the lists do not show, so
    a near-tie there (seen on the card: 1.3e-7 apart) may keep either."""
    (gv, gi), (rv, ri) = got, ref
    assert gv.shape == rv.shape and gi.shape == ri.shape
    gv, gi, rv, ri = map(as_k_rows, (gv, gi, rv, ri))
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    if mode == "int8" and not flags[3]:
        np.testing.assert_array_equal(gv[fin], rv[fin])
        rel = 0.0
    else:
        rel = pow_rtol if mode == "int8" else 1e-5
        np.testing.assert_allclose(gv[fin], rv[fin], rtol=rel, atol=0)
    ok = not_tied(rv, rel)
    ok[-1] = False
    np.testing.assert_array_equal(gi[ok], ri[ok])


# K4: (dtype, u_pad, cg, n): repeated and unsorted ids, u_pad - 1 among them;
# the last has rows of 1,030 bytes, whose starts are not 16-byte aligned
GATHER_CASES = [(dt, u, cg, n) for dt in MODES
                for u, cg, n in ((4096, 1024, 700), (300, 515, 1000))]


def gather_inputs(mode, u_pad, cg, n):
    """A dense table and the row ids to take from it, as numpy."""
    rng = np.random.default_rng(u_pad + cg + MODES.index(mode))
    if mode == "int8":
        table = rng.integers(-128, 128, (u_pad, cg)).astype(np.int8)
    else:
        table = rng.standard_normal((u_pad, cg)).astype(np.float32)
    idx = rng.integers(0, u_pad, n).astype(np.int32)
    idx[:3] = (u_pad - 1, 0, u_pad - 1)
    idx[n // 2] = idx[n // 2 + 1]
    return table, idx
