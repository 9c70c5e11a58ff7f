"""K1 test cases shared by the CPU parity tests (against the JAX kernel)
and the card tests (kernel against its plain version). NumPy and PyTorch
only: the card's machine has no JAX."""

import numpy as np
import torch

from similaripy_tpu_torch.convert import pvec_from_reference

MODES = ("f32", "bf16", "int8")
MASKS = ("none", "allowed", "filter", "target")
CASES = [
    (mode, carry_on, mask)
    for mode in MODES for carry_on in (False, True) for mask in MASKS
]
# (flags, a1 l1 l2 l3 t1 t2 stab bayes threshold): cosine, raw dot,
# tversky + depop + power, bayesian-shrunk cosine with a threshold
FLAG_SETS = [
    ((False, True, False, False, False, True), [1, 0, 1, 0, 1, 1, 0, 0, 0]),
    ((False, False, False, False, False, False), [1, 0, 0, 0, 1, 1, 0, 0, 0]),
    ((True, False, True, True, False, True), [0.8, 1, 0, 0.5, 0.7, 0.4, 0.5, 0, 0]),
    ((False, True, False, False, True, True), [1, 0, 1, 0, 1, 1, 0.1, 2.0, 0.05]),
]
# (trp, u_pad, tc, k_pad): trp a multiple of tm=8, u_pad of kb=128 (the JAX
# kernel's block constraints); the last has k_pad > tc
SHAPES = [(16, 256, 200, 8), (24, 384, 130, 40), (8, 128, 96, 104)]
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
# card only, the edges of the product's copy ring (3 slabs of 32 f32 / 64
# bf16 K rows, of 128 int8 K bytes) and of its blocks (128 rows; 128
# columns, 256 for int8), as (label, (trp, u, tc, k_pad)): K shorter than
# the ring and than one slab in every mode, with fewer rows than a block;
# M = 256 exactly with K ending mid-ring and mid-slab, whose int8 A rows are
# 8 bytes off 16-byte alignment (u % 16 = 8) and whose D rows are not even
# 4-byte aligned (tc 250), so each mode takes its narrow copies; and the
# executor's widest tile (tc 8,192, KERNEL_MAX_TC)
CARD_SHAPES = [("ring-short", (40, 40, 96, 16)), ("m256-mid-ring", (256, 1000, 250, 40)),
               ("widest-tc", (136, 384, 8192, 104))]
CARD_CASES = [(mode, carry_on, mask, label)
              for (label, _), (carry_on, mask) in zip(
                  CARD_SHAPES, ((True, "filter"), (False, "allowed"), (True, "target")))
              for mode in MODES]
# int8 over all of [-128, 127] (none zero): a u8 or a selector slip in the
# product changes the sums; K 4,096 keeps every int32 sum exact
CARD_CASES += [("int8", True, "none", "full-range")]
CARD_SHAPES.append(("full-range", (128, 4096, 512, 64)))

# int8 products are exact everywhere, so int8 values are bit-equal -- except
# through `pow`, which each implementation takes from its own math library
# and which may round the last bit differently: two ulp of f32 there
POW_RTOL = 2.0**-22


def operands(rng, mode, trp, u, tc, full_range=False):
    """A panel, a tile, and the vectors an S-Plus call derives from them
    (squared norms, their square roots, positive depop weights);
    full_range: int8 values drawn from all of [-128, 127], none zero."""
    if mode == "int8" and full_range:
        a = rng.integers(-128, 127, (trp, u)).astype(np.int8)
        a[a >= 0] += 1
        d = rng.integers(-128, 127, (u, tc)).astype(np.int8)
        d[d >= 0] += 1
    elif mode == "int8":
        a = (rng.integers(-6, 7, (trp, u)) * (rng.random((trp, u)) < 0.3)).astype(np.int8)
        d = (rng.integers(-6, 7, (u, tc)) * (rng.random((u, tc)) < 0.3)).astype(np.int8)
    else:
        a = (rng.random((trp, u)) * (rng.random((trp, u)) < 0.3)).astype(np.float32)
        d = (rng.random((u, tc)) * (rng.random((u, tc)) < 0.3)).astype(np.float32)
        if mode == "bf16":  # values the bf16 operands hold exactly
            a = torch.from_numpy(a).bfloat16().float().numpy()
            d = torch.from_numpy(d).bfloat16().float().numpy()
    xt = (a.astype(np.float32) ** 2).sum(1).astype(np.float32)
    yt = (d.astype(np.float32) ** 2).sum(0).astype(np.float32)
    xd = (rng.random(trp) + 0.5).astype(np.float32)
    yd = (rng.random(tc) + 0.5).astype(np.float32)
    return a, d, [xt, np.sqrt(xt), xd, yt, np.sqrt(yt), yd]


def make_case(mode, carry_on, mask, carry_fn, label=None):
    """Inputs for one call, as numpy: operands, vectors, pvec, masks and a
    real carry, `carry_fn`'s top-k of another tile of ids. `label` names a
    card case (CARD_SHAPES)."""
    mi, ki = MODES.index(mode), MASKS.index(mask)
    full_range = label == "full-range"
    if label is None:
        rng = np.random.default_rng(10 * mi + 2 * ki + carry_on)
        trp, u, tc, k_pad = SHAPES[(mi + ki + carry_on) % len(SHAPES)]
    else:
        li = [name for name, _ in CARD_SHAPES].index(label)
        rng = np.random.default_rng(1000 + 10 * li + mi)
        trp, u, tc, k_pad = dict(CARD_SHAPES)[label]
    flags, p = FLAG_SETS[(ki + 2 * carry_on + mi) % len(FLAG_SETS)]
    a, d, vecs = operands(rng, mode, trp, u, tc, full_range)
    pv = np.zeros(16, np.float32)
    pv[:9] = p
    pv[9] = 0.25 if mode == "int8" else 1.0
    if label is not None and mode == "int8":  # the norms of the scaled-back values
        for i in (0, 3):
            vecs[i] = vecs[i] * pv[9]
            vecs[i + 1] = np.sqrt(vecs[i])
    pv[10] = 3 * tc
    masks = {}
    if mask == "allowed":
        masks["allowed"] = (rng.random(tc) < 0.7).astype(np.uint8)
    elif mask == "filter":
        masks["fmask"] = (rng.random((trp, tc)) < 0.4).astype(np.uint8)
    elif mask == "target":
        masks["tmask"] = (rng.random((trp, tc)) < 0.4).astype(np.uint8)
    carry = None
    if carry_on:
        _, d2, vecs2 = operands(rng, mode, trp, u, tc, full_range)
        pv0 = pv.copy()
        pv0[10] = 0
        carry = carry_fn(mode, a, d2, vecs[:3] + vecs2[3:], pv0, masks, None, flags, k_pad)
    return a, d, vecs, pv, masks, carry, flags, k_pad


def run_port(fn, mode, a, d, vecs, pv, masks, carry, flags, k_pad, device="cpu"):
    dt = TORCH_DTYPES[mode]
    dev = torch.device(device)
    vals, idx = fn(
        torch.from_numpy(a).to(dev).to(dt), torch.from_numpy(d).to(dev).to(dt),
        *(torch.from_numpy(v).to(dev) for v in vecs), pvec_from_reference(pv, dev),
        **{k: torch.from_numpy(v).to(dev) for k, v in masks.items()},
        carry=None if carry is None else tuple(torch.from_numpy(c).to(dev) for c in carry),
        flags=flags, k_pad=k_pad, int8_mode=mode == "int8",
    )
    return vals.cpu().numpy(), idx.cpu().numpy()


def not_tied(v, rel):
    """(k, rows) mask of finite values clear of both neighbours."""
    out = np.isfinite(v)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(v, axis=0)) > rel * np.maximum(np.abs(v[1:]), 1e-30)
    out[1:] &= gap
    out[:-1] &= gap
    return out


def assert_same(mode, got, ref, flags):
    """Equal finite slots; int8 bit-equal (pow: POW_RTOL), f32/bf16 within
    rtol 1e-5 (sums in another order); ids equal where values are untied."""
    (gv, gi), (rv, ri) = got, ref
    assert gv.shape == rv.shape and gi.shape == ri.shape
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    if mode == "int8" and not flags[3]:
        np.testing.assert_array_equal(gv[fin], rv[fin])
        rel = 0.0
    else:
        rel = POW_RTOL if mode == "int8" else 1e-5
        np.testing.assert_allclose(gv[fin], rv[fin], rtol=rel, atol=0)
    np.testing.assert_array_equal(gi[not_tied(rv, rel)], ri[not_tied(rv, rel)])
