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
# the wgmma kernel's edges (bf16 with 16-byte rows): M and N past a 128 x
# 128 block's edge, K ending mid-slab (two slabs of 64 K rows and 8)
CARD_SHAPES.append(("wgmma-edges", (200, 136, 264, 40)))
CARD_CASES += [(mode, True, "allowed", "wgmma-edges") for mode in MODES]


def product_kernel(mode, K, N):
    """The product kernel (tile_topk.PRODUCT_KERNELS) that a K1 or K3 launch
    takes for operands at PyTorch's 256-byte aligned bases, with rows of K
    (A) and N (D) elements (csrc/tile_kernels.cuh: product_kernel): bf16
    and the split modes on wgmma when both rows are 16-byte multiples."""
    if mode == "f32":
        return "simt"
    if mode == "int8":
        return "mma.sync s8"
    wide = (2 * K) % 16 == 0 and (2 * N) % 16 == 0
    return "wgmma bf16" if wide or mode in ("both", "rhs", "lhs") else "mma.sync bf16"


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


# ---------------------------------------------------------------------------
# the split-bf16x3 modes (precision='high' on f32 data): the f32 side(s) go
# to K1 as split_bf16x3 stacks, a side that bf16 holds exactly as a plain
# bf16 operand ('rhs': the panel, 'lhs': the tile)
# ---------------------------------------------------------------------------

SPLITS = ("both", "rhs", "lhs")
# CPU parity against the JAX kernel: every mode x carry x mask, on SHAPES
SPLIT_CASES = [(split, carry_on, mask)
               for split in SPLITS for carry_on in (False, True) for mask in MASKS]
# card only, as CARD_SHAPES for the split kernels, which take 16-byte rows
# (u and tc multiples of 8): K shorter than one slab of 64 K rows, with
# fewer rows than a block; M = 256 with K ending mid-ring and mid-slab and a
# ragged last column block; the executor's widest tile; M, N and K all past
# a block's or slab's edge
SPLIT_CARD_SHAPES = [("split-ring-short", (40, 40, 96, 16)),
                     ("split-m256-mid-ring", (256, 1000, 264, 40)),
                     ("split-widest-tc", (136, 384, 8192, 104)),
                     ("split-wgmma-edges", (200, 136, 264, 40))]
SPLIT_CARD_CASES = [(split, carry_on, mask, label)
                    for (label, _), (carry_on, mask) in zip(
                        SPLIT_CARD_SHAPES, ((True, "filter"), (False, "allowed"), (True, "target"),
                                            (True, "allowed")))
                    for split in SPLITS]
# kernel against plain version on the card: both sum the same exact bf16
# products in f32, in another order (rtol as the f32 cases; these cases
# measured at most 5.9e-07 relative in chip_smoke.py on an H100 80GB HBM3
# at 700 W)
SPLIT_RTOL = 1e-5
# the same at the main path's depth (K 200,960: the kernel adds 3,140
# slabs' partial sums to its f32 total, each rounded; the plain version's
# library products sum in another order): measured 1.03e-05 relative at
# the 1,024-item cosine tile in mode 'both' (one value of 106,496) in
# chip_smoke.py on an H100 80GB HBM3 at 700 W
SPLIT_RTOL_FULL_K = 3e-5


def split_card_ok(split, carry_on, mask):
    """Whether a CPU parity case also fits the split kernels' 16-byte
    copies (u and tc multiples of 8), so that the card runs it too."""
    si, ki = SPLITS.index(split), MASKS.index(mask)
    _, u, tc, _ = SHAPES[(si + ki + carry_on) % len(SHAPES)]
    return u % 8 == 0 and tc % 8 == 0


def assert_same_split(got, ref, flags, rtol=SPLIT_RTOL):
    """assert_same for a split mode, kernel against plain version: values
    at `rtol` in every slot, ids where the values are not tied, except the
    last slot, whose lower neighbour (the first value the top-k drops) is
    not in the output, so a near-tie across the cut cannot be seen."""
    (gv, gi), (rv, ri) = got, ref
    assert gv.shape == rv.shape and gi.shape == ri.shape
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], rv[fin], rtol=rtol, atol=0)
    ok = not_tied(rv, rtol)
    ok[-1] = False
    bad = np.argwhere(ok & (gi != ri))
    assert bad.size == 0, f"ids differ at untied (slot, row) {bad[:8].tolist()}"


def make_split_case(split, carry_on, mask, carry_fn, label=None):
    """make_case for a split mode: f32 operands (not exact in bf16), the
    side that the mode leaves whole rounded to bf16 values; `carry_fn`
    takes (split, a, d, vecs, pv, masks, carry, flags, k_pad)."""
    si, ki = SPLITS.index(split), MASKS.index(mask)
    if label is None:
        rng = np.random.default_rng(500 + 10 * si + 2 * ki + carry_on)
        trp, u, tc, k_pad = SHAPES[(si + ki + carry_on) % len(SHAPES)]
    else:
        li = [name for name, _ in SPLIT_CARD_SHAPES].index(label)
        rng = np.random.default_rng(2000 + 10 * li + si)
        trp, u, tc, k_pad = dict(SPLIT_CARD_SHAPES)[label]
    flags, p = FLAG_SETS[(ki + 2 * carry_on + si) % len(FLAG_SETS)]

    def operands_of(rng):
        a, d, vecs = operands(rng, "f32", trp, u, tc)
        if split == "rhs":
            a = torch.from_numpy(a).bfloat16().float().numpy()
        if split == "lhs":
            d = torch.from_numpy(d).bfloat16().float().numpy()
        return a, d, vecs

    a, d, vecs = operands_of(rng)
    pv = np.zeros(16, np.float32)
    pv[:9] = p
    pv[9] = 1.0
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
        _, d2, vecs2 = operands_of(rng)
        pv0 = pv.copy()
        pv0[10] = 0
        carry = carry_fn(split, a, d2, vecs[:3] + vecs2[3:], pv0, masks, None, flags, k_pad)
    return a, d, vecs, pv, masks, carry, flags, k_pad


def split_operands(split, a, d, device="cpu"):
    """The bf16 operands of a split mode from f32 numpy a (trp, u) and d
    (u, tc): split_bf16x3 stacks of the split side(s), a bf16 cast of the
    other."""
    from similaripy_tpu_torch.engine.tile_topk import split_bf16x3

    ta, td = torch.from_numpy(a).to(device), torch.from_numpy(d).to(device)
    ta = split_bf16x3(ta, 1) if split in ("both", "lhs") else ta.bfloat16()
    td = split_bf16x3(td, 0) if split in ("both", "rhs") else td.bfloat16()
    return ta, td


def run_port_split(fn, split, a, d, vecs, pv, masks, carry, flags, k_pad, device="cpu"):
    dev = torch.device(device)
    ta, td = split_operands(split, a, d, dev)
    vals, idx = fn(
        ta, td, *(torch.from_numpy(v).to(dev) for v in vecs), pvec_from_reference(pv, dev),
        **{k: torch.from_numpy(v).to(dev) for k, v in masks.items()},
        carry=None if carry is None else tuple(torch.from_numpy(c).to(dev) for c in carry),
        flags=flags, k_pad=k_pad, int8_mode=False, split_f32=split,
    )
    return vals.cpu().numpy(), idx.cpu().numpy()
