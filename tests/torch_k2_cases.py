"""K2 test cases shared by the CPU parity tests (the port's plain version
against the JAX kernel) and the card tests (the kernel against its plain
version). NumPy and PyTorch only: the card's machine has no JAX.

A case is one block of the symmetric executor: an anchor group of gt tiles
starting at tile a0 = 2 against inner tile t, with the vectors that a
self-similarity derives from the items (X and Y equal for a symmetric
epilogue, different for an asymmetric one).
"""

import zlib

import numpy as np
import torch

from similaripy_tpu_torch.convert import pvec_from_reference
from torch_k1_cases import POW_RTOL, TORCH_DTYPES, not_tied

MODES = ("f32", "bf16", "int8")
# where the inner tile lies against the anchor group (gt = 2, a0 = 2):
# "band": t = a0, the first anchor tile is diagonal and the second is dead
# (its rows pass the row carry through); "diagonal": t = a0 + 1, the first
# anchor tile feeds both sides and the second is diagonal (row side only);
# "live": t = a0 + 2, every row feeds both sides
BLOCKS = ("band", "diagonal", "live")
A0 = 2
# (flags, a1 l1 l2 l3 t1 t2 stab bayes threshold): cosine for the
# symmetric epilogue; tversky with depop and a power for the asymmetric one
EPILOGUES = {
    "sym": ((False, True, False, False, False, True), [1, 0, 1, 0, 1, 1, 0, 0, 0]),
    "asym": ((True, False, True, True, False, True), [0.8, 1, 0, 0.5, 0.7, 0.4, 0.5, 0, 0]),
}


def _case(mode, block, carry_on, epi, layout="3d", k=16, tc=128, gt=2, u=768, label="",
          full_range=False):
    return dict(mode=mode, block=block, carry_on=carry_on, epi=epi, layout=layout,
                k=k, tc=tc, gt=gt, u=u, label=label, full_range=full_range)


# CPU parity against the JAX kernel (interpret mode: u a multiple of its
# 768-wide K block, tc of its row block)
CASES = [
    _case(mode, block, carry_on, ("sym", "asym")[(bi + carry_on + mi) % 2],
          layout="2d" if (bi, carry_on) == (0, True) else "3d",
          tc=256 if block == "live" else 128)
    for mi, mode in enumerate(MODES)
    for bi, block in enumerate(BLOCKS)
    for carry_on in (False, True)
] + [_case(mode, "diagonal", True, "asym", k=136) for mode in MODES]  # k > tc
# a band that cuts a three-tile anchor group (t = a0 + 1: a live, a
# diagonal and a dead tile), and int8 values over all of [-128, 127]
CASES += [_case(mode, "cut", True, "sym", gt=3, label="band-cut") for mode in MODES]
CASES += [_case("int8", "live", True, "sym", label="full-range", full_range=True)]

# on the card only, at the widths of the main path: sw = 2,048 anchor rows
# (its tc, gt = 1), and sw = 18,432, more col-side candidates than one
# chunk of the kernel's shared memory (16,384)
CARD_CASES = [
    _case(mode, "live", carry_on, epi, tc=2048, gt=gt, u=512, k=100)
    for mode in MODES
    for carry_on, epi, gt in ((False, "sym", 1), (True, "asym", 9))
]
# on the card only, the edges of the kernels' copy ring (3 slabs of 32 K
# rows for f32 and bf16, of 128 K bytes for int8): K shorter than the ring
# (u 128 for int8, u 40 for every mode, which also ends inside a slab), K
# that ends mid-ring and mid-slab (u 1,000: 32 and 8 slabs), a band that
# cuts the anchor group (gt 3, t = a0 + 1: a live, a diagonal and a dead
# tile), the asymmetric epilogue on a diagonal block at tc 2,048, a band
# whose second anchor tile is dead, three column blocks and K ending
# mid-slab (u 136: the bf16 wgmma kernel's 64-row slabs); and int8
# values over all of [-128, 127] at u 4,096, where no int32 sum can
# overflow (a u8 or a PRMT selector slip changes the products). tc 128 and
# 384 leave the int8 kernel's last 256-wide column block half empty.
CARD_CASES += [
    _case(mode, block, carry_on, epi, tc=tc, gt=gt, u=u, k=k, label=label)
    for mode in MODES
    for label, block, carry_on, epi, tc, gt, u, k in (
        ("ring-short-u128", "live", False, "sym", 256, 2, 128, 24),
        ("ring-short-u40", "diagonal", True, "asym", 128, 2, 40, 16),
        ("mid-ring-u1000", "live", True, "sym", 384, 2, 1000, 40),
        ("band-cut-gt3", "cut", True, "sym", 256, 3, 512, 32),
        ("asym-diagonal-tc2048", "diagonal", False, "asym", 2048, 2, 640, 100),
        ("band-u136-tc384", "band", True, "sym", 384, 2, 136, 24),
    )
] + [_case("int8", "live", True, "sym", tc=512, gt=2, u=4096, k=64, label="full-range",
           full_range=True)]


# the split-bf16x3 mode (precision='high' on f32 data, mode "split": f32
# items whose anchors and tiles go to K2 as split_bf16x3 stacks along the
# user axis). CPU parity against the JAX kernel: every block kind, cold and
# warm, both epilogues, the anchors as tiles and as a row panel
SPLIT_CASES = [
    _case("split", block, carry_on, ("sym", "asym")[(bi + carry_on) % 2],
          layout="2d" if (bi, carry_on) == (0, True) else "3d",
          tc=256 if block == "live" else 128)
    for bi, block in enumerate(BLOCKS)
    for carry_on in (False, True)
] + [_case("split", "cut", True, "sym", gt=3, label="band-cut")]
# on the card only: the main path's widths (sw = 2,048, gt 1; sw = 18,432,
# gt 9, warm and asymmetric), the ring's edges (K shorter than one slab of
# 64 K rows; K ending mid-ring and mid-slab), a diagonal block with the
# asymmetric epilogue at tc 2,048, a band that cuts the anchor group, and a
# band with a dead anchor tile, three column blocks and K ending mid-slab. Kernel against plain version: the same exact bf16 products
# summed in f32 in another order (rtol as the f32 cases, 1e-5)
SPLIT_CARD_CASES = [
    _case("split", "live", carry_on, epi, tc=2048, gt=gt, u=512, k=100)
    for carry_on, epi, gt in ((False, "sym", 1), (True, "asym", 9))
] + [
    _case("split", block, carry_on, epi, tc=tc, gt=gt, u=u, k=k, label=label)
    for label, block, carry_on, epi, tc, gt, u, k in (
        ("ring-short-u40", "diagonal", True, "asym", 128, 2, 40, 16),
        ("mid-ring-u1000", "live", True, "sym", 384, 2, 1000, 40),
        ("band-cut-gt3", "cut", True, "sym", 256, 3, 512, 32),
        ("asym-diagonal-tc2048", "diagonal", False, "asym", 2048, 2, 640, 100),
        ("band-u136-tc384", "band", True, "sym", 384, 2, 136, 24),
    )
]


def case_id(c) -> str:
    return (f"{c['mode']}-{c['block']}-{'warm' if c['carry_on'] else 'cold'}-{c['epi']}"
            f"-{c['layout']}-k{c['k']}-tc{c['tc']}-gt{c['gt']}"
            + (f"-{c['label']}" if c.get("label") else ""))


def _items(rng, mode, u, n, full_range=False):
    """n item columns over u users (the dense tiles' (u, n) layout);
    full_range: int8 values drawn from all of [-128, 127], none zero."""
    if mode == "int8" and full_range:
        return rng.integers(-128, 128, (u, n)).astype(np.int8)
    if mode == "int8":
        x = rng.integers(-6, 7, (u, n)) * (rng.random((u, n)) < 0.3)
        return x.astype(np.int8)
    x = (rng.random((u, n)) * (rng.random((u, n)) < 0.3)).astype(np.float32)
    if mode == "bf16":  # values the bf16 operands hold exactly
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _vectors(rng, items, epi):
    """X and Y (t, c, d) per item: equal for the symmetric epilogue,
    different (c and d) for the asymmetric one."""
    sq = (items.astype(np.float32) ** 2).sum(0).astype(np.float32)
    n = sq.shape[0]
    x = [sq, np.sqrt(sq), (rng.random(n) + 0.5).astype(np.float32)]
    if epi == "sym":
        return x, [v.copy() for v in x]
    y = [sq, (sq ** 0.3).astype(np.float32), (rng.random(n) + 0.5).astype(np.float32)]
    return x, y


def make_inputs(c, fn):
    """The call's arguments as numpy, with warm carries made by `fn` (the
    implementation under test) from other blocks. Returns (args, kwargs)."""
    mode, tc, gt, u, k = c["mode"], c["tc"], c["gt"], c["u"], c["k"]
    rng = np.random.default_rng(zlib.crc32(case_id(c).encode()))
    sw = gt * tc
    # "cut": t = a0 + 1, the band cuts the group after its second tile
    t = A0 + {"band": 0, "diagonal": gt - 1, "live": gt, "cut": 1}[c["block"]]
    full = c.get("full_range", False)
    # items of tiles A0 .. A0 + gt (anchors, then one tile right of them)
    items = _items(rng, mode, u, (gt + 1) * tc, full)
    X, Y = _vectors(rng, items, c["epi"])
    anchors = items[:, :sw]
    d = items[:, (t - A0) * tc:(t - A0 + 1) * tc]
    a3 = np.ascontiguousarray(anchors.reshape(u, gt, tc).transpose(1, 0, 2))
    a = a3 if c["layout"] == "3d" else np.ascontiguousarray(anchors.T)
    sel_a, sel_t = slice(0, sw), slice((t - A0) * tc, (t - A0 + 1) * tc)
    flags, p = EPILOGUES[c["epi"]]
    pv = np.zeros(16, np.float32)
    pv[:9] = p
    pv[9] = 0.25 if mode == "int8" else 1.0

    def pvec(t_, a0_):
        out = pv.copy()
        out[10:14] = (t_ * tc, a0_ * tc, t_, a0_)
        return out

    asym = c["epi"] == "asym"
    kw = dict(flags=flags, k=k, tc=tc, int8_mode=mode == "int8")
    k_pad = -(-k // 8) * 8
    crv = np.full((k_pad, sw), -np.inf, np.float32)
    cri = np.zeros((k_pad, sw), np.int32)
    ccv = np.full((k_pad, tc), -np.inf, np.float32)
    cci = np.zeros((k_pad, tc), np.int32)
    if c["carry_on"]:
        # row carry: the anchors against another tile far right of them;
        # col carry: another anchor group left of A0 against this tile
        other = _items(rng, mode, u, tc, full)
        Xo, Yo = _vectors(rng, other, c["epi"])
        far = A0 + gt + 3
        crv, cri, _, _ = fn(
            a, other, *[v[sel_a] for v in X], *Yo, crv, cri, crv[-1].reshape(sw, 1), ccv,
            cci, pvec(far, A0), x2=tuple(Xo) if asym else None,
            y2=tuple(v[sel_a] for v in Y) if asym else None, **kw)
        left = _items(rng, mode, u, sw, full)
        Xl, Yl = _vectors(rng, left, c["epi"])
        left_a = (np.ascontiguousarray(left.reshape(u, gt, tc).transpose(1, 0, 2))
                  if c["layout"] == "3d" else np.ascontiguousarray(left.T))
        _, _, ccv, cci = fn(
            left_a, d, *Xl, *[v[sel_t] for v in Y], np.full((k_pad, sw), -np.inf, np.float32),
            np.zeros((k_pad, sw), np.int32), np.full((sw, 1), -np.inf, np.float32), ccv, cci,
            pvec(t, A0 - gt), x2=tuple(v[sel_t] for v in X) if asym else None,
            y2=tuple(Yl) if asym else None, **kw)
    args = (a, d, *[v[sel_a] for v in X], *[v[sel_t] for v in Y], crv, cri,
            np.ascontiguousarray(crv[-1].reshape(sw, 1)), ccv, cci, pvec(t, A0))
    if asym:
        kw["x2"] = tuple(v[sel_t] for v in X)
        kw["y2"] = tuple(v[sel_a] for v in Y)
    return args, kw


def kmajor_operands(a, d):
    """int8 anchors (gt, u, tc) or (sw, u) and tile (u, tc) as K2's kernel
    takes them, K-major: the anchors a contiguous (sw, u16) stack and the
    tile the (u16, tc) transposed view of a contiguous (tc, u16) tile, the
    user axis zero-padded to u16, a multiple of 16 (the kernel's row
    stride), which changes no product."""
    rows = a if a.dim() == 2 else a.transpose(1, 2).reshape(-1, a.shape[1])
    u, tc = d.shape
    u16 = -(-u // 16) * 16
    a_k = torch.zeros((rows.shape[0], u16), dtype=a.dtype, device=a.device)
    d_k = torch.zeros((tc, u16), dtype=d.dtype, device=d.device)
    a_k[:, :u], d_k[:, :u] = rows, d.T
    return a_k, d_k.T


def torch_fn(fn, mode, device="cpu"):
    """`fn` (fused_sym_topk or its plain version) over numpy arguments on
    `device`, returning numpy; mode "split" hands it the split_bf16x3
    stacks of f32 anchors and tile, mode "int8" the K-major operands
    (kmajor_operands)."""
    dt = TORCH_DTYPES.get(mode, torch.float32)
    dev = torch.device(device)

    def call(a, d, *rest, x2=None, y2=None, **kw):
        def tt(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        ta, td = tt(a).to(dt), tt(d).to(dt)
        if mode == "int8":
            ta, td = kmajor_operands(ta, td)
        if mode == "split":
            from similaripy_tpu_torch.engine.tile_topk import split_bf16x3

            # the user axis: 1 of (gt, u, tc) tiles and of an (sw, u) panel
            ta, td = split_bf16x3(ta, 1), split_bf16x3(td, 0)
            kw["split_f32"] = True
        vecs, (crv, cri, rkth, ccv, cci, pv) = rest[:6], rest[6:]
        out = fn(ta, td, *map(tt, vecs), tt(crv), tt(cri), tt(rkth),
                 tt(ccv), tt(cci), pvec_from_reference(pv, dev),
                 x2=None if x2 is None else tuple(map(tt, x2)),
                 y2=None if y2 is None else tuple(map(tt, y2)), **kw)
        return tuple(o.cpu().numpy() for o in out)

    return call


def assert_same(mode, got, ref, flags, split_rtol=1e-5):
    """Both sides: equal finite slots; int8 bit-equal (through pow:
    POW_RTOL), f32, bf16 and split within rtol 1e-5 (sums in another
    order; split at `split_rtol`, which the full-width check in
    chip_smoke.py widens as torch_k1_cases.SPLIT_RTOL_FULL_K says); ids
    equal where values are not tied (for split, not in the last slot
    either: its lower neighbour, the first value the top-k drops, is not
    in the output, and the split kernel's f32 sums differ from the plain
    version's by up to a few 1e-6, so a near-tie across the cut can swap
    an id there)."""
    for side, (gv, gi), (rv, ri) in (("row", got[:2], ref[:2]), ("col", got[2:], ref[2:])):
        assert gv.shape == rv.shape and gi.shape == ri.shape, side
        fin = np.isfinite(rv)
        np.testing.assert_array_equal(np.isfinite(gv), fin, err_msg=side)
        if mode == "int8" and not flags[3]:
            np.testing.assert_array_equal(gv[fin], rv[fin], err_msg=side)
            rel = 0.0
        else:
            rel = POW_RTOL if mode == "int8" else split_rtol if mode == "split" else 1e-5
            np.testing.assert_allclose(gv[fin], rv[fin], rtol=rel, atol=0, err_msg=side)
        ok = not_tied(rv, rel)
        if mode == "split":
            ok[-1] = False
        bad = np.argwhere(ok & (gi != ri))
        assert bad.size == 0, f"{side}: ids differ at untied (slot, row) {bad[:8].tolist()}"
