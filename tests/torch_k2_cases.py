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


def _case(mode, block, carry_on, epi, layout="3d", k=16, tc=128, gt=2, u=768):
    return dict(mode=mode, block=block, carry_on=carry_on, epi=epi, layout=layout,
                k=k, tc=tc, gt=gt, u=u)


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

# on the card only, at the widths of the main path: sw = 2,048 anchor rows
# (its tc, gt = 1), and sw = 18,432, more col-side candidates than one
# chunk of the kernel's shared memory (16,384)
CARD_CASES = [
    _case(mode, "live", carry_on, epi, tc=2048, gt=gt, u=512, k=100)
    for mode in MODES
    for carry_on, epi, gt in ((False, "sym", 1), (True, "asym", 9))
]


def case_id(c) -> str:
    return (f"{c['mode']}-{c['block']}-{'warm' if c['carry_on'] else 'cold'}-{c['epi']}"
            f"-{c['layout']}-k{c['k']}-tc{c['tc']}-gt{c['gt']}")


def _items(rng, mode, u, n):
    """n item columns over u users (the dense tiles' (u, n) layout)."""
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
    t = A0 + {"band": 0, "diagonal": gt - 1, "live": gt}[c["block"]]
    # items of tiles A0 .. A0 + gt (anchors, then one tile right of them)
    items = _items(rng, mode, u, (gt + 1) * tc)
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
        other = _items(rng, mode, u, tc)
        Xo, Yo = _vectors(rng, other, c["epi"])
        far = A0 + gt + 3
        crv, cri, _, _ = fn(
            a, other, *[v[sel_a] for v in X], *Yo, crv, cri, crv[-1].reshape(sw, 1), ccv,
            cci, pvec(far, A0), x2=tuple(Xo) if asym else None,
            y2=tuple(v[sel_a] for v in Y) if asym else None, **kw)
        left = _items(rng, mode, u, sw)
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


def torch_fn(fn, mode, device="cpu"):
    """`fn` (fused_sym_topk or its plain version) over numpy arguments on
    `device`, returning numpy."""
    dt = TORCH_DTYPES[mode]
    dev = torch.device(device)

    def call(a, d, *rest, x2=None, y2=None, **kw):
        def tt(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        vecs, (crv, cri, rkth, ccv, cci, pv) = rest[:6], rest[6:]
        out = fn(tt(a).to(dt), tt(d).to(dt), *map(tt, vecs), tt(crv), tt(cri), tt(rkth),
                 tt(ccv), tt(cci), pvec_from_reference(pv, dev),
                 x2=None if x2 is None else tuple(map(tt, x2)),
                 y2=None if y2 is None else tuple(map(tt, y2)), **kw)
        return tuple(o.cpu().numpy() for o in out)

    return call


def assert_same(mode, got, ref, flags):
    """Both sides: equal finite slots; int8 bit-equal (through pow:
    POW_RTOL), f32 and bf16 within rtol 1e-5 (sums in another order); ids
    equal where values are not tied."""
    for side, (gv, gi), (rv, ri) in (("row", got[:2], ref[:2]), ("col", got[2:], ref[2:])):
        assert gv.shape == rv.shape and gi.shape == ri.shape, side
        fin = np.isfinite(rv)
        np.testing.assert_array_equal(np.isfinite(gv), fin, err_msg=side)
        if mode == "int8" and not flags[3]:
            np.testing.assert_array_equal(gv[fin], rv[fin], err_msg=side)
            rel = 0.0
        else:
            rel = POW_RTOL if mode == "int8" else 1e-5
            np.testing.assert_allclose(gv[fin], rv[fin], rtol=rel, atol=0, err_msg=side)
        ok = not_tied(rv, rel)
        np.testing.assert_array_equal(gi[ok], ri[ok], err_msg=side)
