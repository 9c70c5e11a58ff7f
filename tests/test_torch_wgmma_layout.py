"""A NumPy model of the wgmma products of K1/K3 (tile_wgmma_kernel in
similaripy_tpu_torch/csrc/tile_kernels.cuh) and K2 (sym_wgmma_kernel in
csrc/sym_topk.cu), built on csrc/hopper.cuh, which no CPU can run.

The model loads each slab's boxes as TMA does (a tensor map's box, elements
past a dimension's end zero-filled, 128-byte rows with the 16-byte chunks
XOR-swizzled by the row), reads each k16 step's operands through the wgmma
descriptors the kernels build (K-major and MN-major, their start offsets,
LBO and SBO), multiplies every phase of a split mode into a per-slab
partial added to the total, and writes through the accumulator fragment's
row and column maps. It checks that the descriptors name the element TMA
put there for every (row, k) of a slab, that the split stacks' 3D and 4D
maps zero-fill past K and never read the other half, that the grid and
its cluster pairs (two column blocks sharing A's multicast boxes) cover
every output block once and skip K2's rows below the band, that every
output cell is written once with the product, and that every ring fits in
shared memory.
"""

import numpy as np
import pytest

# the constants of hopper.cuh and the kernels' blocks
BM, BN, WG_BK = 128, 128, 64
WG_THREADS, WG_CONSUMERS = 288, 256
BOX_BYTES, HALF_BYTES, RING_BYTES = 64 * 64 * 2, 2 * 64 * 64 * 2, 192 * 1024
MAX_SMEM = 232_448  # a block's dynamic shared memory on an H100
SBO = 1024
# the split modes: (A has a lo half, D has a lo half), phases in the order
# wgmma_block issues them
SPLITS = {"none": (False, False), "both": (True, True), "rhs": (False, True),
          "lhs": (True, False)}


def ring(split):
    """WgmmaRing<SPLIT>: (A halves, D halves, slab bytes, stages, smem)."""
    a_lo, d_lo = SPLITS[split]
    ha, hd = 1 + a_lo, 1 + d_lo
    nbytes = (ha + hd) * HALF_BYTES
    stages = RING_BYTES // nbytes
    return ha, hd, nbytes, stages, 1024 + stages * nbytes + 2 * stages * 8


def swizzle(addr):
    """CU_TENSOR_MAP_SWIZZLE_128B and the wgmma layout type 1 on an address
    inside a 1024-byte-aligned atom: 16-byte chunk bits 4-6 XOR row bits
    7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(smem, dst, src, coords, box):
    """One box of the tensor `src` (indexed outermost first, as NumPy
    stores it) at tensor-map coordinates `coords` (innermost first) into
    the element array `smem` at byte `dst`: 128-byte rows of the innermost
    64 elements, one after another over the outer box dims; elements past
    an end read as zeros. Returns the byte addresses written."""
    assert dst % 1024 == 0 and box[0] * 2 == 128
    rank = len(box)
    grids = np.meshgrid(*[np.arange(b) for b in reversed(box)], indexing="ij")
    idx = [g.ravel() + coords[rank - 1 - i] for i, g in enumerate(grids)]  # outermost first
    inside = np.ones(idx[0].shape, bool)
    for ax, ix in enumerate(idx):
        inside &= ix < src.shape[ax]
    vals = np.zeros(idx[0].shape)
    vals[inside] = src[tuple(ix[inside] for ix in idx)]
    row, col = np.divmod(np.arange(vals.size), box[0])
    addr = swizzle(dst + row * 128 + 2 * col)
    smem[addr // 2] = vals
    return addr


def desc_read(smem, start, lbo, major, mn, k):
    """The elements that a wgmma operand descriptor (layout type 1, SBO
    1024, LBO `lbo`) names at operand coordinates (mn, k), mn over the
    operand's M or N and k over one k16 step, as broadcast index arrays."""
    if major == "K":
        off = start + (mn % 8) * 128 + (mn // 8) * SBO + 2 * k
    else:
        off = start + 2 * (mn % 64) + (mn // 64) * lbo + (k % 8) * 128 + (k // 8) * SBO
    return smem[swizzle(off) // 2]


def stack(x, halves, axis):
    """x's [hi; lo] stack along `axis` as the kernels receive it, with the
    lo half a different value of each element (here: hi + 1000)."""
    if halves == 1:
        return x
    return np.concatenate([x, x + 1000.0], axis=axis)


# ---------------------------------------------------------------------------
# K1 / K3: A (M x H_A K) K-major, D (H_D K x N) MN-major
# ---------------------------------------------------------------------------


def k1_stage(a, d, K, split, m0, n0, s):
    """One slab of tile_wgmma_kernel: the pair's loads (ta: (K, H_A, M)
    boxes {64, 1, 64} at m0, m0 + 64, one from each block of the pair;
    td: (N, K, H_D) boxes {64, 64, 1} at n0, n0 + 64)."""
    ha, hd, nbytes, _, _ = ring(split)
    M, N = a.shape[0], d.shape[1]
    a3 = a.reshape(M, ha, K)  # outermost first: (M, H, K)
    d3 = d.reshape(hd, K, N)
    smem = np.full(nbytes // 2, np.nan)
    written = []
    k0 = s * WG_BK
    for h in range(ha):
        for rank in range(2):
            written.append(tma_box(smem, h * HALF_BYTES + rank * BOX_BYTES, a3,
                                   (k0, h, m0 + 64 * rank), (64, 1, 64)))
    for h in range(hd):
        for j in range(2):
            written.append(tma_box(smem, (ha + h) * HALF_BYTES + j * BOX_BYTES, d3,
                                   (n0 + 64 * j, k0, h), (64, 64, 1)))
    written = np.concatenate(written)
    assert len(np.unique(written)) == written.size == nbytes // 2  # each byte pair once
    return smem


def wgmma_operands(smem, split, wg, t, a_major):
    """The A (64 x 16) and D (16 x 128) operands of each phase of k16 step
    t for consumer warpgroup wg, read through wgmma_block's descriptors."""
    ha, _, _, _, _ = ring(split)
    m = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    sa = wg * BOX_BYTES
    sd = ha * HALF_BYTES
    a_off = t * 2048 if a_major == "MN" else t * 32

    def a_of(h):
        return desc_read(smem, sa + h * HALF_BYTES + a_off, BOX_BYTES, a_major, m, k)

    def d_of(h):
        return desc_read(smem, sd + h * HALF_BYTES + t * 2048, BOX_BYTES, "MN",
                         np.arange(128)[None, :], np.arange(16)[:, None])

    a_lo, d_lo = SPLITS[split]
    out = [(a_of(0), d_of(0))]
    if a_lo:
        out.append((a_of(1), d_of(0)))
    if d_lo:
        out.append((a_of(0), d_of(1)))
    return out


def fragment_cells(wg):
    """(rows, cols) of accumulator register i of every thread of consumer
    warpgroup wg: d[4 j + 2 i + c] is row 16 w + 8 i + g, column 8 j +
    2 tig + c (hopper.cuh: wgmma_m64n128k16), as in the epilogue maps."""
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    rows = np.zeros((4, 32, 64), int)
    cols = np.zeros((4, 32, 64), int)
    for w in range(4):
        for reg in range(64):
            j, rem = divmod(reg, 4)
            i, c = divmod(rem, 2)
            rows[w, :, reg] = 64 * wg + 16 * w + 8 * i + g
            cols[w, :, reg] = 8 * j + 2 * tig + c
    return rows, cols


def block_product(stage_of, n_slabs, split, a_major):
    """The 128 x 128 block as wgmma_block computes and the epilogue writes
    it: per slab and warpgroup, every phase into a zeroed partial, then the
    total; each thread's 64 registers through the fragment map."""
    out = np.full((BM, BN), np.nan)
    writes = np.zeros((BM, BN), int)
    for wg in range(2):
        total = np.zeros((64, 128))
        for s in range(n_slabs):
            smem = stage_of(s)
            part = np.zeros((64, 128))
            for t in range(WG_BK // 16):
                for fa, fd in wgmma_operands(smem, split, wg, t, a_major):
                    assert not np.isnan(fa).any() and not np.isnan(fd).any()
                    part += fa @ fd
            total += part
        rows, cols = fragment_cells(wg)
        out[rows, cols] = total[rows - 64 * wg, cols]
        np.add.at(writes, (rows, cols), 1)
    return out, writes


def split_product(a, d, K, split):
    """The product a split mode must give on the stacks, phase by phase."""
    a_lo, d_lo = SPLITS[split]
    ah, al = (a[:, :K], a[:, K:]) if a_lo else (a, None)
    dh, dl = (d[:K], d[K:]) if d_lo else (d, None)
    xy = ah @ dh
    if a_lo:
        xy = xy + al @ dh
    if d_lo:
        xy = xy + ah @ dl
    return xy


# (split, M, K, N): K shorter than a slab and ending mid-slab, M and N past
# a block's edge, and every split mode
K1_SHAPES = [("none", 128, 128, 128), ("none", 40, 40, 96), ("none", 200, 136, 264),
             ("both", 136, 72, 136), ("both", 128, 40, 128), ("rhs", 130, 100, 200),
             ("lhs", 256, 64, 136), ("rhs", 64, 8, 72)]


@pytest.mark.parametrize("split,M,K,N", K1_SHAPES)
def test_k1_block_writes_each_cell_once_with_the_product(split, M, K, N):
    rng = np.random.default_rng(M + K + N)
    a_lo, d_lo = SPLITS[split]
    a = stack(rng.integers(-8, 9, (M, K)).astype(np.float64), 1 + a_lo, 1)
    d = stack(rng.integers(-8, 9, (K, N)).astype(np.float64), 1 + d_lo, 0)
    ref_all = split_product(a, d, K, split)
    n_slabs = -(-K // WG_BK)
    for m0 in range(0, M, BM):
        for n0 in range(0, N, BN):
            out, writes = block_product(lambda s: k1_stage(a, d, K, split, m0, n0, s),
                                        n_slabs, split, "K")
            assert (writes == 1).all()
            ref = np.zeros((BM, BN))
            blk = ref_all[m0:m0 + BM, n0:n0 + BN]
            ref[:blk.shape[0], :blk.shape[1]] = blk
            np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# K2: anchors (gt, H K, tc) and tile (H K, tc), both MN-major
# ---------------------------------------------------------------------------


def k2_stage(a3, d, K, split, m0, n0, s):
    """One slab of sym_wgmma_kernel (ta: (tc, K, H, gt) boxes {64, 64, 1, 1}
    at the anchor columns m0 % tc, + 64 of tile m0 / tc; td as K1's D)."""
    ha, hd, nbytes, _, _ = ring(split)
    gt, _, tc = a3.shape
    a4 = a3.reshape(gt, ha, K, tc)
    d3 = d.reshape(hd, K, tc)
    smem = np.full(nbytes // 2, np.nan)
    k0, tile, c0 = s * WG_BK, m0 // tc, m0 % tc
    written = []
    for h in range(ha):
        for j in range(2):
            written.append(tma_box(smem, h * HALF_BYTES + j * BOX_BYTES, a4,
                                   (c0 + 64 * j, k0, h, tile), (64, 64, 1, 1)))
            written.append(tma_box(smem, (ha + h) * HALF_BYTES + j * BOX_BYTES, d3,
                                   (n0 + 64 * j, k0, h), (64, 64, 1)))
    written = np.concatenate(written)
    assert len(np.unique(written)) == written.size == nbytes // 2
    return smem


@pytest.mark.parametrize("split,K,m0,n0", [("none", 40, 128, 0), ("both", 100, 256, 128),
                                           ("none", 64, 0, 128), ("both", 8, 384, 0)])
def test_k2_block_writes_each_cell_once_with_the_product(split, K, m0, n0):
    """A block whose anchor rows are 128 columns of an anchor tile (tc 256,
    gt 2), K shorter than a slab or ending mid-slab."""
    rng = np.random.default_rng(K + m0)
    gt, tc = 2, 256
    halves = 2 if split == "both" else 1
    a3 = rng.integers(-8, 9, (gt, K, tc)).astype(np.float64)
    a3 = stack(a3, halves, 1)
    d = stack(rng.integers(-8, 9, (K, tc)).astype(np.float64), halves, 0)
    out, writes = block_product(lambda s: k2_stage(a3, d, K, split, m0, n0, s),
                                -(-K // WG_BK), split, "MN")
    assert (writes == 1).all()
    anchors = a3.transpose(0, 2, 1).reshape(gt * tc, halves * K)[m0:m0 + BM]
    np.testing.assert_array_equal(out, split_product(anchors, d[:, n0:n0 + BN], K, split))


# ---------------------------------------------------------------------------
# the descriptors against the boxes, element by element
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("major", ["K", "MN"])
@pytest.mark.parametrize("t", range(4))
def test_descriptors_name_the_element_tma_put_there(major, t):
    """For every (row, k) of a warpgroup's A strip and of D in k16 step t:
    the descriptor's address holds the element that the box of that (row,
    k) was loaded from (ids, not values, so no two elements agree)."""
    M, K, N = 128, 64, 128
    ids = np.arange(M * K, dtype=np.float64).reshape(M, K) + 1
    smem = np.full(2 * HALF_BYTES // 2, np.nan)
    if major == "K":  # K1's A: two boxes {64, 1, 64}
        for j in range(2):
            tma_box(smem, j * BOX_BYTES, ids.reshape(M, 1, K), (0, 0, 64 * j), (64, 1, 64))
    else:  # K2's anchors: (k, m) rows, two boxes {64, 64, 1, 1}
        a4 = ids.T.reshape(1, 1, K, M)
        for j in range(2):
            tma_box(smem, j * BOX_BYTES, a4, (64 * j, 0, 0, 0), (64, 64, 1, 1))
    dids = -(np.arange(K * N, dtype=np.float64).reshape(K, N) + 1)
    for j in range(2):
        tma_box(smem, HALF_BYTES + j * BOX_BYTES, dids.reshape(1, K, N), (64 * j, 0, 0),
                (64, 64, 1))
    for wg in range(2):
        m = np.arange(64)[:, None]
        k = np.arange(16)[None, :]
        start = wg * BOX_BYTES + (t * 2048 if major == "MN" else t * 32)
        got = desc_read(smem, start, BOX_BYTES, major, m, k)
        np.testing.assert_array_equal(got, ids[64 * wg + m, 16 * t + k])
    n = np.arange(128)[None, :]
    k = np.arange(16)[:, None]
    got = desc_read(smem, HALF_BYTES + t * 2048, BOX_BYTES, "MN", n, k)
    np.testing.assert_array_equal(got, dids[16 * t + k, n])


# ---------------------------------------------------------------------------
# the split stacks: the half is a dimension of the map
# ---------------------------------------------------------------------------


def box_rows(smem, dst, rows):
    """A box's elements as TMA wrote them, unswizzled: (rows, 64)."""
    r, c = np.divmod(np.arange(rows * 64), 64)
    return smem[swizzle(dst + r * 128 + 2 * c) // 2].reshape(rows, 64)


@pytest.mark.parametrize("K", [8, 40, 64, 100, 136])
@pytest.mark.parametrize("operand", ["k1_a", "k1_d", "k2_anchors"])
def test_split_maps_zero_fill_past_k_and_never_read_the_other_half(operand, K):
    """hi holds 1, lo holds 2: in every slab the hi boxes hold 1 at k < K
    and 0 past it, the lo boxes 2 and 0, so a half never reads the other;
    a 2D box over the stacked rows would read lo values into the hi slab
    wherever K is no multiple of 64."""
    M = 128
    halves = np.array([1.0, 2.0])
    for s in range(-(-K // WG_BK)):
        k0 = s * WG_BK
        for h in range(2):
            smem = np.full(HALF_BYTES // 2, np.nan)
            if operand == "k1_a":  # (M, halves, K): two boxes {64, 1, 64}, rows m of 64 k
                src = np.broadcast_to(halves[None, :, None], (M, 2, K))
                for j in range(2):
                    tma_box(smem, j * BOX_BYTES, src, (k0, h, 64 * j), (64, 1, 64))
                got = box_rows(smem, 0, 128)
                k_of = k0 + np.arange(64)[None, :]
            else:  # (halves, K, cols) or (gt, halves, K, cols): two boxes of 64 k rows
                src = np.broadcast_to(halves[:, None, None], (2, K, M))
                extra = (0,) if operand == "k2_anchors" else ()
                if extra:
                    src = src[None]
                for j in range(2):
                    tma_box(smem, j * BOX_BYTES, src, (64 * j, k0, h) + extra,
                            (64, 64, 1) + (1,) * len(extra))
                got = np.stack([box_rows(smem, j * BOX_BYTES, 64) for j in range(2)])
                k_of = k0 + np.arange(64)[None, :, None]
            np.testing.assert_array_equal(got, np.broadcast_to(
                np.where(k_of < K, halves[h], 0.0), got.shape))
    # what the half dimension prevents: a 2D box over the [hi; lo] rows
    stacked = np.repeat(halves, K)
    last = stacked[(-(-K // WG_BK) - 1) * WG_BK:][:WG_BK]
    assert (K % WG_BK == 0) == bool((last == 1).all())


# ---------------------------------------------------------------------------
# the grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,N", [(1024, 7040), (256, 43_008), (40, 96), (136, 8192)])
def test_k1_grid_covers_every_block_once(M, N):
    """Block (x, y) is row block x of column block y (x runs fastest, so
    the row blocks of one column block run side by side and share D in
    L2); y is padded to an even count for the cluster pairs (2j, 2j + 1),
    two column blocks of one row block, which share A; a padding block's
    columns lie past N and it writes nothing. Together the blocks write
    every (row, column) once."""
    gx, gy = -(-M // BM), -(-N // BN)
    gy_pairs = (gy + 1) // 2 * 2
    cover = np.zeros((gx * BM, gy_pairs * BN), int)
    order = [(x, y) for y in range(gy_pairs) for x in range(gx)]  # launch order
    for x, y in order:
        cover[x * BM:(x + 1) * BM, y * BN:(y + 1) * BN] += 1
    assert (cover == 1).all()
    assert all(order[i][1] == order[i + 1][1] for i in range(gx - 1))
    assert gy_pairs * BN - N < 2 * BN  # at most one padding column block


def live_rows(t, a0, sw, tc):
    return int(np.clip((t - a0 + 1) * tc, 0, sw))


@pytest.mark.parametrize("gt,tc,a0,t", [(1, 2048, 5, 7), (1, 2048, 5, 5), (3, 256, 2, 3),
                                        (2, 128, 4, 2), (2, 384, 2, 2), (2, 4096, 0, 1)])
def test_k2_grid_covers_live_blocks_once_and_skips_below_the_band(gt, tc, a0, t):
    """sym_wgmma_kernel's grid: tc / 128 column blocks padded to an even
    count for the cluster pairs (2i, 2i + 1), by sw / 128 row blocks. It
    computes each live (row, column) once; a row block at or past
    live_rows returns before it loads anything, and the two blocks of a
    pair (one row block) return or run as one; a padding block's columns
    lie past tc and it writes nothing."""
    sw = gt * tc
    n_live = live_rows(t, a0, sw, tc)
    gx = (tc // BN + 1) // 2 * 2
    cover = np.zeros((sw, gx * BN), int)
    loads = 0
    for by in range(sw // BM):
        for pair in range(gx // 2):
            runs = {by * BM < n_live for bx in (2 * pair, 2 * pair + 1)}  # m0 decides
            assert len(runs) == 1
            for bx in (2 * pair, 2 * pair + 1):
                m0, n0 = by * BM, bx * BN
                if m0 >= n_live:
                    continue
                loads += 1
                cover[m0:m0 + BM, n0:n0 + BN] += 1
    assert (cover[:n_live, :tc] == 1).all() and (cover[n_live:] == 0).all()
    assert loads == -(-n_live // BM) * gx
    assert gx * BN - tc in (0, BN)  # at most one padding block a row block


@pytest.mark.parametrize("split", list(SPLITS))
def test_each_slab_fills_its_stage_once_with_the_expected_bytes(split):
    """The boxes of one slab cover each block's stage once, so the bytes
    the `full` barrier expects (RING::BYTES) are the bytes that land: each
    block of a cluster pair loads D's (K2: the tile's) two boxes a half and
    A's (K2: the anchors') box `rank` a half, multicast into both blocks;
    K1/K3's A boxes are {64, 1, 64}, K2's {64, 64, 1, 1}, the same 8 KB."""
    ha, hd, nbytes, _, _ = ring(split)
    ranks = (0, 1)
    writes = {r: np.zeros(nbytes // 2, int) for r in ranks}
    for rank in ranks:
        own = [((ha + h) * HALF_BYTES + j * BOX_BYTES, BOX_BYTES)
               for h in range(hd) for j in range(2)]
        shared = [(h * HALF_BYTES + rank * BOX_BYTES, BOX_BYTES) for h in range(ha)]
        for dst, size in own:
            assert dst % 1024 == 0
            writes[rank][dst // 2:(dst + size) // 2] += 1
        for dst, size in shared:
            for block in ranks:
                writes[block][dst // 2:(dst + size) // 2] += 1
    for w in writes.values():
        assert (w == 1).all()


@pytest.mark.parametrize("split", list(SPLITS))
def test_every_ring_fits_in_shared_memory(split):
    ha, hd, nbytes, stages, smem = ring(split)
    assert stages >= 3 and smem <= MAX_SMEM
    assert nbytes % 1024 == 0  # every slab, so every box, stays 1024-byte aligned
    # 9 warps: 3 on each SM sub-partition's quarter of the register file
    # (16,384 registers), 168 registers a thread in steps of 8
    warps_per_quarter = -(-WG_THREADS // 32 // 4)
    assert WG_THREADS - WG_CONSUMERS == 32
    assert 16_384 // (32 * warps_per_quarter) // 8 * 8 == 168
