"""A NumPy model of the int8 products on wgmma s8, which no CPU can run:
the K-major pass (similaripy_tpu_torch/csrc/kmajor.cuh), the 8-bit TMA
boxes and descriptors of hopper.cuh's wgmma_block_s8, P1's product
(tlhs_wgmma_s8_kernel in csrc/probe_tlhs.cu), P2's (int_wgmma_kernel in
csrc/probe_int_mma.cu) and K2's (sym_s8_kernel in csrc/sym_topk.cu).

The model runs the pass thread by thread (16-byte loads, the PRMT 4 x 4
byte transpose as its byte permutes, the XOR-swizzled shared tile, the
16-byte stores) and checks that it writes x^T zero-padded to a multiple of
128, every byte once, with conflict-free shared stores and loads. It loads
the K-major operands as TMA does (boxes of 128 K bytes x 64 rows, 128-byte
swizzle) by viewing each pair of bytes as one 16-bit element of
test_torch_wgmma_layout.py's model, reads each k32 step through the
descriptors the kernels build, multiplies into int32 totals, writes through
the s32 accumulator fragments, and checks P1's grid of cluster pairs and
P2's grid with its split of K. For K2 it loads the K-major anchors (sw,
u_pad) and tile (tc, u_pad) that K5 writes, u_pad a multiple of 16 but not
of 128 (the last slab's boxes zero-filled past it), runs the grid with its
band skip, and writes through the epilogue's register-to-(row, column) maps
of the row side and of the transposed col side, checking that every live
cell of both planes is written once with the scaled product.
"""

import numpy as np
import pytest

from test_torch_wgmma_layout import desc_read, fragment_cells, swizzle, tma_box

# the constants of kmajor.cuh, hopper.cuh (wgmma_block_s8) and probe_int_mma.cu
KT, KM_THREADS = 128, 256
BOX_BYTES, SBO = 128 * 64, 1024
WG_S8_BK, WG_S8_BN, RING_BYTES = 128, 256, 192 * 1024
WG_S8_SLAB = (2 + WG_S8_BN // 64) * BOX_BYTES
WG_S8_STAGES = RING_BYTES // WG_S8_SLAB
WG_S8_SMEM = 1024 + WG_S8_STAGES * WG_S8_SLAB + 2 * WG_S8_STAGES * 8
S8_B, S8_MAX_SLABS = 128, RING_BYTES // WG_S8_SLAB
MAX_SMEM = 232_448  # a block's dynamic shared memory on an H100
SMEM_PER_SM = 233_472  # an SM's shared memory for its blocks
H100_SMS = 132


def k_pad(K):
    return -(-K // 128) * 128


def byte_perm(x, y, sel):
    """__byte_perm (PRMT): bytes 0-3 of x then y, output byte n the one
    selector nibble n names."""
    src = np.stack([(x >> (8 * b)) & 255 for b in range(4)] + [(y >> (8 * b)) & 255
                                                               for b in range(4)])
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def transpose4x4(w):
    """tensor_core.cuh's transpose4x4, its eight byte permutes."""
    x0, x1 = byte_perm(w[0], w[1], 0x5140), byte_perm(w[0], w[1], 0x7362)
    y0, y1 = byte_perm(w[2], w[3], 0x5140), byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(x0, y0, 0x5410), byte_perm(x0, y0, 0x7632),
            byte_perm(x1, y1, 0x5410), byte_perm(x1, y1, 0x7632)]


def words(b):
    """Little-endian 32-bit words of a (..., 4 n) uint8 array."""
    b = b.astype(np.int64)
    return b[..., 0::4] | b[..., 1::4] << 8 | b[..., 2::4] << 16 | b[..., 3::4] << 24


def load16(x, row, c, C):
    """kmajor.cuh's load16: bytes c .. c + 15 of row `row` of x, zeros past
    C (the byte-wise path; the 16-byte one reads the same bytes)."""
    out = np.zeros((row.size, 16), np.uint8)
    for b in range(16):
        inside = (c + b < C) & (row >= 0)
        out[inside, b] = x[row[inside], (c + b)[inside]]
    return out


def kmajor_model(x, trans):
    """xt as kmajor_transpose_kernel (trans) or kmajor_pad_kernel writes
    it, block by block and thread by thread; also the number of writes of
    every byte and the shared banks of each warp access."""
    K, R = x.shape if trans else x.shape[::-1]
    kp = k_pad(K)
    xt = np.full((R, kp), -1, np.int64)
    writes = np.zeros((R, kp), int)
    xb = x.view(np.uint8)
    tid = np.arange(KM_THREADS)
    banks = []
    for bx in range(kp // KT):
        for by in range(-(-R // KT)):
            k0, r0 = bx * KT, by * KT
            e = tid[None, :] + KM_THREADS * np.arange(KT * KT // 16 // KM_THREADS)[:, None]
            r, q = (e >> 3).ravel(), (e & 7).ravel()
            if trans:
                i, j = tid >> 3, tid & 7
                tile = np.full((KT, KT // 4), -1, np.int64)
                w = []
                for qq in range(4):
                    k = k0 + 4 * i + qq
                    w.append(words(load16(xb, np.where(k < K, k, -1), r0 + 16 * j, R)))
                for c in range(4):
                    b = transpose4x4([w[qq][:, c] for qq in range(4)])
                    for jj in range(4):
                        col = i ^ (4 * j)
                        tile[16 * j + 4 * c + jj, col] = b[jj]
                        banks.append(("store", col.reshape(-1, 32)))
                phys = 4 * (q ^ ((r >> 4) & 7))
                banks.append(("load", ((phys[:, None] + np.arange(4)) % 32).reshape(-1, 32)))
                chunk = tile[r[:, None], phys[:, None] + np.arange(4)]
            else:
                chunk = words(load16(xb, np.where(r0 + r < R, r0 + r, -1), k0 + 16 * q, K))
            keep = r0 + r < R
            for t in range(4):
                wd = chunk[keep, t]
                for b in range(4):
                    col = k0 + 16 * q[keep] + 4 * t + b
                    xt[r0 + r[keep], col] = (wd >> (8 * b)) & 255
                    writes[r0 + r[keep], col] += 1
    return xt.astype(np.uint8).view(np.int8), writes, banks


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("K,R", [(1, 1), (77, 130), (128, 128), (300, 129), (256, 16),
                                 (130, 300)])
def test_kmajor_pass_writes_padded_transpose_every_byte_once(trans, K, R):
    """The pass's tiles cover xt (R x k_pad) once, and it equals x^T (or x)
    followed by zeros up to k_pad, a multiple of 128."""
    rng = np.random.default_rng(K * 1000 + R)
    x = rng.integers(-128, 128, (K, R) if trans else (R, K)).astype(np.int8)
    xt, writes, _ = kmajor_model(x, trans)
    kp = k_pad(K)
    assert kp % 128 == 0 and kp - K < 128
    assert (writes == 1).all()
    want = np.zeros((R, kp), np.int8)
    want[:, :K] = x.T if trans else x
    np.testing.assert_array_equal(xt, want)


def test_kmajor_transpose_banks_are_distinct():
    """Each warp's 4-byte stores into the tile hit 32 distinct banks, and
    each quarter-warp's 16-byte loads 8 distinct 16-byte chunks (32 banks)."""
    x = np.zeros((128, 128), np.int8)
    _, _, banks = kmajor_model(x, True)
    for _, b in banks:  # a warp's stores; a load phase is 8 lanes of 4 words
        assert all(len(set(w)) == 32 for w in b)


def test_transpose4x4_is_the_byte_transpose():
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (50, 4, 4))
    w = [words(blocks[:, r].astype(np.uint8))[:, 0] for r in range(4)]
    out = transpose4x4(w)
    for c in range(4):
        np.testing.assert_array_equal(out[c], words(blocks[:, :, c].astype(np.uint8))[:, 0])


# ---------------------------------------------------------------------------
# 8-bit TMA boxes and k32 descriptors
# ---------------------------------------------------------------------------


def pairs(xt):
    """An int8 (rows, k_pad) array as the 16-bit elements of the model:
    bytes 2 p and 2 p + 1 of a row as one little-endian element."""
    u = xt.view(np.uint8).astype(np.float64)
    return u[:, 0::2] + 256.0 * u[:, 1::2]


def smem_byte(smem, addr):
    """The byte at shared address `addr` of a model array of 16-bit elements."""
    v = smem[addr // 2].astype(np.int64)
    return ((v >> (8 * (addr % 2))) & 255).astype(np.uint8).view(np.int8)


def s8_box(smem, dst, xt, k0, row0):
    """One TMA box {128, 64} of the 2D map (k_pad, rows) at (k0, row0)."""
    return tma_box(smem, dst, pairs(xt), (k0 // 2, row0), (64, 64))


def s8_desc_read(smem, start, mn, kb):
    """The byte a K-major SW128 descriptor (SBO 1024) names at operand row
    mn, byte kb of a k32 step."""
    pair = desc_read(smem, start, BOX_BYTES, "K", mn, kb // 2)
    return ((pair.astype(np.int64) >> (8 * (kb % 2))) & 255).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("rows,row0,k0", [(64, 0, 0), (200, 64, 128), (70, 64, 0)])
def test_s8_box_is_128_bytes_by_64_rows_swizzled(rows, row0, k0):
    """Byte kb of box row r lands at swizzle(r * 128 + kb); rows past the
    tensor's end read as zeros."""
    rng = np.random.default_rng(rows)
    xt = rng.integers(-128, 128, (rows, 256)).astype(np.int8)
    smem = np.full(BOX_BYTES // 2, np.nan)
    written = s8_box(smem, 0, xt, k0, row0)
    assert len(np.unique(written)) == written.size == BOX_BYTES // 2
    r, kb = np.divmod(np.arange(BOX_BYTES), 128)
    got = smem_byte(smem, swizzle(r * 128 + kb))
    src = np.zeros((64, 128), np.int8)
    inside = xt[row0:row0 + 64, k0:k0 + 128]
    src[:inside.shape[0]] = inside
    np.testing.assert_array_equal(got.reshape(64, 128), src)


@pytest.mark.parametrize("t", range(4))
def test_k32_descriptors_name_the_byte_tma_put_there(t):
    """For every (row, k) of a warpgroup's A strip (64 rows, box wg) and of
    B (256 rows, four boxes) in k32 step t, the descriptor at 32 t bytes in
    names the byte that the boxes loaded from (rows of distinct ids)."""
    ids = np.arange(256 * 128).reshape(256, 128) % 251 - 125
    at = ids[:128].astype(np.int8)
    bt = (-ids).astype(np.int8)
    smem = np.full(WG_S8_SLAB // 2, np.nan)
    for j in range(2):
        s8_box(smem, j * BOX_BYTES, at, 0, 64 * j)
    for j in range(4):
        s8_box(smem, (2 + j) * BOX_BYTES, bt, 0, 64 * j)
    kb = np.arange(32)[None, :]
    for wg in range(2):
        m = np.arange(64)[:, None]
        got = s8_desc_read(smem, wg * BOX_BYTES + 32 * t, m, kb)
        np.testing.assert_array_equal(got, at[64 * wg + m, 32 * t + kb])
    n = np.arange(256)[:, None]
    got = s8_desc_read(smem, 2 * BOX_BYTES + 32 * t, n, kb)
    np.testing.assert_array_equal(got, bt[n, 32 * t + kb])


# ---------------------------------------------------------------------------
# P1: wgmma_block_s8 over the pass's output
# ---------------------------------------------------------------------------


def s8_stage(at, bt, m0, n0, s):
    """Slab s of tlhs_wgmma_s8_kernel in one block of a pair: A's box
    `rank` from each block of the pair (multicast), B's four boxes."""
    smem = np.full(WG_S8_SLAB // 2, np.nan)
    k0 = s * WG_S8_BK
    written = [s8_box(smem, rank * BOX_BYTES, at, k0, m0 + 64 * rank) for rank in range(2)]
    written += [s8_box(smem, (2 + j) * BOX_BYTES, bt, k0, n0 + 64 * j)
                for j in range(WG_S8_BN // 64)]
    written = np.concatenate(written)
    assert len(np.unique(written)) == written.size == WG_S8_SLAB // 2  # the expected bytes
    return smem


def s32_fragment_cells(wg, n):
    """(rows, cols) of accumulator register i of every thread of consumer
    warpgroup wg for m64n{n}k32 s32: d[4 j + 2 i + c] is row 16 w + 8 i + g,
    column 8 j + 2 tig + c, as in the epilogues."""
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    rows = np.zeros((4, 32, n // 2), int)
    cols = np.zeros((4, 32, n // 2), int)
    for w in range(4):
        for reg in range(n // 2):
            j, rem = divmod(reg, 4)
            i, c = divmod(rem, 2)
            rows[w, :, reg] = 64 * wg + 16 * w + 8 * i + g
            cols[w, :, reg] = 8 * j + 2 * tig + c
    return rows, cols


def s8_block(at, bt, m0, n0):
    """The 128 x 256 int32 block as wgmma_block_s8 computes it and the
    epilogue writes it: every k32 step into the total, through the s32
    fragment map; and the writes of each cell."""
    out = np.full((128, WG_S8_BN), np.nan)
    writes = np.zeros((128, WG_S8_BN), int)
    n_slabs = at.shape[1] // WG_S8_BK
    stages = [s8_stage(at, bt, m0, n0, s) for s in range(n_slabs)]
    for wg in range(2):
        total = np.zeros((64, WG_S8_BN), np.int64)
        for smem in stages:
            for t in range(WG_S8_BK // 32):
                kb = np.arange(32)[None, :]
                fa = s8_desc_read(smem, wg * BOX_BYTES + 32 * t, np.arange(64)[:, None], kb)
                fb = s8_desc_read(smem, 2 * BOX_BYTES + 32 * t, np.arange(WG_S8_BN)[:, None], kb)
                total += fa.astype(np.int64) @ fb.astype(np.int64).T
        rows, cols = s32_fragment_cells(wg, WG_S8_BN)
        out[rows, cols] = total[rows - 64 * wg, cols]
        np.add.at(writes, (rows, cols), 1)
    return out, writes


@pytest.mark.parametrize("K,M,N", [(77, 130, 70), (256, 128, 256), (5, 1, 3), (300, 129, 300)])
def test_p1_s8_blocks_write_each_cell_once_with_the_product(K, M, N):
    """a^T . b through the pass and the s8 block, full-range int8, ragged
    edges: each output cell of every block once, equal to the product."""
    rng = np.random.default_rng(K + M + N)
    a = rng.integers(-128, 128, (K, M)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    at, _, _ = kmajor_model(a, True)
    bt, _, _ = kmajor_model(b, True)
    ref = a.astype(np.int64).T @ b.astype(np.int64)
    for m0 in range(0, M, 128):
        for n0 in range(0, N, WG_S8_BN):
            out, writes = s8_block(at, bt, m0, n0)
            assert (writes == 1).all()
            want = np.zeros((128, WG_S8_BN))
            blk = ref[m0:m0 + 128, n0:n0 + WG_S8_BN]
            want[:blk.shape[0], :blk.shape[1]] = blk
            np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("n", [128, 256])
def test_s32_fragments_cover_the_warpgroup_strip_once(n):
    """m64n{128,256}k32 s32: the n / 2 registers of the 128 threads name
    each cell of the warpgroup's 64 x n strip once; n256's first 64
    registers are n128's, which are the f32 fragment of m64n128k16."""
    for wg in range(2):
        rows, cols = s32_fragment_cells(wg, n)
        cells = np.zeros((128, n), int)
        np.add.at(cells, (rows, cols), 1)
        assert (cells[64 * wg:64 * wg + 64] == 1).all() and cells.sum() == 64 * n
        f_rows, f_cols = fragment_cells(wg)
        np.testing.assert_array_equal(rows[..., :64], f_rows)
        np.testing.assert_array_equal(cols[..., :64], f_cols)


@pytest.mark.parametrize("M,N", [(4096, 4096), (256, 1024), (130, 300), (1, 3), (37, 129)])
def test_p1_s8_grid_covers_every_block_once(M, N):
    """Column blocks of 256 padded to an even count for the cluster pairs
    (2i, 2i + 1) of one row block, which share A's boxes; a padding block's
    columns lie past N and it stores nothing; every output cell once."""
    bn = WG_S8_BN
    gx, gy = (-(-N // bn) + 1) // 2 * 2, -(-M // 128)
    cover = np.zeros((gy * 128, gx * bn), int)
    for y in range(gy):
        for pair in range(gx // 2):
            for x in (2 * pair, 2 * pair + 1):
                cover[y * 128:(y + 1) * 128, x * bn:(x + 1) * bn] += 1
    assert (cover == 1).all()
    assert gx * bn - N < 2 * bn


def test_s8_ring_fits_in_shared_memory():
    """4 slabs of 48 KB; the 128 int32 totals of a consumer thread fit the
    168 registers a thread that 9 warps leave (ptxas: 154, no spill)."""
    assert WG_S8_STAGES == 4 and WG_S8_SLAB % 1024 == 0
    assert WG_S8_SMEM <= MAX_SMEM
    assert WG_S8_BN // 2 < 16_384 // (32 * 3) // 8 * 8 == 168


# ---------------------------------------------------------------------------
# P2: the grid and its split of K
# ---------------------------------------------------------------------------


def p2_grid(M, K, N, sms=H100_SMS):
    """probe_int_mma.cu's launch_s8: (gx, gy, gz, per, n_slabs, smem)."""
    gx, gy = -(-N // WG_S8_BN), -(-M // S8_B)
    n_slabs = k_pad(K) // WG_S8_BK
    split = min(-(-2 * sms // (gx * gy)), n_slabs)
    per = -(-n_slabs // split) if n_slabs else 0
    per = min(per, S8_MAX_SLABS)
    gz = -(-n_slabs // per) if per else 1
    return gx, gy, gz, per, n_slabs, 1024 + per * WG_S8_SLAB


P2_GRID_CASES = [(512, 2048, 512, 2), (32, 64, 48, 3), (64, 2048, 64, 5), (100, 130, 70, 2),
                 (17, 1000, 9, 1), (64, 300, 40, 0), (8, 40_000, 8, 1)]


@pytest.mark.parametrize("M,K,N,steps", P2_GRID_CASES)
def test_p2_grid_covers_every_block_and_chunk_once(M, K, N, steps):
    """Every (output block, slab of 128 K bytes) once; no block holds more
    than S8_MAX_SLABS slabs or an empty chunk; the blocks' atomic adds of
    steps x their chunk's product give steps x a . b."""
    gx, gy, gz, per, n_slabs, smem = p2_grid(M, K, N)
    assert smem <= MAX_SMEM and per <= S8_MAX_SLABS
    seen = np.zeros((gy, gx, n_slabs), int)
    rng = np.random.default_rng(M + K)
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    ap, _, _ = kmajor_model(a, False)
    bt, _, _ = kmajor_model(b, True)
    out = np.zeros((gy * 128, gx * WG_S8_BN), np.int64)
    for z in range(gz):
        q0 = z * per
        nq = min(n_slabs, q0 + per) - q0
        assert nq > 0
        for y in range(gy):
            for x in range(gx):
                seen[y, x, q0:q0 + nq] += 1
                ks = slice(q0 * WG_S8_BK, (q0 + nq) * WG_S8_BK)
                blk = ap[y * 128:(y + 1) * 128, ks].astype(np.int64) @ \
                    bt[x * WG_S8_BN:(x + 1) * WG_S8_BN, ks].astype(np.int64).T
                acc = np.zeros_like(blk)
                for _ in range(steps):
                    acc += blk
                out[y * 128:y * 128 + blk.shape[0],
                    x * WG_S8_BN:x * WG_S8_BN + blk.shape[1]] += acc
    assert (seen == 1).all()
    want = (a.astype(np.int64) @ b.astype(np.int64)) * steps
    np.testing.assert_array_equal(out[:M, :N], want)


def test_p2_probe_shape_fills_the_card():
    """At the probe's shape (512 x 2,048 x 512): 8 output blocks of 128 x
    256, each K split into 16 one-slab chunks (the finest split): 128
    blocks of 49 KB, one on each of 128 SMs."""
    gx, gy, gz, per, n_slabs, smem = p2_grid(512, 2048, 512)
    assert (gx, gy, gz, per, n_slabs) == (2, 4, 16, 1, 16)
    assert smem <= SMEM_PER_SM and gx * gy * gz <= H100_SMS


# ---------------------------------------------------------------------------
# K2: sym_s8_kernel on the K-major anchors (sw, u_pad) and tile (tc, u_pad)
# ---------------------------------------------------------------------------

BM = 128


def k2_live_rows(t, a0, sw, tc):
    """live_rows and col_rows of sym_topk.cu: anchor rows of tile <= t, < t."""
    return (int(np.clip((t - a0 + 1) * tc, 0, sw)), int(np.clip((t - a0) * tc, 0, sw)))


def k2_s8_grid(sw, tc):
    """launch_s8's grid: (column blocks, padded to an even count for the
    cluster pairs; row blocks)."""
    gx = -(-tc // WG_S8_BN)
    return (gx + 1) // 2 * 2, sw // BM


def k2_s8_stage(anchors, tile, m0, n0, s):
    """Slab s of sym_s8_kernel in one block of a pair: the anchors' box
    `rank` of the 2D map (u_pad, sw) at (k0, m0 + 64 rank) from each block
    of the pair (multicast), the tile's four boxes of the map (u_pad, tc)
    at (k0, n0 + 64 j)."""
    smem = np.full(WG_S8_SLAB // 2, np.nan)
    k0 = s * WG_S8_BK
    written = [s8_box(smem, rank * BOX_BYTES, anchors, k0, m0 + 64 * rank) for rank in range(2)]
    written += [s8_box(smem, (2 + j) * BOX_BYTES, tile, k0, n0 + 64 * j)
                for j in range(WG_S8_BN // 64)]
    written = np.concatenate(written)
    assert len(np.unique(written)) == written.size == WG_S8_SLAB // 2
    return smem


def k2_s8_totals(anchors, tile, m0, n0):
    """Each consumer thread's 128 s32 totals, by (wg, warp, lane, register),
    as wgmma_block_s8 accumulates them over the slabs and the m64n256k32
    fragment lays them out (s32_fragment_cells)."""
    n_slabs = -(-anchors.shape[1] // WG_S8_BK)
    acc = np.zeros((2, 4, 32, 128), np.int64)
    for wg in range(2):
        total = np.zeros((64, WG_S8_BN), np.int64)
        for s in range(n_slabs):
            smem = k2_s8_stage(anchors, tile, m0, n0, s)
            for t in range(WG_S8_BK // 32):
                kb = np.arange(32)[None, :]
                fa = s8_desc_read(smem, wg * BOX_BYTES + 32 * t, np.arange(64)[:, None], kb)
                fb = s8_desc_read(smem, 2 * BOX_BYTES + 32 * t, np.arange(WG_S8_BN)[:, None], kb)
                total += fa.astype(np.int64) @ fb.astype(np.int64).T
        rows, cols = s32_fragment_cells(wg, WG_S8_BN)
        acc[wg] = total[rows - 64 * wg, cols]
    return acc


def k2_s8_epilogue(acc, m0, n0, sw, tc, n_live, n_col, inv_scale, scores_r, scores_c, writes):
    """The kernel's epilogue lambda: thread (wg, warp, lane) names rows[i] =
    m0 + 64 wg + 16 warp + 8 i + g and cols[j] = n0 + 8 (j >> 1) + 2 tig +
    (j & 1), reads acc[4 (j >> 1) + 2 i + (j & 1)], and (epilogue() of
    sym_topk.cu) skips rows past n_live and columns past tc, writes the row
    side at (row, col) and, for rows below n_col, the col side at (col,
    row). writes[0] and writes[1] count the stores of each plane."""
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    for wg in range(2):
        for warp in range(4):
            for i in range(2):
                r = m0 + 64 * wg + 16 * warp + 8 * i + g
                for j in range(64):
                    c = n0 + 8 * (j >> 1) + 2 * tig + (j & 1)
                    v = acc[wg, warp, :, 4 * (j >> 1) + 2 * i + (j & 1)] * inv_scale
                    ok = (r < n_live) & (c < tc)
                    scores_r[r[ok], c[ok]] = v[ok]
                    np.add.at(writes[0], (r[ok], c[ok]), 1)
                    ok &= r < n_col
                    scores_c[c[ok], r[ok]] = v[ok]
                    np.add.at(writes[1], (c[ok], r[ok]), 1)


def k2_s8_call(anchors, tile, gt, tc, a0, t, inv_scale=0.25):
    """Every block of the launch over the K-major operands: the two score
    planes (row side sw x tc, col side tc x sw; NaN where nothing was
    written), the writes of each cell, and the row blocks that ran."""
    sw = gt * tc
    n_live, n_col = k2_live_rows(t, a0, sw, tc)
    scores_r, scores_c = np.full((sw, tc), np.nan), np.full((tc, sw), np.nan)
    writes = (np.zeros((sw, tc), int), np.zeros((tc, sw), int))
    gx, gy = k2_s8_grid(sw, tc)
    ran = set()
    for by in range(gy):
        for bx in range(gx):
            m0, n0 = by * BM, bx * WG_S8_BN
            if m0 >= n_live:  # below the band: returns before any load
                continue
            ran.add(by)
            acc = k2_s8_totals(anchors, tile, m0, n0)
            k2_s8_epilogue(acc, m0, n0, sw, tc, n_live, n_col, inv_scale, scores_r, scores_c,
                           writes)
    return scores_r, scores_c, writes, ran


def kmajor_tiles(items, tc):
    """The (u, n) item columns as K5's K-major tiles: (n, u_pad) rows, the
    user axis padded with zeros to a multiple of 16."""
    u = items.shape[0]
    out = np.zeros((items.shape[1], -(-u // 16) * 16), np.int8)
    out[:, :u] = items.T
    return out


# (gt, tc, u, a0, t): every row of a live block; a band whose first anchor
# tile is diagonal and second dead; a band that cuts a three-tile group; an
# odd count of 256-wide column blocks with a half-empty last one; u_pad
# shorter than one slab, and ending mid-slab
K2_S8_CASES = [(2, 128, 48, 2, 4), (2, 256, 144, 2, 2), (3, 128, 272, 2, 3),
               (2, 384, 112, 1, 2), (1, 640, 16, 0, 1), (2, 128, 1008, 3, 4)]


@pytest.mark.parametrize("gt,tc,u,a0,t", K2_S8_CASES)
def test_k2_s8_blocks_write_each_live_cell_once_with_the_product(gt, tc, u, a0, t):
    """Full-range int8 over u users: the row side holds anchors . tile x
    inv_scale on rows of tile <= t and nothing below the band, the col side
    its transpose on rows of tile < t; each of those cells is written once,
    no other cell at all, and a row block past the band never runs."""
    rng = np.random.default_rng(gt * 1000 + tc + u)
    sw = gt * tc
    items = rng.integers(-128, 128, (u, sw + tc)).astype(np.int8)
    anchors = kmajor_tiles(items[:, :sw], tc)
    tile = kmajor_tiles(items[:, sw:], tc)
    assert anchors.shape == (sw, -(-u // 16) * 16) and tile.shape == (tc, anchors.shape[1])
    scores_r, scores_c, writes, ran = k2_s8_call(anchors, tile, gt, tc, a0, t)
    n_live, n_col = k2_live_rows(t, a0, sw, tc)
    ref = items[:, :sw].astype(np.int64).T @ items[:, sw:].astype(np.int64) * 0.25
    assert (writes[0][:n_live] == 1).all() and (writes[0][n_live:] == 0).all()
    assert (writes[1][:, :n_col] == 1).all() and (writes[1][:, n_col:] == 0).all()
    np.testing.assert_array_equal(scores_r[:n_live], ref[:n_live])
    np.testing.assert_array_equal(scores_c[:, :n_col], ref[:n_col].T)
    assert ran == set(range(-(-n_live // BM)))


@pytest.mark.parametrize("u", [16, 48, 112, 128, 144, 1008])
@pytest.mark.parametrize("operand", ["anchors", "tile"])
def test_k2_s8_kmajor_boxes_zero_fill_past_u_pad_and_past_the_rows(operand, u):
    """Each box of the 2D map (u_pad, rows) holds 128 K bytes of 64 K-major
    rows: the operand's bytes at k < u_pad and rows inside, zeros past
    u_pad in the last slab and past the last row (a tile's column block
    past tc), every byte of the box written once."""
    rows = 384 if operand == "anchors" else 128
    rng = np.random.default_rng(u + rows)
    xt = rng.integers(1, 128, (rows, u)).astype(np.int8)
    for s in range(-(-u // WG_S8_BK)):
        k0 = s * WG_S8_BK
        for row0 in range(0, rows + 128, 64):
            smem = np.full(BOX_BYTES // 2, np.nan)
            written = s8_box(smem, 0, xt, k0, row0)
            assert len(np.unique(written)) == written.size == BOX_BYTES // 2
            r, kb = np.divmod(np.arange(BOX_BYTES), 128)
            got = smem_byte(smem, swizzle(r * 128 + kb)).reshape(64, 128)
            want = np.zeros((64, 128), np.int8)
            inside = xt[row0:row0 + 64, k0:k0 + 128]
            want[:inside.shape[0], :inside.shape[1]] = inside
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gt,tc,a0,t", [(1, 4096, 0, 0), (1, 4096, 3, 7), (2, 128, 4, 2),
                                        (3, 256, 2, 3), (2, 384, 2, 2), (9, 2048, 0, 5)])
def test_k2_s8_grid_covers_live_blocks_once_and_skips_below_the_band(gt, tc, a0, t):
    """launch_s8's grid: ceil(tc / 256) column blocks padded to an even
    count for the cluster pairs (2i, 2i + 1) of one row block, by sw / 128
    row blocks. Each live (row, column) is covered once; the two blocks of
    a pair share m0, so they return or run as one (the multicast needs
    both); a padding block's columns lie past tc."""
    sw = gt * tc
    n_live, _ = k2_live_rows(t, a0, sw, tc)
    gx, gy = k2_s8_grid(sw, tc)
    cover = np.zeros((sw, gx * WG_S8_BN), int)
    for by in range(gy):
        for pair in range(gx // 2):
            runs = {by * BM < n_live for _ in (2 * pair, 2 * pair + 1)}
            assert len(runs) == 1
            for bx in (2 * pair, 2 * pair + 1):
                if by * BM < n_live:
                    cover[by * BM:(by + 1) * BM, bx * WG_S8_BN:(bx + 1) * WG_S8_BN] += 1
    assert (cover[:n_live, :tc] == 1).all() and (cover[n_live:] == 0).all()
    assert gx * WG_S8_BN - tc < 2 * WG_S8_BN
    if (gt, tc) == (1, 4096):  # the main path's int8 block: 16 x 32 blocks of 128 x 256
        assert (gx, gy) == (16, 32)


@pytest.mark.parametrize("side", ["row", "col"])
def test_k2_s8_epilogue_maps_name_the_fragment_cells(side):
    """The epilogue's (rows[i], cols[j]) of register 4 (j >> 1) + 2 i + (j &
    1) is the m64n256k32 fragment's cell of that register, for every thread
    of both warpgroups: on the row side at (row, col), on the col side at
    (col, row); together the 128 threads of a warpgroup name each cell of
    its 64 x 256 strip once."""
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    for wg in range(2):
        f_rows, f_cols = s32_fragment_cells(wg, WG_S8_BN)
        cells = np.zeros((BM, WG_S8_BN), int)
        for warp in range(4):
            for i in range(2):
                for j in range(64):
                    reg = 4 * (j >> 1) + 2 * i + (j & 1)
                    r = 64 * wg + 16 * warp + 8 * i + g
                    c = 8 * (j >> 1) + 2 * tig + (j & 1)
                    np.testing.assert_array_equal(r, f_rows[warp, :, reg])
                    np.testing.assert_array_equal(c, f_cols[warp, :, reg])
                    if side == "row":
                        np.add.at(cells, (r, c), 1)
                    else:
                        np.add.at(cells.T, (c, r), 1)
        assert (cells[64 * wg:64 * wg + 64] == 1).all() and cells.sum() == 64 * WG_S8_BN
