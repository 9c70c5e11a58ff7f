"""A NumPy model of the probes' int8 products on wgmma s8, which no CPU can
run: the K-major pass (similaripy_tpu_torch/csrc/kmajor.cuh), the 8-bit TMA
boxes and descriptors of hopper.cuh's wgmma_block_s8, P1's product
(tlhs_wgmma_s8_kernel in csrc/probe_tlhs.cu) and P2's (int_wgmma_kernel in
csrc/probe_int_mma.cu).

The model runs the pass thread by thread (16-byte loads, the PRMT 4 x 4
byte transpose as its byte permutes, the XOR-swizzled shared tile, the
16-byte stores) and checks that it writes x^T zero-padded to a multiple of
128, every byte once, with conflict-free shared stores and loads. It loads
the K-major operands as TMA does (boxes of 128 K bytes x 64 rows, 128-byte
swizzle) by viewing each pair of bytes as one 16-bit element of
test_torch_wgmma_layout.py's model, reads each k32 step through the
descriptors the kernels build, multiplies into int32 totals, writes through
the s32 accumulator fragments, and checks P1's grid of cluster pairs and
P2's grid with its split of K.
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
