"""A NumPy model of the index maps of K1/K3's product kernels
(similaripy_tpu_torch/csrc/tile_kernels.cuh), which no CPU can run.

The model copies each operand slab into shared memory with the kernels'
copy maps and swizzles, reads the fragments with their read maps (ldmatrix
and the in-register 4 x 4 byte transpose for int8, the strip reads for the
SIMT loop), multiplies as mma.sync m16n8k32 and the FMA loop do, and
writes through the epilogue's row and column maps. It checks that every
output cell of a block is written once and equals A . D, that every slab
byte is copied once, and that each warp's shared-memory accesses fall in
32 banks. The last test mirrors the launch's choice of copy width and checks
that the card cases (tests/torch_k1_cases.py, tests/torch_k3_cases.py) take
every instantiated variant, and the main path the 16-byte one.
"""

import numpy as np
import pytest

from torch_k1_cases import CARD_CASES as K1_CARD_CASES
from torch_k1_cases import CARD_SHAPES as K1_CARD_SHAPES
from torch_k3_cases import CARD_CASES as K3_CARD_CASES
from torch_k3_cases import CARD_SHAPES as K3_CARD_SHAPES
from torch_k3_cases import TM

# the constants of tile_kernels.cuh
BM, BN, S8_BN, THREADS, STAGES = 128, 128, 256, 256, 3
UNITS, A_LD, IBK = 32, BM + 4, 128
ESZ = {"f32": 4, "bf16": 2, "int8": 1}
# the (mode, copy width) pairs that product_kernel takes: bf16 at 16 bytes
# the wgmma kernel (tests/test_torch_wgmma_layout.py), the others the
# kernels modelled here
VARIANTS = {("f32", 16), ("f32", 4), ("bf16", 16), ("bf16", 4), ("bf16", 2),
            ("int8", 16), ("int8", 4), ("int8", 1)}


def banks_ok(word_addrs):
    """One warp access, as the 32-bit word addresses it touches: each bank
    sees one distinct word (equal words are broadcast)."""
    seen = {}
    for w in np.asarray(word_addrs).ravel():
        if seen.setdefault(int(w) % 32, int(w)) != int(w):
            return False
    return True


# ---------------------------------------------------------------------------
# int8: tile_s8_kernel
# ---------------------------------------------------------------------------


def a_swz(r, ch):
    return r * IBK + ((ch ^ (r & 7)) << 4)


def d_swz(r, ch):
    return r * S8_BN + ((ch ^ (((r >> 2) & 3) << 1)) << 4)


def s8_fill(a, d, m0, n0, s, V):
    """One slab of each operand in shared memory (fetch), and how often each
    byte was written."""
    M, K = a.shape
    N = d.shape[1]
    sa, ca = np.zeros(BM * IBK, np.int64), np.zeros(BM * IBK, int)
    sd, cd = np.zeros(IBK * S8_BN, np.int64), np.zeros(IBK * S8_BN, int)
    a_row, d_row = IBK // V, S8_BN // V
    c = np.arange(BM * a_row // THREADS * THREADS)  # tid + i * THREADS over all i
    row, off = c // a_row, (c % a_row) * V
    k = s * IBK + off
    full = (m0 + row < M) & (k < K)
    dst = a_swz(row, off >> 4) + (off & 15)
    for b in range(V):
        sa[dst + b] = np.where(full, a[np.minimum(m0 + row, M - 1), np.minimum(k + b, K - 1)], 0)
        np.add.at(ca, dst + b, 1)
    c = np.arange(IBK * d_row // THREADS * THREADS)
    row, off = c // d_row, (c % d_row) * V
    k = s * IBK + row
    full = (k < K) & (n0 + off < N)
    dst = d_swz(row, off >> 4) + (off & 15)
    for b in range(V):
        sd[dst + b] = np.where(full, d[np.minimum(k, K - 1), np.minimum(n0 + off + b, N - 1)], 0)
        np.add.at(cd, dst + b, 1)
    return sa, sd, ca, cd


def s8_block(a, d, m0, n0, V):
    """The block's outputs as tile_s8_kernel computes and writes them, and
    how often each cell was written."""
    K = a.shape[1]
    out = np.zeros((BM, S8_BN), np.int64)
    writes = np.zeros((BM, S8_BN), int)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    accs = np.zeros((8, 4, 8, 4, 32), np.int64)  # warp, mi, ni, q, lane
    for s in range((K + IBK - 1) // IBK):
        sa, sd, ca, cd = s8_fill(a, d, m0, n0, s, V)
        assert (ca == 1).all() and (cd == 1).all()
        for warp in range(8):
            wm, wn = (warp >> 2) * 64, (warp & 3) * 64
            for ks in range(0, IBK, 32):
                af = np.zeros((4, 4, 32, 4), np.int64)  # mi, reg, lane, byte
                for mi in range(4):
                    addr = a_swz(wm + 16 * mi + (lane & 15), ks // 16 + (lane >> 4))
                    for i in range(4):  # matrix i: one phase of 8 rows of 16 bytes
                        rows16 = addr[8 * i:8 * i + 8]
                        assert banks_ok((rows16[:, None] + 4 * np.arange(4)) // 4)
                        src = addr[8 * i + g] + 4 * t
                        af[mi, i] = sa[src[:, None] + np.arange(4)]
                bf = np.zeros((8, 2, 32, 4), np.int64)  # ni, reg, lane, byte
                for kh in range(2):
                    r0 = ks + 16 * kh + 4 * t
                    for h in range(2):
                        word = wn // 4 + 8 * h + g
                        w = np.zeros((4, 32, 4), np.int64)
                        for q in range(4):
                            addr = d_swz(r0 + q, word >> 2) + (word & 3) * 4
                            assert banks_ok(addr // 4)
                            w[q] = sd[addr[:, None] + np.arange(4)]
                        for j in range(4):  # transpose4x4: word j = byte j of w[0..3]
                            bf[4 * h + j, kh] = w[:, :, j].T
                for mi in range(4):
                    A16 = np.zeros((16, 32), np.int64)
                    A16[g[:, None], 4 * t[:, None] + np.arange(4)] = af[mi, 0]
                    A16[g[:, None] + 8, 4 * t[:, None] + np.arange(4)] = af[mi, 1]
                    A16[g[:, None], 16 + 4 * t[:, None] + np.arange(4)] = af[mi, 2]
                    A16[g[:, None] + 8, 16 + 4 * t[:, None] + np.arange(4)] = af[mi, 3]
                    for ni in range(8):
                        B = np.zeros((32, 8), np.int64)
                        B[4 * t[:, None] + np.arange(4), g[:, None]] = bf[ni, 0]
                        B[16 + 4 * t[:, None] + np.arange(4), g[:, None]] = bf[ni, 1]
                        C = A16 @ B
                        for q in range(4):
                            accs[warp, mi, ni, q] += C[g + 8 * (q >> 1), 2 * t + (q & 1)]
    for warp in range(8):
        wm, wn = (warp >> 2) * 64, (warp & 3) * 64
        for i in range(8):
            rows = wm + 16 * (i >> 1) + 8 * (i & 1) + g
            for j in range(16):
                cols = wn + 32 * (j >> 3) + 4 * (2 * t + (j & 1)) + ((j >> 1) & 3)
                out[rows, cols] = accs[warp, i >> 1, j >> 1, 2 * (i & 1) + (j & 1)]
                np.add.at(writes, (rows, cols), 1)
    return out, writes


# (V, M, K, N): 16-byte copies over two slabs; 4-byte ones with K ending mid
# slab; byte copies with ragged rows and columns
S8_SHAPES = [(16, 128, 256, 256), (4, 130, 200, 260), (1, 100, 131, 251)]


@pytest.mark.parametrize("V,M,K,N", S8_SHAPES)
def test_s8_block_writes_each_cell_once_with_the_product(V, M, K, N):
    rng = np.random.default_rng(V)
    a = rng.integers(-128, 128, (M, K)).astype(np.int64)
    d = rng.integers(-128, 128, (K, N)).astype(np.int64)
    for m0, n0 in ((0, 0), (BM, S8_BN)) if M > BM and N > S8_BN else ((0, 0),):
        out, writes = s8_block(a, d, m0, n0, V)
        assert (writes == 1).all()
        ref = np.zeros((BM, S8_BN), np.int64)
        blk = a[m0:m0 + BM] @ d[:, n0:n0 + S8_BN]
        ref[:blk.shape[0], :blk.shape[1]] = blk
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("V", [16, 4, 1])
def test_s8_copies_fill_each_slab_byte_once_in_32_banks(V):
    """Each copy instruction of a warp (32 lanes, V bytes each) writes
    distinct bytes and, for 16-byte copies, spreads each quarter-warp's 128
    bytes over the 32 banks."""
    for rows_w, swz in ((IBK, a_swz), (S8_BN, d_swz)):
        per_row = rows_w // V
        for i in range(BM * IBK // V // THREADS):
            c = np.arange(THREADS) + i * THREADS
            row, off = c // per_row, (c % per_row) * V
            dst = swz(row, off >> 4) + (off & 15)
            assert len(set(dst.tolist())) == THREADS
            if V == 16:
                for q in range(0, THREADS, 8):
                    assert banks_ok((dst[q:q + 8, None] + 4 * np.arange(4)) // 4)


# ---------------------------------------------------------------------------
# f32 and bf16: tile_simt_kernel
# ---------------------------------------------------------------------------


def strip(t, i):
    return np.where(i < 4, t * 4 + i, 64 + t * 4 + i - 4)


def bf16_bits(x):
    return (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.uint64)


def simt_fill(a, d, m0, n0, s, mode, V):
    """One slab: A as 4-byte units [UNITS][A_LD] (f32 bits, or two bf16
    with k even in the low half), D as [KS][BN] values; with write counts."""
    M, K = a.shape
    N = d.shape[1]
    uk = 4 // ESZ[mode]
    ks = UNITS * uk
    sa, ca = np.zeros(UNITS * A_LD, np.uint64), np.zeros(UNITS * A_LD, int)
    tid = np.arange(THREADS)
    lane, warp = tid & 31, tid >> 5
    au = (warp & 3) * 8 + (lane & 7)
    am = (warp >> 2) * 4 + (lane >> 3)
    k = s * ks + au * uk
    for i in range(BM * UNITS // THREADS):
        rows = m0 + am + 8 * i
        dst = au * A_LD + am + 8 * i
        assert banks_ok(dst.reshape(8, 32)[0]) and banks_ok(dst.reshape(8, 32)[5])
        rin = rows < M
        r = np.minimum(rows, M - 1)
        if mode == "f32":
            word = np.where(rin & (k < K), a[r, np.minimum(k, K - 1)].astype(np.float32)
                            .view(np.uint32), 0).astype(np.uint64)
        else:  # V >= 4 needs K even, so k < K covers k + 1; V 2 tests each half
            lo = np.where(rin & (k < K), bf16_bits(a[r, np.minimum(k, K - 1)]), 0)
            hi = np.where(rin & (k + 1 < K), bf16_bits(a[r, np.minimum(k + 1, K - 1)]), 0)
            word = lo | (hi << 16)
        sa[dst] = word
        np.add.at(ca, dst, 1)
    dv = ESZ[mode] if V < 4 else V
    epc = dv // ESZ[mode]  # elements per copy
    d_row = BN * ESZ[mode] // dv
    sd, cd = np.zeros(ks * BN), np.zeros(ks * BN, int)
    c = np.arange(ks * d_row)
    row, col = c // d_row, (c % d_row) * epc
    gk = s * ks + row
    for e in range(epc):
        full = (gk < K) & (n0 + col < N)
        sd[row * BN + col + e] = np.where(
            full, d[np.minimum(gk, K - 1), np.minimum(n0 + col + e, N - 1)], 0)
        np.add.at(cd, row * BN + col + e, 1)
    return sa, sd, ca, cd


def simt_block(a, d, m0, n0, mode, V):
    K = a.shape[1]
    uk = 4 // ESZ[mode]
    ks = UNITS * uk
    tid = np.arange(THREADS)
    tx, ty = tid % 16, tid // 16
    i8 = np.arange(8)
    acc = np.zeros((THREADS, 8, 8))
    for s in range((K + ks - 1) // ks):
        sa, sd, ca, cd = simt_fill(a, d, m0, n0, s, mode, V)
        assert (ca[(np.arange(UNITS * A_LD) % A_LD) < BM] == 1).all() and (cd == 1).all()
        for kk in range(ks):
            u, q = kk // uk, kk % uk
            addr = u * A_LD + strip(ty[:, None], i8)  # (threads, 8) words
            for wp in range(8):  # a warp's two reads (strips), two 16-byte chunks each
                assert banks_ok(addr[32 * wp:32 * wp + 32, :4])
                assert banks_ok(addr[32 * wp:32 * wp + 32, 4:])
            w = sa[addr]
            if mode == "f32":
                av = w.astype(np.uint32).view(np.float32)
            else:
                bits = (w << 16) & 0xFFFFFFFF if q == 0 else w & 0xFFFF0000
                av = bits.astype(np.uint32).view(np.float32)
            bv = sd[kk * BN + strip(tx[:, None], i8)]
            acc += av[:, :, None].astype(np.float64) * bv[:, None, :]
    out = np.full((BM, BN), np.nan)
    writes = np.zeros((BM, BN), int)
    rows = strip(ty[:, None, None], i8[None, :, None]) + 0 * i8[None, None, :]
    cols = strip(tx[:, None, None], i8[None, None, :]) + 0 * i8[None, :, None]
    out[rows, cols] = acc
    np.add.at(writes, (rows, cols), 1)
    return out, writes


# (mode, V, M, K, N): 16-byte D copies over two slabs; 4-byte ones with K
# ending mid slab; bf16's element copies with an odd K and N
SIMT_SHAPES = [("f32", 16, 200, 64, 256), ("f32", 4, 130, 45, 130),
               ("bf16", 16, 128, 128, 128), ("bf16", 4, 100, 70, 130),
               ("bf16", 2, 129, 75, 131)]


@pytest.mark.parametrize("mode,V,M,K,N", SIMT_SHAPES)
def test_simt_block_writes_each_cell_once_with_the_product(mode, V, M, K, N):
    rng = np.random.default_rng(K)
    a = rng.integers(-8, 9, (M, K)).astype(np.float64)  # exact in bf16 and f32
    d = rng.integers(-8, 9, (K, N)).astype(np.float64)
    for m0, n0 in ((0, 0), (BM, BN)) if M > BM and N > BN else ((0, 0),):
        out, writes = simt_block(a, d, m0, n0, mode, V)
        assert (writes == 1).all()
        ref = np.zeros((BM, BN))
        blk = a[m0:m0 + BM] @ d[:, n0:n0 + BN]
        ref[:blk.shape[0], :blk.shape[1]] = blk
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_simt_d_reads_are_two_wavefronts(mode):
    """A warp's D strip reads (16 threads across, 8 values each) touch 16
    distinct chunks of one slab row: 256 (f32) or 128 (bf16) bytes, the
    least the data needs."""
    tid = np.arange(32)
    tx = tid % 16
    for lo in (0, 64):
        words = (lo + tx * 4) * ESZ[mode] // 4
        chunk = words[:, None] + np.arange(ESZ[mode])  # the words one thread reads
        assert len(np.unique(chunk)) == 16 * ESZ[mode]
        per_bank = np.bincount(np.unique(chunk) % 32, minlength=32)
        assert per_bank.max() == (2 if mode == "f32" else 1)


# ---------------------------------------------------------------------------
# the launch's copy width
# ---------------------------------------------------------------------------


def copy_width(K, N, esz, base_align=256):
    """product_any's choice (copy_width in tile_kernels.cuh) for operands
    whose bases are `base_align`-byte aligned, as PyTorch allocates them."""
    bits = base_align | K * esz | N * esz
    return 16 if bits % 16 == 0 else 4 if bits % 4 == 0 else esz


def test_card_cases_take_every_copy_width_and_the_main_path_16_bytes():
    taken = set()
    shapes = dict(K1_CARD_SHAPES)
    for mode, _, _, label in K1_CARD_CASES:
        _, u, tc, _ = shapes[label]
        taken.add((mode, copy_width(u, tc, ESZ[mode])))
    for mode, _, _, si in K3_CARD_CASES:
        K, tc, n_tiles, _ = K3_CARD_SHAPES[si]
        taken.add((mode, copy_width(K, tc * n_tiles, ESZ[mode])))
    assert taken == VARIANTS
    # the main path: u_pad, compaction K (multiples of KB = 768) and tc are
    # multiples of 128
    for mode in ESZ:
        for K, N in ((200_960, 8192), (84_480, 7680), (33_024, 86_016), (8448, 43_008)):
            assert copy_width(K, N, ESZ[mode]) == 16
    assert TM == 2 * BM  # a K3 panel is two row blocks of one column block


# ---------------------------------------------------------------------------
# bf16 with narrow copies: tile_bf16_kernel (K1, K3), mma.sync m16n8k16
# through ldmatrix (16-byte copies and the split modes take the wgmma
# kernel, tests/test_torch_wgmma_layout.py)
# ---------------------------------------------------------------------------

TBK, T_STAGES = 64, 3


def ak_swz(r, ch):
    """Byte offset of chunk ch of row r of K1's A slab (128-byte rows)."""
    return r * (TBK * 2) + ((ch ^ (r & 7)) << 4)


def kn_swz(r, ch):
    """Byte offset of chunk ch of row r of a 128-column bf16 slab."""
    return r * 256 + ((ch ^ (r & 7)) << 4)


def ldmatrix(smem, addrs, trans):
    """ldmatrix .x4 of 16-bit words from `smem` (one value per 2-byte
    element) at the 32 lanes' row byte addresses: (4 regs, 32 lanes, 2
    values); each matrix's 8 rows must hit 32 banks."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    out = np.zeros((4, 32, 2), smem.dtype)
    for i in range(4):
        rows = addrs[8 * i:8 * i + 8]
        assert (rows % 16 == 0).all()
        assert banks_ok((rows[:, None] + 4 * np.arange(4)) // 4)
        if trans:  # lane 4g+t: rows 2t and 2t+1 of column g
            for h in range(2):
                out[i, :, h] = smem[(rows[2 * t + h] + 2 * g) // 2]
        else:  # lane 4g+t: row g, columns 2t and 2t+1
            for h in range(2):
                out[i, :, h] = smem[(rows[g] + 4 * t + 2 * h) // 2]
    return out


def mma16816(af, bf):
    """m16n8k16 of one warp from fragments (regs, lanes, 2): the (16, 8)
    product as C's four registers (4, 32)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for h in range(2):
        A[g, 2 * t + h], A[g + 8, 2 * t + h] = af[0, :, h], af[1, :, h]
        A[g, 2 * t + 8 + h], A[g + 8, 2 * t + 8 + h] = af[2, :, h], af[3, :, h]
        B[2 * t + h, g], B[2 * t + 8 + h, g] = bf[0, :, h], bf[1, :, h]
    C = A @ B
    return np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]])


def bf16_fill(a, d, m0, n0, s, V):
    """One stage of tile_bf16_kernel (fetch): A's slab [BM][TBK] and D's
    [TBK][BN] as swizzled element arrays, with write counts."""
    (M, K), N = a.shape, d.shape[1]
    tid = np.arange(THREADS)
    out = {}
    for name, rows_n, row_b in (("a", BM, TBK * 2), ("d", TBK, BN * 2)):
        per_row = row_b // V
        sm, cnt = np.zeros(rows_n * row_b // 2), np.zeros(rows_n * row_b // 2, int)
        for i in range(rows_n * per_row // THREADS):
            c = tid + i * THREADS
            row, off = c // per_row, (c % per_row) * V
            if name == "a":
                dst = ak_swz(row, off >> 4) + (off & 15)
                k = s * TBK + off // 2
                for e in range(V // 2):
                    full = (m0 + row < M) & (k + e < K)
                    sm[dst // 2 + e] = np.where(full, a[np.minimum(m0 + row, M - 1),
                                                        np.minimum(k + e, K - 1)], 0)
                    np.add.at(cnt, dst // 2 + e, 1)
            else:
                dst = kn_swz(row, off >> 4) + (off & 15)
                k, col = s * TBK + row, n0 + off // 2
                for e in range(V // 2):
                    full = (k < K) & (col + e < N)
                    sm[dst // 2 + e] = np.where(full, d[np.minimum(k, K - 1),
                                                        np.minimum(col + e, N - 1)], 0)
                    np.add.at(cnt, dst // 2 + e, 1)
            if V == 16:  # each quarter-warp's 128 bytes over 32 banks
                for q in range(0, THREADS, 8):
                    assert banks_ok((dst[q:q + 8, None] + 4 * np.arange(4)) // 4)
        assert (cnt == 1).all()
        out[name] = sm
    return out


def bf16_block(a, d, m0, n0, V):
    """The block's outputs as tile_bf16_kernel computes and writes them."""
    K = a.shape[1]
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    acc = np.zeros((8, 4, 4, 4, 32))  # warp, mi, ni, q, lane
    for s in range((K + TBK - 1) // TBK):
        st = bf16_fill(a, d, m0, n0, s, V)
        for warp in range(8):
            wm, wn = (warp >> 2) * 64, (warp & 3) * 32
            for ks in range(0, TBK, 16):
                fa = [ldmatrix(st["a"], ak_swz(wm + 16 * mi + (lane & 15), ks // 8 + (lane >> 4)),
                               False) for mi in range(4)]
                fb = []
                for nj in range(2):
                    r = ldmatrix(st["d"], kn_swz(ks + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                 (wn + 16 * nj) // 8 + (lane >> 4)), True)
                    fb += [r[0:2], r[2:4]]
                for mi in range(4):
                    for ni in range(4):
                        acc[warp, mi, ni] += mma16816(fa[mi], fb[ni])
    out = np.full((BM, BN), np.nan)
    writes = np.zeros((BM, BN), int)
    for warp in range(8):
        wm, wn = (warp >> 2) * 64, (warp & 3) * 32
        for i in range(8):
            rows = wm + 16 * (i >> 1) + 8 * (i & 1) + g
            for j in range(8):
                cols = wn + 8 * (j >> 1) + 2 * t + (j & 1)
                out[rows, cols] = acc[warp, i >> 1, j >> 1, 2 * (i & 1) + (j & 1)]
                np.add.at(writes, (rows, cols), 1)
    return out, writes


# (V, M, K, N): the narrow copies that take this kernel (4 with K ending
# mid slab, element copies with odd K and N), and the template at 16 bytes
# over two slabs
BF16_SHAPES = [(16, 128, 128, 128), (4, 100, 70, 130), (2, 129, 75, 131)]


@pytest.mark.parametrize("V,M,K,N", BF16_SHAPES)
def test_bf16_block_writes_each_cell_once_with_the_product(V, M, K, N):
    rng = np.random.default_rng(K + V)
    a = rng.integers(-8, 9, (M, K)).astype(np.float64)
    d = rng.integers(-8, 9, (K, N)).astype(np.float64)
    ref_all = a @ d
    for m0, n0 in ((0, 0), (BM, BN)) if M > BM and N > BN else ((0, 0),):
        out, writes = bf16_block(a, d, m0, n0, V)
        assert (writes == 1).all()
        ref = np.zeros((BM, BN))
        blk = ref_all[m0:m0 + BM, n0:n0 + BN]
        ref[:blk.shape[0], :blk.shape[1]] = blk
        np.testing.assert_array_equal(out, ref)
