// K2 of the port: one block of the symmetric (self-similarity) executor,
// feeding both top-k directions, for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces similaripy_tpu/engine/pallas_kernels.py::fused_sym_topk (kernel
// body _sym_kernel, shared epilogue _epilogue_val). The anchors are an
// anchor group of sw = gt * tc item rows starting at tile a0, stored as the
// executor's dense (gt, K, tc) tiles; d is the (K, tc) dense inner tile t.
// With xy = anchors . d (the shared user axis contracted):
//   row side  anchor rows whose tile rt = a0 + row / tc satisfies rt <= t
//             take tile t's columns (ids col_base + col): only values above
//             the row's carried kth enter, ties go to the lowest column and
//             tile entries come before carry entries (K1's rules);
//             rows with rt > t pass their carry through unchanged
//   col side  only for rt < t: tile t's columns take those anchor rows as
//             candidates (ids row_base + row), merged into the column's
//             carry with the carry ahead of an equal new entry and, among
//             new entries, the lowest row first (_sym_kernel's sorted
//             insertion, `ge = av >= x`). With an asymmetric epilogue the
//             col side re-runs it with x2 (X at the tile's items) and y2
//             (Y at the anchor's items).
// The masks deliver every ordered pair once, the diagonal included.
// pvec_ext carries [10] col_base, [11] row_base, [12] t, [13] a0, read on
// the card so that the host never waits.
//
// What bounds it on an H100 SXM: the product. At the main path's shapes
// (sw = tc = 2,048 f32, 4,096 int8; K = 200,960) it does ~500 (f32) to
// ~4,000 (int8) operations per byte of the anchors and the tile, against
// peaks (NVIDIA's data sheet, dense, at the 700 W limit) of 67 TFLOP/s of
// f32 FMA outside the tensor cores for f32 and bf16 (bf16 operands, f32
// products) and 1,979 TOP/s of int8 on the tensor cores.
//
// Three launches:
//   1. the product with the fused epilogue, one output block per thread
//      block (both operands are (K, tc) row-major: a block's 128 anchor rows
//      are 128 columns of one anchor tile), skipping row blocks below the
//      band. Both operands stream through a ring of STAGES = 3 shared-memory
//      slabs filled by 16-byte cp.async copies (rows past K and columns
//      past tc zero-filled), two slabs ahead of the one in use, with one
//      barrier per slab. The epilogue writes the row-side scores (sw x tc)
//      and, for rows with rt < t, the col-side scores transposed (tc x sw)
//      to scratch that the wrapper allocates.
//        f32, bf16  sym_simt_kernel: 128 x 128 blocks, SIMT FMA, 8 x 8
//                   outputs a thread, 32 K rows a slab; the (K, tc) slab is
//                   already the outer product's layout. Each output is one
//                   in-order fmaf chain over k (no split, no TF32), so the
//                   scores are those of the plain loop; bf16 is widened
//                   exactly on the way out of shared memory.
//        int8       sym_s8_kernel: 128 x 256 blocks, mma.sync m16n8k32 s8
//                   -> s32 (exact), 8 warps of 64 x 64, 128 K bytes a slab,
//                   one block per SM (128 accumulators a thread). mma.sync
//                   wants k-contiguous words and the slab holds (k, m)
//                   bytes, so each warp reads its fragments straight from the
//                   arrived slab as 4 (k) x 4 (m) byte blocks and transposes
//                   them in registers (transpose4x4, csrc/tensor_core.cuh).
//                   The four words of a block are four columns, so a
//                   fragment row (column) stands for a permuted column of
//                   the warp's 64: one block gives a word to each of four
//                   mma tiles, with no staging buffer and no second barrier,
//                   and the epilogue maps the permutation back. The slab's
//                   16-byte chunks are XOR-swizzled by bits 2..3 of the row
//                   so that these reads hit 32 banks.
//   2. merge_kernel<true>: one block per anchor row, K1's survivor sort and
//      carry merge over the row-side plane.
//   3. merge_kernel<false>: one block per tile column over the transposed
//      plane. A column has up to sw candidates, more than shared memory
//      holds at 8 bytes each, so they are taken in chunks of at most 16,384:
//      each chunk keeps the values above the running kth, sorts them and
//      merges them into the running list in shared memory.
// Shapes: tc a multiple of 128 (the executor's) and 16-byte aligned
// operands, else the launch returns cudaErrorInvalidValue; any K.
// Given away for later work: wgmma (an 8-bit operand must be K-major in
// swizzled shared memory), TMA, and keeping the scores on chip instead of
// a round trip through device memory.

#include "splus_epilogue.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block (f32, bf16)
constexpr int S8_BN = 256;    // output columns per block (int8)
constexpr int THREADS = 256;  // 8 warps
constexpr int STAGES = 3;     // slabs in the shared-memory ring
constexpr int FBK = 32;       // f32 / bf16: K rows per slab
constexpr int IBK = 128;      // int8: K bytes per slab, four k32 steps
constexpr int MERGE_THREADS = 512;
constexpr int MAX_CHUNK = 16384;  // candidates sorted at once (128 KB of keys)
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// anchor rows that take tile t's columns: row tile <= t
__device__ __forceinline__ int live_rows(const float* pvec, int sw, int tc) {
  return clampi(((int)pvec[12] - (int)pvec[13] + 1) * tc, 0, sw);
}

// anchor rows that are candidates of tile t's columns: row tile < t
__device__ __forceinline__ int col_rows(const float* pvec, int sw, int tc) {
  return clampi(((int)pvec[12] - (int)pvec[13]) * tc, 0, sw);
}

// What the product's epilogue reads and writes.
struct Epi {
  const float *xt, *xc, *xd;     // X at the anchor rows (sw)
  const float *yt, *yc, *yd;     // Y at the tile columns (tc)
  const float *x2t, *x2c, *x2d;  // asymmetric col side: X at the tile (tc), or null
  const float *y2t, *y2c, *y2d;  //   and Y at the anchor rows (sw)
  const float* pvec;
  int flags;
  float* scores_r;  // (sw, tc)
  float* scores_c;  // (tc, sw)
};

// The fused epilogue of a thread's 8 x NC cells: anchor rows rows[i] x tile
// columns cols[j], with products xy(i, j); columns past tc are skipped.
template <int NC, typename XY>
__device__ __forceinline__ void epilogue(const Epi& e, int sw, int tc, int n_live, int n_col,
                                         const int (&rows)[8], const int (&cols)[NC], XY xy) {
  const float thr = e.pvec[8];
  const bool asym = e.x2t != nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rows[i];
    if (r >= n_live) continue;
    const float xtr = e.xt[r], xcr = e.xc[r], xdr = e.xd[r];
    const bool col_side = r < n_col;
    const float y2tr = (col_side && asym) ? e.y2t[r] : 0.0f;
    const float y2cr = (col_side && asym) ? e.y2c[r] : 0.0f;
    const float y2dr = (col_side && asym) ? e.y2d[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = cols[j];
      if (c >= tc) continue;
      const float v = xy(i, j);
      const bool cand = v != 0.0f;
      const float val = splus_val(v, e.flags, e.pvec, xtr, xcr, xdr, e.yt[c], e.yc[c], e.yd[c]);
      e.scores_r[(size_t)r * tc + c] = (cand && val >= thr) ? val : -INFINITY;
      if (col_side) {
        const float vc = asym ? splus_val(v, e.flags, e.pvec, e.x2t[c], e.x2c[c], e.x2d[c],
                                          y2tr, y2cr, y2dr)
                              : val;
        e.scores_c[(size_t)c * sw + r] = (cand && vc >= thr) ? vc : -INFINITY;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 and bf16: pipelined SIMT
// ---------------------------------------------------------------------------

// the row (or column) of micro-tile entry i: two 4-wide strips 64 apart
__device__ __forceinline__ int strip(int t, int i) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + i - 4;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four bf16 widened to f32 (exact: the bf16 bits are the f32's top half)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// a thread's 8 values of one slab row: strips t * 4 and 64 + t * 4
template <typename E>
__device__ __forceinline__ void load_frag(float (&v)[8], const E* row, int t) {
  const float4 lo = load4(row + t * 4), hi = load4(row + 64 + t * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

template <typename E>
constexpr size_t simt_smem() { return 2ull * STAGES * FBK * BM * sizeof(E); }

template <typename E>
__global__ void __launch_bounds__(THREADS, 2) sym_simt_kernel(
    const E* __restrict__ a, const E* __restrict__ d, int sw, int K, int tc, Epi e) {
  constexpr int ROW_CHUNKS = BM * (int)sizeof(E) / 16;  // 16-byte chunks in a slab row
  constexpr int ROW_STEP = THREADS / ROW_CHUNKS;        // rows between a thread's copies
  constexpr int COPIES = FBK / ROW_STEP;                // per operand, thread and slab
  constexpr int STAGE = FBK * BM;                       // elements per operand and slab
  extern __shared__ __align__(16) unsigned char smem[];
  E* as = reinterpret_cast<E*>(smem);  // [STAGES][FBK][BM]
  E* ds = as + STAGES * STAGE;         // [STAGES][FBK][BN]

  const int n_live = live_rows(e.pvec, sw, tc);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= n_live) return;  // below the band: the merge passes the carry
  const int n_col = col_rows(e.pvec, sw, tc);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // this thread's copies: rows crow + i * ROW_STEP of a slab, 16 bytes at
  // ccol; the block's anchor rows are columns m0 % tc .. + 128 of anchor
  // tile m0 / tc
  const int crow = tid / ROW_CHUNKS, ccol = (tid % ROW_CHUNKS) * (16 / (int)sizeof(E));
  const size_t first = (size_t)crow * tc + ccol;
  const E* ag = a + (size_t)(m0 / tc) * K * tc + m0 % tc + first;
  const E* dg = d + n0 + first;
  const int n_slabs = (K + FBK - 1) / FBK;

  auto fetch = [&](int s) {
    if (s < n_slabs) {
      E* sa = as + (s % STAGES) * STAGE + crow * BM + ccol;
      E* sd = ds + (s % STAGES) * STAGE + crow * BN + ccol;
#pragma unroll
      for (int i = 0; i < COPIES; ++i) {
        const bool full = s * FBK + crow + i * ROW_STEP < K;
        const size_t off = (size_t)(s * FBK + i * ROW_STEP) * tc;
        cp_async16(sa + i * ROW_STEP * BM, full ? ag + off : a, full);
        cp_async16(sd + i * ROW_STEP * BN, full ? dg + off : d, full);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();  // slab s is in
    __syncthreads();              // ... for every thread, and slab s - 1 is done with
    fetch(s + STAGES - 1);        // into slab s - 1's place
    const E* sa = as + (s % STAGES) * STAGE;
    const E* sd = ds + (s % STAGES) * STAGE;
    float av[2][8], bv[2][8];
    load_frag(av[0], sa, ty);
    load_frag(bv[0], sd, tx);
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      if (kk + 1 < FBK) {  // the next row's values load while this row's FMAs run
        load_frag(av[(kk + 1) & 1], sa + (kk + 1) * BM, ty);
        load_frag(bv[(kk + 1) & 1], sd + (kk + 1) * BN, tx);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[kk & 1][i], bv[kk & 1][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  int rows[8], cols[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rows[i] = m0 + strip(ty, i);
    cols[i] = n0 + strip(tx, i);
  }
  epilogue(e, sw, tc, n_live, n_col, rows, cols, [&](int i, int j) { return acc[i][j]; });
}

// ---------------------------------------------------------------------------
// int8: mma.sync m16n8k32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr size_t S8_SMEM = (size_t)STAGES * IBK * (BM + S8_BN);

// Byte offset of 16-byte chunk `ch` of row `r` of an int8 slab whose rows
// are W bytes: the chunk index is XORed with twice bits 2..3 of the row, so
// a warp's fragment reads (rows 4 tig + q for tig 0..3, words of two
// neighbouring chunks for g 0..7) fall in 8 distinct chunks, 32 banks.
template <int W>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * W + ((ch ^ (((r >> 2) & 3) << 1)) << 4);
}

// rows r0 .. r0 + 3 of 32-bit word `word` (four bytes of m), transposed:
// w[j] holds the four k bytes of column 4 word + j
template <int W>
__device__ __forceinline__ void block4x4(uint32_t (&w)[4], const unsigned char* s, int r0,
                                         int word) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = *reinterpret_cast<const uint32_t*>(s + swz<W>(r0 + q, word >> 2) + (word & 3) * 4);
  transpose4x4(w);
}

// One 128 x 256 block: 8 warps of 64 x 64 (4 m16 x 8 n8 tiles each), 128
// accumulators a thread, so one block per SM.
__global__ void __launch_bounds__(THREADS, 1) sym_s8_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ d, int sw, int K, int tc, Epi e) {
  constexpr int SA = IBK * BM, SD = IBK * S8_BN;  // bytes per operand and slab
  constexpr int A_COPIES = SA / 16 / THREADS, D_COPIES = SD / 16 / THREADS;
  constexpr int D_CHUNKS = S8_BN / 16;            // 16-byte chunks in a d slab row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* as = smem;                   // [STAGES][IBK][BM], swizzled rows
  unsigned char* ds = smem + STAGES * SA;     // [STAGES][IBK][S8_BN]

  const int n_live = live_rows(e.pvec, sw, tc);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * S8_BN;
  if (m0 >= n_live) return;  // below the band: the merge passes the carry
  const int n_col = col_rows(e.pvec, sw, tc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 64;

  // the block's anchor rows are columns m0 % tc .. + 128 of anchor tile
  // m0 / tc; its tile columns n0 .. n0 + 256 of d, those past tc zero-filled
  const int8_t* ab = a + (size_t)(m0 / tc) * K * tc + m0 % tc;
  const int8_t* db = d + n0;
  const int n_slabs = (K + IBK - 1) / IBK;

  auto fetch = [&](int s) {
    if (s < n_slabs) {
      unsigned char* sa = as + (s % STAGES) * SA;
      unsigned char* sd = ds + (s % STAGES) * SD;
#pragma unroll
      for (int i = 0; i < A_COPIES; ++i) {
        const int c = tid + i * THREADS, row = c >> 3, ch = c & 7;
        const int k = s * IBK + row;
        const bool full = k < K;
        cp_async16(sa + swz<BM>(row, ch), full ? ab + (size_t)k * tc + ch * 16 : a, full);
      }
#pragma unroll
      for (int i = 0; i < D_COPIES; ++i) {
        const int c = tid + i * THREADS, row = c / D_CHUNKS, ch = c % D_CHUNKS;
        const int k = s * IBK + row;
        const bool full = k < K && n0 + ch * 16 < tc;
        cp_async16(sd + swz<S8_BN>(row, ch), full ? db + (size_t)k * tc + ch * 16 : d, full);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  int acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();  // slab s is in
    __syncthreads();              // ... for every thread, and slab s - 1 is done with
    fetch(s + STAGES - 1);        // into slab s - 1's place
    const unsigned char* sa = as + (s % STAGES) * SA;
    const unsigned char* sd = ds + (s % STAGES) * SD;
#pragma unroll
    for (int ks = 0; ks < IBK; ks += 32) {
      // fragment row g of m-tile mi is column 4 g + mi of the warp's first
      // 32, row g + 8 column 32 + 4 g + mi; column g of n-tile 4 h + j is
      // column 32 h + 4 g + j of its 64
      uint32_t af[4][4], bf[8][2];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {  // k = ks + 16 kh + 4 tig .. + 3
        const int r0 = ks + 16 * kh + 4 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w[4];
          block4x4<BM>(w, sa, r0, wm / 4 + 8 * h + g);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) af[mi][h + 2 * kh] = w[mi];
          block4x4<S8_BN>(w, sd, r0, wn / 4 + 8 * h + g);
#pragma unroll
          for (int j = 0; j < 4; ++j) bf[4 * h + j][kh] = w[j];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // C row g + 8 hh of m-tile mi is anchor row wm + 32 hh + 4 g + mi; C
  // column 2 tig + jj of n-tile ni is tile column wn + 32 (ni / 4) +
  // 4 (2 tig + jj) + ni % 4
  int rows[8], cols[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = m0 + wm + 32 * (i & 1) + 4 * g + (i >> 1);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    cols[j] = n0 + wn + 32 * (j >> 3) + 4 * (2 * tig + (j & 1)) + ((j >> 1) & 3);
  const float inv_scale = e.pvec[9];
  epilogue(e, sw, tc, n_live, n_col, rows, cols, [&](int i, int j) {
    return __fmul_rn(__int2float_rn(acc[i >> 1][j >> 1][2 * (i & 1) + (j & 1)]), inv_scale);
  });
}

// One block per output row; the outputs and the carry are (k_pad x M).
// ROW_SIDE: the rows are the anchor rows, the candidates tile t's tc
// columns of the row-side plane (row stride tc); rows below the band pass
// their carry through. Only values above kth_in[row] enter; ties go to new
// entries (lowest column first), then the carry.
// !ROW_SIDE: the rows are tile t's columns, the candidates the anchor rows
// with row tile < t in the transposed plane (row stride sw), taken in
// chunks of `cap`; each chunk keeps what beats the running kth. Ties go to
// the running list (the carry first), then new entries by lowest row.
// Dynamic shared memory: `cap` sort keys, then the running list and its
// merge target (values and ids, k_pad each).
template <bool ROW_SIDE>
__global__ void __launch_bounds__(MERGE_THREADS) merge_kernel(
    const float* __restrict__ scores, int M, int stride, int sw, int tc,
    int k_pad, int cap, const float* __restrict__ pvec,
    const float* __restrict__ kth_in, const float* __restrict__ cv,
    const int* __restrict__ ci, float* __restrict__ ov, int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* lv = reinterpret_cast<float*>(keys + cap);
  int* li = reinterpret_cast<int*>(lv + k_pad);
  float* lv2 = reinterpret_cast<float*>(li + k_pad);
  int* li2 = reinterpret_cast<int*>(lv2 + k_pad);
  __shared__ int n_surv;

  const int row = blockIdx.x, tid = threadIdx.x;
  int n_cand, id_base;
  if constexpr (ROW_SIDE) {
    n_cand = row < live_rows(pvec, sw, tc) ? tc : 0;
    id_base = (int)pvec[10];
  } else {
    n_cand = col_rows(pvec, sw, tc);
    id_base = (int)pvec[11];
  }
  for (int j = tid; j < k_pad; j += MERGE_THREADS) {
    lv[j] = cv[(size_t)j * M + row];
    li[j] = ci[(size_t)j * M + row];
  }
  __syncthreads();
  float kth = ROW_SIDE ? kth_in[row] : lv[k_pad - 1];
  const float* srow = scores + (size_t)row * stride;

  for (int c0 = 0; c0 < n_cand; c0 += cap) {
    if (tid == 0) n_surv = 0;
    __syncthreads();
    const int c1 = min(c0 + cap, n_cand);
    for (int c = c0 + tid; c < c1; c += MERGE_THREADS) {
      const float v = srow[c];
      if (v > kth) keys[atomicAdd(&n_surv, 1)] = make_key(v, c);
    }
    __syncthreads();
    const int n = n_surv;
    if (n > 0) {
      int p2 = 1;
      while (p2 < n) p2 <<= 1;
      for (int i = n + tid; i < p2; i += MERGE_THREADS) keys[i] = 0ull;  // sorts last
      __syncthreads();
      // bitonic sort, descending, over the p2 keys
      for (int k = 2; k <= p2; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = tid; i < p2; i += MERGE_THREADS) {
            const int ixj = i ^ j;
            if (ixj > i) {
              const unsigned long long x = keys[i], y = keys[ixj];
              const bool desc = (i & k) == 0;
              if (desc ? (x < y) : (x > y)) {
                keys[i] = y;
                keys[ixj] = x;
              }
            }
          }
          __syncthreads();
        }
      }
      // stable merge of the chunk's top m with the running list: each entry
      // lands after the entries of the other list that go before it
      const int m = n < k_pad ? n : k_pad;
      for (int i = tid; i < m; i += MERGE_THREADS) {
        const float v = key_val(keys[i]);
        int lo = 0, hi = k_pad;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ROW_SIDE ? (lv[mid] > v) : (lv[mid] >= v)) lo = mid + 1; else hi = mid;
        }
        const int pos = i + lo;
        if (pos < k_pad) {
          lv2[pos] = v;
          li2[pos] = id_base + key_col(keys[i]);
        }
      }
      for (int j = tid; j < k_pad; j += MERGE_THREADS) {
        const float v = lv[j];
        int lo = 0, hi = m;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const float w = key_val(keys[mid]);
          if (ROW_SIDE ? (w >= v) : (w > v)) lo = mid + 1; else hi = mid;
        }
        const int pos = j + lo;
        if (pos < k_pad) {
          lv2[pos] = v;
          li2[pos] = li[j];
        }
      }
      __syncthreads();
      float* tv = lv; lv = lv2; lv2 = tv;
      int* ti = li; li = li2; li2 = ti;
      if (!ROW_SIDE) kth = lv[k_pad - 1];
    }
    __syncthreads();  // every thread is done with keys and n_surv
  }
  for (int j = tid; j < k_pad; j += MERGE_THREADS) {
    ov[(size_t)j * M + row] = lv[j];
    oi[(size_t)j * M + row] = li[j];
  }
}

template <typename... P, typename... A>
cudaError_t launch_product(void (*kern)(P...), size_t smem, int bn, int sw, int tc,
                           cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((tc + bn - 1) / bn, sw / BM), THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// registers, local bytes (spills), dynamic shared bytes and resident blocks
// per SM of one product kernel
template <typename... P>
cudaError_t kernel_attrs(void (*kern)(P...), size_t smem, int* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, kern);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, smem);
  if (err != cudaSuccess) return err;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return cudaSuccess;
}

template <bool ROW_SIDE>
cudaError_t launch_merge(const void* scores, int M, int stride, int sw, int tc,
                         int k_pad, int cap, size_t smem, const void* pvec,
                         const void* kth, const void* cv, const void* ci,
                         void* ov, void* oi, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<ROW_SIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  merge_kernel<ROW_SIDE><<<M, MERGE_THREADS, smem, stream>>>(
      static_cast<const float*>(scores), M, stride, sw, tc, k_pad, cap,
      static_cast<const float*>(pvec), static_cast<const float*>(kth),
      static_cast<const float*>(cv), static_cast<const int*>(ci),
      static_cast<float*>(ov), static_cast<int*>(oi));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch 1: the masked epilogue scores of the anchors (a (sw / tc, K, tc)
// tile stack) . d (K x tc) into scores_r (sw x tc) and, transposed,
// scores_c (tc x sw). `vecs` holds twelve f32 pointers: xt xc
// xd (sw), yt yc yd (tc), then x2t x2c x2d (tc) y2t y2c y2d (sw), the last
// six null unless the epilogue is asymmetric. mode 0 = f32, 1 = bf16,
// 2 = int8. tc must be a multiple of 128 and a and d 16-byte aligned.
int sym_product(int mode, const void* a, const void* d, int sw, int K, int tc,
                const void* const* vecs, const void* pvec, int flags,
                void* scores_r, void* scores_c, void* stream) {
  if (sw <= 0 || tc <= 0 || K < 0 || sw % tc != 0 || tc % BN != 0 ||
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(d)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [&](int i) { return static_cast<const float*>(vecs[i]); };
  const Epi e{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11),
              static_cast<const float*>(pvec), flags, static_cast<float*>(scores_r),
              static_cast<float*>(scores_c)};
  switch (mode) {
    case MODE_F32:
      return (int)launch_product(sym_simt_kernel<float>, simt_smem<float>(), BN, sw, tc, s,
                                 static_cast<const float*>(a), static_cast<const float*>(d),
                                 sw, K, tc, e);
    case MODE_BF16:
      return (int)launch_product(
          sym_simt_kernel<__nv_bfloat16>, simt_smem<__nv_bfloat16>(), BN, sw, tc, s,
          static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(d), sw, K,
          tc, e);
    case MODE_INT8:
      return (int)launch_product(sym_s8_kernel, S8_SMEM, S8_BN, sw, tc, s,
                                 static_cast<const int8_t*>(a), static_cast<const int8_t*>(d),
                                 sw, K, tc, e);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The product kernel of `mode`: out[0] registers a thread, out[1] local
// memory bytes a thread (spills), out[2] dynamic shared memory bytes a
// block, out[3] resident blocks per SM.
int sym_product_attrs(int mode, int* out) {
  switch (mode) {
    case MODE_F32:
      return (int)kernel_attrs(sym_simt_kernel<float>, simt_smem<float>(), out);
    case MODE_BF16:
      return (int)kernel_attrs(sym_simt_kernel<__nv_bfloat16>, simt_smem<__nv_bfloat16>(), out);
    case MODE_INT8:
      return (int)kernel_attrs(sym_s8_kernel, S8_SMEM, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launches 2 and 3: the row-side merge (row_side = 1; carries and outputs
// k_pad x sw, kth: sw) or the col-side merge (row_side = 0; k_pad x tc, kth
// unused) of the scores that sym_product wrote.
int sym_merge(int row_side, const void* scores, int sw, int tc, int k_pad,
              const void* pvec, const void* kth, const void* cv, const void* ci,
              void* ov, void* oi, void* stream) {
  if (sw <= 0 || tc <= 0 || k_pad <= 0) return (int)cudaErrorInvalidValue;
  const int n = row_side ? tc : sw;
  int cap = 1;
  while (cap < n && cap < MAX_CHUNK) cap <<= 1;
  if (row_side && cap < tc) return (int)cudaErrorInvalidValue;  // one chunk only
  const size_t smem = (size_t)cap * 8 + (size_t)k_pad * 16;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_side) {
    return (int)launch_merge<true>(scores, sw, tc, sw, tc, k_pad, cap, smem, pvec,
                                   kth, cv, ci, ov, oi, s);
  }
  return (int)launch_merge<false>(scores, tc, sw, sw, tc, k_pad, cap, smem, pvec,
                                  kth, cv, ci, ov, oi, s);
}

}  // extern "C"
