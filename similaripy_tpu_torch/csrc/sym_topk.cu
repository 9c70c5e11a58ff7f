// K2 of the port: one block of the symmetric (self-similarity) executor,
// feeding both top-k directions, for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces similaripy_tpu/engine/pallas_kernels.py::fused_sym_topk (kernel
// body _sym_kernel, shared epilogue _epilogue_val). The anchors are an
// anchor group of sw = gt * tc item rows starting at tile a0, stored as the
// executor's dense (gt, K, tc) tiles; d is the (K, tc) dense inner tile t.
// int8 takes both K-major instead: the anchors as (sw, K) rows, d as (tc,
// K) rows, which K5 writes so (engine/scatter.py, layout "kmajor").
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
// f32 FMA outside the tensor cores for f32, 989 TFLOP/s of bf16 on the
// tensor cores for bf16 and the split-bf16x3 mode (3 phases: a third of
// that rate in f32 operations), and 1,979 TOP/s of int8 on the tensor cores.
//
// Three launches:
//   1. the product with the fused epilogue, one output block per thread
//      block, skipping row blocks below the band. f32 streams both operands
//      ((K, tc) row-major: a block's 128 anchor rows are 128 columns of one
//      anchor tile) through a ring of 3 shared-memory slabs filled by
//      16-byte cp.async copies (rows past K and columns past tc
//      zero-filled), two slabs ahead of the one in use, with one barrier
//      per slab; bf16, split and int8 through TMA. The epilogue writes the
//      row-side scores (sw x tc) and, for rows with rt < t, the col-side
//      scores transposed (tc x sw) to scratch that the wrapper allocates.
//      The products are shared with P1 (probe_tlhs.cu), which runs them
//      with a store for its epilogue: f32 and bf16 csrc/mn_products.cuh's,
//      int8 hopper.cuh's wgmma_block_s8.
//        f32        sym_simt_kernel: 128 x 128 blocks, SIMT FMA, 8 x 8
//                   outputs a thread, 32 K rows a slab; the (K, tc) slab is
//                   already the outer product's layout. Each output is one
//                   in-order fmaf chain over k (no split, no TF32), so the
//                   scores are those of the plain loop. (The kernel is
//                   written for bf16 too, which no launch instantiates.)
//        bf16 and   sym_wgmma_kernel: 128 x 128 blocks, wgmma.mma_async
//        split      m64n128k16 bf16 -> f32 on operands that TMA brings into
//                   128-byte-swizzled shared memory, in hopper.cuh's
//                   warp-specialised block (two consumer warpgroups of 64 x
//                   128, one producer warp, slabs of 64 K rows in a ring of
//                   6, or 3 for the split mode), in cluster pairs of two
//                   column blocks of one row block that share the anchors:
//                   TMA multicasts each anchor box into both blocks, so the
//                   pair reads its anchors from L2 once (on an H100 the
//                   pairs timed faster than unpaired blocks in both
//                   modes). The block's anchor rows are
//                   128 columns of one (K, tc) anchor tile and its tile
//                   columns 128 columns of d, so both operands are MN-major
//                   and wgmma reads them as they arrive (a 16-bit operand
//                   may be MN-major, unlike int8's). The anchors are the 4D
//                   map (tc, K, halves, gt): the anchor tile m0 / tc is a
//                   coordinate, and so is the half of a [hi; lo] stack, so a
//                   box past K is zero-filled and never reads the lo half.
//                   The split-bf16x3 mode (precision='high' on f32 data;
//                   pallas_kernels.py::split_bf16x3) takes [hi; lo] tiles of
//                   2K rows: a slab holds the hi and the lo boxes of both
//                   operands, and each k16 step runs hi.hi, lo.hi and hi.lo
//                   into one partial that the slab's first wgmma zeroes and
//                   that joins the f32 total once per slab.
//        int8       sym_s8_kernel: 128 x 256 blocks, wgmma.mma_async
//                   m64n256k32 s8 -> s32 (exact in any order) in
//                   hopper.cuh's wgmma_block_s8: the same warp-specialised
//                   block and cluster pairs that multicast the anchors, a
//                   ring of 4 slabs of 128 K bytes, each TMA box 128 K bytes
//                   of 64 rows of a 2D map (K, rows), so past K it reads
//                   zeros. 8-bit wgmma reads K-major operands only, and the
//                   executor densifies int8 tiles K-major, so neither
//                   operand is transposed on the card. 128 s32 totals a
//                   consumer thread; the epilogue scales each by pvec[9].
//   2. merge_kernel<true>: one block per anchor row, K1's survivor sort and
//      carry merge over the row-side plane.
//   3. merge_kernel<false>: one block per tile column over the transposed
//      plane. A column has up to sw candidates, more than shared memory
//      holds at 8 bytes each, so they are taken in chunks of at most 16,384:
//      each chunk keeps the values above the running kth, sorts them and
//      merges them into the running list in shared memory.
// Shapes: tc a multiple of 128 (the executor's) and 16-byte aligned
// operands, else the launch returns cudaErrorInvalidValue; any K (int8: a
// multiple of 16, the row stride TMA takes).
// What bounds the int8 product now: the tensor cores' rate, less the
// epilogue, which runs after the block's last slab with the ring idle, and
// the tail of a grid of 128 x 256 blocks over 132 SMs. Given away for later
// work: a persistent grid (below-band row blocks are launched and exit at
// once, and one block's epilogue could overlap the next block's loads),
// TMA for the f32 ring, and keeping the scores on chip instead of a round
// trip through device memory.

#include "hopper.cuh"
#include "mn_products.cuh"
#include "splus_epilogue.cuh"

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block (f32, bf16; int8 WG_S8_BN)
constexpr int THREADS = 256;  // 8 warps (f32)
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

// The fused epilogue of a thread's NR x NC cells: anchor rows rows[i] x
// tile columns cols[j], with products xy(i, j); columns past tc are skipped.
template <int NR, int NC, typename XY>
__device__ __forceinline__ void epilogue(const Epi& e, int sw, int tc, int n_live, int n_col,
                                         const int (&rows)[NR], const int (&cols)[NC], XY xy) {
  const float thr = e.pvec[8];
  const bool asym = e.x2t != nullptr;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
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
// f32: pipelined SIMT (mn_products.cuh, shared with P1)
// ---------------------------------------------------------------------------

// The block's anchor rows are columns m0 % tc .. + 128 of anchor tile m0 /
// tc, its tile columns n0 .. + 128 of d.
template <typename E>
__global__ void __launch_bounds__(THREADS, 2) sym_simt_kernel(
    const E* __restrict__ a, const E* __restrict__ d, int sw, int K, int tc, Epi e) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_live = live_rows(e.pvec, sw, tc);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= n_live) return;  // below the band: the merge passes the carry
  const int n_col = col_rows(e.pvec, sw, tc);
  const int c0 = m0 % tc;
  mn_simt_block<E>(smem, a + (size_t)(m0 / tc) * K * tc + c0, d + n0, tc, tc, K, tc - c0,
                   tc - n0, [&](const float (&acc)[8][8], int ty, int tx) {
                     int rows[8], cols[8];
#pragma unroll
                     for (int i = 0; i < 8; ++i) {
                       rows[i] = m0 + strip(ty, i);
                       cols[i] = n0 + strip(tx, i);
                     }
                     epilogue(e, sw, tc, n_live, n_col, rows, cols,
                              [&](int i, int j) { return acc[i][j]; });
                   });
}

// ---------------------------------------------------------------------------
// bf16 and the split-bf16x3 mode: wgmma fed by TMA (mn_products.cuh, shared
// with P1)
// ---------------------------------------------------------------------------

// One 128 x 128 block: ta is the anchors as the 4D map (tc, K, halves, gt),
// td the tile as (tc, K, halves); each slab loads two boxes {64, 64, 1...}
// a half and operand (64 K rows of 64 columns: MN-major). The blocks run in
// cluster pairs, column blocks 2i and 2i + 1 of one row block (so a pair is
// below the band, or not, as one), and each brings one of the anchors' two
// boxes to both: the pair reads its anchors from L2 once. Consumer
// warpgroup wg owns anchor rows m0 + 64 wg .. + 63, its A strip the box of
// anchor columns m0 % tc + 64 wg.
template <int SPLIT>
__global__ void __launch_bounds__(WG_THREADS, 1) sym_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap td, int sw,
    int K, int tc, Epi e) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_live = live_rows(e.pvec, sw, tc);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= n_live) return;  // below the band: the merge passes the carry
  const int n_col = col_rows(e.pvec, sw, tc);
  mn_wgmma_block<SPLIT>(
      smem, &ta, &td, K, m0 % tc, m0 / tc, n0,
      [&](const float (&acc)[64], int wg, int warp, int lane) {
        // acc[4 j + 2 i + c] is row 8 i + g, column 8 j + 2 tig + c of the
        // warp's 16 x 128 (hopper.cuh: wgmma_m64n128k16)
        const int g = lane >> 2, tig = lane & 3;
        int rows[2], cols[32];
#pragma unroll
        for (int i = 0; i < 2; ++i) rows[i] = m0 + 64 * wg + 16 * warp + 8 * i + g;
#pragma unroll
        for (int j = 0; j < 32; ++j) cols[j] = n0 + 8 * (j >> 1) + 2 * tig + (j & 1);
        epilogue(e, sw, tc, n_live, n_col, rows, cols, [&](int i, int j) {
          return acc[4 * (j >> 1) + 2 * i + (j & 1)];
        });
      });
}

// ---------------------------------------------------------------------------
// int8: wgmma s8 fed by TMA (hopper.cuh: wgmma_block_s8, shared with P1)
// ---------------------------------------------------------------------------

// One 128 x 256 block: ta is the anchors (sw, K) and td the tile (tc, K),
// both K-major rows of K bytes, as 2D maps (K, rows) read in boxes {128,
// 64}; a slab is 128 K bytes of the block's 128 anchor rows (two boxes) and
// 256 tile columns (four boxes). The blocks run in cluster pairs, column
// blocks 2i and 2i + 1 of one row block, and each brings one of the anchor
// boxes to both. Consumer warpgroup wg owns anchor rows m0 + 64 wg .. + 63.
__global__ void __launch_bounds__(WG_THREADS, 1) sym_s8_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap td, int sw,
    int K, int tc, Epi e) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_live = live_rows(e.pvec, sw, tc);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * WG_S8_BN;
  if (m0 >= n_live) return;  // below the band: the merge passes the carry
  const int n_col = col_rows(e.pvec, sw, tc);
  wgmma_block_s8(
      smem, (K + WG_S8_BK - 1) / WG_S8_BK,
      [&](int s, unsigned char* st, uint64_t* bar, uint32_t rank) {
        const int k0 = s * WG_S8_BK;
        tma_load_2d_both(st + rank * BOX_BYTES, &ta, bar, k0, m0 + 64 * rank);
#pragma unroll
        for (int j = 0; j < WG_S8_BN / 64; ++j)
          tma_load_2d(st + (2 + j) * BOX_BYTES, &td, bar, k0, n0 + 64 * j);
      },
      [&](const int (&acc)[128], int wg, int warp, int lane) {
        // acc[4 j + 2 i + c] is row 8 i + g, column 8 j + 2 tig + c of the
        // warp's 16 x 256 (hopper.cuh: wgmma_m64n256k32_s8)
        const int g = lane >> 2, tig = lane & 3;
        int rows[2], cols[64];
#pragma unroll
        for (int i = 0; i < 2; ++i) rows[i] = m0 + 64 * wg + 16 * warp + 8 * i + g;
#pragma unroll
        for (int j = 0; j < 64; ++j) cols[j] = n0 + 8 * (j >> 1) + 2 * tig + (j & 1);
        const float inv_scale = e.pvec[9];
        epilogue(e, sw, tc, n_live, n_col, rows, cols, [&](int i, int j) {
          return __fmul_rn(__int2float_rn(acc[4 * (j >> 1) + 2 * i + (j & 1)]), inv_scale);
        });
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

// The f32 launch (sym_simt_kernel)
cudaError_t launch_simt(const float* a, const float* d, int sw, int K, int tc, const Epi& e,
                        cudaStream_t stream) {
  const size_t smem = mn_simt_smem<float>();
  cudaError_t err = cudaFuncSetAttribute(
      sym_simt_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sym_simt_kernel<float><<<dim3(tc / BN, sw / BM), THREADS, smem, stream>>>(a, d, sw, K, tc, e);
  return cudaGetLastError();
}

// The wgmma launch (sym_wgmma_kernel): the anchors (gt, H K, tc) and the
// tile (H K, tc) as tensor maps, H = 2 for the split mode; with K = 0 no
// slab is loaded and the maps stay unset.
template <int SPLIT>
cudaError_t launch_wgmma(const void* a, const void* d, int sw, int K, int tc, const Epi& e,
                         cudaStream_t stream) {
  CUtensorMap ta{}, td{};
  if (K > 0) {
    const cudaError_t err = mn_wgmma_maps<SPLIT>(&ta, &td, a, d, K, tc, sw / tc, tc);
    if (err != cudaSuccess) return err;
  }
  Epi ep = e;
  void* args[] = {&ta, &td, &sw, &K, &tc, &ep};
  // column blocks in pairs: an odd count's last pair has a block past tc
  const dim3 grid((tc / BN + 1) / 2 * 2, sw / BM);
  return launch_pairs(reinterpret_cast<const void*>(sym_wgmma_kernel<SPLIT>), grid, false,
                      WgmmaRing<SPLIT>::SMEM, stream, args);
}

// The int8 launch (sym_s8_kernel): the anchors (sw, K) and the tile (tc, K)
// as K-major tensor maps; with K = 0 no slab is loaded and the maps stay
// unset.
cudaError_t launch_s8(const void* a, const void* d, int sw, int K, int tc, const Epi& e,
                      cudaStream_t stream) {
  CUtensorMap ta{}, td{};
  if (K > 0) {
    cudaError_t err = s8_kmajor_map(&ta, a, K, sw);
    if (err == cudaSuccess) err = s8_kmajor_map(&td, d, K, tc);
    if (err != cudaSuccess) return err;
  }
  Epi ep = e;
  void* args[] = {&ta, &td, &sw, &K, &tc, &ep};
  // column blocks in pairs: an odd count's last pair has a block past tc
  const int gx = (tc + WG_S8_BN - 1) / WG_S8_BN;
  return launch_pairs(reinterpret_cast<const void*>(sym_s8_kernel),
                      dim3((gx + 1) / 2 * 2, sw / BM), false, WG_S8_SMEM, stream, args);
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

// Launch 1: the masked epilogue scores of the anchors . d into scores_r
// (sw x tc) and, transposed, scores_c (tc x sw). f32, bf16 and split: the
// anchors a (sw / tc, K, tc) tile stack, d (K x tc); int8: both K-major, a
// (sw x K) and d (tc x K) row-major, K a multiple of 16. `vecs` holds twelve
// f32 pointers: xt xc xd (sw), yt yc yd (tc), then x2t x2c x2d (tc) y2t y2c
// y2d (sw), the last six null unless the epilogue is asymmetric. mode 0 =
// f32, 1 = bf16, 2 = int8, 3 = split 'both' (bf16 [hi; lo] tiles of 2K
// rows; K is one half's depth). tc must be a multiple of 128 and a and d
// 16-byte aligned. `kind` receives the product kernel taken (ProductKernel).
int sym_product(int mode, const void* a, const void* d, int sw, int K, int tc,
                const void* const* vecs, const void* pvec, int flags,
                void* scores_r, void* scores_c, void* stream, int* kind) {
  if (sw <= 0 || tc <= 0 || K < 0 || sw % tc != 0 || tc % BN != 0 ||
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(d)) & 15) != 0 ||
      (mode == MODE_INT8 && K % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [&](int i) { return static_cast<const float*>(vecs[i]); };
  const Epi e{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11),
              static_cast<const float*>(pvec), flags, static_cast<float*>(scores_r),
              static_cast<float*>(scores_c)};
  switch (mode) {
    case MODE_F32:
      *kind = PK_SIMT;
      return (int)launch_simt(static_cast<const float*>(a), static_cast<const float*>(d), sw, K,
                              tc, e, s);
    case MODE_BF16:
      *kind = PK_WGMMA_BF16;
      return (int)launch_wgmma<SPLIT_NONE>(a, d, sw, K, tc, e, s);
    case MODE_SPLIT_BOTH:
      *kind = PK_WGMMA_BF16;
      return (int)launch_wgmma<SPLIT_BOTH>(a, d, sw, K, tc, e, s);
    case MODE_INT8:
      *kind = PK_WGMMA_S8;
      return (int)launch_s8(a, d, sw, K, tc, e, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The product kernel of `mode`: out[0] registers a thread, out[1] local
// memory bytes a thread (spills), out[2] dynamic shared memory bytes a
// block, out[3] resident blocks per SM, out[4] the kernel (ProductKernel).
int sym_product_attrs(int mode, int* out) {
  const void* kern;
  size_t smem;
  int threads = THREADS;
  switch (mode) {
    case MODE_F32:
      kern = reinterpret_cast<const void*>(sym_simt_kernel<float>);
      smem = mn_simt_smem<float>();
      out[4] = PK_SIMT;
      break;
    case MODE_BF16:
      kern = reinterpret_cast<const void*>(sym_wgmma_kernel<SPLIT_NONE>);
      smem = WgmmaRing<SPLIT_NONE>::SMEM;
      threads = WG_THREADS;
      out[4] = PK_WGMMA_BF16;
      break;
    case MODE_SPLIT_BOTH:
      kern = reinterpret_cast<const void*>(sym_wgmma_kernel<SPLIT_BOTH>);
      smem = WgmmaRing<SPLIT_BOTH>::SMEM;
      threads = WG_THREADS;
      out[4] = PK_WGMMA_BF16;
      break;
    case MODE_INT8:
      kern = reinterpret_cast<const void*>(sym_s8_kernel);
      smem = WG_S8_SMEM;
      threads = WG_THREADS;
      out[4] = PK_WGMMA_S8;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)launch_attrs(kern, threads, smem, out);
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
