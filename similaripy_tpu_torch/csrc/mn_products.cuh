// The product of one 128 x 128 block of a^T . d, with a and d row-major (K,
// C) operands contracted on K, shared by K2 (sym_topk.cu: sym_simt_kernel,
// sym_wgmma_kernel) and P1 (probe_tlhs.cu: tlhs_simt_ring_kernel,
// tlhs_wgmma_bf16_kernel), which run the same product and differ only in
// their epilogues (K2's fused S-Plus scores, P1's store of the block). Both
// operands are MN-major: a block's 128 rows are 128 columns of a, its 128
// columns 128 columns of d.
//   mn_simt_block   f32 SIMT FMA, 8 x 8 outputs a thread, fed by a ring of
//                   MN_STAGES slabs of MN_BK K rows through 16-byte cp.async
//                   copies, two slabs ahead of the one in use, one barrier a
//                   slab; each output one in-order fmaf chain over k (no
//                   split, no TF32). Rows past K, and 16-byte chunks at or
//                   past an operand's column bound, are zero-filled. (The
//                   block is written for bf16 too, which no launch takes.)
//   mn_wgmma_block  bf16 and the split-bf16x3 mode 'both': hopper.cuh's
//                   wgmma_block with both operands MN-major, a as the 4D map
//                   (a columns, K, halves, a tiles) and d as the 3D map (d
//                   columns, K, halves), made by mn_wgmma_maps; the blocks
//                   run in cluster pairs of two column blocks that multicast
//                   a's boxes.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int MN_B = 128;        // block rows and columns
constexpr int MN_THREADS = 256;  // the SIMT block's 8 warps
constexpr int MN_STAGES = 3;     // slabs in the SIMT ring
constexpr int MN_BK = 32;        // SIMT: K rows per slab

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
constexpr size_t mn_simt_smem() { return 2ull * MN_STAGES * MN_BK * MN_B * sizeof(E); }

// The SIMT product of the block whose rows start at column 0 of `a` and
// whose columns start at column 0 of `d` (row strides lda and ldd elements,
// 16-byte aligned rows; a_cols and d_cols the columns left from there).
// Then epi(acc, ty, tx): acc[i][j] is row strip(ty, i), column strip(tx, j).
template <typename E, typename Epi>
__device__ __forceinline__ void mn_simt_block(unsigned char* smem, const E* __restrict__ a,
                                              const E* __restrict__ d, int lda, int ldd, int K,
                                              int a_cols, int d_cols, Epi epi) {
  constexpr int ROW_CHUNKS = MN_B * (int)sizeof(E) / 16;  // 16-byte chunks in a slab row
  constexpr int ROW_STEP = MN_THREADS / ROW_CHUNKS;       // rows between a thread's copies
  constexpr int COPIES = MN_BK / ROW_STEP;                // per operand, thread and slab
  constexpr int STAGE = MN_BK * MN_B;                     // elements per operand and slab
  E* as = reinterpret_cast<E*>(smem);  // [MN_STAGES][MN_BK][MN_B]
  E* ds = as + MN_STAGES * STAGE;      // [MN_STAGES][MN_BK][MN_B]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // this thread's copies: rows crow + i * ROW_STEP of a slab, 16 bytes at ccol
  const int crow = tid / ROW_CHUNKS, ccol = (tid % ROW_CHUNKS) * (16 / (int)sizeof(E));
  const bool a_in = ccol < a_cols, d_in = ccol < d_cols;
  const E* ag = a + (size_t)crow * lda + ccol;
  const E* dg = d + (size_t)crow * ldd + ccol;
  const int n_slabs = (K + MN_BK - 1) / MN_BK;

  auto fetch = [&](int s) {
    if (s < n_slabs) {
      E* sa = as + (s % MN_STAGES) * STAGE + crow * MN_B + ccol;
      E* sd = ds + (s % MN_STAGES) * STAGE + crow * MN_B + ccol;
#pragma unroll
      for (int i = 0; i < COPIES; ++i) {
        const int k = s * MN_BK + i * ROW_STEP;
        const bool k_in = k + crow < K;
        cp_async16(sa + i * ROW_STEP * MN_B, (k_in && a_in) ? ag + (size_t)k * lda : a,
                   k_in && a_in);
        cp_async16(sd + i * ROW_STEP * MN_B, (k_in && d_in) ? dg + (size_t)k * ldd : d,
                   k_in && d_in);
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
  for (int s = 0; s < MN_STAGES - 1; ++s) fetch(s);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<MN_STAGES - 2>();  // slab s is in
    __syncthreads();                 // ... for every thread, and slab s - 1 is done with
    fetch(s + MN_STAGES - 1);        // into slab s - 1's place
    const E* sa = as + (s % MN_STAGES) * STAGE;
    const E* sd = ds + (s % MN_STAGES) * STAGE;
    float av[2][8], bv[2][8];
    load_frag(av[0], sa, ty);
    load_frag(bv[0], sd, tx);
#pragma unroll
    for (int kk = 0; kk < MN_BK; ++kk) {
      if (kk + 1 < MN_BK) {  // the next row's values load while this row's FMAs run
        load_frag(av[(kk + 1) & 1], sa + (kk + 1) * MN_B, ty);
        load_frag(bv[(kk + 1) & 1], sd + (kk + 1) * MN_B, tx);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[kk & 1][i], bv[kk & 1][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  epi(acc, ty, tx);
}

// The wgmma product of the block whose rows are columns a_col .. + 128 of
// tile a_tile of the map ta and whose columns are columns n0 .. + 128 of
// td; then epi(total, wg, warp, lane) as wgmma_block's.
template <int SPLIT, typename Epi>
__device__ __forceinline__ void mn_wgmma_block(unsigned char* smem, const CUtensorMap* ta,
                                               const CUtensorMap* td, int K, int a_col,
                                               int a_tile, int n0, Epi epi) {
  using R = WgmmaRing<SPLIT>;
  wgmma_block<SPLIT, true>(
      smem, (K + WG_BK - 1) / WG_BK,
      [&](int s, unsigned char* st, uint64_t* bar, uint32_t rank) {
        const int k0 = s * WG_BK;
#pragma unroll
        for (int h = 0; h < R::A_HALVES; ++h) {
          // a is the pair's: this block brings box `rank` to both
          tma_load_4d_both(st + h * HALF_BYTES + rank * BOX_BYTES, ta, bar, a_col + 64 * rank,
                           k0, h, a_tile);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tma_load_3d(st + (R::A_HALVES + h) * HALF_BYTES + j * BOX_BYTES, td, bar,
                        n0 + 64 * j, k0, h);
        }
      },
      epi);
}

// The maps of mn_wgmma_block: a as (a_cols, K, halves, a_tiles) and d as
// (d_cols, K, halves), halves 2 for the split mode 'both' ([hi; lo] stacks
// of 2K rows; K is one half's depth), boxes of 64 K rows of 64 columns.
template <int SPLIT>
inline cudaError_t mn_wgmma_maps(CUtensorMap* ta, CUtensorMap* td, const void* a, const void* d,
                                 int K, int a_cols, int a_tiles, int d_cols) {
  const cuuint64_t h = SPLIT == SPLIT_BOTH ? 2 : 1, k = K;
  const cuuint64_t ra = 2 * (cuuint64_t)a_cols, rd = 2 * (cuuint64_t)d_cols;
  cudaError_t err = bf16_tensor_map<4>(ta, a, {(cuuint64_t)a_cols, k, h, (cuuint64_t)a_tiles},
                                       {ra, ra * k, ra * k * h}, {64, 64, 1, 1});
  if (err == cudaSuccess)
    err = bf16_tensor_map<3>(td, d, {(cuuint64_t)d_cols, k, h}, {rd, rd * k}, {64, 64, 1});
  return err;
}

}  // namespace
