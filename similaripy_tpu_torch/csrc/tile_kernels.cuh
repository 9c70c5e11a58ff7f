// The two launches shared by K1 (tile_topk.cu) and K3 (panel_topk.cu): the
// tiled SIMT product with the fused S-Plus epilogue and masks, and the
// per-row exact top-k of its scores.
//
//   product_kernel: scores (M x N f32) = epilogue(A . D + bias), -inf where
//       a cell is no candidate or falls below the threshold. Each block owns
//       a 128 x 128 output block, stages K slabs of 16 units through shared
//       memory and keeps an 8 x 8 register micro-tile per thread (int8 packs
//       four K values per unit and multiplies them with __dp4a). With BIAS,
//       `bias` (M x N, f32, or int32 for int8) joins the accumulator before
//       the epilogue, so int8 stays exact until the single inverse-scale
//       multiply. BIAS is a template parameter, not a null test: with a
//       runtime test the product took 159-174 registers (ptxas) and K1 ran
//       1.2-1.9x slower on the card (chip_smoke.py); compiled apart, K1
//       keeps its own times. K1's file instantiates BIAS = false only, K3's
//       BIAS = true only (K3 without a bias calls K1's product).
//   topk_kernel: one block per (row, tile) of the scores. It keeps the
//       scores above the carry's kth, sorts them in shared memory (bitonic,
//       on 64-bit keys that order by value and then by lowest column) and,
//       with a carry, merges them with it. Tile t of a row is the columns
//       [t*N, (t+1)*N) of a score row `ld` wide; its ids are
//       pvec[10] + t*N + col, and its output is plane t of (tiles, k_pad, M).
//
// Given away, for later work: bf16 and int8 run on the SIMT cores instead of
// the tensor cores (wgmma), loads are neither asynchronous (TMA / cp.async)
// nor double-buffered, and the scores round-trip through device memory
// between the two launches instead of staying on chip.

#pragma once

#include "splus_epilogue.cuh"

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BKU = 16;       // K units per shared-memory slab
constexpr int PAD = 4;        // keeps slab rows 16-byte aligned, spreads banks
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int TOPK_THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;

// A unit at (row offset, unit u) of the row-major (M x K) panel.
template <int MODE>
__device__ __forceinline__ typename Unit<MODE>::smem load_a(
    const typename Unit<MODE>::elem* __restrict__ a, size_t row_off, int u, int K) {
  if constexpr (MODE == MODE_INT8) {
    int w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * u + j;
      const int b = k < K ? (int)(uint8_t)a[row_off + k] : 0;
      w |= b << (8 * j);
    }
    return w;
  } else {
    return to_f32(a[row_off + u]);
  }
}

// A unit at (unit u, column c) of the row-major (K x N) tile.
template <int MODE>
__device__ __forceinline__ typename Unit<MODE>::smem load_d(
    const typename Unit<MODE>::elem* __restrict__ d, int u, int c, int K, int N) {
  if constexpr (MODE == MODE_INT8) {
    int w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * u + j;
      const int b = k < K ? (int)(uint8_t)d[(size_t)k * N + c] : 0;
      w |= b << (8 * j);
    }
    return w;
  } else {
    return to_f32(d[(size_t)u * N + c]);
  }
}

// the row (or column) of micro-tile entry i: two 4-wide strips 64 apart
__device__ __forceinline__ int strip(int t, int i) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + i - 4;
}

template <int MODE, bool BIAS>
__global__ void __launch_bounds__(THREADS) product_kernel(
    const typename Unit<MODE>::elem* __restrict__ a,
    const typename Unit<MODE>::elem* __restrict__ d,
    const typename Unit<MODE>::smem* __restrict__ bias, int M, int K, int N,
    const float* __restrict__ xt, const float* __restrict__ xc,
    const float* __restrict__ xd, const float* __restrict__ yt,
    const float* __restrict__ yc, const float* __restrict__ yd,
    const float* __restrict__ pvec, const uint8_t* __restrict__ allowed,
    const uint8_t* __restrict__ fmask, const uint8_t* __restrict__ tmask,
    int flags, float* __restrict__ scores) {
  using U = Unit<MODE>;
  using S = typename U::smem;
  using V = typename U::vec;
  using Acc = S;
  __shared__ __align__(16) S as[BKU][BM + PAD];
  __shared__ __align__(16) S ds[BKU][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ku = (K + U::K - 1) / U::K;  // K in units

  Acc acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int u0 = 0; u0 < ku; u0 += BKU) {
#pragma unroll
    for (int i = 0; i < BM * BKU / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BKU, u = e % BKU;
      const int gr = m0 + r, gu = u0 + u;
      as[u][r] = (gr < M && gu < ku) ? load_a<MODE>(a, (size_t)gr * K, gu, K) : S(0);
    }
#pragma unroll
    for (int i = 0; i < BN * BKU / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int u = e / BN, c = e % BN;
      const int gc = n0 + c, gu = u0 + u;
      ds[u][c] = (gc < N && gu < ku) ? load_d<MODE>(d, gu, gc, K, N) : S(0);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < BKU; ++u) {
      // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; the same split for columns
      const V a0 = *reinterpret_cast<const V*>(&as[u][ty * 4]);
      const V a1 = *reinterpret_cast<const V*>(&as[u][64 + ty * 4]);
      const V b0 = *reinterpret_cast<const V*>(&ds[u][tx * 4]);
      const V b1 = *reinterpret_cast<const V*>(&ds[u][64 + tx * 4]);
      const S av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const S bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = mac(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float thr = pvec[8];
  const float inv_scale = pvec[9];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + strip(ty, i);
    if (r >= M) continue;
    const float xtr = xt[r], xcr = xc[r], xdr = xd[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + strip(tx, j);
      if (c >= N) continue;
      const size_t cell = (size_t)r * N + c;
      Acc sum = acc[i][j];
      if constexpr (BIAS) sum += bias[cell];
      float xy;
      if constexpr (MODE == MODE_INT8) {
        xy = __fmul_rn(__int2float_rn(sum), inv_scale);
      } else {
        xy = sum;
      }
      bool keep = xy != 0.0f;
      if (allowed) keep = keep && allowed[c] != 0;
      if (fmask) keep = keep && fmask[cell] == 0;
      if (tmask) keep = keep && tmask[cell] != 0;
      const float val = splus_val(xy, flags, pvec, xtr, xcr, xdr, yt[c], yc[c], yd[c]);
      scores[cell] = (keep && val >= thr) ? val : -INFINITY;
    }
  }
}

// One block per (row, tile): blockIdx.x is the row, blockIdx.y the tile.
// Dynamic shared memory: `cap` sort keys (cap = the power of two >= N),
// then, with a carry, the row's carried k_pad values and ids.
template <bool CARRY>
__global__ void __launch_bounds__(TOPK_THREADS) topk_kernel(
    const float* __restrict__ scores, int M, int N, int ld, int k_pad, int cap,
    const float* __restrict__ pvec, const float* __restrict__ cv,
    const int* __restrict__ ci, float* __restrict__ ov, int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  __shared__ int n_surv;

  const int row = blockIdx.x, t = blockIdx.y, tid = threadIdx.x;
  const int col_base = (int)pvec[10] + t * N;
  const float kth = CARRY ? cv[(size_t)(k_pad - 1) * M + row] : -INFINITY;
  ov += (size_t)t * k_pad * M;
  oi += (size_t)t * k_pad * M;
  if (tid == 0) n_surv = 0;
  __syncthreads();

  // survivors: finite scores above the carry's kth (pallas_kernels.py:338)
  const float* srow = scores + (size_t)row * ld + (size_t)t * N;
  for (int c = tid; c < N; c += TOPK_THREADS) {
    const float v = srow[c];
    if (v > kth) keys[atomicAdd(&n_surv, 1)] = make_key(v, c);
  }
  __syncthreads();
  const int n = n_surv;
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int i = n + tid; i < p2; i += TOPK_THREADS) keys[i] = 0ull;  // sorts last
  __syncthreads();

  // bitonic sort, descending, over the p2 keys
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p2; i += TOPK_THREADS) {
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

  const int m = n < k_pad ? n : k_pad;  // the tile's top entries
  if constexpr (!CARRY) {
    for (int i = tid; i < k_pad; i += TOPK_THREADS) {
      const bool hit = i < m;
      ov[(size_t)i * M + row] = hit ? key_val(keys[i]) : -INFINITY;
      oi[(size_t)i * M + row] = col_base + (hit ? key_col(keys[i]) : 0);
    }
  } else {
    float* bv = reinterpret_cast<float*>(keys + cap);
    int* bi = reinterpret_cast<int*>(bv + k_pad);
    for (int j = tid; j < k_pad; j += TOPK_THREADS) {
      bv[j] = cv[(size_t)j * M + row];
      bi[j] = ci[(size_t)j * M + row];
    }
    __syncthreads();
    // stable merge of two descending lists, ties to the tile: a tile entry
    // lands after the carry entries strictly above it, a carry entry after
    // the tile entries at or above it
    for (int i = tid; i < m; i += TOPK_THREADS) {
      const float v = key_val(keys[i]);
      int lo = 0, hi = k_pad;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (bv[mid] > v) lo = mid + 1; else hi = mid;
      }
      const int pos = i + lo;
      if (pos < k_pad) {
        ov[(size_t)pos * M + row] = v;
        oi[(size_t)pos * M + row] = col_base + key_col(keys[i]);
      }
    }
    for (int j = tid; j < k_pad; j += TOPK_THREADS) {
      const float v = bv[j];
      int lo = 0, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_val(keys[mid]) >= v) lo = mid + 1; else hi = mid;
      }
      const int pos = j + lo;
      if (pos < k_pad) {
        ov[(size_t)pos * M + row] = v;
        oi[(size_t)pos * M + row] = bi[j];
      }
    }
  }
}

template <int MODE, bool BIAS>
cudaError_t launch_product(const void* a, const void* d, const void* bias, int M,
                           int K, int N, const void* xt, const void* xc,
                           const void* xd, const void* yt, const void* yc,
                           const void* yd, const void* pvec, const void* allowed,
                           const void* fmask, const void* tmask, int flags,
                           void* scores, cudaStream_t stream) {
  using E = typename Unit<MODE>::elem;
  using S = typename Unit<MODE>::smem;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  product_kernel<MODE, BIAS><<<grid, THREADS, 0, stream>>>(
      static_cast<const E*>(a), static_cast<const E*>(d), static_cast<const S*>(bias),
      M, K, N, static_cast<const float*>(xt), static_cast<const float*>(xc),
      static_cast<const float*>(xd), static_cast<const float*>(yt),
      static_cast<const float*>(yc), static_cast<const float*>(yd),
      static_cast<const float*>(pvec), static_cast<const uint8_t*>(allowed),
      static_cast<const uint8_t*>(fmask), static_cast<const uint8_t*>(tmask),
      flags, static_cast<float*>(scores));
  return cudaGetLastError();
}

// The product launch for a runtime mode (0 = f32, 1 = bf16, 2 = int8); the
// mask pointers may be null, the bias must be null exactly when !BIAS.
template <bool BIAS>
cudaError_t product_any(int mode, const void* a, const void* d, const void* bias,
                               int M, int K, int N, const void* xt, const void* xc,
                               const void* xd, const void* yt, const void* yc,
                               const void* yd, const void* pvec, const void* allowed,
                               const void* fmask, const void* tmask, int flags,
                               void* scores, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K < 0 || (bias != nullptr) != BIAS) return cudaErrorInvalidValue;
  switch (mode) {
    case MODE_F32:
      return launch_product<MODE_F32, BIAS>(a, d, bias, M, K, N, xt, xc, xd, yt, yc, yd,
                                            pvec, allowed, fmask, tmask, flags, scores, s);
    case MODE_BF16:
      return launch_product<MODE_BF16, BIAS>(a, d, bias, M, K, N, xt, xc, xd, yt, yc, yd,
                                             pvec, allowed, fmask, tmask, flags, scores, s);
    case MODE_INT8:
      return launch_product<MODE_INT8, BIAS>(a, d, bias, M, K, N, xt, xc, xd, yt, yc, yd,
                                             pvec, allowed, fmask, tmask, flags, scores, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The top-k launch over `tiles` tiles N wide of an (M x ld) score scratch,
// merged with the carry (cv, ci: k_pad x M) when cv is not null.
inline cudaError_t topk_any(const void* scores, int M, int N, int ld, int tiles,
                            int k_pad, const void* pvec, const void* cv,
                            const void* ci, void* ov, void* oi, cudaStream_t s) {
  if (M <= 0 || N <= 0 || k_pad <= 0 || tiles <= 0 || ld < N * tiles)
    return cudaErrorInvalidValue;
  int cap = 1;
  while (cap < N) cap <<= 1;
  const size_t smem = (size_t)cap * 8 + (cv ? (size_t)k_pad * 8 : 0);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(M, tiles);
  const float* sc = static_cast<const float*>(scores);
  const float* pv = static_cast<const float*>(pvec);
  float* v = static_cast<float*>(ov);
  int* i = static_cast<int*>(oi);
  cudaError_t err;
  if (cv) {
    err = cudaFuncSetAttribute(topk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    topk_kernel<true><<<grid, TOPK_THREADS, smem, s>>>(
        sc, M, N, ld, k_pad, cap, pv, static_cast<const float*>(cv),
        static_cast<const int*>(ci), v, i);
  } else {
    err = cudaFuncSetAttribute(topk_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    topk_kernel<false><<<grid, TOPK_THREADS, smem, s>>>(
        sc, M, N, ld, k_pad, cap, pv, nullptr, nullptr, v, i);
  }
  return cudaGetLastError();
}

}  // namespace
