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
// (sw = tc = 2,048, K = 200,960) it does ~1,000 operations per byte of the
// anchors and the tile: 67 TFLOP/s of f32 FMA outside the tensor cores for
// f32, 989 TFLOP/s of bf16 and 1,979 TOP/s of int8 on the tensor cores.
//
// The design is K1's, kept simple:
//   1. sym_product_kernel: K1's shared-memory SIMT product (128 x 128
//      blocks, 8 x 8 per thread, __dp4a for int8), skipping row blocks
//      below the band. The epilogue writes the row-side scores (sw x tc)
//      and, for rows with rt < t, the col-side scores transposed (tc x sw)
//      to scratch that the wrapper allocates.
//   2. merge_kernel<true>: one block per anchor row, K1's survivor sort and
//      carry merge over the row-side plane.
//   3. merge_kernel<false>: one block per tile column over the transposed
//      plane. A column has up to sw candidates, more than shared memory
//      holds at 8 bytes each, so they are taken in chunks of at most 16,384:
//      each chunk keeps the values above the running kth, sorts them and
//      merges them into the running list in shared memory.
// Given away for later work: tensor cores, asynchronous loads, and keeping
// the scores on chip instead of a round trip through device memory.

#include "splus_epilogue.cuh"

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BKU = 16;       // K units per shared-memory slab
constexpr int PAD = 4;        // keeps slab rows 16-byte aligned, spreads banks
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
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

// K unit u of a vector that starts at `base` with its K values `step`
// apart (int8 packs four of them).
template <int MODE>
__device__ __forceinline__ typename Unit<MODE>::smem load_unit(
    const typename Unit<MODE>::elem* __restrict__ p, size_t base, size_t step,
    int u, int K) {
  if constexpr (MODE == MODE_INT8) {
    int w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * u + j;
      const int b = k < K ? (int)(uint8_t)p[base + (size_t)k * step] : 0;
      w |= b << (8 * j);
    }
    return w;
  } else {
    return to_f32(p[base + (size_t)u * step]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) sym_product_kernel(
    const typename Unit<MODE>::elem* __restrict__ a,
    const typename Unit<MODE>::elem* __restrict__ d, int sw, int K, int tc,
    const float* __restrict__ xt, const float* __restrict__ xc,
    const float* __restrict__ xd, const float* __restrict__ yt,
    const float* __restrict__ yc, const float* __restrict__ yd,
    const float* __restrict__ x2t, const float* __restrict__ x2c,
    const float* __restrict__ x2d, const float* __restrict__ y2t,
    const float* __restrict__ y2c, const float* __restrict__ y2d,
    const float* __restrict__ pvec, int flags, float* __restrict__ scores_r,
    float* __restrict__ scores_c) {
  using U = Unit<MODE>;
  using S = typename U::smem;
  using V = typename U::vec;
  __shared__ __align__(16) S as[BKU][BM + PAD];
  __shared__ __align__(16) S ds[BKU][BN + PAD];

  const int n_live = live_rows(pvec, sw, tc);
  const int n_col = col_rows(pvec, sw, tc);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= n_live) return;  // below the band: the merge passes the carry

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ku = (K + U::K - 1) / U::K;  // K in units

  S acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int u0 = 0; u0 < ku; u0 += BKU) {
#pragma unroll
    for (int i = 0; i < BM * BKU / THREADS; ++i) {
      const int e = tid + i * THREADS;
      // neighbouring threads read neighbouring anchor rows: the tile stack
      // keeps an anchor tile's rows as its contiguous columns
      const int r = e % BM, u = e / BM;
      const int gr = m0 + r, gu = u0 + u;
      as[u][r] = (gr < n_live && gu < ku)
                     ? load_unit<MODE>(a, (size_t)(gr / tc) * K * tc + gr % tc, tc, gu, K)
                     : S(0);
    }
#pragma unroll
    for (int i = 0; i < BN * BKU / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int u = e / BN, c = e % BN;
      const int gc = n0 + c, gu = u0 + u;
      ds[u][c] = (gc < tc && gu < ku) ? load_unit<MODE>(d, gc, tc, gu, K) : S(0);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < BKU; ++u) {
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
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= n_live) continue;
    const float xtr = xt[r], xcr = xc[r], xdr = xd[r];
    const bool col_side = r < n_col;
    const bool asym = x2t != nullptr;
    const float y2tr = (col_side && asym) ? y2t[r] : 0.0f;
    const float y2cr = (col_side && asym) ? y2c[r] : 0.0f;
    const float y2dr = (col_side && asym) ? y2d[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= tc) continue;
      float xy;
      if constexpr (MODE == MODE_INT8) {
        xy = __fmul_rn(__int2float_rn(acc[i][j]), inv_scale);
      } else {
        xy = acc[i][j];
      }
      const bool cand = xy != 0.0f;
      const float val = splus_val(xy, flags, pvec, xtr, xcr, xdr, yt[c], yc[c], yd[c]);
      scores_r[(size_t)r * tc + c] = (cand && val >= thr) ? val : -INFINITY;
      if (col_side) {
        const float vc = asym ? splus_val(xy, flags, pvec, x2t[c], x2c[c], x2d[c],
                                          y2tr, y2cr, y2dr)
                              : val;
        scores_c[(size_t)c * sw + r] = (cand && vc >= thr) ? vc : -INFINITY;
      }
    }
  }
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

template <int MODE>
cudaError_t launch_product(const void* a, const void* d, int sw, int K, int tc,
                           const void* const* vecs, const void* pvec, int flags,
                           void* scores_r, void* scores_c, cudaStream_t stream) {
  using E = typename Unit<MODE>::elem;
  const dim3 grid((tc + BN - 1) / BN, (sw + BM - 1) / BM);
  auto f = [&](int i) { return static_cast<const float*>(vecs[i]); };
  sym_product_kernel<MODE><<<grid, THREADS, 0, stream>>>(
      static_cast<const E*>(a), static_cast<const E*>(d), sw, K, tc,
      f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11),
      static_cast<const float*>(pvec), flags, static_cast<float*>(scores_r),
      static_cast<float*>(scores_c));
  return cudaGetLastError();
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
// 2 = int8.
int sym_product(int mode, const void* a, const void* d, int sw, int K, int tc,
                const void* const* vecs, const void* pvec, int flags,
                void* scores_r, void* scores_c, void* stream) {
  if (sw <= 0 || tc <= 0 || K < 0 || sw % tc != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_F32:
      return (int)launch_product<MODE_F32>(a, d, sw, K, tc, vecs, pvec, flags,
                                        scores_r, scores_c, s);
    case MODE_BF16:
      return (int)launch_product<MODE_BF16>(a, d, sw, K, tc, vecs, pvec, flags,
                                         scores_r, scores_c, s);
    case MODE_INT8:
      return (int)launch_product<MODE_INT8>(a, d, sw, K, tc, vecs, pvec, flags,
                                         scores_r, scores_c, s);
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
