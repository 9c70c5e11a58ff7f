// The two launches shared by K1 (tile_topk.cu) and K3 (panel_topk.cu): the
// product with the fused S-Plus epilogue and masks, and the per-row exact
// top-k of its scores.
//
// Product: scores (M x N f32) = epilogue(A . D + bias), -inf where a cell is
// no candidate or falls below the threshold. A is (M x K) row-major, D is
// (K x N) row-major. Both stream through a ring of shared-memory slabs, the
// ring's depth less one slab ahead of the one in use, with one barrier a
// slab; rows past M, K rows past K and columns past N are zero-filled.
// Block (x, y) is row block x of column block y, so the row blocks of one
// column block run side by side and the second reads D from L2. With BIAS,
// `bias` (M x N, f32, or int32 for int8) joins the sum before the epilogue,
// so int8 stays exact until the single inverse-scale multiply. BIAS is a
// template parameter, not a null test: a runtime test cost K1 1.2-1.9x on
// the card (its register count rose). K1's file instantiates BIAS = false
// only, K3's BIAS = true only (K3 without a bias calls K1's product).
//   int8       tile_s8_kernel: mma.sync m16n8k32 s8 -> s32 (exact), 128 x
//              256 blocks of 8 warps with 64 x 64 tiles, one block an SM, 128
//              K bytes a slab, 3 slabs. A's slab rows are already
//              k-contiguous, the layout of mma.sync's A fragment: ldmatrix
//              reads them as they are, 16-byte chunks XOR-swizzled by the
//              row's low 3 bits. D's slab holds (k, n) bytes, so each warp
//              reads its B fragments as 4 (k) x 4 (n) byte blocks and
//              transposes them in registers, as K2 does (csrc/sym_topk.cu,
//              transpose4x4 in tensor_core.cuh); fragment columns then stand
//              for permuted columns that the epilogue maps back.
//   bf16 and   tile_wgmma_kernel (16-byte aligned operands: every launch
//   the split  of the executors): wgmma.mma_async m64n128k16 bf16 -> f32 on
//   modes      operands that TMA brings into 128-byte-swizzled shared memory,
//              in hopper.cuh's warp-specialised 128 x 128 block (two
//              consumer warpgroups of 64 x 128, one producer warp; slabs of
//              64 K rows in a ring of 6, 4 or 3 by the halves a slab
//              holds), the blocks in cluster pairs of two column blocks
//              that multicast A's boxes, so a pair reads A once. A is K-major (M x K row-major), D is MN-major (K x N
//              row-major), so wgmma reads both straight from the boxes: no
//              fragment loads, no register transposes. The split-bf16x3
//              modes (precision='high' on f32 data;
//              pallas_kernels.py::split_bf16x3) take [hi; lo] stacks: A
//              (M x 2K) with the lo half at column K, D (2K x N) with it at
//              row K. Each stack is a 3D tensor map with the half as a
//              dimension of its own ((K, halves, M) and (N, K, halves)), so
//              a box that runs past K is zero-filled by TMA and never reads
//              the other half. Every phase of every k16 step (SPLIT, a
//              template parameter) goes into one partial that the slab's
//              first wgmma zeroes; once the slab's wgmmas complete, the
//              partial joins the f32 total with one rounded add, so the
//              tensor cores' own rounding inside a product acts on a slab's
//              partial only, not on the running total.
//              tile_bf16_kernel (mma.sync m16n8k16) stays for plain bf16
//              with narrow copies (V = 4, 2: ragged
//              shapes that only tests use), which TMA cannot take: 128 x
//              128 blocks of 8 warps with 64 x 32 tiles, 64 K rows a slab,
//              3 slabs, fragments by ldmatrix from XOR-swizzled slabs, the
//              same per-slab partial.
//   f32        tile_simt_kernel: 128 x 128 blocks, 8 x 8 SIMT FMA outputs a
//              thread, slabs of 32 four-byte K units, 3 slabs. The FMA loop
//              wants 8 rows of A at one k, and A's rows arrive k-contiguous:
//              4-byte cp.async copies land each unit transposed, A[u][m] with
//              rows BM + 4 words apart, a warp copying 8 units of 4 rows (32
//              bytes of each, 32 banks). D's slab is already the outer
//              product's layout. Each output is one in-order fmaf chain over
//              k (no split, no TF32), so the scores are those of the plain
//              loop. (The kernel is written for 2-byte elements too, which
//              no launch instantiates since bf16 runs on the tensor cores.)
// Copies are 16 bytes (4 for A's f32 units) when both operands' rows and
// bases are 16-byte aligned (the main path: u_pad, K and tc are multiples of
// 128), else 4-byte cp.async when they are 4-byte aligned, else plain
// element loads and stores (V, a template parameter chosen at launch). bf16
// with 16-byte copies takes the wgmma kernel; the split modes take 16-byte
// copies only (the executor's shapes).
//
// Top-k: topk_kernel, one block per (row, tile) of the scores. It keeps the
// scores above the carry's kth, sorts them in shared memory (bitonic, on
// 64-bit keys that order by value and then by lowest column) and, with a
// carry, merges them with it. Tile t of a row is the columns [t*N,
// (t+1)*N) of a score row `ld` wide; its ids are pvec[10] + t*N + col, and
// its output is plane t of (tiles, k_pad, M).
//
// Given away, for later work: wgmma for int8 (an 8-bit operand must be
// K-major, and D's slab holds (k, n) bytes), a persistent grid (one block
// an SM walking the tiles, which would overlap a block's epilogue with the
// next block's loads and shorten K1's wave tail: 440 blocks on 132 SMs),
// tiles larger than 128 x 128 for plain bf16, which loads bound (they need
// more than the 168 registers a thread that 9 warps leave), and keeping
// the scores on chip instead of a round trip through device memory
// between the two launches.

#pragma once

#include "hopper.cuh"
#include "splus_epilogue.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block (f32, bf16)
constexpr int S8_BN = 256;    // output columns per block (int8)
constexpr int THREADS = 256;  // 8 warps
constexpr int STAGES = 3;     // slabs in the shared-memory ring
constexpr int UNITS = 32;     // f32 / bf16: 4-byte K units per slab
constexpr int A_LD = BM + 4;  // f32 / bf16: words between A's unit rows
constexpr int IBK = 128;      // int8: K bytes per slab, four k32 steps
constexpr int TBK = 64;       // bf16 tensor cores: K rows per slab, four k16 steps
constexpr int T_STAGES = 3;   // bf16 tensor cores: slabs in the ring
constexpr int TA_SLAB = BM * TBK * 2;  // bytes of A's slab
constexpr int TD_SLAB = TBK * BN * 2;  // ... and of D's
constexpr int TOPK_THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;

// operand element and accumulator of a mode
template <int MODE> struct Operand;
template <> struct Operand<MODE_F32> { using elem = float; using acc = float; };
template <> struct Operand<MODE_BF16> { using elem = __nv_bfloat16; using acc = float; };
template <> struct Operand<MODE_INT8> { using elem = int8_t; using acc = int; };

// What the product's epilogue reads and writes; Acc is the accumulator.
template <typename Acc>
struct TileEpi {
  const Acc* bias;                          // (M x N), null unless BIAS
  const float *xt, *xc, *xd;                // X at the rows (M)
  const float *yt, *yc, *yd;                // Y at the columns (N)
  const float* pvec;
  const uint8_t *allowed, *fmask, *tmask;   // (N), (M x N), (M x N), or null
  int flags;
  float* scores;                            // (M x N)
};

// The fused epilogue of a thread's NR x NC cells: rows[i] x cols[j], with
// sums xy(i, j); cells past M or N are skipped.
template <int MODE, bool BIAS, int NR, int NC, typename XY>
__device__ __forceinline__ void tile_epilogue(const TileEpi<typename Operand<MODE>::acc>& e,
                                              int M, int N,
                                              const int (&rows)[NR], const int (&cols)[NC],
                                              XY xy) {
  const float thr = e.pvec[8];
  const float inv_scale = e.pvec[9];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = rows[i];
    if (r >= M) continue;
    const float xtr = e.xt[r], xcr = e.xc[r], xdr = e.xd[r];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = cols[j];
      if (c >= N) continue;
      const size_t cell = (size_t)r * N + c;
      typename Operand<MODE>::acc sum = xy(i, j);
      if constexpr (BIAS) sum += e.bias[cell];
      float v;
      if constexpr (MODE == MODE_INT8) {
        v = __fmul_rn(__int2float_rn(sum), inv_scale);
      } else {
        v = sum;
      }
      bool keep = v != 0.0f;
      if (e.allowed) keep = keep && e.allowed[c] != 0;
      if (e.fmask) keep = keep && e.fmask[cell] == 0;
      if (e.tmask) keep = keep && e.tmask[cell] != 0;
      const float val = splus_val(v, e.flags, e.pvec, xtr, xcr, xdr, e.yt[c], e.yc[c], e.yd[c]);
      e.scores[cell] = (keep && val >= thr) ? val : -INFINITY;
    }
  }
}

// V bytes from global to shared memory: cp.async for 16 (L2 only) and 4
// bytes, zero-filled and nothing read when !full; a plain load and store
// below 4 (2: one bf16, 1: one int8), which the barrier before the slab's
// use makes visible all the same.
template <int V>
__device__ __forceinline__ void copy_v(void* dst, const void* src, bool full) {
  if constexpr (V == 16) {
    cp_async16(dst, src, full);
  } else if constexpr (V == 4) {
    cp_async4(dst, src, full);
  } else if constexpr (V == 2) {
    *static_cast<uint16_t*>(dst) = full ? *static_cast<const uint16_t*>(src) : 0;
  } else {
    static_assert(V == 1, "copies are 16, 4, 2 or 1 bytes");
    *static_cast<uint8_t*>(dst) = full ? *static_cast<const uint8_t*>(src) : 0;
  }
}

// ---------------------------------------------------------------------------
// f32 and bf16: ring-fed SIMT
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

// a thread's 8 values of one D slab row: strips t * 4 and 64 + t * 4
template <typename E>
__device__ __forceinline__ void load_frag(float (&v)[8], const E* row, int t) {
  const float4 lo = load4(row + t * 4), hi = load4(row + 64 + t * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// a thread's 8 A values at k = 4-byte unit row `row`, sub-row q: the unit
// is one f32, or two bf16 (k even in the low half)
template <typename E>
__device__ __forceinline__ void load_a(float (&v)[8], const uint32_t* row, int t, int q) {
  const uint4 lo = *reinterpret_cast<const uint4*>(row + t * 4);
  const uint4 hi = *reinterpret_cast<const uint4*>(row + 64 + t * 4);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (sizeof(E) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else {
      v[i] = __uint_as_float(q == 0 ? w[i] << 16 : w[i] & 0xffff0000u);
    }
  }
}

template <typename E>
constexpr size_t simt_smem() {
  return (size_t)STAGES * (UNITS * A_LD * 4 + UNITS * (4 / sizeof(E)) * BN * sizeof(E));
}

template <int MODE, bool BIAS, int V>
__global__ void __launch_bounds__(THREADS, 2) tile_simt_kernel(
    const typename Operand<MODE>::elem* __restrict__ a,
    const typename Operand<MODE>::elem* __restrict__ d, int M, int K, int N,
    TileEpi<float> e) {
  using E = typename Operand<MODE>::elem;
  constexpr int UK = 4 / (int)sizeof(E);          // K rows per unit
  constexpr int KS = UNITS * UK;                  // K rows per slab
  constexpr int SA = UNITS * A_LD;                // A words per slab
  constexpr int SD = KS * BN;                     // D elements per slab
  constexpr int DV = V < 4 ? (int)sizeof(E) : V;  // D copy bytes
  constexpr int D_ROW = BN * (int)sizeof(E) / DV; // D copies per slab row
  constexpr int D_COPIES = KS * D_ROW / THREADS;
  constexpr int A_COPIES = BM * UNITS / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* as = reinterpret_cast<uint32_t*>(smem);          // [STAGES][UNITS][A_LD]
  E* ds = reinterpret_cast<E*>(as + STAGES * SA);            // [STAGES][KS][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_slabs = (K + KS - 1) / KS;

  // A copies: unit au of the rows am + 8 i (a warp: 8 units x 4 rows)
  const int au = (warp & 3) * 8 + (lane & 7);
  const int am = (warp >> 2) * 4 + (lane >> 3);
  const E* ag = a + (size_t)(m0 + am) * K + au * UK;

  auto fetch = [&](int s) {
    if (s < n_slabs) {
      uint32_t* sa = as + (s % STAGES) * SA + au * A_LD + am;
      E* sd = ds + (s % STAGES) * SD;
      const int k = s * KS + au * UK;
#pragma unroll 16
      for (int i = 0; i < A_COPIES; ++i) {
        const bool row_in = m0 + am + 8 * i < M;
        const E* src = ag + (size_t)(8 * i) * K + s * KS;
        if constexpr (V >= 4) {
          const bool full = row_in && k < K;
          copy_v<4>(sa + 8 * i, full ? src : a, full);
        } else {  // two bf16 of an unaligned row, each on its own
          const uint32_t lo = row_in && k < K ? *reinterpret_cast<const uint16_t*>(src) : 0u;
          const uint32_t hi = row_in && k + 1 < K ? *reinterpret_cast<const uint16_t*>(src + 1) : 0u;
          sa[8 * i] = lo | (hi << 16);
        }
      }
#pragma unroll 16
      for (int i = 0; i < D_COPIES; ++i) {
        const int c = tid + i * THREADS, row = c / D_ROW;
        const int col = (c % D_ROW) * (DV / (int)sizeof(E));
        const int gk = s * KS + row;
        const bool full = gk < K && n0 + col < N;
        copy_v<DV>(sd + row * BN + col, full ? d + (size_t)gk * N + n0 + col : d, full);
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
    const uint32_t* sa = as + (s % STAGES) * SA;
    const E* sd = ds + (s % STAGES) * SD;
    float av[2][8], bv[2][8];
    load_a<E>(av[0], sa, ty, 0);
    load_frag(bv[0], sd, tx);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk + 1 < KS) {  // the next row's values load while this row's FMAs run
        load_a<E>(av[(kk + 1) & 1], sa + ((kk + 1) / UK) * A_LD, ty, (kk + 1) % UK);
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
  tile_epilogue<MODE, BIAS>(e, M, N, rows, cols, [&](int i, int j) { return acc[i][j]; });
}

// ---------------------------------------------------------------------------
// bf16 with narrow copies: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr size_t BF16_SMEM = (size_t)T_STAGES * (TA_SLAB + TD_SLAB);

// Byte offset of 16-byte chunk `ch` (0..7) of row `r` of A's slab (rows of
// TBK bf16 = 128 bytes): the chunk is XORed with the row's low 3 bits, so
// the 8 rows of one ldmatrix matrix fall in 8 distinct chunks, 32 banks.
__device__ __forceinline__ int ak_swz(int r, int ch) {
  return r * (TBK * 2) + ((ch ^ (r & 7)) << 4);
}

// One 128 x 128 block: 8 warps of 64 x 32 (4 m16 x 4 n8 tiles), 64 f32
// accumulators and 64 of the slab's partial sums a thread, one block an SM.
template <bool BIAS, int V>
__global__ void __launch_bounds__(THREADS, 1) tile_bf16_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ d, int M, int K,
    int N, TileEpi<float> e) {
  constexpr int STAGE = TA_SLAB + TD_SLAB;
  constexpr int A_ROW = TBK * 2 / V, D_ROW = BN * 2 / V;  // copies per slab row
  constexpr int A_COPIES = BM * A_ROW / THREADS, D_COPIES = TBK * D_ROW / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];  // [T_STAGES][A, D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_slabs = (K + TBK - 1) / TBK;

  auto fetch = [&](int s) {
    if (s < n_slabs) {
      unsigned char* st = smem + (s % T_STAGES) * STAGE;
#pragma unroll
      for (int i = 0; i < A_COPIES; ++i) {
        const int c = tid + i * THREADS, row = c / A_ROW, off = (c % A_ROW) * V;
        const int k = s * TBK + off / 2;
        const bool full = m0 + row < M && k < K;
        copy_v<V>(st + ak_swz(row, off >> 4) + (off & 15),
                  full ? a + (size_t)(m0 + row) * K + k : a, full);
      }
#pragma unroll
      for (int i = 0; i < D_COPIES; ++i) {
        const int c = tid + i * THREADS, row = c / D_ROW, off = (c % D_ROW) * V;
        const int k = s * TBK + row, col = n0 + off / 2;
        const bool full = k < K && col < N;
        copy_v<V>(st + TA_SLAB + kn_swz(row, off >> 4) + (off & 15),
                  full ? d + (size_t)k * N + col : d, full);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) fetch(s);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<T_STAGES - 2>();  // slab s is in
    __syncthreads();                // ... for every thread, and slab s - 1 is done with
    fetch(s + T_STAGES - 1);        // into slab s - 1's place
    const unsigned char* sa = smem + (s % T_STAGES) * STAGE;
    const unsigned char* sd = sa + TA_SLAB;
    float part[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      // A: ldmatrix x4 of m-tile mi, matrices (rows 0-7 | 8-15) x (k ks ..
      // +7 | ks + 8 .. +15): lane l gives row l & 15, chunk ks / 8 + l / 16
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], sa + ak_swz(wm + 16 * mi + (lane & 15), ks / 8 + (lane >> 4)));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_b_pair(bf[2 * nj], bf[2 * nj + 1], sd, ks, wn + 16 * nj, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(part[mi][ni], af[mi], bf[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
  }
  cp_async_wait<0>();

  // C row g + 8 hh of m-tile mi is row wm + 16 mi + 8 hh + g; C column
  // 2 tig + jj of n-tile ni is column wn + 8 ni + 2 tig + jj
  int rows[8], cols[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = m0 + wm + 16 * (i >> 1) + 8 * (i & 1) + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) cols[j] = n0 + wn + 8 * (j >> 1) + 2 * tig + (j & 1);
  tile_epilogue<MODE_BF16, BIAS>(e, M, N, rows, cols, [&](int i, int j) {
    return acc[i >> 1][j >> 1][2 * (i & 1) + (j & 1)];
  });
}

// ---------------------------------------------------------------------------
// bf16 and the split-bf16x3 modes: wgmma fed by TMA (hopper.cuh)
// ---------------------------------------------------------------------------

// One 128 x 128 block: ta is A's stack as the 3D map (K, A halves, M), two
// boxes {64, 1, 64} a half and slab (K-major: 64 rows of 128 bytes each),
// one brought by each block of the cluster pair (column blocks 2j and 2j +
// 1 of one row block); td is D's as (N, K, D halves), two boxes {64, 64,
// 1} a half and slab (MN-major: 64 K rows of 64 columns each). Consumer
// warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block.
template <int SPLIT, bool BIAS>
__global__ void __launch_bounds__(WG_THREADS, 1) tile_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap td, int M, int K,
    int N, TileEpi<float> e) {
  using R = WgmmaRing<SPLIT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  wgmma_block<SPLIT, false>(
      smem, (K + WG_BK - 1) / WG_BK,
      [&](int s, unsigned char* st, uint64_t* bar, uint32_t rank) {
        const int k0 = s * WG_BK;
        // A is the pair's: this block brings rows 64 rank .. + 63 to both
#pragma unroll
        for (int h = 0; h < R::A_HALVES; ++h)
          tma_load_3d_both(st + h * HALF_BYTES + rank * BOX_BYTES, &ta, bar, k0, h, m0 + 64 * rank);
#pragma unroll
        for (int h = 0; h < R::D_HALVES; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tma_load_3d(st + (R::A_HALVES + h) * HALF_BYTES + j * BOX_BYTES, &td, bar,
                        n0 + 64 * j, k0, h);
      },
      [&](const float (&acc)[64], int wg, int warp, int lane) {
        // acc[4 j + 2 i + c] is row 8 i + g, column 8 j + 2 tig + c of the
        // warp's 16 x 128 (hopper.cuh: wgmma_m64n128k16)
        const int g = lane >> 2, tig = lane & 3;
        int rows[2], cols[32];
#pragma unroll
        for (int i = 0; i < 2; ++i) rows[i] = m0 + 64 * wg + 16 * warp + 8 * i + g;
#pragma unroll
        for (int j = 0; j < 32; ++j) cols[j] = n0 + 8 * (j >> 1) + 2 * tig + (j & 1);
        tile_epilogue<MODE_BF16, BIAS>(e, M, N, rows, cols, [&](int i, int j) {
          return acc[4 * (j >> 1) + 2 * i + (j & 1)];
        });
      });
}

// ---------------------------------------------------------------------------
// int8: mma.sync m16n8k32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr size_t S8_SMEM = (size_t)STAGES * IBK * (BM + S8_BN);

// Byte offset of 16-byte chunk `ch` of row `r` of A's slab (rows of IBK =
// 128 bytes): the chunk index is XORed with the row's low 3 bits, so the
// 8 rows of an ldmatrix phase fall in 8 distinct chunks, 32 banks.
__device__ __forceinline__ int a_swz(int r, int ch) { return r * IBK + ((ch ^ (r & 7)) << 4); }

// Byte offset of 16-byte chunk `ch` of row `r` of D's slab (rows of S8_BN =
// 256 bytes): the chunk index is XORed with twice bits 2..3 of the row, so a
// warp's block reads (rows 4 tig + q for tig 0..3, words of two
// neighbouring chunks for g 0..7) fall in 8 distinct chunks, 32 banks.
__device__ __forceinline__ int d_swz(int r, int ch) {
  return r * S8_BN + ((ch ^ (((r >> 2) & 3) << 1)) << 4);
}

// rows r0 .. r0 + 3 of 32-bit word `word` (four bytes of n) of D's slab,
// transposed: w[j] holds the four k bytes of column 4 word + j
__device__ __forceinline__ void d_block4x4(uint32_t (&w)[4], const unsigned char* s, int r0,
                                           int word) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = *reinterpret_cast<const uint32_t*>(s + d_swz(r0 + q, word >> 2) + (word & 3) * 4);
  transpose4x4(w);
}

// One 128 x 256 block: 8 warps of 64 x 64 (4 m16 x 8 n8 tiles each), 128
// accumulators a thread, so one block per SM.
template <bool BIAS, int V>
__global__ void __launch_bounds__(THREADS, 1) tile_s8_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ d, int M, int K, int N,
    TileEpi<int> e) {
  constexpr int SA = IBK * BM, SD = IBK * S8_BN;  // bytes per operand and slab
  constexpr int A_ROW = IBK / V, D_ROW = S8_BN / V;  // copies per slab row
  constexpr int A_COPIES = BM * A_ROW / THREADS, D_COPIES = IBK * D_ROW / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* as = smem;                // [STAGES][BM][IBK], swizzled rows
  unsigned char* ds = smem + STAGES * SA;  // [STAGES][IBK][S8_BN], swizzled rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 64;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * S8_BN;
  const int8_t* ab = a + (size_t)m0 * K;
  const int8_t* db = d + n0;
  const int n_slabs = (K + IBK - 1) / IBK;

  auto fetch = [&](int s) {
    if (s < n_slabs) {
      unsigned char* sa = as + (s % STAGES) * SA;
      unsigned char* sd = ds + (s % STAGES) * SD;
#pragma unroll 16
      for (int i = 0; i < A_COPIES; ++i) {
        const int c = tid + i * THREADS, row = c / A_ROW, off = (c % A_ROW) * V;
        const int k = s * IBK + off;
        const bool full = m0 + row < M && k < K;
        copy_v<V>(sa + a_swz(row, off >> 4) + (off & 15),
                  full ? ab + (size_t)row * K + k : a, full);
      }
#pragma unroll 16
      for (int i = 0; i < D_COPIES; ++i) {
        const int c = tid + i * THREADS, row = c / D_ROW, off = (c % D_ROW) * V;
        const int k = s * IBK + row;
        const bool full = k < K && n0 + off < N;
        copy_v<V>(sd + d_swz(row, off >> 4) + (off & 15),
                  full ? db + (size_t)k * N + off : d, full);
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
      // A: ldmatrix x4 of m-tile mi, matrices (rows 0-7 | 8-15) x (k bytes
      // ks .. +15 | ks + 16 .. +31): lane l gives row l & 15, chunk
      // ks / 16 + l / 16, and receives mma.sync's A fragment as it is
      uint32_t af[4][4], bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], sa + a_swz(wm + 16 * mi + (lane & 15), ks / 16 + (lane >> 4)));
      // B: column g of n-tile 4 h + j is column 32 h + 4 g + j of the warp's 64
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {  // k = ks + 16 kh + 4 tig .. + 3
        const int r0 = ks + 16 * kh + 4 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w[4];
          d_block4x4(w, sd, r0, wn / 4 + 8 * h + g);
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

  // C row g + 8 hh of m-tile mi is row wm + 16 mi + 8 hh + g; C column
  // 2 tig + jj of n-tile ni is column wn + 32 (ni / 4) + 4 (2 tig + jj) +
  // ni % 4
  int rows[8], cols[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = m0 + wm + 16 * (i >> 1) + 8 * (i & 1) + g;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    cols[j] = n0 + wn + 32 * (j >> 3) + 4 * (2 * tig + (j & 1)) + ((j >> 1) & 3);
  tile_epilogue<MODE_INT8, BIAS>(e, M, N, rows, cols, [&](int i, int j) {
    return acc[i >> 1][j >> 1][2 * (i & 1) + (j & 1)];
  });
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The copy width of both operands: 16 bytes when the bases and the row
// strides (K and N elements of `esz` bytes) are 16-byte aligned, else 4 when
// they are 4-byte aligned, else one element.
inline int copy_width(const void* a, const void* d, int K, int N, int esz) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(d) |
                         (uintptr_t)K * esz | (uintptr_t)N * esz;
  return bits % 16 == 0 ? 16 : bits % 4 == 0 ? 4 : esz;
}

template <int MODE, bool BIAS, int V>
void* kernel_for(size_t* smem) {
  if constexpr (MODE == MODE_INT8) {
    *smem = S8_SMEM;
    return reinterpret_cast<void*>(tile_s8_kernel<BIAS, V>);
  } else if constexpr (MODE == MODE_F32) {
    *smem = simt_smem<float>();
    return reinterpret_cast<void*>(tile_simt_kernel<MODE_F32, BIAS, V>);
  } else {
    *smem = BF16_SMEM;
    return reinterpret_cast<void*>(tile_bf16_kernel<BIAS, V>);
  }
}

// The product kernel of a runtime mode (0 = f32, 1 = bf16, 2 = int8) and a
// copy width below 16 bytes or f32 / int8 at 16, with its dynamic shared
// memory; null for a pair that no launch takes.
template <bool BIAS>
void* select_product(int mode, int v, size_t* smem) {
  switch (mode * 32 + v) {
    case MODE_F32 * 32 + 16: return kernel_for<MODE_F32, BIAS, 16>(smem);
    case MODE_F32 * 32 + 4: return kernel_for<MODE_F32, BIAS, 4>(smem);
    case MODE_BF16 * 32 + 4: return kernel_for<MODE_BF16, BIAS, 4>(smem);
    case MODE_BF16 * 32 + 2: return kernel_for<MODE_BF16, BIAS, 2>(smem);
    case MODE_INT8 * 32 + 16: return kernel_for<MODE_INT8, BIAS, 16>(smem);
    case MODE_INT8 * 32 + 4: return kernel_for<MODE_INT8, BIAS, 4>(smem);
    case MODE_INT8 * 32 + 1: return kernel_for<MODE_INT8, BIAS, 1>(smem);
    default: return nullptr;
  }
}

template <int SPLIT, bool BIAS>
void* wgmma_kernel(size_t* smem) {
  *smem = WgmmaRing<SPLIT>::SMEM;
  return reinterpret_cast<void*>(tile_wgmma_kernel<SPLIT, BIAS>);
}

// The wgmma kernel of a bf16 or split mode (1, 3 / 4 / 5 = 'both' / 'rhs'
// / 'lhs'), with its dynamic shared memory; null for a mode it does not
// take (the split modes run without a bias: K3 has none).
template <bool BIAS>
void* select_wgmma(int mode, size_t* smem) {
  switch (mode) {
    case MODE_BF16: return wgmma_kernel<SPLIT_NONE, BIAS>(smem);
    case MODE_SPLIT_BOTH: return BIAS ? nullptr : wgmma_kernel<SPLIT_BOTH, false>(smem);
    case MODE_SPLIT_RHS: return BIAS ? nullptr : wgmma_kernel<SPLIT_RHS, false>(smem);
    case MODE_SPLIT_LHS: return BIAS ? nullptr : wgmma_kernel<SPLIT_LHS, false>(smem);
    default: return nullptr;
  }
}

// Which kernel a launch of `mode` with copy width v takes, with its
// dynamic shared memory and threads a block (ProductKernel in
// splus_epilogue.cuh); null for a pair that no launch takes: bf16 and the
// split modes with 16-byte copies take the wgmma kernel, the split modes no
// other width.
template <bool BIAS>
void* product_kernel(int mode, int v, size_t* smem, int* threads, int* kind) {
  const bool tensor_bf16 = mode == MODE_BF16 || mode >= MODE_SPLIT_BOTH;
  if (tensor_bf16 && v == 16) {
    *threads = WG_THREADS;
    *kind = PK_WGMMA_BF16;
    return select_wgmma<BIAS>(mode, smem);
  }
  if (mode >= MODE_SPLIT_BOTH) return nullptr;
  *threads = THREADS;
  *kind = mode == MODE_F32 ? PK_SIMT : mode == MODE_INT8 ? PK_MMA_S8 : PK_MMA_BF16;
  return select_product<BIAS>(mode, v, smem);
}

// The wgmma launch's tensor maps (tile_wgmma_kernel) for a bf16 or split
// mode: A (M x H_A K) and D (H_D K x N) bf16 stacks; with K = 0 no slab is
// loaded and the maps stay unset.
inline cudaError_t wgmma_maps(CUtensorMap* ta, CUtensorMap* td, const void* a, const void* d,
                              int M, int K, int N, int mode) {
  if (K == 0) return cudaSuccess;
  const cuuint64_t ha = (mode == MODE_SPLIT_BOTH || mode == MODE_SPLIT_LHS) ? 2 : 1;
  const cuuint64_t hd = (mode == MODE_SPLIT_BOTH || mode == MODE_SPLIT_RHS) ? 2 : 1;
  const cuuint64_t k = K, row = 2 * k;  // bytes of one half of an A row
  cudaError_t err =
      bf16_tensor_map<3>(ta, a, {k, ha, (cuuint64_t)M}, {row, ha * row}, {64, 1, 64});
  if (err != cudaSuccess) return err;
  const cuuint64_t n = N;
  return bf16_tensor_map<3>(td, d, {n, k, hd}, {2 * n, 2 * n * k}, {64, 64, 1});
}

// The product launch for a runtime mode; the mask pointers may be null, the
// bias must be null exactly when !BIAS. `kind` receives the kernel taken
// (ProductKernel).
template <bool BIAS>
cudaError_t product_any(int mode, const void* a, const void* d, const void* bias, int M,
                        int K, int N, const void* xt, const void* xc, const void* xd,
                        const void* yt, const void* yc, const void* yd, const void* pvec,
                        const void* allowed, const void* fmask, const void* tmask, int flags,
                        void* scores, cudaStream_t s, int* kind) {
  if (M <= 0 || N <= 0 || K < 0 || (bias != nullptr) != BIAS) return cudaErrorInvalidValue;
  const int esz = mode == MODE_F32 ? 4 : mode == MODE_INT8 ? 1 : 2;
  size_t smem = 0;
  int threads = 0;
  void* kern = product_kernel<BIAS>(mode, copy_width(a, d, K, N, esz), &smem, &threads, kind);
  if (!kern) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  const int bn = mode == MODE_INT8 ? S8_BN : BN;
  const dim3 grid((M + BM - 1) / BM, (N + bn - 1) / bn);
  if (mode == MODE_INT8) {
    TileEpi<int> e{static_cast<const int*>(bias), f(xt), f(xc), f(xd), f(yt), f(yc), f(yd),
                   f(pvec), u8(allowed), u8(fmask), u8(tmask), flags,
                   static_cast<float*>(scores)};
    void* args[] = {&a, &d, &M, &K, &N, &e};
    err = cudaLaunchKernel(kern, grid, threads, args, smem, s);
  } else {
    TileEpi<float> e{f(bias), f(xt), f(xc), f(xd), f(yt), f(yc), f(yd), f(pvec),
                     u8(allowed), u8(fmask), u8(tmask), flags, static_cast<float*>(scores)};
    if (*kind == PK_WGMMA_BF16) {
      CUtensorMap ta{}, td{};
      err = wgmma_maps(&ta, &td, a, d, M, K, N, mode);
      if (err != cudaSuccess) return err;
      void* args[] = {&ta, &td, &M, &K, &N, &e};
      // column blocks in pairs: an odd count's last pair has a block past N
      return launch_pairs(kern, dim3(grid.x, (grid.y + 1) / 2 * 2), true, smem, s, args);
    } else {
      void* args[] = {&a, &d, &M, &K, &N, &e};
      err = cudaLaunchKernel(kern, grid, threads, args, smem, s);
    }
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// out[0..3]: registers, local bytes (spills), dynamic shared bytes and
// resident blocks per SM of the product kernel of a runtime mode for
// 16-byte aligned operands (the main path's), out[4] the kernel
// (ProductKernel)
template <bool BIAS>
cudaError_t product_attrs(int mode, int* out) {
  size_t smem = 0;
  int threads = 0;
  void* kern = product_kernel<BIAS>(mode, 16, &smem, &threads, &out[4]);
  if (!kern) return cudaErrorInvalidValue;
  return launch_attrs(kern, threads, smem, out);
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
