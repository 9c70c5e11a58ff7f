// P1 of the port: the transposed-lhs product out[M, N] = A[K, M]^T . B[K, N],
// for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces benchmarks/tpu_kernel_check.py::_probe_transposed_lhs (its
// pallas_call body `kern`): one dot_general that contracts the lhs on its
// dimension 0, int8 -> int32, bf16 -> f32 and f32 -> f32 at HIGHEST
// precision. A and B are row-major as given (M and N contiguous) and are not
// transposed on the host: that operand orientation is K2's (both of its
// tiles are (u_pad, tc), contracted on the user axis).
//
// What bounds it on an H100 SXM: operations at K2's block shape (K 200,960,
// M = N = 2,048 or 4,096): 67 TFLOP/s of f32 FMA outside the tensor cores,
// 989 TFLOP/s of bf16 and 1,979 TOP/s of int8 on the tensor cores.
//
// One block owns a 128 x 128 output block and walks K in slabs staged
// through shared memory (no asynchronous loads, no double buffering, no
// wgmma: a simple kernel that is right). Any M, N and K: slabs are
// zero-filled past the edges and the stores are masked.
//   f32   SIMT FMA, 8 x 8 outputs a thread (K1's product). There are no f32
//         tensor cores, and TF32 would not be HIGHEST.
//   bf16  mma.sync m16n8k16 with f32 accumulation. The slab is stored as it
//         lies in memory, (k, m) rows, and ldmatrix.x4.trans hands each warp
//         the transposed fragments of both operands: the "row" A fragment is
//         (m, k), the "col" B fragment is k-contiguous per n, and both are
//         the 8 x 8 transposes of the stored (k, m) and (k, n) blocks.
//   int8  mma.sync m16n8k32 with int32 accumulation. ldmatrix has no .trans
//         for 8-bit data (nor does wgmma: an 8-bit operand must be K-major),
//         so the kernel transposes both operands itself on the way into
//         shared memory: each thread reads a 4 (k) x 4 (m) byte block as four
//         32-bit words, transposes it in registers with four pairs of byte
//         permutes (PRMT, __byte_perm), and stores four k-contiguous words.
//         Chosen over a byte-wise transposing store because it keeps the
//         global reads and the shared stores 32 bits wide, and the
//         fragments are then plain 32-bit shared loads. The shared rows
//         are 17 words (16 + 1) apart, so the transposing stores of a warp
//         fall in 32 distinct banks.
//         Built with -DNO_PRMT_TRANSPOSE (by
//         benchmarks/tlhs_transpose_cost.py only, never by the engine's
//         library) the PRMT pass (transpose4x4, csrc/tensor_core.cuh) is
//         compiled out: the results are wrong but
//         every load and store is the same, so its time against this
//         kernel's is what the transpose costs.

#include "tensor_core.cuh"

namespace {

enum ProbeMode { P_F32 = 0, P_BF16 = 1, P_INT8 = 2 };

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int THREADS = 256;  // 8 warps

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------

constexpr int FBK = 16;  // K per slab
constexpr int FPAD = 4;

// the row (or column) of micro-tile entry i: two 4-wide strips 64 apart
__device__ __forceinline__ int strip(int t, int i) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + i - 4;
}

__global__ void __launch_bounds__(THREADS) tlhs_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ b, int K, int M, int N,
    float* __restrict__ out) {
  __shared__ __align__(16) float as[FBK][BM + FPAD];
  __shared__ __align__(16) float bs[FBK][BN + FPAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    // neighbouring threads read neighbouring m (n): coalesced rows of A (B)
#pragma unroll
    for (int i = 0; i < BM * FBK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BM, r = e % BM;
      const int gk = k0 + kk;
      as[kk][r] = (gk < K && m0 + r < M) ? a[(size_t)gk * M + m0 + r] : 0.0f;
      bs[kk][r] = (gk < K && n0 + r < N) ? b[(size_t)gk * N + n0 + r] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + strip(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + strip(tx, j);
      if (c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernels: warp layout and fragment stores (ldmatrix, mma.sync
// and the PRMT transpose are in csrc/tensor_core.cuh)
// ---------------------------------------------------------------------------

// Warp layout of the mma kernels: 8 warps as 2 (m) x 4 (n), each owning a
// 64 x 32 sub-block = 4 m16 x 4 n8 mma tiles.
constexpr int WM = 64, WN = 32;

// The m16n8 accumulator fragment of the mma tile whose corner is (r0, c0):
// frag[0..1] at row g, frag[2..3] at row g + 8,
// columns 2 * tig + {0, 1}.
template <typename T>
__device__ __forceinline__ void store_frag(T* __restrict__ out, const T (&frag)[4], int r0,
                                           int c0, int M, int N, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + 2 * tig + j;
      if (c < N) out[(size_t)r * N + c] = frag[2 * h + j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, fragments by ldmatrix.trans
// ---------------------------------------------------------------------------

constexpr int HBK = 32;  // K per slab: two k16 steps
constexpr int HPAD = 8;  // rows 272 bytes apart: 16-byte aligned, conflict-free ldmatrix

// Rows k0 .. k0 + HBK of a row-major (K x C) bf16 matrix, columns
// c0 .. c0 + 128, into s[k][c]: 16-byte copies where the chunk lies inside
// and is aligned, element by element at a ragged edge, zeros outside.
__device__ __forceinline__ void load_slab_bf16(uint16_t (*s)[BM + HPAD],
                                               const uint16_t* __restrict__ g, int k0,
                                               int c0, int K, int C, int tid) {
#pragma unroll
  for (int i = 0; i < HBK * BM / 8 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int kk = e / (BM / 8), col = (e % (BM / 8)) * 8;
    const int gk = k0 + kk, gc = c0 + col;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gk < K && gc < C) {
      const uint16_t* p = g + (size_t)gk * C + gc;
      if (gc + 8 <= C && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (gc + j < C) w[j / 2] |= (uint32_t)p[j] << (16 * (j % 2));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(&s[kk][col]) = v;
  }
}

__global__ void __launch_bounds__(THREADS) tlhs_bf16_kernel(
    const uint16_t* __restrict__ a, const uint16_t* __restrict__ b, int K, int M, int N,
    float* __restrict__ out) {
  __shared__ __align__(16) uint16_t as[HBK][BM + HPAD];
  __shared__ __align__(16) uint16_t bs[HBK][BN + HPAD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  // ldmatrix row addresses: lanes 8q .. 8q + 7 address matrix q
  const int a_k = (lane & 7) + ((lane >> 4) << 3);  // A: matrices (k0-7|k8-15) x (m0-7|m8-15)
  const int a_m = ((lane >> 3) & 1) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;  // B: (k0-7|k8-15) x (n0-7|n8-15)
  const int b_n = (lane >> 4) * 8;

  for (int k0 = 0; k0 < K; k0 += HBK) {
    load_slab_bf16(as, a, k0, m0, K, M, tid);
    load_slab_bf16(bs, b, k0, n0, K, N, tid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < HBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], &as[ks + a_k][wm + mi * 16 + a_m]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &bs[ks + b_k][wn + nj * 16 + b_n]);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      store_frag(out, acc[mi][ni], m0 + wm + mi * 16, n0 + wn + ni * 8, M, N, lane);
}

// ---------------------------------------------------------------------------
// int8: mma.sync m16n8k32, operands transposed in registers (PRMT)
// ---------------------------------------------------------------------------

constexpr int IBK = 64;            // K per slab: two k32 steps
constexpr int IROW = IBK / 4 + 1;  // words per shared row, one of them pad

// Bytes c .. c + 3 of a row as one little-endian word: a 32-bit load where
// the four lie inside the row and are aligned, byte by byte at a ragged
// edge, zeros past it.
__device__ __forceinline__ uint32_t load_word(const int8_t* __restrict__ row, int c, int C) {
  const int8_t* p = row + c;
  if (c + 4 <= C && (reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < C) w |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return w;
}

// Slab k0 .. k0 + IBK of a row-major (K x C) operand, columns c0 .. c0 + 128
// of the output side, into s[c][k / 4] as k-contiguous words; each thread
// transposes IBK / 32 4 x 4 blocks. In pass i, warp w takes the 4 x 8
// blocks e = w + 8 i: k blocks (e % (IBK / 16)) * 4 + lane / 8 and c blocks
// (e / (IBK / 16)) * 8 + lane % 8, so that each global read instruction
// covers four 32-byte row segments and, with rows IROW = 1 (mod 8) words
// apart, the shared stores of a warp hit 32 distinct banks.
__device__ __forceinline__ void load_slab_s8(uint32_t (*s)[IROW], const int8_t* __restrict__ g,
                                             int k0, int c0, int K, int C, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < IBK / 32; ++i) {
    const int e = warp + 8 * i;
    const int kb = (e % (IBK / 16)) * 4 + (lane >> 3);
    const int cb = (e / (IBK / 16)) * 8 + (lane & 7);
    const int gc = c0 + cb * 4;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gk = k0 + kb * 4 + q;
      w[q] = (gk < K && gc < C) ? load_word(g + (size_t)gk * C, gc, C) : 0u;
    }
    transpose4x4(w);
#pragma unroll
    for (int j = 0; j < 4; ++j) s[cb * 4 + j][kb] = w[j];
  }
}

__global__ void __launch_bounds__(THREADS) tlhs_s8_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b, int K, int M, int N,
    int* __restrict__ out) {
  __shared__ __align__(16) uint32_t as[BM][IROW];
  __shared__ __align__(16) uint32_t bs[BN][IROW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  for (int k0 = 0; k0 < K; k0 += IBK) {
    load_slab_s8(as, a, k0, m0, K, M, tid);
    load_slab_s8(bs, b, k0, n0, K, N, tid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < IBK / 4; ks += 8) {
      // A (row): regs 0/1 = rows g / g + 8 at k = 4 tig .. +3, regs 2/3
      // the same at k + 16; B (col): column g at k = 4 tig and 16 + 4 tig
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = as[r][ks + tig];
        af[mi][1] = as[r + 8][ks + tig];
        af[mi][2] = as[r][ks + 4 + tig];
        af[mi][3] = as[r + 8][ks + 4 + tig];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + g;
        bf[ni][0] = bs[c][ks + tig];
        bf[ni][1] = bs[c][ks + 4 + tig];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      store_frag(out, acc[mi][ni], m0 + wm + mi * 16, n0 + wn + ni * 8, M, N, lane);
}

}  // namespace

extern "C" {

// out (M x N; f32 for f32 and bf16, int32 for int8) = a^T . b, with a
// (K x M) and b (K x N) row-major in `mode` (0 f32, 1 bf16, 2 int8).
int probe_tlhs(int mode, const void* a, const void* b, int K, int M, int N, void* out,
               void* stream) {
  if (K < 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case P_F32:
      tlhs_f32_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(a),
                                               static_cast<const float*>(b), K, M, N,
                                               static_cast<float*>(out));
      break;
    case P_BF16:
      tlhs_bf16_kernel<<<grid, THREADS, 0, s>>>(static_cast<const uint16_t*>(a),
                                                static_cast<const uint16_t*>(b), K, M, N,
                                                static_cast<float*>(out));
      break;
    case P_INT8:
      tlhs_s8_kernel<<<grid, THREADS, 0, s>>>(static_cast<const int8_t*>(a),
                                              static_cast<const int8_t*>(b), K, M, N,
                                              static_cast<int*>(out));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
