// P1 of the port: the transposed-lhs product out[M, N] = A[K, M]^T . B[K, N],
// for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces benchmarks/tpu_kernel_check.py::_probe_transposed_lhs (its
// pallas_call body `kern`): one dot_general that contracts the lhs on its
// dimension 0, int8 -> int32, bf16 -> f32 and f32 -> f32 at HIGHEST
// precision. A and B are row-major as given (M and N contiguous): that
// operand orientation is K2's (both of its tiles are (u_pad, tc),
// contracted on the user axis), and so are the products P1 runs.
//
// What bounds it on an H100 SXM: operations at K2's block shape (K 200,960,
// M = N = 2,048 or 4,096): 67 TFLOP/s of f32 FMA outside the tensor cores,
// 989 TFLOP/s of bf16 and 1,979 TOP/s of int8 on the tensor cores.
//
// The product kernel a launch takes (TlhsKernel, counted by the wrapper):
//   int8  tlhs_wgmma_s8_kernel, any shape: the K-major pass (kmajor.cuh)
//         writes A and B as at[M, k_pad] and bt[N, k_pad] into the
//         wrapper's workspace, then hopper.cuh's wgmma_block_s8 (wgmma
//         m64n256k32 s8 -> s32, exact) runs over 128 x 256 blocks on TMA
//         boxes of 128 K bytes x 64 rows, in cluster pairs of two column
//         blocks that multicast A. The pass runs apart from the product so
//         that its time (bytes) and the product's (operations) are read
//         separately; K2's int8 product (sym_topk.cu) runs the same block
//         on tiles that K5 writes K-major, so it needs no pass.
//   f32   rows of 16-byte multiples (M, N multiples of 4, 16-byte aligned
//         operands): tlhs_simt_ring_kernel, K2's SIMT product
//         (mn_products.cuh: mn_simt_block, a 3-slab cp.async ring, one
//         in-order fmaf chain per output; TF32 would not be HIGHEST).
//         Other rows: tlhs_f32_kernel, SIMT FMA, 8 x 8 outputs a thread,
//         slabs staged by plain loads (the first port's kernel).
//   bf16  M, N multiples of 8, 16-byte aligned operands:
//         tlhs_wgmma_bf16_kernel, K2's wgmma product (mn_products.cuh:
//         mn_wgmma_block, both operands MN-major on TMA boxes of 64 K rows).
//         Other rows (TMA needs 16-byte row strides): tlhs_bf16_kernel,
//         mma.sync m16n8k16 on slabs stored as they lie, (k, m) rows, whose
//         fragments ldmatrix.x4.trans hands each warp transposed (the
//         first port's).
// Any M, N and K: past the edges operands read as zeros and the stores are
// masked.

#include "hopper.cuh"
#include "kmajor.cuh"
#include "mn_products.cuh"
#include "tensor_core.cuh"

namespace {

enum ProbeMode { P_F32 = 0, P_BF16 = 1, P_INT8 = 2 };

// the product kernels (benchmarks/probes.py: TLHS_KERNELS)
enum TlhsKernel {
  TK_SIMT = 0, TK_SIMT_RING = 1, TK_MMA_BF16 = 2, TK_WGMMA_BF16 = 3, TK_WGMMA_S8 = 4
};

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int THREADS = 256;  // 8 warps

// ---------------------------------------------------------------------------
// f32 on rows that are not 16-byte multiples: SIMT
// ---------------------------------------------------------------------------

constexpr int FBK = 16;  // K per slab
constexpr int FPAD = 4;

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
// bf16 on rows that are not 16-byte multiples: mma.sync m16n8k16, fragments
// by ldmatrix.trans
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
// f32 and bf16 on 16-byte rows: K2's products (mn_products.cuh)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(MN_THREADS, 2) tlhs_simt_ring_kernel(
    const float* __restrict__ a, const float* __restrict__ b, int K, int M, int N,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * MN_B, n0 = blockIdx.x * MN_B;
  mn_simt_block<float>(smem, a + m0, b + n0, M, N, K, M - m0, N - n0,
                       [&](const float (&acc)[8][8], int ty, int tx) {
#pragma unroll
                         for (int i = 0; i < 8; ++i) {
                           const int r = m0 + strip(ty, i);
                           if (r >= M) continue;
#pragma unroll
                           for (int j = 0; j < 8; ++j) {
                             // 4-byte stores, as K2's epilogue: float4 stores timed slower
                             const int c = n0 + strip(tx, j);
                             if (c < N) out[(size_t)r * N + c] = acc[i][j];
                           }
                         }
                       });
}

// ta: A as the 4D map (M, K, 1, 1), tb: B as (N, K, 1); warpgroup wg's
// accumulator acc[4 j + 2 i + c] is row 64 wg + 16 warp + 8 i + g, column
// 8 j + 2 tig + c of the block (hopper.cuh: wgmma_m64n128k16)
__global__ void __launch_bounds__(WG_THREADS, 1) tlhs_wgmma_bf16_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, int K, int M,
    int N, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * MN_B, n0 = blockIdx.x * MN_B;
  mn_wgmma_block<SPLIT_NONE>(
      smem, &ta, &tb, K, m0, 0, n0, [&](const float (&acc)[64], int wg, int warp, int lane) {
        const int g = lane >> 2, tig = lane & 3;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + 64 * wg + 16 * warp + 8 * i + g;
          if (r >= M) continue;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = n0 + 8 * j + 2 * tig;  // N is even: c + 1 < N with c
            if (c < N) {  // 4-byte stores, as K2's epilogue: a float2 store timed slower
              out[(size_t)r * N + c] = acc[4 * j + 2 * i];
              out[(size_t)r * N + c + 1] = acc[4 * j + 2 * i + 1];
            }
          }
        }
      });
}

// ---------------------------------------------------------------------------
// int8: wgmma s8 on K-major operands (hopper.cuh: wgmma_block_s8)
// ---------------------------------------------------------------------------

// ta, tb: at (M x k_pad) and bt (N x k_pad), the K-major pass's output, as
// 2D maps (k_pad, rows) in boxes {128, 64}; k_pad / 128 slabs; the block's
// rows m0 .. + 128, its columns n0 .. + 256
__global__ void __launch_bounds__(WG_THREADS, 1) tlhs_wgmma_s8_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, int k_pad,
    int M, int N, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * MN_B, n0 = blockIdx.x * WG_S8_BN;
  wgmma_block_s8(
      smem, k_pad / WG_S8_BK,
      [&](int s, unsigned char* st, uint64_t* bar, uint32_t rank) {
        const int k0 = s * WG_S8_BK;
        // A is the pair's: this block brings box `rank` to both
        tma_load_2d_both(st + rank * BOX_BYTES, &ta, bar, k0, m0 + 64 * rank);
#pragma unroll
        for (int j = 0; j < WG_S8_BN / 64; ++j)
          tma_load_2d(st + (2 + j) * BOX_BYTES, &tb, bar, k0, n0 + 64 * j);
      },
      [&](const int (&acc)[128], int wg, int warp, int lane) {
        const int g = lane >> 2, tig = lane & 3;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + 64 * wg + 16 * warp + 8 * i + g;
          if (r >= M) continue;
#pragma unroll
          for (int j = 0; j < WG_S8_BN / 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = n0 + 8 * j + 2 * tig + c;
              if (col < N) out[(size_t)r * N + col] = acc[4 * j + 2 * i + c];
            }
        }
      });
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the s8 product on K-major operands; with k_pad = 0 no slab is loaded and
// the maps stay unset
cudaError_t launch_s8(const void* at, const void* bt, int k_pad, int M, int N, int* out,
                      cudaStream_t stream) {
  CUtensorMap ta{}, tb{};
  if (k_pad > 0) {
    cudaError_t err = s8_kmajor_map(&ta, at, k_pad, M);
    if (err == cudaSuccess) err = s8_kmajor_map(&tb, bt, k_pad, N);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&ta, &tb, &k_pad, &M, &N, &out};
  // column blocks in pairs: an odd count's last pair has a block past N
  const int gx = (N + WG_S8_BN - 1) / WG_S8_BN;
  return launch_pairs(reinterpret_cast<const void*>(tlhs_wgmma_s8_kernel),
                      dim3((gx + 1) / 2 * 2, (M + MN_B - 1) / MN_B), false, WG_S8_SMEM, stream,
                      args);
}

}  // namespace

extern "C" {

// The K-major pass alone (kmajor.cuh: kmajor_launch): xt (R x k_pad) = x^T
// zero-padded for x (K x R), trans = 1, or x zero-padded for x (R x K).
int kmajor_pass(int trans, const void* x, int K, int R, void* xt, void* stream) {
  return (int)kmajor_launch(trans != 0, x, K, R, xt, static_cast<cudaStream_t>(stream));
}

// out (M x N, int32) = at[:M] . bt[:N]^T, the s8 product alone on K-major
// operands at (M x k_pad) and bt (N x k_pad), k_pad a multiple of 128, both
// 16-byte aligned (the K-major pass's output).
int probe_s8_product(const void* at, const void* bt, int k_pad, int M, int N, void* out,
                     void* stream) {
  if (k_pad < 0 || k_pad % WG_S8_BK != 0 || M <= 0 || N <= 0 || !aligned16(at) ||
      !aligned16(bt) || (M + MN_B - 1) / MN_B > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_s8(at, bt, k_pad, M, N, static_cast<int*>(out),
                        static_cast<cudaStream_t>(stream));
}

// out (M x N; f32 for f32 and bf16, int32 for int8) = a^T . b, with a
// (K x M) and b (K x N) row-major in `mode` (0 f32, 1 bf16, 2 int8). For
// int8, ws_a (M x k_pad) and ws_b (N x k_pad), k_pad = K rounded up to a
// multiple of 128, receive the K-major pass's output (null when k_pad is
// 0). `kind` receives the product kernel taken (TlhsKernel).
int probe_tlhs(int mode, const void* a, const void* b, int K, int M, int N, void* out,
               void* ws_a, void* ws_b, void* stream, int* kind) {
  if (K < 0 || M <= 0 || N <= 0 || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned16(a) && aligned16(b);
  switch (mode) {
    case P_F32:
      if (al && M % 4 == 0 && N % 4 == 0) {
        *kind = TK_SIMT_RING;
        const size_t smem = mn_simt_smem<float>();
        cudaError_t err = cudaFuncSetAttribute(
            tlhs_simt_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        tlhs_simt_ring_kernel<<<dim3((N + MN_B - 1) / MN_B, (M + MN_B - 1) / MN_B), MN_THREADS,
                                smem, s>>>(static_cast<const float*>(a),
                                           static_cast<const float*>(b), K, M, N,
                                           static_cast<float*>(out));
        break;
      }
      *kind = TK_SIMT;
      tlhs_f32_kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b), K, M, N,
          static_cast<float*>(out));
      break;
    case P_BF16:
      if (al && M % 8 == 0 && N % 8 == 0) {
        *kind = TK_WGMMA_BF16;
        CUtensorMap ta{}, tb{};
        if (K > 0) {
          const cudaError_t err = mn_wgmma_maps<SPLIT_NONE>(&ta, &tb, a, b, K, M, 1, N);
          if (err != cudaSuccess) return (int)err;
        }
        void* args[] = {&ta, &tb, &K, &M, &N, &out};
        const dim3 grid(((N + MN_B - 1) / MN_B + 1) / 2 * 2, (M + MN_B - 1) / MN_B);
        return (int)launch_pairs(reinterpret_cast<const void*>(tlhs_wgmma_bf16_kernel), grid,
                                 false, WgmmaRing<SPLIT_NONE>::SMEM, s, args);
      }
      *kind = TK_MMA_BF16;
      tlhs_bf16_kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), THREADS, 0, s>>>(
          static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b), K, M, N,
          static_cast<float*>(out));
      break;
    case P_INT8: {
      *kind = TK_WGMMA_S8;
      const int k_pad = (K + WG_S8_BK - 1) / WG_S8_BK * WG_S8_BK;
      if (k_pad > 0 && !(ws_a && ws_b)) return (int)cudaErrorInvalidValue;
      int err = kmajor_pass(1, a, K, M, ws_a, stream);
      if (err == 0) err = kmajor_pass(1, b, K, N, ws_b, stream);
      if (err != 0) return err;
      return probe_s8_product(ws_a, ws_b, k_pad, M, N, out, stream);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
