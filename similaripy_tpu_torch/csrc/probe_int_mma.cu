// P2 of the port: the int8 / int4 tensor-core rate probe, for NVIDIA Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces benchmarks/micro_int4.py::_kernel (the body of its pallas_call):
// a grid of `steps` dots of one fixed (M, K) x (K, N) int8 block pair, each
// added into one int32 output, so out = steps * A . B; in mode s4 the
// operands are cast to int4 inside the kernel first. The rate is
// 2 * M * K * N * steps / time.
//
// What bounds it on an H100 SXM: operations, 1,979 TOP/s of dense int8 on
// the tensor cores, which only wgmma reaches (mma.sync tops out near 1,100);
// the data sheet lists no int4 rate, and wgmma has no s4 type.
//
// Translation. The TPU kernel keeps both blocks in VMEM under constant
// index maps, so its DMA is negligible and it measures the matrix unit.
// Here shared memory (int8) or the register file (s4) plays that part: the
// operands of one K chunk are loaded once, and the chunk's products are
// then issued `steps` times. The sums are the TPU kernel's in another
// order, exact in int32. K is split over several blocks, whose partial sums
// meet in the output with atomic adds, so that the grid fills the card's
// SMs; the C entry zeroes the output first.
//   int8  int_wgmma_kernel: the K-major pass (kmajor.cuh) pads A to
//         (M, k_pad) and writes B as bt (N, k_pad), once a call, outside the
//         step loop; each block owns a 128 x 256 output block and a chunk of
//         at most S8_MAX_SLABS slabs of 128 K bytes, which one TMA barrier
//         brings into shared memory (A's and bt's boxes of 128 K bytes x 64
//         rows, 128-byte swizzled); its two warpgroups then issue the
//         chunk's wgmma m64n256k32 s8 -> s32 instructions (one 64-row strip
//         of A each, by all 256 rows of bt) `steps` times, one step's group
//         in flight while the next is issued. K is split so that the grid
//         has about two blocks for every SM (at the probe's shape 128
//         blocks, one a chunk of one slab: the split can go no finer); on
//         an H100 they timed a little faster than 128 x 128 blocks (256
//         blocks, two an SM).
//   s4    s4_mma_kernel: each warp loads its operand fragments for one K
//         chunk straight from global memory (A row-major is k-contiguous, B
//         is gathered down its columns), packs the int8 values to signed
//         nibbles in registers (their low four bits, as an int4 cast keeps
//         them) and issues mma.sync m16n8k64 s4 x s4 -> s32 `steps` times
//         per chunk. A warp owns a 32 x 32 output block, a block 2 x 2 warps,
//         K is split over KSPLIT blocks.
// Any M, N and K: operands read as zeros past the edges and the atomic adds
// are masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "kmajor.cuh"

namespace {

enum RateMode { R_INT8 = 0, R_S4 = 1 };

// the product kernels (benchmarks/probes.py: RATE_KERNELS)
enum RateKernel { IK_WGMMA_S8 = 0, IK_MMA_S4 = 1 };

// ---------------------------------------------------------------------------
// int8: wgmma s8 on shared-memory-resident K-major chunks
// ---------------------------------------------------------------------------

constexpr int S8_BM = 128;                              // output block rows
constexpr int S8_MAX_SLABS = RING_BYTES / WG_S8_SLAB;  // a chunk at most: 4 of 48 KB
constexpr int S8_THREADS = WG_CONSUMERS;

// Block (x, y, z): output columns WG_S8_BN x (256), rows 128 y, slabs z *
// per .. min(n_slabs, (z + 1) * per). Slab q of the chunk sits at q *
// WG_S8_SLAB: A's two 64-row boxes, then bt's four (hopper.cuh's s8 slab
// layout).
__global__ void __launch_bounds__(S8_THREADS, 1) int_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, int M, int N,
    int n_slabs, int per, int steps, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bar;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * S8_BM, n0 = blockIdx.x * WG_S8_BN;
  const int q0 = blockIdx.z * per, nq = min(n_slabs, q0 + per) - q0;
  if (nq <= 0 || steps == 0) return;  // adds nothing to the zeroed output
  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar, nq * WG_S8_SLAB);
    for (int q = 0; q < nq; ++q) {
      const int k0 = (q0 + q) * WG_S8_BK;
      unsigned char* st = smem + q * WG_S8_SLAB;
#pragma unroll
      for (int j = 0; j < 2; ++j) tma_load_2d(st + j * BOX_BYTES, &ta, &bar, k0, m0 + 64 * j);
#pragma unroll
      for (int j = 0; j < WG_S8_BN / 64; ++j)
        tma_load_2d(st + (2 + j) * BOX_BYTES, &tb, &bar, k0, n0 + 64 * j);
    }
  }
  mbar_wait(&bar, 0);

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  int acc[WG_S8_BN / 2];
#pragma unroll
  for (int i = 0; i < WG_S8_BN / 2; ++i) acc[i] = 0;
  wgmma_fence();
  for (int s = 0; s < steps; ++s) {
    for (int q = 0; q < nq; ++q) {
      const unsigned char* sa = smem + q * WG_S8_SLAB + wg * BOX_BYTES;
      const unsigned char* sb = smem + q * WG_S8_SLAB + 2 * BOX_BYTES;
#pragma unroll
      for (int t = 0; t < WG_S8_BK / 32; ++t)
        wgmma_m64n256k32_s8(acc, sw128_desc(sa + 32 * t, BOX_BYTES),
                            sw128_desc(sb + 32 * t, BOX_BYTES), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  wgmma_fence_operand(acc);

  // acc[4 j + 2 i + c] is row 64 wg + 16 warp + 8 i + g, column 8 j + 2 tig + c
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
        if (col < N) atomicAdd(out + (size_t)r * N + col, acc[4 * j + 2 * i + c]);
      }
  }
}

// ---------------------------------------------------------------------------
// s4: register-resident mma.sync m16n8k64
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;  // 4 warps, 2 (m) x 2 (n)
constexpr int WARP_M = 32, WARP_N = 32;
constexpr int BLOCK_M = 2 * WARP_M, BLOCK_N = 2 * WARP_N;
constexpr int KSPLIT = 8;
constexpr int KC = 64;  // one mma's depth

__device__ __forceinline__ int at(const int8_t* __restrict__ p, size_t stride_r, int r, int c,
                                  int R, int C) {
  return (r < R && c < C) ? (int)p[(size_t)r * stride_r + c] : 0;
}

// 8 consecutive values packed to signed nibbles in one 32-bit register,
// lowest first; element j is at row r0 + j * dr, column c0 + j * dc of a
// row-major (R x C) matrix
__device__ __forceinline__ uint32_t pack_s4(const int8_t* __restrict__ p, int R, int C, int r0,
                                            int c0, int dr, int dc) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t v = (uint32_t)at(p, C, r0 + j * dr, c0 + j * dc, R, C);
    w |= (v & 15u) << (4 * j);
  }
  return w;
}

__device__ __forceinline__ void mma_s4(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS) s4_mma_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b, int M, int K, int N,
    int steps, int* __restrict__ out) {
  // a register holds 8 consecutive k, lanes tig = 0..3 take consecutive
  // groups, registers 2/3 (A) and 1 (B) the second half
  constexpr int PER = KC / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.y * BLOCK_M + (warp >> 1) * WARP_M;
  const int c0 = blockIdx.x * BLOCK_N + (warp & 1) * WARP_N;

  const int chunks = (K + KC - 1) / KC;
  const int per_split = (chunks + gridDim.z - 1) / gridDim.z;
  const int q0 = blockIdx.z * per_split;
  const int q1 = min(chunks, q0 + per_split);
  if (q0 >= q1) return;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  for (int q = q0; q < q1; ++q) {
    const int k0 = q * KC + tig * PER;
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = r0 + mi * 16 + g;
      af[mi][0] = pack_s4(a, M, K, r, k0, 0, 1);
      af[mi][1] = pack_s4(a, M, K, r + 8, k0, 0, 1);
      af[mi][2] = pack_s4(a, M, K, r, k0 + KC / 2, 0, 1);
      af[mi][3] = pack_s4(a, M, K, r + 8, k0 + KC / 2, 0, 1);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = c0 + ni * 8 + g;
      bf[ni][0] = pack_s4(b, K, N, k0, c, 1, 0);
      bf[ni][1] = pack_s4(b, K, N, k0 + KC / 2, c, 1, 0);
    }
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s4(acc[mi][ni], af[mi], bf[ni]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + mi * 16 + g + 8 * h;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + ni * 8 + 2 * tig + j;
          if (c < N) atomicAdd(out + (size_t)r * N + c, acc[mi][ni][2 * h + j]);
        }
      }
}

// The int8 launch: the chunks per block (`per`) so that about two blocks
// run on every SM, and never more than S8_MAX_SLABS; the padded a and bt
// (M x k_pad, N x k_pad) as 2D maps, unset when k_pad is 0.
cudaError_t launch_s8(const void* ap, const void* bt, int M, int k_pad, int N, int steps,
                      int* out, cudaStream_t stream) {
  CUtensorMap ta{}, tb{};
  if (k_pad > 0) {
    cudaError_t err = s8_kmajor_map(&ta, ap, k_pad, M);
    if (err == cudaSuccess) err = s8_kmajor_map(&tb, bt, k_pad, N);
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int gx = (N + WG_S8_BN - 1) / WG_S8_BN, gy = (M + S8_BM - 1) / S8_BM;
  const int n_slabs = k_pad / WG_S8_BK;
  int split = (2 * sms + gx * gy - 1) / (gx * gy);  // blocks per output block
  if (split > n_slabs) split = n_slabs;
  int per = n_slabs > 0 ? (n_slabs + split - 1) / split : 0;
  if (per > S8_MAX_SLABS) per = S8_MAX_SLABS;
  const dim3 grid(gx, gy, per > 0 ? (n_slabs + per - 1) / per : 1);
  const size_t smem = 1024 + (size_t)per * WG_S8_SLAB;
  err = cudaFuncSetAttribute(int_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int_wgmma_kernel<<<grid, S8_THREADS, smem, stream>>>(ta, tb, M, N, n_slabs, per, steps, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M x N, int32) = steps * a . b with a (M x K) and b (K x N) int8,
// row-major; mode 0 multiplies as int8, mode 1 as int4 (the low four bits
// of each value). For int8, ws_a (M x k_pad) and ws_b (N x k_pad), k_pad =
// K rounded up to a multiple of 128, receive the K-major pass's output
// (null when k_pad is 0). `kind` receives the product kernel taken
// (RateKernel).
int probe_int_mma(int mode, const void* a, const void* b, int M, int K, int N, int steps,
                  void* out, void* ws_a, void* ws_b, void* stream, int* kind) {
  if (M <= 0 || N <= 0 || K < 0 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  int* po = static_cast<int*>(out);
  switch (mode) {
    case R_INT8: {
      *kind = IK_WGMMA_S8;
      const int k_pad = (K + WG_S8_BK - 1) / WG_S8_BK * WG_S8_BK;
      if ((M + S8_BM - 1) / S8_BM > 65535) return (int)cudaErrorInvalidValue;
      if (k_pad > 0 && !(ws_a && ws_b)) return (int)cudaErrorInvalidValue;
      err = kmajor_launch(false, a, K, M, ws_a, s);
      if (err == cudaSuccess) err = kmajor_launch(true, b, K, N, ws_b, s);
      if (err != cudaSuccess) return (int)err;
      return (int)launch_s8(ws_a, ws_b, M, k_pad, N, steps, po, s);
    }
    case R_S4: {
      *kind = IK_MMA_S4;
      const dim3 grid((N + BLOCK_N - 1) / BLOCK_N, (M + BLOCK_M - 1) / BLOCK_M, KSPLIT);
      if (grid.y > 65535) return (int)cudaErrorInvalidValue;
      s4_mma_kernel<<<grid, THREADS, 0, s>>>(static_cast<const int8_t*>(a),
                                             static_cast<const int8_t*>(b), M, K, N, steps, po);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
