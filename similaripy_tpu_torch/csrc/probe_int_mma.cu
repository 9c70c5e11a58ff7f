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
// the tensor cores; the data sheet lists no int4 rate, and wgmma has no s4
// type. mma.sync does have s4 shapes (m16n8k64), and whether they build for
// sm_90a and how fast they run is what this probe measures.
//
// Translation. The TPU kernel keeps both blocks in VMEM under constant
// index maps, so its DMA is negligible and it measures the matrix unit.
// Here the register file plays that part: each warp loads its operand
// fragments for one K chunk once (straight from global memory; A is
// row-major (M, K) and so already k-contiguous, B is row-major (K, N) and
// is gathered down its columns) and then issues the chunk's mma.sync
// instructions `steps` times before it moves to the next chunk. The sums
// are the TPU kernel's in another order, exact in int32. A warp owns a
// 32 x 32 output block (2 m16 x 4 n8 tiles, eight independent
// accumulators); a block is 2 x 2 warps; K is split over KSPLIT blocks,
// whose partial sums meet in the output with atomic adds, so that the grid
// (512 blocks at the probe's shape) fills all 132 SMs. The C entry zeroes
// the output first.
//   int8  mma.sync m16n8k32 s8 x s8 -> s32.
//   s4    the int8 values are packed to signed nibbles in registers (their
//         low four bits, as an int4 cast keeps them) and multiplied with
//         mma.sync m16n8k64 s4 x s4 -> s32.
// Any M, N and K: fragments are zero-filled past the edges and the atomic
// adds are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum RateMode { R_INT8 = 0, R_S4 = 1 };

constexpr int THREADS = 128;  // 4 warps, 2 (m) x 2 (n)
constexpr int WARP_M = 32, WARP_N = 32;
constexpr int BLOCK_M = 2 * WARP_M, BLOCK_N = 2 * WARP_N;
constexpr int KSPLIT = 8;

__device__ __forceinline__ int at(const int8_t* __restrict__ p, size_t stride_r, int r, int c,
                                  int R, int C) {
  return (r < R && c < C) ? (int)p[(size_t)r * stride_r + c] : 0;
}

// `n` consecutive values packed into one 32-bit register, lowest first:
// bytes for int8 (n = 4), nibbles for s4 (n = 8). Element j is at row
// r0 + j * dr, column c0 + j * dc of a row-major (R x C) matrix.
template <int MODE>
__device__ __forceinline__ uint32_t pack(const int8_t* __restrict__ p, int R, int C, int r0,
                                         int c0, int dr, int dc) {
  constexpr int n = MODE == R_S4 ? 8 : 4;
  constexpr int bits = 32 / n;
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const uint32_t v = (uint32_t)at(p, C, r0 + j * dr, c0 + j * dc, R, C);
    w |= (v & ((1u << bits) - 1)) << (bits * j);
  }
  return w;
}

template <int MODE>
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  if constexpr (MODE == R_S4) {
    asm volatile(
        "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) int_mma_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b, int M, int K, int N,
    int steps, int* __restrict__ out) {
  // one mma's depth, and the k offset of a register's first value: a
  // register holds 4 (int8) or 8 (s4) consecutive k, lanes tig = 0..3 take
  // consecutive groups, registers 2/3 (A) and 1 (B) the second half
  constexpr int KC = MODE == R_S4 ? 64 : 32;
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
      af[mi][0] = pack<MODE>(a, M, K, r, k0, 0, 1);
      af[mi][1] = pack<MODE>(a, M, K, r + 8, k0, 0, 1);
      af[mi][2] = pack<MODE>(a, M, K, r, k0 + KC / 2, 0, 1);
      af[mi][3] = pack<MODE>(a, M, K, r + 8, k0 + KC / 2, 0, 1);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = c0 + ni * 8 + g;
      bf[ni][0] = pack<MODE>(b, K, N, k0, c, 1, 0);
      bf[ni][1] = pack<MODE>(b, K, N, k0 + KC / 2, c, 1, 0);
    }
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma<MODE>(acc[mi][ni], af[mi], bf[ni]);
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

}  // namespace

extern "C" {

// out (M x N, int32) = steps * a . b with a (M x K) and b (K x N) int8,
// row-major; mode 0 multiplies as int8, mode 1 as int4 (the low four bits
// of each value).
int probe_int_mma(int mode, const void* a, const void* b, int M, int K, int N, int steps,
                  void* out, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BLOCK_N - 1) / BLOCK_N, (M + BLOCK_M - 1) / BLOCK_M, KSPLIT);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int* po = static_cast<int*>(out);
  switch (mode) {
    case R_INT8:
      int_mma_kernel<R_INT8><<<grid, THREADS, 0, s>>>(pa, pb, M, K, N, steps, po);
      break;
    case R_S4:
      int_mma_kernel<R_S4><<<grid, THREADS, 0, s>>>(pa, pb, M, K, N, steps, po);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
