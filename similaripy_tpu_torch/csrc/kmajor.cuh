// The K-major staging pass of the probes' int8 products (P1: probe_tlhs.cu,
// which exports it as kmajor_pass, and P2: probe_int_mma.cu), for NVIDIA
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces no TPU kernel. It exists because wgmma takes an 8-bit operand
// only K-major (PTX has no transpose for 8-bit types), while P1's operands
// a[K, M] and b[K, N] and P2's b[K, N] are row-major with K outermost. The
// pass writes x[K, R] (row-major, R contiguous) as xt[R, k_pad]: each row
// K-contiguous, K padded with zeros to k_pad, the next multiple of 128, so
// every row is 16-byte aligned for TMA and every slab of 128 K bytes is
// whole. Without the transpose (P2's a[M, K]) it only pads: x[R, K] ->
// xt[R, k_pad].
//
// What bounds it on an H100 SXM: bytes, each input byte read once and each
// output byte written once at 3.35 TB/s (at K2's int8 block, x of 200,960 x
// 4,096, 1.65 GB: 0.49 ms).
//
// One block moves a tile of 128 K x 128 rows through 16 KB of shared
// memory. Loads: thread (i, j) reads k rows 4 i .. 4 i + 3 at bytes 16 j ..
// 16 j + 15 as four 16-byte loads (each warp instruction four 128-byte row
// segments), transposes each 4 x 4 byte block in registers with byte
// permutes (transpose4x4, tensor_core.cuh) and stores the four k-contiguous
// words of rows 16 j + 4 c + jj at word i of the row; the word index is
// XORed with 4 j, so a warp's stores fall in 32 distinct banks. Stores: each
// thread reads 16-byte chunks of k (words 4 q .. 4 q + 3, at 4 (q ^ j)) and
// writes them to xt, 8 lanes a 128-byte row segment. Rows and columns at a
// ragged edge (R or K not a multiple of 16, or x not 16-byte aligned) are
// read byte by byte; past them zeros. tests/test_torch_s8_wgmma_layout.py
// models the maps in NumPy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int KT = 128;          // tile: 128 K bytes x 128 rows
constexpr int KM_THREADS = 256;  // 8 warps

// bytes c .. c + 15 of a row of C bytes as four little-endian words; zeros
// past C. V16: C is a multiple of 16 and the row 16-byte aligned, so a
// chunk lies wholly inside or wholly past the row.
template <bool V16>
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ row, int c, int C) {
  if constexpr (V16) {
    return c < C ? *reinterpret_cast<const uint4*>(row + c) : make_uint4(0, 0, 0, 0);
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (c + b < C) w[b / 4] |= (uint32_t)(uint8_t)row[c + b] << (8 * (b % 4));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool V16>
__global__ void __launch_bounds__(KM_THREADS) kmajor_transpose_kernel(
    const int8_t* __restrict__ x, int K, int R, int k_pad, int8_t* __restrict__ xt) {
  __shared__ __align__(16) uint32_t tile[KT][KT / 4];  // [row][k word ^ 4 ((row >> 4) & 7)]
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * KT, r0 = blockIdx.y * KT;
  const int i = tid >> 3, j = tid & 7;
  uint32_t w[4][4];  // [k row q][word c: bytes 16 j + 4 c .. + 3]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + 4 * i + q;
    const uint4 v = k < K ? load16<V16>(x + (size_t)k * R, r0 + 16 * j, R) : make_uint4(0, 0, 0, 0);
    w[q][0] = v.x;
    w[q][1] = v.y;
    w[q][2] = v.z;
    w[q][3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t b[4] = {w[0][c], w[1][c], w[2][c], w[3][c]};
    transpose4x4(b);  // b[jj]: k bytes 4 i .. 4 i + 3 of row 16 j + 4 c + jj
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) tile[16 * j + 4 * c + jj][i ^ (4 * j)] = b[jj];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < KT * KT / 16 / KM_THREADS; ++p) {
    const int e = tid + p * KM_THREADS, r = e >> 3, q = e & 7;
    if (r0 + r < R)
      *reinterpret_cast<uint4*>(xt + (size_t)(r0 + r) * k_pad + k0 + 16 * q) =
          *reinterpret_cast<const uint4*>(&tile[r][4 * (q ^ ((r >> 4) & 7))]);
  }
}

template <bool V16>
__global__ void __launch_bounds__(KM_THREADS) kmajor_pad_kernel(
    const int8_t* __restrict__ x, int K, int R, int k_pad, int8_t* __restrict__ xt) {
  const int k0 = blockIdx.x * KT, r0 = blockIdx.y * KT;
#pragma unroll
  for (int p = 0; p < KT * KT / 16 / KM_THREADS; ++p) {
    const int e = threadIdx.x + p * KM_THREADS, r = e >> 3, q = e & 7;
    if (r0 + r < R)
      *reinterpret_cast<uint4*>(xt + (size_t)(r0 + r) * k_pad + k0 + 16 * q) =
          load16<V16>(x + (size_t)(r0 + r) * K, k0 + 16 * q, K);
  }
}

// xt (R x k_pad, k_pad = K rounded up to a multiple of 128, 16-byte
// aligned) = x^T zero-padded, for x (K x R) row-major (trans true), or x
// zero-padded, for x (R x K) row-major (trans false). Launches nothing when
// xt is empty.
inline cudaError_t kmajor_launch(bool trans, const void* x, int K, int R, void* xt,
                                 cudaStream_t stream) {
  if (K < 0 || R < 0) return cudaErrorInvalidValue;
  const int k_pad = (K + KT - 1) / KT * KT;
  if (k_pad == 0 || R == 0) return cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(xt) & 15) != 0) return cudaErrorInvalidValue;
  const dim3 grid(k_pad / KT, (R + KT - 1) / KT);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const bool v16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (trans ? R : K) % 16 == 0;
  const int8_t* px = static_cast<const int8_t*>(x);
  int8_t* pt = static_cast<int8_t*>(xt);
  if (trans) {
    if (v16)
      kmajor_transpose_kernel<true><<<grid, KM_THREADS, 0, stream>>>(px, K, R, k_pad, pt);
    else
      kmajor_transpose_kernel<false><<<grid, KM_THREADS, 0, stream>>>(px, K, R, k_pad, pt);
  } else {
    if (v16)
      kmajor_pad_kernel<true><<<grid, KM_THREADS, 0, stream>>>(px, K, R, k_pad, pt);
    else
      kmajor_pad_kernel<false><<<grid, KM_THREADS, 0, stream>>>(px, K, R, k_pad, pt);
  }
  return cudaGetLastError();
}

}  // namespace
