// K4 of the port: copy chosen rows of a dense row-major table into a
// compact buffer, for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces similaripy_tpu/engine/gather.py::row_gather_words (kernel body
// _gather_kernel): out[i, :] = table[idx[i], :] for an (n_rows x row_bytes)
// table of any element type. The TPU kernel issues one HBM-to-HBM DMA per
// row between int32-word views of the table, with 128 in flight, because
// Mosaic cannot slice one row out of a 2-D tiled array; none of that
// applies here. On Hopper a row is a contiguous span of bytes, so one block
// copies one gathered row with 16-byte loads and stores, neighbouring
// threads on neighbouring addresses (fully coalesced), and a byte loop
// for a tail or a row whose start is not 16-byte aligned. An index outside
// [0, n_rows) yields a zero row and reads nothing.
//
// What bounds it on an H100 SXM: bytes. It reads and writes
// n * row_bytes each, at 3.35 TB/s; it does no arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) gather_kernel(
    const unsigned char* __restrict__ table, long long n_rows, long long row_bytes,
    const int* __restrict__ idx, unsigned char* __restrict__ out) {
  const long long i = blockIdx.x;
  const long long r = idx[i];
  unsigned char* dst = out + i * row_bytes;
  if (r < 0 || r >= n_rows) {
    for (long long b = threadIdx.x; b < row_bytes; b += THREADS) dst[b] = 0;
    return;
  }
  const unsigned char* src = table + r * row_bytes;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const long long n16 = row_bytes / 16;
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    uint4* d16 = reinterpret_cast<uint4*>(dst);
    for (long long v = threadIdx.x; v < n16; v += THREADS) d16[v] = __ldg(s16 + v);
    done = n16 * 16;
  }
  for (long long b = done + threadIdx.x; b < row_bytes; b += THREADS) dst[b] = src[b];
}

}  // namespace

extern "C" {

// out (n x row_bytes) = the rows idx (n, int32) of table (n_rows x row_bytes).
int gather_rows(const void* table, long long n_rows, long long row_bytes, const void* idx,
                int n, void* out, void* stream) {
  if (n < 0 || n_rows <= 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  gather_kernel<<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(table), n_rows, row_bytes,
      static_cast<const int*>(idx), static_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
