// K5 of the port: per-tile COO into dense (u_pad x tc) tiles, for NVIDIA
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces similaripy_tpu/engine/pallas_kernels.py::mxu_scatter (kernel
// body _mxu_scatter_kernel). The TPU kernel builds a tile as one-hot
// matmuls over (512 user x 512 slot) bins of host-binned COO, because a
// scatter is slow there; it computes a scatter-add into a dense tile. This
// kernel does that directly: G tiles' padded COO (ru user, sl slot, vv
// value, each G x p2) land in a (G, u_pad, tc) stack of f32, bf16 or int8.
// Entries with a user outside [0, u_pad) are the padding sentinels and land
// nowhere (slots outside [0, tc) are dropped the same way). The wrapper
// (engine/scatter.py) also launches it with the roles of user and slot
// swapped, which writes (G, tc, u_pad) K-major tiles for K2's int8 product.
//
// Duplicates: the port's CSR coercion (ops/csr.py::ensure_csr_f32) keeps
// duplicate entries as SciPy holds them and does not sum them, so a tile may
// hold a (user, slot) pair twice. Every entry is therefore added, not
// stored: f32 and bf16 with atomicAdd in the tile's own type, int8 with a
// compare-and-swap on the enclosing 32-bit word (two's complement wrap, as
// PyTorch's int8 addition). A unique entry lands exactly (0 + v == v), so
// the tile is bit-identical to the plain index_put_ version; duplicates of
// f32 or bf16 may round in another order (one rounding of the tile's type
// per extra duplicate); int8 stays exact.
//
// The kernel zero-fills its target itself (launch 1, 16-byte stores), so
// the wrapper allocates with torch.empty. The fill is most of the bytes:
// what bounds it on an H100 is the memory rate (3.35 TB/s) for the tile
// written plus the COO read, 12 bytes an entry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

enum Mode { MODE_F32 = 0, MODE_BF16 = 1, MODE_INT8 = 2 };

__global__ void __launch_bounds__(THREADS) zero_kernel(uint4* __restrict__ out16,
                                                      size_t n16,
                                                      unsigned char* __restrict__ tail,
                                                      size_t n_tail) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t i = first; i < n16; i += stride) out16[i] = make_uint4(0, 0, 0, 0);
  for (size_t i = first; i < n_tail; i += stride) tail[i] = 0;
}

__device__ __forceinline__ void add_int8(int8_t* p, int v) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  unsigned int* word = reinterpret_cast<unsigned int*>(addr & ~(uintptr_t)3);
  const unsigned shift = (unsigned)(addr & 3) * 8;
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    const unsigned b = ((assumed >> shift) + (unsigned)v) & 0xFFu;
    old = atomicCAS(word, assumed, (assumed & ~(0xFFu << shift)) | (b << shift));
  } while (old != assumed);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) scatter_kernel(
    const int* __restrict__ ru, const int* __restrict__ sl,
    const float* __restrict__ vv, size_t n, int p2, int u_pad, int tc,
    void* __restrict__ out) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int u = ru[i], s = sl[i];
    if (u < 0 || u >= u_pad || s < 0 || s >= tc) continue;
    const size_t g = i / (size_t)p2;
    const size_t cell = (g * (size_t)u_pad + (size_t)u) * (size_t)tc + (size_t)s;
    if constexpr (MODE == MODE_F32) {
      atomicAdd(static_cast<float*>(out) + cell, vv[i]);
    } else if constexpr (MODE == MODE_BF16) {
      atomicAdd(static_cast<__nv_bfloat16*>(out) + cell, __float2bfloat16_rn(vv[i]));
    } else {
      // the values are the quantized integers, exact in f32
      add_int8(static_cast<int8_t*>(out) + cell, (int)vv[i]);
    }
  }
}

int grid_for(size_t n) {
  const size_t blocks = (n + THREADS - 1) / THREADS;
  const size_t cap = 132 * 32;  // a few waves on an H100's 132 SMs
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// Densify G tiles: ru, sl (int32) and vv (f32), each G x p2, into out
// (G x u_pad x tc) of mode 0 = f32, 1 = bf16, 2 = int8. Two launches: the
// zero fill, then one thread per COO entry.
int densify_tiles(int mode, const void* ru, const void* sl, const void* vv, int G,
                  int p2, int u_pad, int tc, void* out, void* stream) {
  if (G <= 0 || p2 < 0 || u_pad <= 0 || tc <= 0) return (int)cudaErrorInvalidValue;
  const size_t item = mode == MODE_F32 ? 4 : (mode == MODE_BF16 ? 2 : 1);
  if (mode < MODE_F32 || mode > MODE_INT8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)G * u_pad * tc * item;
  const size_t n16 = bytes / 16;
  unsigned char* base = static_cast<unsigned char*>(out);
  zero_kernel<<<grid_for(n16), THREADS, 0, s>>>(reinterpret_cast<uint4*>(base), n16,
                                                base + n16 * 16, bytes - n16 * 16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)G * p2;
  if (n == 0) return 0;
  const int* r = static_cast<const int*>(ru);
  const int* c = static_cast<const int*>(sl);
  const float* v = static_cast<const float*>(vv);
  switch (mode) {
    case MODE_F32:
      scatter_kernel<MODE_F32><<<grid_for(n), THREADS, 0, s>>>(r, c, v, n, p2, u_pad, tc, out);
      break;
    case MODE_BF16:
      scatter_kernel<MODE_BF16><<<grid_for(n), THREADS, 0, s>>>(r, c, v, n, p2, u_pad, tc, out);
      break;
    default:
      scatter_kernel<MODE_INT8><<<grid_for(n), THREADS, 0, s>>>(r, c, v, n, p2, u_pad, tc, out);
      break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
