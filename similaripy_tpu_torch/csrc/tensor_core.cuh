// Tensor-core and asynchronous-copy helpers for NVIDIA Hopper (sm_90a),
// shared by P1 (probe_tlhs.cu) and K2 (sym_topk.cu): shared-memory
// addresses, ldmatrix, mma.sync in bf16 and s8, the in-register 4 x 4 byte
// transpose that hands int8 (k, m) data to mma.sync as k-contiguous words,
// and 16-byte cp.async copies with their group waits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of m16n8k32 (lane = 4 g + tig): A regs 0/1 hold rows g / g + 8
// at k = 4 tig .. 4 tig + 3, regs 2/3 the same at k + 16; B regs 0/1 hold
// column g at k = 4 tig and 16 + 4 tig; C regs 0..1 row g, 2..3 row g + 8,
// columns 2 tig + {0, 1}.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// w[i] holds bytes (i, 0..3) of a 4 x 4 byte block; afterwards w[j] holds
// bytes (0..3, j): four pairs of byte permutes (PRMT). Compiled out by
// -DNO_PRMT_TRANSPOSE, which only benchmarks/tlhs_transpose_cost.py passes,
// for its own build of probe_tlhs.cu and sym_topk.cu (wrong products, the
// same loads and stores: the control that times the pass).
__device__ __forceinline__ void transpose4x4(uint32_t (&w)[4]) {
#ifndef NO_PRMT_TRANSPOSE
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);  // (0,0) (1,0) (0,1) (1,1)
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);  // (0,2) (1,2) (0,3) (1,3)
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140);  // (2,0) (3,0) (2,1) (3,1)
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);  // (2,2) (3,2) (2,3) (3,3)
  w[0] = __byte_perm(x0, y0, 0x5410);
  w[1] = __byte_perm(x0, y0, 0x7632);
  w[2] = __byte_perm(x1, y1, 0x5410);
  w[3] = __byte_perm(x1, y1, 0x7632);
#endif
}

// 16 bytes from global to shared memory, asynchronously (L2 only, as the
// operands are streamed once per block); with `full` false the 16 bytes
// are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
