// Tensor-core and asynchronous-copy helpers for NVIDIA Hopper (sm_90a),
// shared by P1 (probe_tlhs.cu), K2 (sym_topk.cu) and K1/K3's product
// (tile_kernels.cuh): shared-memory addresses, ldmatrix (plain and
// transposing), mma.sync in bf16 and s8, the in-register 4 x 4 byte
// transpose that hands int8 (k, m) data to mma.sync as k-contiguous words,
// 16- and 4-byte cp.async copies with their group waits, the split-bf16x3
// modes' halves (which the wgmma products of hopper.cuh read), and the
// pieces of the mma.sync bf16 product of K1's narrow copies: the swizzle of
// a 128-column bf16 slab and its B fragment reads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 matrices of 16-bit words (8 rows of 16 bytes each), lanes
// 8 i .. 8 i + 7 giving the row addresses of matrix i; lane 4 g + t receives
// word t of row g of matrix i in register i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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
// bytes (0..3, j): four pairs of byte permutes (PRMT).
__device__ __forceinline__ void transpose4x4(uint32_t (&w)[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);  // (0,0) (1,0) (0,1) (1,1)
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);  // (0,2) (1,2) (0,3) (1,3)
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140);  // (2,0) (3,0) (2,1) (3,1)
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);  // (2,2) (3,2) (2,3) (3,3)
  w[0] = __byte_perm(x0, y0, 0x5410);
  w[1] = __byte_perm(x0, y0, 0x7632);
  w[2] = __byte_perm(x1, y1, 0x5410);
  w[3] = __byte_perm(x1, y1, 0x7632);
}

// 16 bytes from global to shared memory, asynchronously (L2 only, as the
// operands are streamed once per block); with `full` false the 16 bytes
// are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, asynchronously (through L1: cp.async
// copies below 16 bytes take .ca only); with `full` false zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
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

// ---------------------------------------------------------------------------
// the split-bf16x3 modes, and the mma.sync bf16 product of K1 and K3's
// narrow copies
// ---------------------------------------------------------------------------

// Which halves of the [hi; lo] stacks (similaripy_tpu/engine/pallas_kernels.py
// ::split_bf16x3) a product reads, and its phases, in the order of the JAX
// kernel's K sweep (_split_maps): NONE a . d (plain bf16); BOTH hi.hi +
// lo.hi + hi.lo (lo.lo dropped); RHS a . d_hi + a . d_lo; LHS a_hi . d +
// a_lo . d.
enum Split { SPLIT_NONE = 0, SPLIT_BOTH = 1, SPLIT_RHS = 2, SPLIT_LHS = 3 };

template <int SPLIT>
__host__ __device__ constexpr bool split_a_lo() { return SPLIT == SPLIT_BOTH || SPLIT == SPLIT_LHS; }

template <int SPLIT>
__host__ __device__ constexpr bool split_b_lo() { return SPLIT == SPLIT_BOTH || SPLIT == SPLIT_RHS; }

// Byte offset of 16-byte chunk `ch` of row `r` of a slab of 128 bf16
// columns (256-byte rows): the chunk's low 3 bits are XORed with the row's,
// so the 8 rows of one ldmatrix matrix fall in 8 distinct chunks, 32 banks.
__device__ __forceinline__ int kn_swz(int r, int ch) { return r * 256 + ((ch ^ (r & 7)) << 4); }

// m16n8k16 B fragments (.col: b[0] holds k 2 tig, 2 tig + 1 of column g,
// b[1] the same at k + 8) of n-tiles n / 8 and n / 8 + 1, k16 step ks, from
// a (k, n) slab: ldmatrix .trans of (k 0-7 | 8-15) x (n 0-7 | 8-15)
__device__ __forceinline__ void ldsm_b_pair(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                            const unsigned char* s, int ks, int n, int lane) {
  uint32_t r[4];
  ldmatrix_x4_trans(r, s + kn_swz(ks + (lane & 7) + ((lane >> 3) & 1) * 8, (n >> 3) + (lane >> 4)));
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}
