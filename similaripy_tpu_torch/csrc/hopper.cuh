// Hopper (sm_90a) building blocks of the bf16 tensor-core products of K1/K3
// (tile_kernels.cuh: tile_wgmma_kernel), K2 and P1 (mn_products.cuh:
// mn_wgmma_block) and of the int8 products of K2 (sym_topk.cu) and of the
// probes P1 and P2 (probe_tlhs.cu, probe_int_mma.cu), in inline PTX: mbarriers, TMA tensor
// loads, the wgmma shared-memory descriptor of 128-byte-swizzled operands,
// wgmma.mma_async m64n128k16 bf16 -> f32 and m64n256k32 s8 -> s32 with
// their fence, commit and wait, the cluster pieces of the block pairs
// (rank, remote arrival, cluster barrier, TMA multicast), the host-side
// tensor-map encoding and paired launch, and the warp-specialised blocks
// (wgmma_block for bf16, wgmma_block_s8 for int8).
//
// The block (WG_THREADS = 288 threads): warps 0-3 and 4-7 are two consumer
// warpgroups, each owning a 64-row strip of the 128 x 128 output block;
// warp 8 is the producer, one thread of which issues the TMA loads of a
// ring of STAGES slabs, each 64 K rows of both operands (every half of a
// split stack), completion tracked by a `full` mbarrier per slab and the
// consumers' release by an `empty` one. The blocks run in cluster pairs,
// two column blocks of one row block, which share A (K1/K3's row panel,
// K2's anchors): TMA multicasts each of A's two 64-row boxes into both
// blocks, so a pair reads A from L2 once (on an H100 this timed faster for
// K2 and K1's 'rhs', no slower elsewhere; pairs sharing K1's D were no
// faster for bf16 and slower for 'both'). Each SM sub-partition's quarter of
// the register file holds 3 of the 9 warps, so a thread may use 168
// registers: a consumer needs 146-151 (64 f32 totals, 64 per-slab partials,
// the epilogue). A second partial, to keep one slab's wgmmas in flight while
// the other's partial is added, spilled at 168, and setmaxnreg (producer 40,
// consumers 232) did not lift the consumers' allocation past 168.
//
// Shared-memory layouts (bf16, every box 64 x 64 = 8 KB, 1024-byte aligned,
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of 128-byte row r lands at
// chunk c ^ (r % 8)):
//   K-major operand (K1/K3's A, M x K row-major): a box of 128 B of K x 64
//     rows; wgmma reads it with SBO = 1024 (8 rows), LBO unused, and the
//     k16 step t starts 32 t bytes into the rows.
//   MN-major operand (K1/K3's D, K x N row-major; K2's anchors and tile, (K,
//     tc)): a box of 64 K rows of 128 B of M or N; SBO = 1024 (8 K rows),
//     LBO = 8 KB (the next box: the next 64 of M or N), and the k16 step t
//     starts 16 t rows (2 KB t) in.
// int8 (every box 128 x 64 bytes = 8 KB, the same geometry): wgmma takes an
// 8-bit operand only K-major (PTX has no transpose for it), so both operands
// of an s8 product are K-major rows of 128 B of K (a box {128, 64} of a (K,
// rows) map), read with SBO = 1024 and LBO unused, and the k32 step t starts
// 32 t bytes into the rows: the bf16 K-major layout, byte for byte.
// tests/test_torch_wgmma_layout.py models these maps in NumPy, and
// tests/test_torch_s8_wgmma_layout.py the int8 ones.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int WG_THREADS = 288;      // two consumer warpgroups and a producer warp
constexpr int WG_CONSUMERS = 256;    // threads of the two consumer warpgroups
constexpr int WG_BK = 64;            // K rows per slab: four k16 steps
constexpr int BOX_BYTES = 64 * 64 * 2;          // one 64 x 64 bf16 box
constexpr int HALF_BYTES = 2 * BOX_BYTES;       // one operand half (hi or lo) of a slab
constexpr int RING_BYTES = 192 * 1024;          // the ring's shared memory

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the TMA unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before the first as completed: parity 1 passes). A wait
// that never ends is a broken pipeline: after 2^26 polls the kernel traps,
// so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// ---------------------------------------------------------------------------
// clusters of two blocks
// ---------------------------------------------------------------------------

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// one arrival on the barrier at the same place in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// every thread of the cluster's blocks arrives, then waits for all
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA: one box of a tensor map into shared memory, signalled on `bar`; the
// multicast form writes the box at the same place in both blocks of the
// cluster and signals each block's barrier at the same place
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

constexpr uint16_t BOTH_BLOCKS = 0b11;  // the multicast's cluster mask

__device__ __forceinline__ void tma_load_2d_both(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                 int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(BOTH_BLOCKS), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d_both(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                 int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(BOTH_BLOCKS), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d_both(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                 int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(BOTH_BLOCKS), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The descriptor of a 128-byte-swizzled operand at `p` (layout type 1 in
// bits 62-63): start address, LBO and SBO in 16-byte units; SBO is 1024
// bytes (8 rows of 128 bytes) for both majors, LBO the MN-major box stride.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo_bytes) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an asynchronous wgmma writes: an empty asm that "writes"
// each, so that the compiler reads them only after the wait before it.
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence_operand(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16) . B (16 x 128), bf16
// operands from shared memory; TRANS_A / TRANS_B are 1 for an MN-major
// operand. Fragment (lane = 4 g + tig of warp w of the warpgroup): d[4 j +
// 2 i + c] is row 16 w + 8 i + g, column 8 j + 2 tig + c.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 256, s32) = (scale_d ? d : 0) + A (64 x 32) . B (32 x 256), s8
// operands from shared memory, both K-major (8-bit wgmma has no transpose).
// The fragment is the f32 one, 32 columns of 8 wide: d[4 j + 2 i + c] is
// row 16 w + 8 i + g, column 8 j + 2 tig + c. Integer sums are exact in any
// order.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// the warp-specialised bf16 product of one 128 x 128 block
// ---------------------------------------------------------------------------

// A slab of a split mode: the halves each operand holds, its bytes (A's
// halves first, then D's, HALF_BYTES each) and the ring's depth: 6 slabs
// of 32 KB for plain bf16, 4 of 48 KB for 'rhs' / 'lhs', 3 of 64 KB for
// 'both'.
template <int SPLIT>
struct WgmmaRing {
  static constexpr int A_HALVES = split_a_lo<SPLIT>() ? 2 : 1;
  static constexpr int D_HALVES = split_b_lo<SPLIT>() ? 2 : 1;
  static constexpr int BYTES = (A_HALVES + D_HALVES) * HALF_BYTES;
  static constexpr int STAGES = RING_BYTES / BYTES;
  // the ring, its full and empty barriers, and room to align it to 1024 bytes
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * BYTES + 2 * STAGES * sizeof(uint64_t);
};

// The block's product over `n_slabs` slabs of 64 K rows, in a cluster pair
// that shares A. The producer thread calls load(s, stage, bar, rank) to
// issue slab s's boxes into `stage` (RING::BYTES, laid out as above) against
// `bar`: D's, and A's box `rank` of each half, multicast into both blocks.
// Either block's multicast writes into both, so a stage is free once the
// consumers of both blocks are done with it: each consumer warp arrives on
// its own block's `empty` barrier and on its pair's. Each consumer
// warpgroup wg multiplies its A strip (the box at A half h + wg *
// BOX_BYTES) by D's two boxes (N = 128, LBO = BOX_BYTES): every phase of
// SPLIT of the slab's four k16 steps goes into a partial that the slab's
// first wgmma zeroes (scale-d = 0), and after the slab's wgmmas complete the
// partial joins the f32 total with one rounded add per element, as
// tile_bf16_kernel does. The two warpgroups run apart, so one adds while
// the other's wgmmas run. Then epi(total, wg, warp of the warpgroup, lane)
// writes the strip. Both blocks of the pair run the whole function
// (neither returns before it), and cluster barriers after the barriers'
// set-up and at the end keep every remote arrival and multicast inside
// both blocks' lifetimes.
template <int SPLIT, bool A_MN, typename Load, typename Epi>
__device__ __forceinline__ void wgmma_block(unsigned char* smem, int n_slabs, Load load,
                                            Epi epi) {
  using R = WgmmaRing<SPLIT>;
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::BYTES);
  uint64_t* empty = full + R::STAGES;
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_CONSUMERS / 32);  // the consumer warps of both blocks
    }
    mbar_fence_init();
  }
  cluster_sync();

  if (tid >= WG_CONSUMERS) {  // the producer warp
    if (tid == WG_CONSUMERS) {
      for (int s = 0; s < n_slabs; ++s) {
        const int st = s % R::STAGES;
        mbar_wait(&empty[st], ((s / R::STAGES) & 1) ^ 1);  // the slab's last use is over
        mbar_arrive_expect_tx(&full[st], R::BYTES);
        load(s, ring + st * R::BYTES, &full[st], rank);
      }
    }
  } else {
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    float total[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = part[i] = 0.0f;
    for (int s = 0; s < n_slabs; ++s) {
      const int st = s % R::STAGES;
      mbar_wait(&full[st], (s / R::STAGES) & 1);
      const unsigned char* sa = ring + st * R::BYTES + wg * BOX_BYTES;
      const unsigned char* sd = ring + st * R::BYTES + R::A_HALVES * HALF_BYTES;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < WG_BK / 16; ++t) {
        // k16 step t: 16 t rows (MN-major, 2 KB t) or 32 t bytes (K-major) in
        const int a_off = A_MN ? t * 2048 : t * 32;
        const uint64_t ah = sw128_desc(sa + a_off, BOX_BYTES);
        const uint64_t dh = sw128_desc(sd + t * 2048, BOX_BYTES);
        wgmma_m64n128k16<A_MN, 1>(part, ah, dh, t > 0);
        if constexpr (R::A_HALVES == 2)
          wgmma_m64n128k16<A_MN, 1>(part, sw128_desc(sa + HALF_BYTES + a_off, BOX_BYTES), dh, 1);
        if constexpr (R::D_HALVES == 2)
          wgmma_m64n128k16<A_MN, 1>(part, ah, sw128_desc(sd + HALF_BYTES + t * 2048, BOX_BYTES), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operand(part);
      if (lane == 0) {
        mbar_arrive(&empty[st]);
        mbar_arrive_cluster(&empty[st], rank ^ 1);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += part[i];
    }
    epi(total, wg, warp, lane);
  }
  cluster_sync();
}

// ---------------------------------------------------------------------------
// the warp-specialised int8 product of one 128 x 256 block
// ---------------------------------------------------------------------------

constexpr int WG_S8_BK = 128;                          // K bytes per slab: four k32 steps
constexpr int WG_S8_BN = 256;                          // the block's columns (B's rows)
constexpr int WG_S8_SLAB = (2 + WG_S8_BN / 64) * BOX_BYTES;  // A's 2 boxes, then B's 4
constexpr int WG_S8_STAGES = RING_BYTES / WG_S8_SLAB;  // 4 slabs of 48 KB
constexpr size_t WG_S8_SMEM =
    1024 + (size_t)WG_S8_STAGES * WG_S8_SLAB + 2 * WG_S8_STAGES * sizeof(uint64_t);

// wgmma_block's int8 sibling, for two K-major operands (A: 128 rows, B: 256
// rows, each in 64-row boxes of 128 K bytes), in cluster pairs that share
// A, with the same producer, ring protocol and pair barriers: load(s,
// stage, bar, rank) issues slab s's boxes, A's box `rank` multicast into
// both blocks. Consumer warpgroup wg multiplies A's box wg by B's 256 rows
// (one K-major operand of 32 KB, SBO 1024) with m64n256k32: 128 int32
// totals a thread (154 registers with P1's store, 164 with K2's epilogue;
// no spill). int32 sums are exact in any
// order, so every wgmma adds straight into the total (scale-d 1 on zeroed
// registers: no per-slab partial), and a slab's wgmmas stay in flight while
// the next slab's are issued: a slab is released once the group after it
// is committed and its own has completed (wait_group 1). Then epi(total,
// wg, warp of the warpgroup, lane) writes the strip. Of 128 x 128 and 128 x
// 256 blocks, each with and without pairs, 128 x 256 in pairs timed fastest
// at K2's int8 block on an H100, and pairs were faster at both widths
// (PERF.md §6).
template <typename Load, typename Epi>
__device__ __forceinline__ void wgmma_block_s8(unsigned char* smem, int n_slabs, Load load,
                                               Epi epi) {
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_S8_STAGES * WG_S8_SLAB);
  uint64_t* empty = full + WG_S8_STAGES;
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < WG_S8_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_CONSUMERS / 32);  // the consumer warps of both blocks
    }
    mbar_fence_init();
  }
  cluster_sync();

  if (tid >= WG_CONSUMERS) {  // the producer warp
    if (tid == WG_CONSUMERS) {
      for (int s = 0; s < n_slabs; ++s) {
        const int st = s % WG_S8_STAGES;
        mbar_wait(&empty[st], ((s / WG_S8_STAGES) & 1) ^ 1);  // the slab's last use is over
        mbar_arrive_expect_tx(&full[st], WG_S8_SLAB);
        load(s, ring + st * WG_S8_SLAB, &full[st], rank);
      }
    }
  } else {
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    int total[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) total[i] = 0;
    for (int s = 0; s < n_slabs; ++s) {
      const int st = s % WG_S8_STAGES;
      mbar_wait(&full[st], (s / WG_S8_STAGES) & 1);
      const unsigned char* sa = ring + st * WG_S8_SLAB + wg * BOX_BYTES;
      const unsigned char* sb = ring + st * WG_S8_SLAB + 2 * BOX_BYTES;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < WG_S8_BK / 32; ++t)  // k32 step t: 32 t bytes into the rows
        wgmma_m64n256k32_s8(total, sw128_desc(sa + 32 * t, BOX_BYTES),
                            sw128_desc(sb + 32 * t, BOX_BYTES), 1);
      wgmma_commit();
      wgmma_wait<1>();  // slab s - 1's wgmmas are done
      if (s > 0 && lane == 0) {
        const int prev = (s - 1) % WG_S8_STAGES;
        mbar_arrive(&empty[prev]);
        mbar_arrive_cluster(&empty[prev], rank ^ 1);
      }
    }
    wgmma_wait<0>();
    wgmma_fence_operand(total);
    epi(total, wg, warp, lane);
  }
  cluster_sync();
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's driver
// entry point (no -lcuda at link time); null if the driver lacks it
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    const bool found = err == cudaSuccess && q == cudaDriverEntryPointSuccess;
    return found ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A tensor of `type` and RANK dimensions at `base` (dims innermost first, in
// elements; strides of dims 1.. in bytes), read in boxes of `box` elements
// (the innermost 128 bytes, the swizzle's width) into 128-byte-swizzled
// shared memory; elements past a dimension's end read as zeros.
template <int RANK>
inline cudaError_t sw128_tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                                    const void* base, const cuuint64_t (&dims)[RANK],
                                    const cuuint64_t (&strides)[RANK - 1],
                                    const cuuint32_t (&box)[RANK]) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  cuuint32_t unit[RANK];
  for (int i = 0; i < RANK; ++i) unit[i] = 1;
  const CUresult r = fn(map, type, RANK, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16: boxes of 64 elements innermost
template <int RANK>
inline cudaError_t bf16_tensor_map(CUtensorMap* map, const void* base,
                                   const cuuint64_t (&dims)[RANK],
                                   const cuuint64_t (&strides)[RANK - 1],
                                   const cuuint32_t (&box)[RANK]) {
  return sw128_tensor_map<RANK>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box);
}

// A K-major int8 operand, `rows` rows of k_pad bytes (k_pad a multiple of
// 16, the row stride TMA takes; rows 16-byte aligned), read in boxes of 128
// K bytes x 64 rows (bytes past k_pad and rows past the end read as zeros)
inline cudaError_t s8_kmajor_map(CUtensorMap* map, const void* base, int k_pad, int rows) {
  return sw128_tensor_map<2>(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base,
                             {(cuuint64_t)k_pad, (cuuint64_t)rows}, {(cuuint64_t)k_pad},
                             {128, 64});
}

// Launch a wgmma product kernel on `grid` in clusters of two blocks along
// y (K1/K3's column blocks) or x (K2's); that dimension must be even.
inline cudaError_t launch_pairs(const void* kern, dim3 grid, bool along_y, size_t smem,
                                cudaStream_t stream, void** args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = along_y ? 1 : 2;
  attr.val.clusterDim.y = along_y ? 2 : 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(WG_THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelExC(&config, kern, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// registers, local bytes (spills), dynamic shared bytes and resident blocks
// per SM of a product kernel launched with `threads` threads and `smem`
// bytes of dynamic shared memory
inline cudaError_t launch_attrs(const void* kern, int threads, size_t smem, int* out) {
  cudaFuncAttributes at;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, kern);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace
