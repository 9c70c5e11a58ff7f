// K1 of the port: one fused similarity tile with the exact per-row top-k,
// for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces similaripy_tpu/engine/pallas_kernels.py::fused_tile_topk (kernel
// body _kernel, shared epilogue _epilogue_val), split_f32 included. For one
// row panel A (trp x K) against one column tile D (K x tc) it computes
//     xy  = A . D             f32: true f32 FMA (no TF32 anywhere)
//                             bf16: bf16 operands, f32 accumulation
//                             split 'both' / 'rhs' / 'lhs': bf16 [hi; lo]
//                               stacks of f32 data (split_bf16x3), summed
//                               over 3 or 2 bf16 phases in f32 (XLA HIGH)
//                             int8: exact int32 accumulation, then * inv_scale
//     val = S-Plus epilogue(xy) with the allowed / filter / target masks,
//           -inf where a cell is no candidate or falls below the threshold
//     out = exact top-k_pad of each row, ids col_base + col, sorted
//           descending; with a carry, the tile's survivors (val > carry kth)
//           merged with the carried top-k_pad.
// Ties follow the TPU kernel (pallas_kernels.py:323-374): the lowest column
// first inside a tile, and tile entries before carry entries.
//
// What bounds it on an H100 SXM: the product. At the main path's shapes
// (trp = 1,024, K ~ 200,960) it does ~400 operations per byte of A and D,
// so it is bound by operations: 67 TFLOP/s of f32 FMA outside the tensor
// cores for f32, 989 TFLOP/s of bf16 on the tensor cores for bf16 (a third
// or half of that for the 3- or 2-phase split modes), 1,979 TOP/s of int8
// on the tensor cores. The D tile streams from device memory at 3.35 TB/s.
//
// Two launches, both in tile_kernels.cuh, shared with K3 (panel_topk.cu):
//   1. the product with the epilogue and masks fused: bf16 and the split
//      modes on the tensor cores by wgmma, fed by TMA into a warp-specialised
//      block (tile_wgmma_kernel, 128 x 128 blocks, every phase of a split
//      mode of a slab into one partial; narrow-copy bf16 by mma.sync m16n8k16,
//      tile_bf16_kernel); int8 on the tensor cores (mma.sync m16n8k32 s8,
//      128 x 256 blocks) and f32 on SIMT FMA (128 x 128 blocks, one in-order
//      fmaf chain per output), both fed by a cp.async ring; the score (or
//      -inf) goes to a (trp x tc) f32 scratch that the wrapper allocates.
//   2. topk_kernel: one block per row. It keeps the scores above the carry's
//      kth, sorts them in shared memory and merges them with the carry.
//
// The epilogue and the sort keys live in splus_epilogue.cuh, shared with K2.

#include "tile_kernels.cuh"

extern "C" {

// Launch 1: scores (M x N f32) = masked S-Plus epilogue of a (M x K) . d (K x N).
// mode 0 = f32, 1 = bf16, 2 = int8; 3 / 4 / 5 = split 'both' / 'rhs' / 'lhs'
// (bf16 stacks: a (M x 2K) for 'both' and 'lhs', d (2K x N) for 'both' and
// 'rhs'; K is one half's depth); the mask pointers may be null. `kind`
// receives the product kernel taken (ProductKernel in splus_epilogue.cuh).
int tile_product(int mode, const void* a, const void* d, int M, int K, int N,
                 const void* xt, const void* xc, const void* xd, const void* yt,
                 const void* yc, const void* yd, const void* pvec,
                 const void* allowed, const void* fmask, const void* tmask,
                 int flags, void* scores, void* stream, int* kind) {
  return (int)product_any<false>(mode, a, d, nullptr, M, K, N, xt, xc, xd, yt, yc, yd, pvec,
                                 allowed, fmask, tmask, flags, scores,
                                 static_cast<cudaStream_t>(stream), kind);
}

// Launch 2: the per-row top-k_pad of the scores, merged with the carry
// (cv, ci: k_pad x M) when cv is not null. Outputs ov, oi: k_pad x M.
int tile_topk_rows(const void* scores, int M, int N, int k_pad, const void* pvec,
                   const void* cv, const void* ci, void* ov, void* oi, void* stream) {
  return (int)topk_any(scores, M, N, N, 1, k_pad, pvec, cv, ci, ov, oi,
                       static_cast<cudaStream_t>(stream));
}

int panel_product_attrs(int mode, int* out);  // panel_topk.cu: the BIAS kernels

// The product kernel of `mode` (with the bias: K3's) for 16-byte aligned
// operands: out[0] registers a thread, out[1] local memory bytes a thread
// (spills), out[2] shared memory bytes a block, out[3] resident blocks per
// SM, out[4] the kernel (ProductKernel).
int tile_product_attrs(int mode, int bias, int* out) {
  if (bias) return panel_product_attrs(mode, out);
  return (int)product_attrs<false>(mode, out);
}

const char* tile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
