// K3 of the port: the union-compacted panel, fused with the S-Plus epilogue
// and a per-(row, tile) exact top-k, for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces similaripy_tpu/engine/pallas_kernels.py::fused_panel_topk (kernel
// body _panel_kernel, shared epilogue _epilogue_val). For one panel of
// TM = 256 target rows, its compact lhs A (TM x K) and the gathered cold
// rows D (K x cg) of a column group, it computes
//     xy  = bias + A . D      bias: the hot-prefix partial scores, f32, or
//                             int32 in int8 mode (int8 stays exact until the
//                             single inverse-scale multiply)
//     val = S-Plus epilogue(xy) with the allowed / filter / target masks
//     out = for each tile t of tc columns: the exact top-k_pad of each row,
//           ids pvec[10] + t*tc + col, sorted descending, no carry; into
//           (n_tiles, k_pad, TM) values and ids.
// Ties go to the lowest column, as the TPU kernel's argmax extraction
// (pallas_kernels.py:452-463). The executor merges the tiles' candidates
// with its running top-k outside the kernel (compact.py:358-363).
//
// What bounds it on an H100 SXM: the product. A panel of the main path
// (TM = 256, K = 8,448-33,024 cold rows, cg ~ 43,000-86,000 columns) does
// 2*TM*K*cg operations on (TM + cg)*K operand values, ~2*TM = 512 a value:
// ~128 a byte for f32, above the 20 at which the 67 TFLOP/s of f32 FMA
// outside the tensor cores meet the 3.35 TB/s of device memory, so bound by
// operations; ~512 a byte for int8, below the tensor cores' 591 (1,979
// TOP/s), so bound by bytes: D's K x cg streaming once from device memory.
//
// The TPU kernel walks a (tile, K block) grid with a (TM x tc) accumulator
// in VMEM. On Hopper the design is K1's (tile_kernels.cuh): one product over
// the whole (TM x cg) group, its sum joined by the bias before the fused
// epilogue, into a (TM x cg) f32 score scratch, then one block per (row,
// tile) that sorts the tile's survivors. The product streams A and D
// through a 3-slab cp.async ring: int8 on the tensor cores (mma.sync
// m16n8k32 s8, 128 x 256 blocks, exact int32 sums with the int32 bias),
// f32 on SIMT FMA (128 x 128 blocks); bf16 runs on the tensor cores by
// wgmma, its operands brought by TMA (tile_wgmma_kernel with the bias, its
// rows x columns of the bias added to the f32 total before the epilogue),
// the narrow-copy shapes by mma.sync. The TM = 256 rows are two
// row blocks, and the grid runs the two of each column block side by side,
// so the second reads D from L2 and D streams from device memory once.

#include "tile_kernels.cuh"

extern "C" {

// K1's product launch (tile_topk.cu): the same kernel without a bias.
int tile_product(int mode, const void* a, const void* d, int M, int K, int N,
                 const void* xt, const void* xc, const void* xd, const void* yt,
                 const void* yc, const void* yd, const void* pvec,
                 const void* allowed, const void* fmask, const void* tmask,
                 int flags, void* scores, void* stream, int* kind);

// Launch 1: scores (M x N f32) = masked S-Plus epilogue of bias + a (M x K) .
// d (K x N). mode 0 = f32, 1 = bf16, 2 = int8 (bias int32); bias and the
// mask pointers may be null.
int panel_product(int mode, const void* a, const void* d, const void* bias, int M,
                  int K, int N, const void* xt, const void* xc, const void* xd,
                  const void* yt, const void* yc, const void* yd, const void* pvec,
                  const void* allowed, const void* fmask, const void* tmask,
                  int flags, void* scores, void* stream, int* kind) {
  if (!bias)
    return tile_product(mode, a, d, M, K, N, xt, xc, xd, yt, yc, yd, pvec, allowed, fmask,
                        tmask, flags, scores, stream, kind);
  return (int)product_any<true>(mode, a, d, bias, M, K, N, xt, xc, xd, yt, yc, yd, pvec,
                                allowed, fmask, tmask, flags, scores,
                                static_cast<cudaStream_t>(stream), kind);
}

// K3's product kernel of `mode`, as tile_product_attrs (tile_topk.cu) reports it.
int panel_product_attrs(int mode, int* out) { return (int)product_attrs<true>(mode, out); }

// Launch 2: the top-k_pad of each (row, tile) of the (M x tiles*tc) scores,
// no carry. Outputs ov, oi: tiles x k_pad x M.
int panel_topk_rows(const void* scores, int M, int tc, int tiles, int k_pad,
                    const void* pvec, void* ov, void* oi, void* stream) {
  return (int)topk_any(scores, M, tc, tc * tiles, tiles, k_pad, pvec, nullptr, nullptr,
                       ov, oi, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
