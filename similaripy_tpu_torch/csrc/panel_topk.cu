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
// (TM = 256, K = 8,448-33,024 cold rows, cg ~ 42,000 columns) does 2*TM*K*cg
// operations on (TM + cg)*K operand values, ~200 operations a byte, so it is
// bound by operations: 67 TFLOP/s of f32 FMA outside the tensor cores,
// 1,979 TOP/s of int8 on them.
//
// The TPU kernel walks a (tile, K block) grid with a (TM x tc) accumulator
// in VMEM. On Hopper the design is K1's (tile_kernels.cuh): a tiled SIMT
// product over the whole (TM x cg) group, its accumulator started from the
// bias, with the epilogue fused into a (TM x cg) f32 score scratch, then one
// block per (row, tile) that sorts the tile's survivors. Given away, as in
// K1: tensor cores, asynchronous loads, and scores kept on chip.

#include "tile_kernels.cuh"

extern "C" {

// K1's product launch (tile_topk.cu): the same kernel without a bias.
int tile_product(int mode, const void* a, const void* d, int M, int K, int N,
                 const void* xt, const void* xc, const void* xd, const void* yt,
                 const void* yc, const void* yd, const void* pvec,
                 const void* allowed, const void* fmask, const void* tmask,
                 int flags, void* scores, void* stream);

// Launch 1: scores (M x N f32) = masked S-Plus epilogue of bias + a (M x K) .
// d (K x N). mode 0 = f32, 1 = bf16, 2 = int8 (bias int32); bias and the
// mask pointers may be null.
int panel_product(int mode, const void* a, const void* d, const void* bias, int M,
                  int K, int N, const void* xt, const void* xc, const void* xd,
                  const void* yt, const void* yc, const void* yd, const void* pvec,
                  const void* allowed, const void* fmask, const void* tmask,
                  int flags, void* scores, void* stream) {
  if (!bias)
    return tile_product(mode, a, d, M, K, N, xt, xc, xd, yt, yc, yd, pvec, allowed, fmask,
                        tmask, flags, scores, stream);
  return (int)product_any<true>(mode, a, d, bias, M, K, N, xt, xc, xd, yt, yc, yd, pvec,
                                allowed, fmask, tmask, flags, scores,
                                static_cast<cudaStream_t>(stream));
}

// Launch 2: the top-k_pad of each (row, tile) of the (M x tiles*tc) scores,
// no carry. Outputs ov, oi: tiles x k_pad x M.
int panel_topk_rows(const void* scores, int M, int tc, int tiles, int k_pad,
                    const void* pvec, void* ov, void* oi, void* stream) {
  return (int)topk_any(scores, M, tc, tc * tiles, tiles, k_pad, pvec, nullptr, nullptr,
                       ov, oi, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
