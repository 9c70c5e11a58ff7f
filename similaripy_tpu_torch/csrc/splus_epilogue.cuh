// Pieces shared by K1 and K3 (tile_kernels.cuh) and K2 (sym_topk.cu): the
// operand modes, the S-Plus epilogue, and the 64-bit sort keys of the exact
// top-k.
//
// The epilogue is the one of similaripy_tpu/engine/pallas_kernels.py::
// _epilogue_val, term by term in the same order, with explicitly rounded
// operations (__fmul_rn, __fadd_rn, __fdiv_rn) so that nvcc never contracts
// a multiply and an add into an FMA: the plain PyTorch version rounds each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the product's operand modes; the split modes take bf16 [hi; lo] stacks
// (tensor_core.cuh: Split)
enum Mode {
  MODE_F32 = 0, MODE_BF16 = 1, MODE_INT8 = 2,
  MODE_SPLIT_BOTH = 3, MODE_SPLIT_RHS = 4, MODE_SPLIT_LHS = 5
};

// the product kernels a launch may take, as the launch wrappers count them
// (engine/tile_topk.py: PRODUCT_KERNELS)
enum ProductKernel {
  PK_SIMT = 0, PK_MMA_S8 = 1, PK_MMA_BF16 = 2, PK_WGMMA_BF16 = 3, PK_WGMMA_S8 = 4
};

// epilogue flags, the order of SPlusParams.static_flags()
enum Flag {
  F_L1 = 1, F_L2 = 2, F_L3 = 4, F_POW = 8, F_BAYES = 16, F_DENOM = 32
};

// The S-Plus value of one cell: x* are the target's normalization values,
// y* the candidate's; p is the parameter vector (a1 l1 l2 l3 t1 t2 stab
// bayes threshold inv_scale ...).
static __device__ __forceinline__ float splus_val(float xy, int flags, const float* p,
                                                  float xt, float xc, float xd,
                                                  float yt, float yc, float yd) {
  if (!(flags & F_DENOM)) return xy;  // raw, un-powered product
  const float xy_p = (flags & F_POW) ? powf(xy, p[0]) : xy;
  float denom = p[6];
  if (flags & F_L1) {
    const float t = __fadd_rn(__fadd_rn(__fmul_rn(p[4], __fsub_rn(xt, xy)),
                                        __fmul_rn(p[5], __fsub_rn(yt, xy))),
                              xy);
    denom = __fadd_rn(denom, __fmul_rn(p[1], t));
  }
  if (flags & F_L2) denom = __fadd_rn(denom, __fmul_rn(p[2], __fmul_rn(xc, yc)));
  if (flags & F_L3) denom = __fadd_rn(denom, __fmul_rn(p[3], __fmul_rn(xd, yd)));
  float val = denom != 0.0f ? __fdiv_rn(xy_p, denom) : 0.0f;
  if (flags & F_BAYES) val = __fmul_rn(val, __fdiv_rn(xy_p, __fadd_rn(xy_p, p[7])));
  return val;
}

// 64-bit sort key: order-preserving bits of the value above the inverted
// position, so a descending sort puts larger values first and, among equal
// values, the lowest position first. -0.0 is folded into +0.0 (they are
// equal).
static __device__ __forceinline__ unsigned long long make_key(float v, int pos) {
  unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned)pos);
}

static __device__ __forceinline__ float key_val(unsigned long long key) {
  unsigned u = (unsigned)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

static __device__ __forceinline__ int key_col(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}
