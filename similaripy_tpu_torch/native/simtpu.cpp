// Native host-side assembly kernels of similaripy_tpu_torch.
//
// A copy of similaripy_tpu/native/simtpu.cpp. The card computes the
// similarities; the host turns the executor's (T, k) top-K buffers into
// SciPy's sparse formats with these two kernels:
//   - coo_to_csr: counting-sort CSR assembly, O(nnz + n_rows), duplicates
//     preserved, stable within a row (reference: cython_code/coo_to_csr.h:28-71),
//     in int32 and int64 index variants.
//   - topk_to_coo: fused -inf/NaN filtering + triple extraction from the
//     executor's (T, k) value/index panels.
//
// Built as a plain shared library (no Python.h) by native/__init__.py and
// loaded with ctypes.

#include <cstdint>
#include <cmath>
#include <cstring>

template <typename Index>
static void coo_to_csr_impl(Index n_rows, int64_t nnz, const Index* rows,
                            const Index* cols, const float* vals,
                            Index* indptr, Index* indices, float* data) {
  // pass 1: row counts
  for (Index i = 0; i <= n_rows; ++i) indptr[i] = 0;
  for (int64_t j = 0; j < nnz; ++j) indptr[rows[j] + 1] += 1;
  // exclusive prefix sum
  for (Index i = 0; i < n_rows; ++i) indptr[i + 1] += indptr[i];
  // pass 2: stable placement using a moving cursor per row
  // (cursor starts at indptr[r]; restore indptr afterwards by shifting)
  for (int64_t j = 0; j < nnz; ++j) {
    const Index r = rows[j];
    const Index dst = indptr[r];
    indices[dst] = cols[j];
    data[dst] = vals[j];
    indptr[r] += 1;
  }
  // indptr now shifted left by one row; shift back
  for (Index i = n_rows; i > 0; --i) indptr[i] = indptr[i - 1];
  indptr[0] = 0;
}

extern "C" {

void coo_to_csr32(int32_t n_rows, int64_t nnz, const int32_t* rows,
                  const int32_t* cols, const float* vals, int32_t* indptr,
                  int32_t* indices, float* data) {
  coo_to_csr_impl<int32_t>(n_rows, nnz, rows, cols, vals, indptr, indices, data);
}

void coo_to_csr64(int64_t n_rows, int64_t nnz, const int64_t* rows,
                  const int64_t* cols, const float* vals, int64_t* indptr,
                  int64_t* indices, float* data) {
  coo_to_csr_impl<int64_t>(n_rows, nnz, rows, cols, vals, indptr, indices, data);
}

// Compact the executor's (T, k) top-K panels into COO triples, dropping
// -inf (empty slot) and NaN entries. Returns the number of triples written.
// targets maps panel row -> output row id. int32 ids suffice: inputs are
// int32 by construction (the engine's device ids are int32).
int64_t topk_to_coo(int64_t n_rows_panel, int64_t k, const float* vals,
                    const int32_t* idx, const int32_t* targets,
                    int32_t* out_rows, int32_t* out_cols, float* out_vals) {
  int64_t w = 0;
  for (int64_t i = 0; i < n_rows_panel; ++i) {
    const int32_t row = targets[i];
    const float* v = vals + i * k;
    const int32_t* c = idx + i * k;
    for (int64_t j = 0; j < k; ++j) {
      const float x = v[j];
      if (x > -INFINITY) {  // false for -inf and NaN (assembly.py semantics)
        out_rows[w] = row;
        out_cols[w] = c[j];
        out_vals[w] = x;
        ++w;
      }
    }
  }
  return w;
}

}  // extern "C"
