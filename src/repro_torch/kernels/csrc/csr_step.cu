// One unit's step of the CSR projection, deterministic and in place:
// acc[row] += val * R_u[col - lo] for each of the row's entries whose
// column lies in [lo, lo + width), in CSR order.
//
// Stands in for src/repro/encode/encoder.py:100 (_sparse_step), which
// JAX runs as a gather and a segment_sum outside any Pallas kernel. The
// sum order is the one XLA gives it: units in ascending order (the
// caller's loop); XLA folds acc + segment_sum(contrib) into one
// scatter-add onto acc, so within a unit each product, rounded
// (__fmul_rn), is added straight to its row of acc (__fadd_rn, never
// contracted into an FMA), the row's entries in CSR order. Duplicate
// columns of a row are added like any other entries. No float atomics:
// one warp owns one row, so the result does not depend on scheduling.
//
// The unit's bucket is selected in the scan itself: the warp reads its
// row's column ids 32 at a time, a ballot marks those in the unit, and
// the lanes consume them in lane order, so the bucket needs neither a
// sort nor any memory beyond the chunk's CSR arrays. Each lane holds 8
// of the row's k sums in registers (256 columns a pass; larger k takes
// more passes), loaded at the row's first entry in the unit; R_u's rows
// are read whole (k floats, coalesced) from L2.
//
// Bound on this card: bytes, set by the touched rows of acc (read and
// written, k floats each) with the bucket's entries and R_u; the scan
// also reads every column id of the chunk, which the bound does not
// count. A row without an entry in the unit is neither read nor written.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256, CPT = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
csr_unit_step_kernel(float* __restrict__ acc, const int64_t* __restrict__ indptr,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ data,
                     const float* __restrict__ r, int64_t n_rows, int k,
                     int lo, int width) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * THREADS) >> 5;
  for (int64_t row = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
       row < n_rows; row += n_warps) {
    const int64_t a = indptr[row], b = indptr[row + 1];
    for (int c0 = 0; c0 < k; c0 += 32 * CPT) {
      float part[CPT];
      bool any = false;
      for (int64_t base = a; base < b; base += 32) {
        const int64_t e = base + lane;
        const int lc = e < b ? indices[e] - lo : -1;
        const bool hit = (unsigned)lc < (unsigned)width;
        const float v = hit ? data[e] : 0.f;  // values of the bucket only
        unsigned hits = __ballot_sync(FULL, hit);
        if (hits && !any) {
          any = true;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int c = c0 + lane + 32 * j;
            part[j] = c < k ? acc[(size_t)row * k + c] : 0.f;
          }
        }
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const int col = __shfl_sync(FULL, lc, src);
          const float val = __shfl_sync(FULL, v, src);
          const float* rr = r + (size_t)col * k;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < k) part[j] = __fadd_rn(part[j], __fmul_rn(val, rr[c]));
          }
        }
      }
      if (!any) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < k) acc[(size_t)row * k + c] = part[j];
      }
    }
  }
}

}  // namespace

extern "C" int csr_unit_step_launch(float* acc, const int64_t* indptr,
                                    const int32_t* indices, const float* data,
                                    const float* r, int64_t n_rows, int k,
                                    int lo, int width, void* stream) {
  if (n_rows == 0 || k == 0) return 0;
  int64_t blocks = (n_rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  csr_unit_step_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      acc, indptr, indices, data, r, n_rows, k, lo, width);
  return (int)cudaGetLastError();
}
