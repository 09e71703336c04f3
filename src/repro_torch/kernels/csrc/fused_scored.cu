// Scored exact search: the top_k by LUT score over the stable top-m by
// collision count, in one call.
//
// Replaces src/repro/kernels/fused_scored.py::fused_scored_topk_pallas:
// query words [Q, W], query tables [Q, F*P] (float32, bf16, or int8 with
// float32 scales [Q, W]) and corpus words [N, W] -> (scores float32, ids
// int32) [Q, top_k]. Survivors are the exact stable top-m by count
// (ties to the lowest id); the result is their top_k by (score desc, id
// asc), with (-inf, -1) past the last survivor.
//
// Bound on this card: operations, the same popcount rate as
// packed_topk.cu. Every (query, row, word) needs one popcount to count
// collisions (Q*N*W = 1.7e10 at the main path), against N*W*4 bytes of
// corpus; the scoring touches m rows a query and is negligible.
//
// Design. The TPU kernel sweeps the corpus twice in grid order: an
// exceedance histogram of counts, inverted into a threshold and a tie
// quota, then a second sweep that admits rows by that rule, counting
// ties in id order through a counter carried across grid steps. That
// order does not exist across the blocks of a GPU, and the rule
// describes no more than the stable top-m by count. So this kernel runs
// one sweep, packed_topk.cu's partial kernel with m in place of top_k:
// per query, the stable top-m of each of S contiguous corpus ranges
// (rows walked in rising id order; a row enters only if it strictly
// beats the list's last entry). A second kernel gives each query one
// block: warp 0 merges the S lists in range order under the same rule,
// which yields exactly the survivor set; meanwhile the block loads the
// query's table into shared memory when it fits (4 KB at the main path).
// Each thread then LUT-scores survivors (lut_common.cuh, the reference's
// accumulation order) and the block selects the top_k by (score, -id).
// The [Q, N] count matrix never reaches device memory. Lists of up to
// 2048 survivors live in shared memory; longer ones in device memory
// (the partial scratch, and a merged scratch [Q, 2, m]), by the same
// rule, so any m the reference takes is answered. The selection of the
// top_k keeps only per-thread state and reads the scores from device
// memory, so top_k is unbounded too.
//
// fused_scored_topk_masked_launch replaces
// src/repro/kernels/fused_scored.py::fused_scored_topk_masked_pallas
// (body _fused_scored_call), the mutable index's scored search over one
// segment: the same kernels, with the partial kernel reading a validity
// bitmask [ceil(N/32)]. A dead row takes count -1 and never enters a
// list (an offer must strictly beat the last entry, which starts at
// -1), so the merged lists of m are exactly the stable top-m over live
// rows: the reference's survivor rule with tombstones at -1. Bound: the
// unmasked kernel's count sweep over the live rows only, and N/8 more
// bytes for the mask.
//
// The sweep is chosen by the wrappers' plan (packed_collision.plan) with
// m in place of top_k: the int8 tensor-core kernel of topk_tc.cuh for 1-
// and 2-bit codes whose one-hot queries fit shared memory, else
// packed_topk_partial; both give the same partial lists.
#include "topk_tc.cuh"
#include "lut_common.cuh"

namespace {

constexpr size_t SMEM_TABLE_MAX = 96 * 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
score_survivors(const int32_t* __restrict__ part_vals,
                const int32_t* __restrict__ part_ids,
                const T* __restrict__ tables, const float* __restrict__ scales,
                const uint32_t* __restrict__ db, int32_t* __restrict__ merged,
                float* __restrict__ scratch, float* __restrict__ out_s,
                int32_t* __restrict__ out_ids, int nq, int m, int w, int bits,
                int top_k, int n_ranges, int fp, int tab_in_smem) {
  extern __shared__ __align__(16) unsigned char score_smem[];
  uint64_t* red = reinterpret_cast<uint64_t*>(score_smem);
  const int qi = blockIdx.x;
  // the merged survivor list: in shared memory up to SMEM_LIST_MAX,
  // else in the merged scratch [nq][2][m]
  const bool in_smem = m <= SMEM_LIST_MAX;
  int* lv = in_smem ? reinterpret_cast<int*>(red + 64)
                    : merged + (size_t)qi * 2 * m;
  int* li = lv + m;
  T* stab = reinterpret_cast<T*>(in_smem ? reinterpret_cast<int*>(red + 64) +
                                               2 * m
                                         : reinterpret_cast<int*>(red + 64));
  const T* tab = tables + (size_t)qi * fp;
  const float* scl = scales ? scales + (size_t)qi * w : nullptr;
  if (tab_in_smem) {
    for (int i = threadIdx.x; i < fp; i += THREADS) stab[i] = tab[i];
    tab = stab;
  }
  if (threadIdx.x < 32)
    warp_merge_ranges(part_vals, part_ids, lv, li, nq, qi, m, n_ranges,
                      threadIdx.x);
  __syncthreads();  // orders warp 0's list, in either memory, for the block
  float* sc = scratch + (size_t)qi * m;
  for (int i = threadIdx.x; i < m; i += THREADS)
    sc[i] = lv[i] >= 0
                ? score_row(tab, scl, db + (size_t)li[i] * w, w, bits)
                : -INFINITY;
  __syncthreads();
  block_select(sc, m, [li](int i) { return li[i]; }, top_k,
               out_s + (size_t)qi * top_k, out_ids + (size_t)qi * top_k, red);
}

template <typename T>
cudaError_t launch_score(const int32_t* pv, const int32_t* pi,
                         const void* tables, const float* scales,
                         const uint32_t* db, int32_t* merged, float* scratch,
                         float* out_s, int32_t* out_ids, int nq, int m, int w,
                         int bits, int top_k, int n_ranges, cudaStream_t st) {
  const int fp = (w * (32 / bits)) << bits;
  const size_t tab_bytes = (size_t)fp * sizeof(T);
  const int in_smem = tab_bytes <= SMEM_TABLE_MAX;
  const size_t lists = m <= SMEM_LIST_MAX ? 2 * (size_t)m * sizeof(int) : 0;
  const size_t smem = 64 * sizeof(uint64_t) + lists + (in_smem ? tab_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      score_survivors<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  score_survivors<T><<<nq, THREADS, smem, st>>>(
      pv, pi, static_cast<const T*>(tables), scales, db, merged, scratch,
      out_s, out_ids, nq, m, w, bits, top_k, n_ranges, fp, in_smem);
  return cudaGetLastError();
}

cudaError_t launch_fused(const uint32_t* q, const uint32_t* db,
                         const uint32_t* valid, const void* tables,
                         int tab_dtype, const float* scales,
                         int32_t* part_vals, int32_t* part_ids,
                         int32_t* merged, float* scratch, float* out_s,
                         int32_t* out_ids,
                         int nq, int n, int w, int bits, int k, int m,
                         int top_k, int n_ranges, int qb, int smem,
                         int in_smem, cudaStream_t st) {
  cudaError_t err = launch_sweep(q, db, valid, part_vals, part_ids, nq, n, w,
                                 bits, k, m, n_ranges, qb, (size_t)smem,
                                 in_smem, st);
  if (err != cudaSuccess) return err;
  if (tab_dtype == 0)
    return launch_score<float>(part_vals, part_ids, tables, nullptr, db,
                               merged, scratch, out_s, out_ids, nq, m, w,
                               bits, top_k, n_ranges, st);
  if (tab_dtype == 1)
    return launch_score<uint16_t>(part_vals, part_ids, tables, nullptr, db,
                                  merged, scratch, out_s, out_ids, nq, m, w,
                                  bits, top_k, n_ranges, st);
  return launch_score<int8_t>(part_vals, part_ids, tables, scales, db, merged,
                              scratch, out_s, out_ids, nq, m, w, bits, top_k,
                              n_ranges, st);
}

}  // namespace

// tab_dtype: 0 float32, 1 bf16, 2 int8 (scales [nq, w], else null).
// part_vals/part_ids: scratch [n_ranges, nq, m]; merged: scratch
// [nq, 2, m] int32 when m > SMEM_LIST_MAX (2048), else unused; scratch:
// [nq, m] float32. qb, smem, in_smem: the plan's sweep (packed_topk.cu).
extern "C" int fused_scored_launch(const uint32_t* q, const uint32_t* db,
                                   const void* tables, int tab_dtype,
                                   const float* scales, int32_t* part_vals,
                                   int32_t* part_ids, int32_t* merged,
                                   float* scratch, float* out_s,
                                   int32_t* out_ids, int nq, int n, int w,
                                   int bits, int k, int m, int top_k,
                                   int n_ranges, int qb, int smem,
                                   int in_smem, void* stream) {
  return (int)launch_fused(q, db, nullptr, tables, tab_dtype, scales,
                           part_vals, part_ids, merged, scratch, out_s,
                           out_ids, nq, n, w, bits, k, m, top_k, n_ranges,
                           qb, smem, in_smem, (cudaStream_t)stream);
}

// valid: the rows' bitmask, uint32 [ceil(n/32)].
extern "C" int fused_scored_topk_masked_launch(
    const uint32_t* q, const uint32_t* db, const uint32_t* valid,
    const void* tables, int tab_dtype, const float* scales,
    int32_t* part_vals, int32_t* part_ids, int32_t* merged, float* scratch,
    float* out_s, int32_t* out_ids, int nq, int n, int w, int bits, int k,
    int m, int top_k, int n_ranges, int qb, int smem, int in_smem,
    void* stream) {
  return (int)launch_fused(q, db, valid, tables, tab_dtype, scales,
                           part_vals, part_ids, merged, scratch, out_s,
                           out_ids, nq, n, w, bits, k, m, top_k, n_ranges,
                           qb, smem, in_smem, (cudaStream_t)stream);
}
