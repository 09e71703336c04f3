// Exact top-k search by collision count over bit-packed codes.
//
// Replaces src/repro/kernels/packed_collision.py::packed_topk_pallas:
// count(q, n) = k - popcount(field-fold(q XOR db[n])) over W uint32
// words, and a stable descending top-k per query: ties go to the lowest
// corpus id, empty slots are (-1, -1). The [Q, N] count matrix never
// reaches device memory.
//
// Bound on this card: operations. Every (query, row, word) triple costs
// one popcount (16 a clock per SM) and 2 + 2*log2(b) other integer
// operations (64 a clock): an XOR, log2(b) shifts and ORs whose last OR
// merges with the mask into one LOP3, and an add. At b = 2 the two pipes
// tie and the popcount rate sets the bound, while the corpus is read
// N*W*4 bytes once per query tile: at Q = 256 queries a chunk that is 64
// popcounts per corpus byte.
//
// Design. The TPU kernel walks the corpus in order on one core and
// merges each count tile into a running top-k. Here the grid is
// (query tiles) x (S contiguous corpus ranges), so enough blocks fill the
// SMs. The 8 warps of a block share corpus tiles staged in shared memory
// (rows padded to an odd stride, so the 32 lanes of a warp, each on its
// own row, hit distinct banks); each warp owns one query, held in
// registers, and keeps its sorted (count, id) list in shared memory. A
// lane's row is offered, after a ballot, only if its count strictly
// beats the list's last entry: rows arrive in rising id order within a
// range, so a tie is always lost to the earlier, lower id, which is the
// reference's stable merge. A second kernel merges the S partial lists
// of each query in range order under the same rule. Rows >= N never
// enter. Lists of up to 2048 entries live in shared memory; longer ones
// in the scratch and output they are written to (topk_common.cuh), so
// any top_k the reference takes is answered, by the same rule.
//
// packed_topk_masked_launch replaces
// src/repro/kernels/packed_collision.py::packed_topk_masked_pallas, the
// mutable index's count-ranked search over one segment: the same two
// kernels with a validity bitmask [ceil(N/32)] (bit r % 32 of word
// r / 32 marks row r live). The partial kernel gives a dead row count -1
// and skips its popcounts; since a list starts at -1 and an offer must
// strictly beat its last entry, a dead row never enters, and slots past
// the live count come back (-1, -1), as the reference's masked merge
// gives them. Bound: the unmasked kernel's operations over the live rows
// only (a dead row's popcounts are skipped; its words are still read),
// and N/8 more bytes for the mask.
//
// Since the tensor-core sweep (topk_tc.cuh), the partial kernel is chosen
// by the wrappers' plan (packed_collision.plan), by shape and before the
// launch: for 1- and 2-bit codes whose one-hot queries fit shared memory
// the count sweep runs on the int8 tensor cores; for 4-, 8- and 16-bit
// codes and wider words it is packed_topk_partial above, its fold
// templated on the code width. Both write the same partial lists, so the
// merge and every result bit are the same.
#include "topk_tc.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
packed_topk_merge(const int32_t* __restrict__ part_vals,
                  const int32_t* __restrict__ part_ids,
                  int32_t* __restrict__ out_vals, int32_t* __restrict__ out_ids,
                  int nq, int top_k, int n_ranges) {
  extern __shared__ int msmem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qi = blockIdx.x * WARPS + warp;
  if (qi >= nq) return;  // whole warp: no block-wide barrier below
  const size_t o = (size_t)qi * top_k;
  const bool in_smem = top_k <= SMEM_LIST_MAX;
  int* lv = in_smem ? msmem + warp * 2 * top_k : out_vals + o;
  int* li = in_smem ? lv + top_k : out_ids + o;
  warp_merge_ranges(part_vals, part_ids, lv, li, nq, qi, top_k, n_ranges,
                    lane);
  if (!in_smem) return;
  for (int i = lane; i < top_k; i += 32) {
    out_vals[o + i] = lv[i];
    out_ids[o + i] = li[i];
  }
}

cudaError_t launch_merge(const int32_t* part_vals, const int32_t* part_ids,
                         int32_t* out_vals, int32_t* out_ids, int nq,
                         int top_k, int n_ranges, cudaStream_t st) {
  const size_t msmem =
      top_k <= SMEM_LIST_MAX ? 2 * (size_t)WARPS * top_k * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      packed_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)msmem);
  if (err != cudaSuccess) return err;
  packed_topk_merge<<<(nq + WARPS - 1) / WARPS, THREADS, msmem, st>>>(
      part_vals, part_ids, out_vals, out_ids, nq, top_k, n_ranges);
  return cudaGetLastError();
}

cudaError_t launch_topk(const uint32_t* q, const uint32_t* db,
                        const uint32_t* valid, int32_t* part_vals,
                        int32_t* part_ids, int32_t* out_vals, int32_t* out_ids,
                        int nq, int n, int w, int bits, int k, int top_k,
                        int n_ranges, int qb, int smem, int in_smem,
                        cudaStream_t st) {
  cudaError_t err = launch_sweep(q, db, valid, part_vals, part_ids, nq, n, w,
                                 bits, k, top_k, n_ranges, qb, (size_t)smem,
                                 in_smem, st);
  if (err != cudaSuccess) return err;
  return launch_merge(part_vals, part_ids, out_vals, out_ids, nq, top_k,
                      n_ranges, st);
}

}  // namespace

// part_vals/part_ids: scratch [n_ranges, nq, top_k]; out: [nq, top_k].
// qb, smem, in_smem: the plan's sweep (qb 0: packed_topk_partial; else the
// tensor-core kernel at QB = qb, smem bytes, lists in shared memory when
// in_smem).
extern "C" int packed_topk_launch(const uint32_t* q, const uint32_t* db,
                                  int32_t* part_vals, int32_t* part_ids,
                                  int32_t* out_vals, int32_t* out_ids, int nq,
                                  int n, int w, int bits, int k, int top_k,
                                  int n_ranges, int qb, int smem, int in_smem,
                                  void* stream) {
  return (int)launch_topk(q, db, nullptr, part_vals, part_ids, out_vals,
                          out_ids, nq, n, w, bits, k, top_k, n_ranges, qb,
                          smem, in_smem, (cudaStream_t)stream);
}

// valid: the rows' bitmask, uint32 [ceil(n/32)].
extern "C" int packed_topk_masked_launch(const uint32_t* q, const uint32_t* db,
                                         const uint32_t* valid,
                                         int32_t* part_vals, int32_t* part_ids,
                                         int32_t* out_vals, int32_t* out_ids,
                                         int nq, int n, int w, int bits, int k,
                                         int top_k, int n_ranges, int qb,
                                         int smem, int in_smem, void* stream) {
  return (int)launch_topk(q, db, valid, part_vals, part_ids, out_vals,
                          out_ids, nq, n, w, bits, k, top_k, n_ranges, qb,
                          smem, in_smem, (cudaStream_t)stream);
}

// The count sweep alone (the partial lists [n_ranges, nq, top_k]); valid
// may be null.
extern "C" int packed_topk_partial_launch(const uint32_t* q,
                                          const uint32_t* db,
                                          const uint32_t* valid,
                                          int32_t* part_vals,
                                          int32_t* part_ids, int nq, int n,
                                          int w, int bits, int k, int top_k,
                                          int n_ranges, int qb, int smem,
                                          int in_smem, void* stream) {
  return (int)launch_sweep(q, db, valid, part_vals, part_ids, nq, n, w, bits,
                           k, top_k, n_ranges, qb, (size_t)smem, in_smem,
                           (cudaStream_t)stream);
}

// The merge alone: partial lists [n_ranges, nq, top_k] -> out [nq, top_k].
extern "C" int packed_topk_merge_launch(const int32_t* part_vals,
                                        const int32_t* part_ids,
                                        int32_t* out_vals, int32_t* out_ids,
                                        int nq, int top_k, int n_ranges,
                                        void* stream) {
  return (int)launch_merge(part_vals, part_ids, out_vals, out_ids, nq, top_k,
                           n_ranges, (cudaStream_t)stream);
}

// Blocks of the tensor-core sweep (bits 1 or 2, QB = qb) an SM holds at
// `smem` bytes of dynamic shared memory, into *blocks.
extern "C" int packed_topk_tc_occupancy(int bits, int qb, int smem,
                                        int* blocks) {
  return (int)tc_occupancy(bits, qb, (size_t)smem, blocks);
}
