// Top-k building blocks shared by packed_topk.cu, fused_scored.cu and
// lut_topk.cu: the field fold, the per-warp sorted (value, id) list (int
// counts or float scores) and the partial top-k kernel by count over S
// contiguous corpus ranges (its design note is in packed_topk.cu). The
// partial kernel takes an optional validity bitmask (bit r % 32 of word
// r / 32 marks row r live; null for the unmasked kernels): a dead row
// gets count -1 and its popcounts are skipped. Lists start at the empty
// value (-1 for counts, -inf for scores) and an offer must strictly beat
// the last entry, so a dead row never enters one.
//
// A list of up to SMEM_LIST_MAX entries lives in shared memory. A longer
// one lives in device memory, in the output it is written to (a range's
// partial list, a query's merged list): the same insertion, one warp per
// list, so the same bits at any length; __syncwarp orders the warp's
// device-memory accesses as it does its shared ones.
#pragma once
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {


constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIST_MAX = 2048;

template <typename V> __device__ __forceinline__ V list_empty();
template <> __device__ __forceinline__ int list_empty<int>() { return -1; }
template <> __device__ __forceinline__ float list_empty<float>() {
  return -INFINITY;
}

__device__ __forceinline__ int field_mismatches(uint32_t x, int bits,
                                                uint32_t lsb) {
  if (bits > 1) x |= x >> 1;
  if (bits > 2) x |= x >> 2;
  if (bits > 4) x |= x >> 4;
  if (bits > 8) x |= x >> 8;
  return __popc(x & lsb);
}

// field_mismatches at a width fixed when compiled: the fold's shifts and
// the field mask are constants
template <int BITS>
__device__ __forceinline__ int field_mismatches_t(uint32_t x) {
  constexpr uint32_t lsb = BITS == 1   ? 0xffffffffu
                           : BITS == 2 ? 0x55555555u
                           : BITS == 4 ? 0x11111111u
                           : BITS == 8 ? 0x01010101u
                                       : 0x00010001u;
  if constexpr (BITS > 1) x |= x >> 1;
  if constexpr (BITS > 2) x |= x >> 2;
  if constexpr (BITS > 4) x |= x >> 4;
  if constexpr (BITS > 8) x |= x >> 8;
  return __popc(x & lsb);
}

// Inserts (c, id) into the warp's list, sorted by value descending and,
// within a value, by arrival: it goes after every entry with value >= c.
template <typename V>
__device__ inline void warp_insert(V* lv, int* li, int top_k, V c, int id,
                                   int lane) {
  int p = 0;
  for (int base = 0; base < top_k; base += 32) {
    const int i = base + lane;
    p += __popc(__ballot_sync(FULL, i < top_k && lv[i] >= c));
  }
  for (int hi = top_k - 1; hi > p; hi -= 32) {  // shift [p, top_k-1) down
    const int i = hi - lane;
    const bool act = i > p;
    V v = 0;
    int d = 0;
    if (act) { v = lv[i - 1]; d = li[i - 1]; }
    __syncwarp();
    if (act) { lv[i] = v; li[i] = d; }
    __syncwarp();
  }
  if (lane == 0) { lv[p] = c; li[p] = id; }
  __syncwarp();
}

// Offers one lane-ordered batch of 32 candidates (the empty value =
// none).
template <typename V>
__device__ __forceinline__ void offer_batch(V* lv, int* li, int top_k, V cnt,
                                            int id, int lane) {
  unsigned cand = __ballot_sync(FULL, cnt > lv[top_k - 1]);
  while (cand) {
    const int src = __ffs(cand) - 1;
    cand &= cand - 1;
    const V c = __shfl_sync(FULL, cnt, src);
    const int d = __shfl_sync(FULL, id, src);
    if (c > lv[top_k - 1]) warp_insert(lv, li, top_k, c, d, lane);
  }
}

// WQ > 0: the query's words live in WQ registers (w <= WQ); WQ == 0: they
// are read from shared memory (any w). BITS: the code width.
template <int WQ, int BITS>
__global__ void __launch_bounds__(THREADS)
packed_topk_partial(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ db,
                    const uint32_t* __restrict__ valid,
                    int32_t* __restrict__ part_vals,
                    int32_t* __restrict__ part_ids, int nq, int n, int w,
                    int k, int top_k, int rows_per_range, int tn) {
  extern __shared__ uint32_t smem[];
  const int wp = w | 1;
  uint32_t* tile = smem;                    // [tn][wp]
  uint32_t* qs = tile + tn * wp;            // [WARPS][w]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* qw = qs + warp * w;
  const int qi = blockIdx.x * WARPS + warp;
  const bool has_q = qi < nq;
  const bool in_smem = top_k <= SMEM_LIST_MAX;
  const size_t o = ((size_t)blockIdx.y * nq + qi) * top_k;
  int* lv = in_smem ? reinterpret_cast<int*>(qs + WARPS * w) + warp * top_k
                    : part_vals + o;        // [WARPS][top_k] in smem
  int* li = in_smem ? reinterpret_cast<int*>(qs + WARPS * w) +
                          (WARPS + warp) * top_k
                    : part_ids + o;
  if (has_q)
    for (int i = lane; i < top_k; i += 32) { lv[i] = -1; li[i] = -1; }
  for (int j = lane; j < w; j += 32) qw[j] = has_q ? q[(size_t)qi * w + j] : 0u;
  __syncwarp();
  uint32_t qr[WQ > 0 ? WQ : 1];
  if constexpr (WQ > 0) {
#pragma unroll
    for (int j = 0; j < WQ; ++j) qr[j] = j < w ? qw[j] : 0u;
  }
  const int r0 = blockIdx.y * rows_per_range;
  const int r1 = min(n, r0 + rows_per_range);
  for (int t0 = r0; t0 < r1; t0 += tn) {
    const int rows = min(tn, r1 - t0);
    __syncthreads();  // the previous tile is consumed by every warp
    for (int e = threadIdx.x; e < rows * w; e += THREADS)
      tile[(e / w) * wp + e % w] = db[(size_t)t0 * w + e];
    __syncthreads();
    if (!has_q) continue;
    for (int b = 0; b < rows; b += 32) {
      const int rr = b + lane;
      int cnt = -1;
      // ranges need not start at a multiple of 32: row r's bit is read
      // from its own word, valid[r >> 5]
      const int row = t0 + rr;
      if (rr < rows &&
          (valid == nullptr || ((valid[row >> 5] >> (row & 31)) & 1u))) {
        const uint32_t* drow = tile + rr * wp;
        int mism = 0;
        if constexpr (WQ > 0) {
#pragma unroll
          for (int j = 0; j < WQ; ++j)
            if (j < w) mism += field_mismatches_t<BITS>(qr[j] ^ drow[j]);
        } else {
          for (int j = 0; j < w; ++j)
            mism += field_mismatches_t<BITS>(qw[j] ^ drow[j]);
        }
        cnt = k - mism;
      }
      offer_batch(lv, li, top_k, cnt, row, lane);
    }
  }
  if (has_q && in_smem) {
    for (int i = lane; i < top_k; i += 32) {
      part_vals[o + i] = lv[i];
      part_ids[o + i] = li[i];
    }
  }
}

// Merges the S partial lists of query qi, in range order, into the
// warp's list (lv, li) of top_k entries: the same strictly-beats rule,
// so ties keep the lower id.
template <typename V>
__device__ inline void warp_merge_ranges(const V* __restrict__ part_vals,
                                         const int32_t* __restrict__ part_ids,
                                         V* lv, int* li, int nq, int qi,
                                         int top_k, int n_ranges, int lane) {
  for (int i = lane; i < top_k; i += 32) {
    lv[i] = list_empty<V>();
    li[i] = -1;
  }
  __syncwarp();
  for (int s = 0; s < n_ranges; ++s) {
    const size_t o = ((size_t)s * nq + qi) * top_k;
    for (int b = 0; b < top_k; b += 32) {
      const int i = b + lane;
      const V c = i < top_k ? part_vals[o + i] : list_empty<V>();
      const int d = i < top_k ? part_ids[o + i] : -1;
      offer_batch(lv, li, top_k, c, d, lane);
    }
  }
}

template <int WQ, int BITS>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t stream,
                           const uint32_t* q, const uint32_t* db,
                           const uint32_t* valid, int32_t* pv, int32_t* pi,
                           int nq, int n, int w, int k, int top_k, int rpr,
                           int tn) {
  cudaError_t err = cudaFuncSetAttribute(
      packed_topk_partial<WQ, BITS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  packed_topk_partial<WQ, BITS><<<grid, THREADS, smem, stream>>>(
      q, db, valid, pv, pi, nq, n, w, k, top_k, rpr, tn);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_partial_bits(dim3 grid, size_t smem, cudaStream_t st,
                                const uint32_t* q, const uint32_t* db,
                                const uint32_t* valid, int32_t* pv,
                                int32_t* pi, int nq, int n, int w, int k,
                                int top_k, int rpr, int tn) {
  if (w <= 16)
    return launch_partial<16, BITS>(grid, smem, st, q, db, valid, pv, pi, nq,
                                    n, w, k, top_k, rpr, tn);
  if (w <= 64)
    return launch_partial<64, BITS>(grid, smem, st, q, db, valid, pv, pi, nq,
                                    n, w, k, top_k, rpr, tn);
  return launch_partial<0, BITS>(grid, smem, st, q, db, valid, pv, pi, nq, n,
                                 w, k, top_k, rpr, tn);
}

// Launches the partial kernel: per query, the stable top_k by count of
// each of n_ranges contiguous corpus ranges, into part_vals/part_ids
// [n_ranges, nq, top_k] ((-1, -1) where a range has fewer live rows).
// valid: the bitmask over db's rows, or null when every row is live.
inline cudaError_t launch_partial_ranges(const uint32_t* q, const uint32_t* db,
                                  const uint32_t* valid,
                                  int32_t* part_vals, int32_t* part_ids,
                                  int nq, int n, int w, int bits, int k,
                                  int top_k, int n_ranges, cudaStream_t st) {
  const int wp = w | 1;
  int tn = (8192 / wp) / 32 * 32;  // corpus tile of at most 32 KB
  tn = tn < 32 ? 32 : (tn > 256 ? 256 : tn);
  const int rpr = (n + n_ranges - 1) / n_ranges;
  const dim3 grid((nq + WARPS - 1) / WARPS, n_ranges);
  const size_t lists = top_k <= SMEM_LIST_MAX ? 2 * (size_t)WARPS * top_k : 0;
  const size_t smem = ((size_t)tn * wp + (size_t)WARPS * w + lists) * 4;
#define PARTIAL_ARGS grid, smem, st, q, db, valid, part_vals, part_ids, nq, n, w, k, top_k, rpr, tn
  switch (bits) {
    case 1: return launch_partial_bits<1>(PARTIAL_ARGS);
    case 2: return launch_partial_bits<2>(PARTIAL_ARGS);
    case 4: return launch_partial_bits<4>(PARTIAL_ARGS);
    case 8: return launch_partial_bits<8>(PARTIAL_ARGS);
    case 16: return launch_partial_bits<16>(PARTIAL_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PARTIAL_ARGS
}

}  // namespace
