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
// enter; top_k up to 2048 fits in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int field_mismatches(uint32_t x, int bits,
                                                uint32_t lsb) {
  if (bits > 1) x |= x >> 1;
  if (bits > 2) x |= x >> 2;
  if (bits > 4) x |= x >> 4;
  if (bits > 8) x |= x >> 8;
  return __popc(x & lsb);
}

// Inserts (c, id) into the warp's list, sorted by count descending and,
// within a count, by arrival: it goes after every entry with count >= c.
__device__ void warp_insert(int* lv, int* li, int top_k, int c, int id,
                            int lane) {
  int p = 0;
  for (int base = 0; base < top_k; base += 32) {
    const int i = base + lane;
    p += __popc(__ballot_sync(FULL, i < top_k && lv[i] >= c));
  }
  for (int hi = top_k - 1; hi > p; hi -= 32) {  // shift [p, top_k-1) down
    const int i = hi - lane;
    const bool act = i > p;
    int v = 0, d = 0;
    if (act) { v = lv[i - 1]; d = li[i - 1]; }
    __syncwarp();
    if (act) { lv[i] = v; li[i] = d; }
    __syncwarp();
  }
  if (lane == 0) { lv[p] = c; li[p] = id; }
  __syncwarp();
}

// Offers one lane-ordered batch of 32 candidates (count -1 = none).
__device__ __forceinline__ void offer_batch(int* lv, int* li, int top_k,
                                            int cnt, int id, int lane) {
  unsigned cand = __ballot_sync(FULL, cnt > lv[top_k - 1]);
  while (cand) {
    const int src = __ffs(cand) - 1;
    cand &= cand - 1;
    const int c = __shfl_sync(FULL, cnt, src);
    const int d = __shfl_sync(FULL, id, src);
    if (c > lv[top_k - 1]) warp_insert(lv, li, top_k, c, d, lane);
  }
}

// WQ > 0: the query's words live in WQ registers (w <= WQ); WQ == 0: they
// are read from shared memory (any w).
template <int WQ>
__global__ void __launch_bounds__(THREADS)
packed_topk_partial(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ db,
                    int32_t* __restrict__ part_vals,
                    int32_t* __restrict__ part_ids, int nq, int n, int w,
                    int bits, int k, int top_k, int rows_per_range, int tn,
                    uint32_t lsb) {
  extern __shared__ uint32_t smem[];
  const int wp = w | 1;
  uint32_t* tile = smem;                    // [tn][wp]
  uint32_t* qs = tile + tn * wp;            // [WARPS][w]
  int* lv = reinterpret_cast<int*>(qs + WARPS * w);  // [WARPS][top_k]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* li = lv + WARPS * top_k + warp * top_k;
  lv += warp * top_k;
  uint32_t* qw = qs + warp * w;
  const int qi = blockIdx.x * WARPS + warp;
  const bool has_q = qi < nq;
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
      if (rr < rows) {
        const uint32_t* drow = tile + rr * wp;
        int mism = 0;
        if constexpr (WQ > 0) {
#pragma unroll
          for (int j = 0; j < WQ; ++j)
            if (j < w) mism += field_mismatches(qr[j] ^ drow[j], bits, lsb);
        } else {
          for (int j = 0; j < w; ++j)
            mism += field_mismatches(qw[j] ^ drow[j], bits, lsb);
        }
        cnt = k - mism;
      }
      offer_batch(lv, li, top_k, cnt, t0 + rr, lane);
    }
  }
  if (has_q) {
    const size_t o = ((size_t)blockIdx.y * nq + qi) * top_k;
    for (int i = lane; i < top_k; i += 32) {
      part_vals[o + i] = lv[i];
      part_ids[o + i] = li[i];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
packed_topk_merge(const int32_t* __restrict__ part_vals,
                  const int32_t* __restrict__ part_ids,
                  int32_t* __restrict__ out_vals, int32_t* __restrict__ out_ids,
                  int nq, int top_k, int n_ranges) {
  extern __shared__ int msmem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qi = blockIdx.x * WARPS + warp;
  if (qi >= nq) return;  // whole warp: no block-wide barrier below
  int* lv = msmem + warp * 2 * top_k;
  int* li = lv + top_k;
  for (int i = lane; i < top_k; i += 32) { lv[i] = -1; li[i] = -1; }
  __syncwarp();
  for (int s = 0; s < n_ranges; ++s) {
    const size_t o = ((size_t)s * nq + qi) * top_k;
    for (int b = 0; b < top_k; b += 32) {
      const int i = b + lane;
      const int c = i < top_k ? part_vals[o + i] : -1;
      const int d = i < top_k ? part_ids[o + i] : -1;
      offer_batch(lv, li, top_k, c, d, lane);
    }
  }
  const size_t o = (size_t)qi * top_k;
  for (int i = lane; i < top_k; i += 32) {
    out_vals[o + i] = lv[i];
    out_ids[o + i] = li[i];
  }
}

template <int WQ>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t stream,
                           const uint32_t* q, const uint32_t* db,
                           int32_t* pv, int32_t* pi, int nq, int n, int w,
                           int bits, int k, int top_k, int rpr, int tn,
                           uint32_t lsb) {
  cudaError_t err = cudaFuncSetAttribute(
      packed_topk_partial<WQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  packed_topk_partial<WQ><<<grid, THREADS, smem, stream>>>(
      q, db, pv, pi, nq, n, w, bits, k, top_k, rpr, tn, lsb);
  return cudaGetLastError();
}

}  // namespace

// part_vals/part_ids: scratch [n_ranges, nq, top_k]; out: [nq, top_k].
extern "C" int packed_topk_launch(const uint32_t* q, const uint32_t* db,
                                  int32_t* part_vals, int32_t* part_ids,
                                  int32_t* out_vals, int32_t* out_ids, int nq,
                                  int n, int w, int bits, int k, int top_k,
                                  int n_ranges, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int wp = w | 1;
  int tn = (8192 / wp) / 32 * 32;  // corpus tile of at most 32 KB
  tn = tn < 32 ? 32 : (tn > 256 ? 256 : tn);
  uint32_t lsb = 0;
  for (int i = 0; i < 32 / bits; ++i) lsb |= 1u << (i * bits);
  const int rpr = (n + n_ranges - 1) / n_ranges;
  const dim3 grid((nq + WARPS - 1) / WARPS, n_ranges);
  const size_t smem =
      ((size_t)tn * wp + (size_t)WARPS * w + 2 * (size_t)WARPS * top_k) * 4;
  cudaError_t err;
  if (w <= 16)
    err = launch_partial<16>(grid, smem, st, q, db, part_vals, part_ids, nq, n,
                             w, bits, k, top_k, rpr, tn, lsb);
  else if (w <= 64)
    err = launch_partial<64>(grid, smem, st, q, db, part_vals, part_ids, nq, n,
                             w, bits, k, top_k, rpr, tn, lsb);
  else
    err = launch_partial<0>(grid, smem, st, q, db, part_vals, part_ids, nq, n,
                            w, bits, k, top_k, rpr, tn, lsb);
  if (err != cudaSuccess) return (int)err;
  const size_t msmem = 2 * (size_t)WARPS * top_k * 4;
  err = cudaFuncSetAttribute(packed_topk_merge,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)msmem);
  if (err != cudaSuccess) return (int)err;
  packed_topk_merge<<<(nq + WARPS - 1) / WARPS, THREADS, msmem, st>>>(
      part_vals, part_ids, out_vals, out_ids, nq, top_k, n_ranges);
  return (int)cudaGetLastError();
}
