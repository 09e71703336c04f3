// Full-corpus LUT-scored streaming top-k over bit-packed codes.
//
// Replaces src/repro/kernels/packed_lut.py::packed_lut_topk_pallas:
// float32 or bf16 tables [Q, F*P] and corpus words [N, W] -> the stable
// top_k by (score desc, id asc) as (scores float32, ids int32)
// [Q, top_k], (-inf, -1) in empty slots. A row's score adds, in
// (word, field) order from 0.0, the table entry each b-bit field selects
// (lut_common.cuh's score_row, the order of ref.lut_scores_rowwise_ref;
// bf16 entries widen exactly on load). The [Q, N] score matrix never
// reaches device memory.
//
// packed_lut_topk_masked_launch replaces
// src/repro/kernels/packed_lut.py::packed_lut_topk_masked_pallas: the
// same over the rows whose bit is set in a validity bitmask [ceil(N/32)]
// (bit r % 32 of word r / 32 marks row r live). A dead row's score is
// never computed: it offers -inf, which never enters a list (lists start
// at -inf and an offer must strictly beat the last entry), so slots past
// the live count come back (-inf, -1), as the reference's oracle gives.
//
// Bound on this card: operations. Each (query, row, field) is a shift, a
// mask, an address and a table load from shared memory plus one float
// add: Q*N*F = 2.7e11 of each at the main path (Q = 256, N = 4,194,304,
// F = 256), against N*W*4 bytes of corpus read once per query tile. The
// float adds alone take 4 ms at 67 TFLOP/s; the integer decode and the
// shared-memory loads (32 lanes a clock per SM) are slower still.
//
// Design. The TPU kernel streams the corpus in order on one core through
// a running top-k. Here the grid is (query tiles of 8) x (S contiguous
// corpus ranges), as in packed_topk.cu: the 8 warps of a block share
// corpus tiles staged in shared memory (odd row stride: distinct banks),
// each warp owns one query, whose table sits in shared memory when the
// block's 8 tables fit in 96 KB beside the tile and lists (4 KB each at
// the main path; 8- and 16-bit tables are read from device memory, as
// are the tables beside long lists), and keeps a sorted
// (score, id) list (topk_common.cuh). Rows arrive in rising id order
// within a range and enter only if they strictly beat the list's last
// entry, so ties keep the lower id; a second kernel merges the S lists
// of each query in range order under the same rule. Lists of up to 2048
// entries live in shared memory, longer ones in the scratch and output
// (any top_k).
#include "topk_common.cuh"
#include "lut_common.cuh"

namespace {

constexpr size_t SMEM_TABLES_MAX = 96 * 1024;
constexpr size_t SMEM_BLOCK_MAX = 232448;  // 227 KB: a block's most

template <typename T>
__global__ void __launch_bounds__(THREADS)
lut_topk_partial(const T* __restrict__ tables, const uint32_t* __restrict__ db,
                 const uint32_t* __restrict__ valid,
                 float* __restrict__ part_s, int32_t* __restrict__ part_i,
                 int nq, int n, int w, int bits, int top_k,
                 int rows_per_range, int tn, int fp, int tab_in_smem) {
  extern __shared__ __align__(16) uint32_t lsmem[];
  const int wp = w | 1;
  uint32_t* tile = lsmem;                               // [tn][wp]
  float* lists = reinterpret_cast<float*>(tile + tn * wp);
  const bool in_smem = top_k <= SMEM_LIST_MAX;
  T* stab = reinterpret_cast<T*>(lists + (in_smem ? 2 * WARPS * top_k : 0));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qi = blockIdx.x * WARPS + warp;
  const bool has_q = qi < nq;
  const size_t o = ((size_t)blockIdx.y * nq + qi) * top_k;
  float* lv = in_smem ? lists + warp * top_k : part_s + o;
  int* li = in_smem ? reinterpret_cast<int*>(lists + WARPS * top_k) +
                          warp * top_k
                    : part_i + o;
  const T* tab = tables + (size_t)qi * fp;
  if (tab_in_smem) {
    if (has_q)
      for (int i = lane; i < fp; i += 32) stab[(size_t)warp * fp + i] = tab[i];
    tab = stab + (size_t)warp * fp;
  }
  if (has_q)
    for (int i = lane; i < top_k; i += 32) {
      lv[i] = -INFINITY;
      li[i] = -1;
    }
  __syncwarp();
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
      const int row = t0 + rr;
      float sc = -INFINITY;
      if (rr < rows &&
          (valid == nullptr || ((valid[row >> 5] >> (row & 31)) & 1u)))
        sc = score_row(tab, nullptr, tile + rr * wp, w, bits);
      offer_batch(lv, li, top_k, sc, row, lane);
    }
  }
  if (has_q && in_smem)
    for (int i = lane; i < top_k; i += 32) {
      part_s[o + i] = lv[i];
      part_i[o + i] = li[i];
    }
}

__global__ void __launch_bounds__(THREADS)
lut_topk_merge(const float* __restrict__ part_s,
               const int32_t* __restrict__ part_i, float* __restrict__ out_s,
               int32_t* __restrict__ out_i, int nq, int top_k, int n_ranges) {
  extern __shared__ __align__(16) uint32_t msmem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qi = blockIdx.x * WARPS + warp;
  if (qi >= nq) return;  // whole warp: no block-wide barrier below
  const size_t o = (size_t)qi * top_k;
  const bool in_smem = top_k <= SMEM_LIST_MAX;
  float* lv = in_smem ? reinterpret_cast<float*>(msmem) + warp * 2 * top_k
                      : out_s + o;
  int* li = in_smem ? reinterpret_cast<int*>(lv + top_k) : out_i + o;
  warp_merge_ranges(part_s, part_i, lv, li, nq, qi, top_k, n_ranges, lane);
  if (!in_smem) return;
  for (int i = lane; i < top_k; i += 32) {
    out_s[o + i] = lv[i];
    out_i[o + i] = li[i];
  }
}

template <typename T>
cudaError_t launch(const void* tables, const uint32_t* db,
                   const uint32_t* valid, float* part_s, int32_t* part_i,
                   float* out_s, int32_t* out_i, int nq, int n, int w,
                   int bits, int top_k, int n_ranges, cudaStream_t st) {
  const int fp = (w * (32 / bits)) << bits;
  const int wp = w | 1;
  int tn = (8192 / wp) / 32 * 32;  // corpus tile of at most 32 KB
  tn = tn < 32 ? 32 : (tn > 256 ? 256 : tn);
  const size_t tab_bytes = (size_t)WARPS * fp * sizeof(T);
  const size_t lists =
      top_k <= SMEM_LIST_MAX ? 2 * (size_t)WARPS * top_k * 4 : 0;
  const size_t base = (size_t)tn * wp * 4 + lists;
  const int tab_in_smem = tab_bytes <= SMEM_TABLES_MAX &&
                          base + tab_bytes <= SMEM_BLOCK_MAX;
  const size_t smem = base + (tab_in_smem ? tab_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      lut_topk_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int rpr = (n + n_ranges - 1) / n_ranges;
  const dim3 grid((nq + WARPS - 1) / WARPS, n_ranges);
  lut_topk_partial<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(tables), db, valid, part_s, part_i, nq, n, w,
      bits, top_k, rpr, tn, fp, tab_in_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t msmem =
      top_k <= SMEM_LIST_MAX ? 2 * (size_t)WARPS * top_k * 4 : 0;
  err = cudaFuncSetAttribute(lut_topk_merge,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)msmem);
  if (err != cudaSuccess) return err;
  lut_topk_merge<<<(nq + WARPS - 1) / WARPS, THREADS, msmem, st>>>(
      part_s, part_i, out_s, out_i, nq, top_k, n_ranges);
  return cudaGetLastError();
}

int launch_any(const void* tables, int tab_dtype, const uint32_t* db,
               const uint32_t* valid, float* part_s, int32_t* part_i,
               float* out_s, int32_t* out_i, int nq, int n, int w, int bits,
               int top_k, int n_ranges, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(tab_dtype == 0
                   ? launch<float>(tables, db, valid, part_s, part_i, out_s,
                                   out_i, nq, n, w, bits, top_k, n_ranges, st)
                   : launch<uint16_t>(tables, db, valid, part_s, part_i,
                                      out_s, out_i, nq, n, w, bits, top_k,
                                      n_ranges, st));
}

}  // namespace

// tab_dtype: 0 float32, 1 bf16. part_s/part_i: scratch
// [n_ranges, nq, top_k]; out: [nq, top_k].
extern "C" int packed_lut_topk_launch(const void* tables, int tab_dtype,
                                      const uint32_t* db, float* part_s,
                                      int32_t* part_i, float* out_s,
                                      int32_t* out_i, int nq, int n, int w,
                                      int bits, int top_k, int n_ranges,
                                      void* stream) {
  return launch_any(tables, tab_dtype, db, nullptr, part_s, part_i, out_s,
                    out_i, nq, n, w, bits, top_k, n_ranges, stream);
}

// valid: the rows' bitmask, uint32 [ceil(n/32)].
extern "C" int packed_lut_topk_masked_launch(
    const void* tables, int tab_dtype, const uint32_t* db,
    const uint32_t* valid, float* part_s, int32_t* part_i, float* out_s,
    int32_t* out_i, int nq, int n, int w, int bits, int top_k, int n_ranges,
    void* stream) {
  return launch_any(tables, tab_dtype, db, valid, part_s, part_i, out_s,
                    out_i, nq, n, w, bits, top_k, n_ranges, stream);
}
