// Full-corpus LUT-scored streaming top-k over bit-packed codes.
//
// Replaces src/repro/kernels/packed_lut.py::packed_lut_topk_pallas:
// float32 or bf16 tables [Q, F*P] and corpus words [N, W] -> the stable
// top_k by (score desc, id asc) as (scores float32, ids int32)
// [Q, top_k], (-inf, -1) in empty slots. A row's score adds, in
// (word, field) order from 0.0, the table entry each b-bit field selects
// (the order of lut_common.cuh's score_row and of
// ref.lut_scores_rowwise_ref; bf16 entries widen exactly on load). The
// [Q, N] score matrix never reaches device memory.
//
// packed_lut_topk_masked_launch replaces
// src/repro/kernels/packed_lut.py::packed_lut_topk_masked_pallas: the
// same over the rows whose bit is set in a validity bitmask [ceil(N/32)]
// (bit r % 32 of word r / 32 marks row r live). A dead row's score is
// never computed: it offers -inf, which never enters a list (lists start
// at -inf and an offer must strictly beat the last entry), so slots past
// the live count come back (-inf, -1), as the reference's oracle gives.
//
// Bound on this card: operations. Each (query, row, field) needs one
// float add, Q*N*F = 2.7e11 of them at the main path (Q = 256,
// N = 4,194,304, F = 256): 8.2 ms at 128 adds a clock per SM (132 SMs,
// 1.98 GHz), against N*W*4 bytes of corpus read once per query block.
// What binds the fields kernel below is shared memory: a warp's 16-byte
// load whose lanes read 4 or more distinct entries costs 4 wavefronts
// (scripts/lds_wavefront_probe.py), so each add's 4-byte operand takes a
// lane's share of the SM's 128 bytes a clock: 32.9 ms at the main path.
//
// Two kernels, chosen by bits and table size (the wrapper, lut_topk.py,
// states the rule):
//
// The fields kernel (bits 1, 2 and 4; templated on bits and on QB, the
// queries of a block, 8 or 16). Each of its 256 threads owns one row of
// a corpus tile and QB accumulators in registers: per field it decodes
// the code once (a constant shift and a mask), loads the field's entries
// for its QB queries with QB/4 16-byte shared-memory loads, and adds
// them, one __fadd_rn each, in (word, field) order from 0.0: every score
// keeps its bits. The block's QB tables sit in shared memory interleaved
// by query as [field][QB/4][code][4] float32 (bf16 widened on staging):
// one load's 32 lanes then read at most P distinct 16-byte entries,
// P*16 contiguous bytes, which share no bank below 4 bits (P <= 8). The
// code's offset ORs into the field's (a multiple of the slice's bytes),
// so a field costs a shift and a LOP3 besides its loads and adds. The
// corpus streams through two tiles of 256 rows filled by cp.async, the
// next while this one is scored; once a tile is scored its buffer takes
// the [QB][256] scores, and each warp offers its queries' scores in
// rising row order to their sorted lists (topk_common.cuh's offer_batch:
// strictly-beats, so ties keep the lower id). The grid is
// (query blocks) x (S contiguous corpus ranges); the wrapper's default S
// makes the grid whole waves of the card's resident blocks.
//
// The generic kernel (bits 8 and 16, and tables too large for the fields
// kernel): the grid is (query tiles of 8) x (S ranges), as in
// packed_topk.cu: the 8 warps of a block share corpus tiles staged in
// shared memory (odd row stride: distinct banks), each warp owns one
// query, whose table sits in shared memory when the block's 8 tables fit
// in 96 KB beside the tile and lists (8- and 16-bit tables are read from
// device memory), and scores one row a lane with score_row.
//
// Both write per-range lists [S, Q, top_k]; a second kernel merges the S
// lists of each query in range order under the same rule. Lists of up to
// 2048 entries live in shared memory where they fit, longer ones in the
// scratch and output (any top_k).
#include <type_traits>

#include "topk_common.cuh"
#include "lut_common.cuh"

namespace {

constexpr size_t SMEM_TABLES_MAX = 96 * 1024;
constexpr size_t SMEM_BLOCK_MAX = 232448;  // 227 KB: a block's most

// ---- the generic kernel -----------------------------------------------

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

template <typename T>
cudaError_t launch_generic(const void* tables, const uint32_t* db,
                           const uint32_t* valid, float* part_s,
                           int32_t* part_i, int nq, int n, int w, int bits,
                           int top_k, int n_ranges, cudaStream_t st) {
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
  return cudaGetLastError();
}

// ---- the fields kernel --------------------------------------------------

constexpr int FT = 256;  // threads a block = corpus rows a tile

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src)
               : "memory");
}

// One row's QB scores: stab is the [F][QB/4][P][4] float32 tables at the
// start of dynamic shared memory, row the row's w words. Field (j, f)'s
// code selects 16 bytes of each of its QB/4 chunks; acc[q] adds them in
// (word, field) order from 0.0.
template <int BITS, int QB>
__device__ __forceinline__ void score_fields(const unsigned char* stab,
                                             const uint32_t* row, int w,
                                             float* acc) {
  constexpr int CPW = 32 / BITS, P = 1 << BITS;
  constexpr int FB = P * QB * 4;   // bytes of one field's slice
  constexpr int CB = P * 16;       // bytes of one chunk of it
  constexpr uint32_t CODE = (uint32_t)(P - 1) << 4;
#pragma unroll
  for (int q = 0; q < QB; ++q) acc[q] = 0.0f;
  for (int j = 0; j < w; ++j) {
    const uint32_t word = row[j];
    // a multiple of FB: the code's offset (below CB <= FB) ORs into it
    const uint32_t base = (uint32_t)j * (CPW * FB);
#pragma unroll
    for (int f = 0; f < CPW; ++f) {
      const int sh = f * BITS;  // the code's 16-byte entries: shift to bit 4
      const uint32_t code = sh >= 4 ? word >> (sh - 4) : word << (4 - sh);
      const unsigned char* e = stab + ((code & CODE) | base) + f * FB;
#pragma unroll
      for (int c = 0; c < QB / 4; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(e + c * CB);
        acc[4 * c + 0] = __fadd_rn(acc[4 * c + 0], v.x);
        acc[4 * c + 1] = __fadd_rn(acc[4 * c + 1], v.y);
        acc[4 * c + 2] = __fadd_rn(acc[4 * c + 2], v.z);
        acc[4 * c + 3] = __fadd_rn(acc[4 * c + 3], v.w);
      }
    }
  }
}

// rows [t0, t0 + rows) of db into a tile [FT][tw], one word a copy by
// cp.async, committed as one group: element e of the flat block is
// (row e / w, word e % w), stepped without a division
__device__ __forceinline__ void load_tile(uint32_t* tile,
                                          const uint32_t* __restrict__ db,
                                          int t0, int rows, int w, int tw) {
  const int dr = FT / w, dj = FT % w;
  const uint32_t* src = db + (size_t)t0 * w;
  int r = threadIdx.x / w, j = threadIdx.x % w;
  for (int e = threadIdx.x; e < rows * w; e += FT) {
    cp_async4(tile + r * tw + j, src + e);
    r += dr;
    j += dj;
    if (j >= w) {
      j -= w;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Dynamic shared memory: the tables [F][QB/4][P][4] float32, two corpus
// tiles [FT][tw] (tw = max(w, QB) | 1, odd: a thread's row reads hit
// distinct banks; a scored tile's buffer then holds the scores
// [QB][FT]), and, when lists_in_smem, the QB lists' scores then ids.
// Two blocks an SM, as the main path's layout allows: without the bound
// the compiler keeps 48-64 registers and spills.
template <int BITS, int QB, typename T>
__global__ void __launch_bounds__(FT, 2)
lut_topk_fields(const T* __restrict__ tables, const uint32_t* __restrict__ db,
                const uint32_t* __restrict__ valid,
                float* __restrict__ part_s, int32_t* __restrict__ part_i,
                int nq, int n, int w, int top_k, int rows_per_range,
                int lists_in_smem) {
  constexpr int CPW = 32 / BITS, P = 1 << BITS;
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int fp = w * CPW * P;
  const int tw = max(w, QB) | 1;
  float* stab = reinterpret_cast<float*>(fsmem);
  uint32_t* tiles = reinterpret_cast<uint32_t*>(stab + (size_t)fp * QB);
  float* lists = reinterpret_cast<float*>(tiles + 2 * FT * tw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QB;

  // stage: destination d = ((i / P) * QB/4 + c) * 4P + (i % P) * 4 + qq
  // holds entry i of query q0 + 4c + qq
  for (int d = tid; d < fp * QB; d += FT) {
    const int qi = q0 + 4 * ((d / (4 * P)) % (QB / 4)) + d % 4;
    const int i = d / (P * QB) * P + (d / 4) % P;
    stab[d] = qi < nq ? entry(tables + (size_t)qi * fp, i) : 0.0f;
  }
  // query q0 + q's list: [QB][top_k] in shared memory, or the range's
  // partial list itself ([S, nq, top_k] from part_s/part_i)
  const size_t o = ((size_t)blockIdx.y * nq + q0) * top_k;
  float* ls = lists_in_smem ? lists : part_s + o;
  int* li = lists_in_smem ? reinterpret_cast<int*>(lists + QB * top_k)
                          : part_i + o;
  for (int q = warp; q < QB; q += FT / 32)
    if (q0 + q < nq)
      for (int i = lane; i < top_k; i += 32) {
        ls[q * top_k + i] = -INFINITY;
        li[q * top_k + i] = -1;
      }

  const int r0 = blockIdx.y * rows_per_range;
  const int r1 = min(n, r0 + rows_per_range);
  if (r0 < r1) load_tile(tiles, db, r0, min(FT, r1 - r0), w, tw);
  int b = 0;
  for (int t0 = r0; t0 < r1; t0 += FT, b ^= 1) {
    const int rows = min(FT, r1 - t0);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // tile t0 is in; the last tile's offers are done
    if (t0 + FT < r1)
      load_tile(tiles + (b ^ 1) * FT * tw, db, t0 + FT,
                min(FT, r1 - t0 - FT), w, tw);
    uint32_t* tile = tiles + b * FT * tw;
    const int row = t0 + tid;
    float acc[QB];
    if (tid < rows &&
        (valid == nullptr || ((valid[row >> 5] >> (row & 31)) & 1u))) {
      score_fields<BITS, QB>(fsmem, tile + tid * tw, w, acc);
    } else {
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] = -INFINITY;
    }
    __syncthreads();  // every row is read: the buffer takes the scores
    float* sc = reinterpret_cast<float*>(tile);
#pragma unroll
    for (int q = 0; q < QB; ++q) sc[q * FT + tid] = acc[q];
    __syncthreads();
    for (int q = warp; q < QB; q += FT / 32) {
      if (q0 + q >= nq) continue;  // warp-uniform
      for (int c = 0; c < rows; c += 32) {
        const float s = c + lane < rows ? sc[q * FT + c + lane] : -INFINITY;
        offer_batch(ls + q * top_k, li + q * top_k, top_k, s, t0 + c + lane,
                    lane);
      }
    }
  }
  if (lists_in_smem)  // each warp copies out the lists it alone wrote
    for (int q = warp; q < QB; q += FT / 32)
      if (q0 + q < nq)
        for (int i = q * top_k + lane; i < (q + 1) * top_k; i += 32) {
          part_s[o + i] = ls[i];
          part_i[o + i] = li[i];
        }
}

template <int BITS, int QB, typename T>
cudaError_t launch_fields(const void* tables, const uint32_t* db,
                          const uint32_t* valid, float* part_s,
                          int32_t* part_i, int nq, int n, int w, int top_k,
                          int n_ranges, int smem, int lists_in_smem,
                          cudaStream_t st) {
  const size_t fp = (size_t)w * (32 / BITS) << BITS;
  const int tw = (w > QB ? w : QB) | 1;
  const size_t need = fp * QB * 4 + 2 * (size_t)FT * tw * 4 +
                      (lists_in_smem ? 2 * (size_t)QB * top_k * 4 : 0);
  if ((size_t)smem < need || (size_t)smem > SMEM_BLOCK_MAX)
    return cudaErrorInvalidValue;
  auto kern = lut_topk_fields<BITS, QB, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rpr = (n + n_ranges - 1) / n_ranges;
  const dim3 grid((nq + QB - 1) / QB, n_ranges);
  kern<<<grid, FT, smem, st>>>(static_cast<const T*>(tables), db, valid,
                               part_s, part_i, nq, n, w, top_k, rpr,
                               lists_in_smem);
  return cudaGetLastError();
}

template <int BITS, int QB, typename T>
cudaError_t fields_occupancy(int smem, int* blocks) {
  auto kern = lut_topk_fields<BITS, QB, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, FT,
                                                       smem);
}

template <int V>
using int_c = std::integral_constant<int, V>;

// fn(int_c<BITS>, int_c<QB>, T{}) for the run-time (tab_dtype, bits, qb)
template <typename Fn>
cudaError_t with_fields(int tab_dtype, int bits, int qb, Fn&& fn) {
  auto by_qb = [&](auto b, auto t) -> cudaError_t {
    if (qb == 8) return fn(b, int_c<8>{}, t);
    if (qb == 16) return fn(b, int_c<16>{}, t);
    return cudaErrorInvalidValue;
  };
  auto by_bits = [&](auto t) -> cudaError_t {
    if (bits == 1) return by_qb(int_c<1>{}, t);
    if (bits == 2) return by_qb(int_c<2>{}, t);
    if (bits == 4) return by_qb(int_c<4>{}, t);
    return cudaErrorInvalidValue;
  };
  return tab_dtype == 0 ? by_bits(float{}) : by_bits(uint16_t{});
}

// ---- the merge, and the launch of both ---------------------------------

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

int launch_any(const void* tables, int tab_dtype, const uint32_t* db,
               const uint32_t* valid, float* part_s, int32_t* part_i,
               float* out_s, int32_t* out_i, int nq, int n, int w, int bits,
               int top_k, int n_ranges, int qb, int smem, int lists_in_smem,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (qb == 0)
    err = tab_dtype == 0
              ? launch_generic<float>(tables, db, valid, part_s, part_i, nq,
                                      n, w, bits, top_k, n_ranges, st)
              : launch_generic<uint16_t>(tables, db, valid, part_s, part_i,
                                         nq, n, w, bits, top_k, n_ranges, st);
  else
    err = with_fields(tab_dtype, bits, qb, [&](auto b, auto q, auto t) {
      return launch_fields<decltype(b)::value, decltype(q)::value,
                           decltype(t)>(tables, db, valid, part_s, part_i,
                                        nq, n, w, top_k, n_ranges, smem,
                                        lists_in_smem, st);
    });
  if (err != cudaSuccess) return (int)err;
  const size_t msmem =
      top_k <= SMEM_LIST_MAX ? 2 * (size_t)WARPS * top_k * 4 : 0;
  err = cudaFuncSetAttribute(lut_topk_merge,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)msmem);
  if (err != cudaSuccess) return (int)err;
  lut_topk_merge<<<(nq + WARPS - 1) / WARPS, THREADS, msmem, st>>>(
      part_s, part_i, out_s, out_i, nq, top_k, n_ranges);
  return (int)cudaGetLastError();
}

}  // namespace

// tab_dtype: 0 float32, 1 bf16. part_s/part_i: scratch
// [n_ranges, nq, top_k]; out: [nq, top_k]. qb: 0 for the generic kernel,
// else the fields kernel's queries a block (8 or 16), with smem bytes of
// dynamic shared memory (the wrapper's layout, checked here) and the
// lists there when lists_in_smem.
extern "C" int packed_lut_topk_launch(const void* tables, int tab_dtype,
                                      const uint32_t* db, float* part_s,
                                      int32_t* part_i, float* out_s,
                                      int32_t* out_i, int nq, int n, int w,
                                      int bits, int top_k, int n_ranges,
                                      int qb, int smem, int lists_in_smem,
                                      void* stream) {
  return launch_any(tables, tab_dtype, db, nullptr, part_s, part_i, out_s,
                    out_i, nq, n, w, bits, top_k, n_ranges, qb, smem,
                    lists_in_smem, stream);
}

// valid: the rows' bitmask, uint32 [ceil(n/32)].
extern "C" int packed_lut_topk_masked_launch(
    const void* tables, int tab_dtype, const uint32_t* db,
    const uint32_t* valid, float* part_s, int32_t* part_i, float* out_s,
    int32_t* out_i, int nq, int n, int w, int bits, int top_k, int n_ranges,
    int qb, int smem, int lists_in_smem, void* stream) {
  return launch_any(tables, tab_dtype, db, valid, part_s, part_i, out_s,
                    out_i, nq, n, w, bits, top_k, n_ranges, qb, smem,
                    lists_in_smem, stream);
}

// The fields kernel's resident blocks an SM at smem bytes of dynamic
// shared memory, into *blocks.
extern "C" int lut_topk_fields_occupancy(int tab_dtype, int bits, int qb,
                                         int smem, int* blocks) {
  return (int)with_fields(tab_dtype, bits, qb, [&](auto b, auto q, auto t) {
    return fields_occupancy<decltype(b)::value, decltype(q)::value,
                            decltype(t)>(smem, blocks);
  });
}
