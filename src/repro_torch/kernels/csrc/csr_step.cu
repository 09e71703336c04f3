// The CSR step for a group of G consecutive units of R, deterministic and
// in place: for each unit u of the group in ascending order, acc[row] +=
// val * R_u[col - lo_u] for each of the row's entries whose column lies in
// unit u, in CSR order. G = 1 is the step of one unit.
//
// Stands in for src/repro/encode/encoder.py:100 (_sparse_step), which
// JAX runs as a gather and a segment_sum outside any Pallas kernel, one
// unit at a time. The sum order is the one XLA gives it: units in
// ascending order; XLA folds acc + segment_sum(contrib) into one
// scatter-add onto acc, so within a unit each product, rounded
// (__fmul_rn), is added straight to its row of acc (__fadd_rn, never
// contracted into an FMA), the row's entries in CSR order. Duplicate
// columns of a row are added like any other entries. No float atomics:
// one warp owns one row for the whole group, so the result does not
// depend on scheduling, and it is bit-identical to G steps of one unit.
//
// Bound on this card: bytes. A launch reads every column id of the
// chunk once (for all G units, where a step of one unit read them once a
// unit), and reads and writes the row's k sums once (the sums of all G
// units stay in registers: 8 a lane, a pass of 256 columns; larger k
// takes more passes). A row without an entry in the group is neither
// read nor written. The group's R (G x r_unit x k, 32 MB at G = 8, r_unit
// 4,096, k = 256) stays in the 50 MB L2, so each entry's R row is a
// gather from L2, as float4 (or 4 bf16) a lane; the CSR arrays and acc
// are streamed evict-first. The chain indptr -> indices -> acc is
// latency-bound, so each warp loads the next row's column ids and the
// row after's bounds before it works on its row, and the grid holds as
// many warps as fit on the card (blocks of 4 warps; MIN_BLOCKS holds a
// thread to 128 registers, and the float32 path takes about 70, so 7
// blocks fit an SM). A
// row of up to 128 entries keeps its column ids in registers (4 a lane);
// a longer row is read again from memory for each unit it touches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int IDS = 4;             // column ids a lane holds: 128 a row
constexpr int CPT = 8;             // sums a lane holds: 256 columns a pass
constexpr int MIN_BLOCKS = 4;      // resident blocks an SM the registers allow
constexpr unsigned FULL = 0xffffffffu;

// The streamed operands (the CSR arrays and acc) are loaded and stored
// evict-first (__ldcs, __stcs), so that they push less of the group's R
// out of L2; R's rows are read through the read-only path (__ldg).
template <typename T>
__device__ __forceinline__ T ld_stream(const T* p) {
  return __ldcs(p);
}
__device__ __forceinline__ int64_t ld_stream(const int64_t* p) {
  return (int64_t)__ldcs(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(uint16_t v) {  // bf16 bits, exact
  return __uint_as_float((uint32_t)v << 16);
}

struct Group {
  int lo;          // first column of the group
  unsigned span;   // columns of the group: units lo/ru .. up to G*ru
  int ru;          // columns a unit (r_unit; the width itself when G = 1)
  int ru_shift;    // log2(ru) for a power of two (31 when G = 1), else -1
  int64_t slot;    // elements between the units of the R buffer
};

// unit of the group of a column offset lc in [0, span)
__device__ __forceinline__ int unit_of(int lc, const Group& gr) {
  return gr.ru_shift >= 0 ? lc >> gr.ru_shift : lc / gr.ru;
}

// The lane's column of sum j in the pass at c0: VEC (k % 4 == 0) holds
// two runs of 4 adjacent columns, c0 + 4*lane and c0 + 128 + 4*lane, so
// that acc and R move as 16-byte (8-byte for bf16) vectors; else
// c0 + lane + 32*j.
template <bool VEC>
__device__ __forceinline__ int col_of(int c0, int lane, int j) {
  return VEC ? c0 + 128 * (j >> 2) + 4 * lane + (j & 3) : c0 + lane + 32 * j;
}

template <bool VEC>
__device__ __forceinline__ void load_acc(float (&part)[CPT], const float* a,
                                         int c0, int k, int lane) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col_of<true>(c0, lane, 4 * h);
      if (c < k) {
        const float4 v = ld_stream(reinterpret_cast<const float4*>(a + c));
        part[4 * h] = v.x, part[4 * h + 1] = v.y;
        part[4 * h + 2] = v.z, part[4 * h + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = col_of<false>(c0, lane, j);
      part[j] = c < k ? ld_stream(a + c) : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_acc(const float (&part)[CPT], float* a,
                                          int c0, int k, int lane) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col_of<true>(c0, lane, 4 * h);
      if (c < k)
        __stcs(reinterpret_cast<float4*>(a + c),
               make_float4(part[4 * h], part[4 * h + 1], part[4 * h + 2],
                           part[4 * h + 3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = col_of<false>(c0, lane, j);
      if (c < k) __stcs(a + c, part[j]);
    }
  }
}

// part += val * rr[columns of the pass], each product rounded, then added
template <typename T, bool VEC>
__device__ __forceinline__ void add_row(float (&part)[CPT],
                                        const T* __restrict__ rr, float val,
                                        int c0, int k, int lane) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col_of<true>(c0, lane, 4 * h);
      if (c >= k) continue;
      float x[4];
      if constexpr (sizeof(T) == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(rr + c));
        x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(rr + c));
        x[0] = __uint_as_float(v.x << 16);
        x[1] = __uint_as_float(v.x & 0xFFFF0000u);
        x[2] = __uint_as_float(v.y << 16);
        x[3] = __uint_as_float(v.y & 0xFFFF0000u);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[4 * h + q] = __fadd_rn(part[4 * h + q], __fmul_rn(val, x[q]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = col_of<false>(c0, lane, j);
      if (c < k)
        part[j] = __fadd_rn(part[j], __fmul_rn(val, as_f32(__ldg(rr + c))));
    }
  }
}

// Adds the entries of unit g held by the warp's lanes (column offset lc
// from the group's first column, g_of the lane's unit or -1, value v), in
// lane order: CSR order within one 32-entry slice of the row.
template <typename T, bool VEC>
__device__ __forceinline__ void add_slice(float (&part)[CPT],
                                          const T* __restrict__ r, int lc,
                                          int g_of, float v, int g,
                                          const Group& gr, int c0, int k,
                                          int lane) {
  unsigned hits = __ballot_sync(FULL, g_of == g);
  const T* rg = r + (int64_t)g * gr.slot;
  while (hits) {
    const int src = __ffs(hits) - 1;
    hits &= hits - 1;
    const int col = __shfl_sync(FULL, lc, src) - g * gr.ru;
    const float val = __shfl_sync(FULL, v, src);
    add_row<T, VEC>(part, rg + (size_t)col * k, val, c0, k, lane);
  }
}

// One row of up to 128 entries [a, b) whose column ids the lanes hold.
template <typename T, bool VEC>
__device__ __forceinline__ void short_row(float* __restrict__ acc_row,
                                          const float* __restrict__ data,
                                          const T* __restrict__ r,
                                          const int (&ids)[IDS], int64_t a,
                                          int64_t b, const Group& gr, int k,
                                          int lane) {
  int lc[IDS], g_of[IDS];
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < IDS; ++j) {
    lc[j] = ids[j] - gr.lo;
    g_of[j] = (unsigned)lc[j] < gr.span ? unit_of(lc[j], gr) : -1;
    if (g_of[j] >= 0) mask |= 1u << g_of[j];
  }
  mask = __reduce_or_sync(FULL, mask);
  if (!mask) return;
  float v[IDS];
#pragma unroll
  for (int j = 0; j < IDS; ++j)  // values of the group's entries only
    v[j] = g_of[j] >= 0 ? ld_stream(data + a + 32 * j + lane) : 0.f;
  for (int c0 = 0; c0 < k; c0 += 32 * CPT) {
    float part[CPT];
    load_acc<VEC>(part, acc_row, c0, k, lane);
    for (unsigned m = mask; m; m &= m - 1) {
      const int g = __ffs(m) - 1;
#pragma unroll
      for (int j = 0; j < IDS; ++j)
        if (a + 32 * j < b)
          add_slice<T, VEC>(part, r, lc[j], g_of[j], v[j], g, gr, c0, k,
                            lane);
    }
    store_acc<VEC>(part, acc_row, c0, k, lane);
  }
}

// A row of more than 128 entries: its ids are read once to find the
// units it touches, then once more for each of them.
template <typename T, bool VEC>
__device__ void long_row(float* __restrict__ acc_row,
                         const int32_t* __restrict__ indices,
                         const float* __restrict__ data,
                         const T* __restrict__ r, int64_t a, int64_t b,
                         const Group& gr, int k, int lane) {
  unsigned mask = 0;
  for (int64_t base = a; base < b; base += 32) {
    const int64_t e = base + lane;
    const int lc = e < b ? ld_stream(indices + e) - gr.lo : -1;
    if ((unsigned)lc < gr.span) mask |= 1u << unit_of(lc, gr);
  }
  mask = __reduce_or_sync(FULL, mask);
  if (!mask) return;
  for (int c0 = 0; c0 < k; c0 += 32 * CPT) {
    float part[CPT];
    load_acc<VEC>(part, acc_row, c0, k, lane);
    for (unsigned m = mask; m; m &= m - 1) {
      const int g = __ffs(m) - 1;
      for (int64_t base = a; base < b; base += 32) {
        const int64_t e = base + lane;
        const int lc = e < b ? ld_stream(indices + e) - gr.lo : -1;
        const int g_of = (unsigned)lc < gr.span ? unit_of(lc, gr) : -1;
        const float v = g_of == g ? ld_stream(data + e) : 0.f;
        add_slice<T, VEC>(part, r, lc, g_of, v, g, gr, c0, k, lane);
      }
    }
    store_acc<VEC>(part, acc_row, c0, k, lane);
  }
}

// the column ids of a row of up to 128 entries, -1 past its end
__device__ __forceinline__ void load_ids(int (&ids)[IDS],
                                         const int32_t* __restrict__ indices,
                                         int64_t a, int64_t b, int lane) {
#pragma unroll
  for (int j = 0; j < IDS; ++j) {
    const int64_t e = a + 32 * j + lane;
    ids[j] = (b - a <= 32 * IDS && e < b) ? ld_stream(indices + e) : -1;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
csr_group_step_kernel(float* __restrict__ acc,
                      const int64_t* __restrict__ indptr,
                      const int32_t* __restrict__ indices,
                      const float* __restrict__ data,
                      const T* __restrict__ r, Group gr, int64_t n_rows,
                      int k) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * WARPS;
  int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  // software pipeline: this row's bounds and ids, the next row's bounds
  int64_t a = 0, b = 0, na = 0, nb = 0;
  if (row < n_rows)
    a = ld_stream(indptr + row), b = ld_stream(indptr + row + 1);
  if (row + n_warps < n_rows)
    na = ld_stream(indptr + row + n_warps),
    nb = ld_stream(indptr + row + n_warps + 1);
  int ids[IDS];
  load_ids(ids, indices, a, b, lane);
  for (; row < n_rows; row += n_warps) {
    int nids[IDS];
    load_ids(nids, indices, na, nb, lane);
    int64_t na2 = 0, nb2 = 0;
    if (row + 2 * n_warps < n_rows)
      na2 = ld_stream(indptr + row + 2 * n_warps),
      nb2 = ld_stream(indptr + row + 2 * n_warps + 1);
    float* acc_row = acc + (size_t)row * k;
    if (b - a <= 32 * IDS)
      short_row<T, VEC>(acc_row, data, r, ids, a, b, gr, k, lane);
    else
      long_row<T, VEC>(acc_row, indices, data, r, a, b, gr, k, lane);
    a = na, b = nb, na = na2, nb = nb2;
#pragma unroll
    for (int j = 0; j < IDS; ++j) ids[j] = nids[j];
  }
}

template <typename T, bool VEC>
int launch(float* acc, const int64_t* indptr, const int32_t* indices,
           const float* data, const void* r, const Group& gr, int64_t n_rows,
           int k, cudaStream_t stream) {
  auto kern = csr_group_step_kernel<T, VEC>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // every resident warp walks rows (grid-stride); no more than the rows
  int64_t blocks = (n_rows + WARPS - 1) / WARPS;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  csr_group_step_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      acc, indptr, indices, data, static_cast<const T*>(r), gr, n_rows, k);
  return (int)cudaGetLastError();
}

}  // namespace

// acc float32 [n_rows, k]; indptr int64 [n_rows + 1]; indices int32 and
// data float32 [nnz]; r [G, ru, k] float32 (r_bf16 = 0) or bf16 bits
// (r_bf16 = 1), unit g of the group at r + g * ru * k and covering
// columns [lo + g * ru, lo + (g + 1) * ru) within [lo, lo + span);
// (G - 1) * ru < span <= G * ru and G <= 32.
extern "C" int csr_group_step_launch(float* acc, const int64_t* indptr,
                                     const int32_t* indices,
                                     const float* data, const void* r,
                                     int r_bf16, int64_t n_rows, int k,
                                     int lo, int span, int ru, int n_units,
                                     void* stream) {
  if (n_rows == 0 || k == 0 || span <= 0) return 0;
  if (ru <= 0 || n_units < 1 || n_units > 32 ||
      (int64_t)(n_units - 1) * ru >= span || (int64_t)n_units * ru < span)
    return (int)cudaErrorInvalidValue;
  Group gr;
  gr.lo = lo;
  gr.span = (unsigned)span;
  gr.ru = ru;
  gr.ru_shift = n_units == 1           ? 31
                : (ru & (ru - 1)) == 0 ? __builtin_ctz(ru)
                                       : -1;
  gr.slot = (int64_t)ru * k;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = k % 4 == 0;
  if (r_bf16)
    return vec ? launch<uint16_t, true>(acc, indptr, indices, data, r, gr,
                                        n_rows, k, st)
               : launch<uint16_t, false>(acc, indptr, indices, data, r, gr,
                                         n_rows, k, st);
  return vec ? launch<float, true>(acc, indptr, indices, data, r, gr, n_rows,
                                   k, st)
             : launch<float, false>(acc, indptr, indices, data, r, gr, n_rows,
                                    k, st);
}
