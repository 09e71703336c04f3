// Re-rank of gathered per-query candidates by LUT score.
//
// Replaces src/repro/kernels/packed_lut.py::packed_lut_rerank_pallas:
// float32 or bf16 tables [Q, F*P], candidate words [Q, M, W] and their
// validity [Q, M] -> the stable top_k by (score desc, position asc) as
// (scores float32, positions int32) [Q, top_k]; invalid candidates score
// -inf and empty slots are (-inf, -1). Two kernels; the wrapper's
// rerank_plan picks one by shape, before the launch, and a failed launch
// raises.
//
// Bound on this card: bytes, and at the main path's sizes (Q = 256,
// M = 64, W = 16, 2-bit) barely those: about 2.1 MB of tables and
// candidate words, under a microsecond at 3.35 TB/s. The scoring is one
// table lookup and one float add per (candidate, field): Q*M*F = 4.2M of
// each. Its latency floor is one candidate's chain of F = 256 dependent
// rounded adds (the reference's order), about 4 clocks each: 0.52 us at
// 1.98 GHz. So what a call costs is latency: the launch, the table's
// trip from device memory, the chain, the selection.
//
// lut_rerank_warp, for 1-, 2- and 4-bit codes and M <= 128 whose table
// and candidates fit a warp's shared memory: one warp a query, several
// queries a block. The warp copies its query's table row (16-byte
// cp.async) and its M candidates' words (4-byte cp.async, rows at an odd
// word stride, so the 32 rows a load reads sit in 32 banks) into its own
// shared memory, all in flight at once. Each lane scores candidates lane,
// lane + 32, ... (CPL of them, compiled in) in the (word, field) order of
// lut_common.cuh, the field loop unrolled at the compiled width (its
// shifts and masks constants), the CPL chains interleaved; the validity
// flags load beside the copies. Selection stays in registers: each lane
// holds its candidates' unique 64-bit (score, -position) values
// (lut_common.cuh's select_value), and each round two warp reductions
// (__reduce_max_sync on the high, then the low 32 bits) find the best;
// its owner drops it. No device-memory scratch, no block barrier.
//
// lut_rerank, the block form, for the other shapes (M in the thousands,
// 8- and 16-bit tables): one block takes one query: its table row goes to
// shared memory when it fits (96 KB; 8- and 16-bit tables can exceed it
// and are read from device memory), each thread scores candidates in the
// same order into a [Q, M] scratch, and the block selects the top_k by
// repeated block-wide maxima over the same unique values, so equal scores
// go to the lower position as in the stable sort. M is unbounded: the
// selection rescans only the winner's strided share.
#include "lut_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr size_t SMEM_TABLE_MAX = 96 * 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
lut_rerank(const T* __restrict__ tables, const uint32_t* __restrict__ cand,
           const uint8_t* __restrict__ valid, float* __restrict__ scratch,
           float* __restrict__ out_s, int32_t* __restrict__ out_pos, int m,
           int w, int bits, int top_k, int fp, int tab_in_smem) {
  extern __shared__ __align__(16) unsigned char score_smem[];
  uint64_t* red = reinterpret_cast<uint64_t*>(score_smem);
  T* stab = reinterpret_cast<T*>(red + 64);
  const int qi = blockIdx.x;
  const T* tab = tables + (size_t)qi * fp;
  if (tab_in_smem) {
    for (int i = threadIdx.x; i < fp; i += THREADS) stab[i] = tab[i];
    __syncthreads();
    tab = stab;
  }
  float* sc = scratch + (size_t)qi * m;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const size_t c = (size_t)qi * m + i;
    sc[i] = valid[c] ? score_row(tab, nullptr, cand + c * w, w, bits)
                     : -INFINITY;
  }
  __syncthreads();
  block_select(sc, m, [](int i) { return i; }, top_k,
               out_s + (size_t)qi * top_k, out_pos + (size_t)qi * top_k, red);
}

template <typename T>
cudaError_t launch(const void* tables, const uint32_t* cand,
                   const uint8_t* valid, float* scratch, float* out_s,
                   int32_t* out_pos, int nq, int m, int w, int bits,
                   int top_k, cudaStream_t st) {
  const int fp = (w * (32 / bits)) << bits;
  const size_t tab_bytes = (size_t)fp * sizeof(T);
  const int in_smem = tab_bytes <= SMEM_TABLE_MAX;
  const size_t smem = 64 * sizeof(uint64_t) + (in_smem ? tab_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      lut_rerank<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lut_rerank<T><<<nq, THREADS, smem, st>>>(
      static_cast<const T*>(tables), cand, valid, scratch, out_s, out_pos, m,
      w, bits, top_k, fp, in_smem);
  return cudaGetLastError();
}

// ---- lut_rerank_warp ---------------------------------------------------

// A warp's shared memory (the wrapper's packed_lut.rerank_plan mirrors
// it): the table row, rounded up to 16 bytes, then 32 CPL candidate rows
// of w | 1 words.
__host__ __device__ inline size_t rw_table_bytes(int fp, int elem) {
  return ((size_t)fp * elem + 15) / 16 * 16;
}
__host__ __device__ inline size_t rw_warp_bytes(int fp, int elem, int w,
                                                int cpl) {
  return rw_table_bytes(fp, elem) + (size_t)32 * cpl * (w | 1) * 4;
}

template <typename T, int BITS, int CPL>
__global__ void lut_rerank_warp(const T* __restrict__ tables,
                                const uint32_t* __restrict__ cand,
                                const uint8_t* __restrict__ valid,
                                float* __restrict__ out_s,
                                int32_t* __restrict__ out_pos, int nq, int m,
                                int w, int top_k, int fp, int tab16) {
  extern __shared__ __align__(16) unsigned char rw_smem[];
  constexpr int CPW = 32 / BITS, P = 1 << BITS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qi = blockIdx.x * (blockDim.x / 32) + warp;
  if (qi >= nq) return;  // the whole warp; no block barrier below
  const int wp = w | 1;
  unsigned char* mine =
      rw_smem + (size_t)warp * rw_warp_bytes(fp, sizeof(T), w, CPL);
  const T* stab = reinterpret_cast<const T*>(mine);
  uint32_t* cs =
      reinterpret_cast<uint32_t*>(mine + rw_table_bytes(fp, sizeof(T)));
  const T* tab = tables + (size_t)qi * fp;
  if (tab16)
    for (int e = lane; e < fp * (int)sizeof(T) / 16; e += 32)
      cp_async_16(smem_addr(mine + 16 * e),
                  reinterpret_cast<const unsigned char*>(tab) + 16 * e);
  // candidate words, row r (< 32 CPL) at r * wp; rows past m zero-filled;
  // element e = lane + 32 i at (row e / w, word e % w), stepped without a
  // division
  const uint32_t* cq = cand + (size_t)qi * m * w;
  {
    const int step_r = 32 / w, step_c = 32 % w;
    int r = lane / w, c = lane % w;
    while (r < 32 * CPL) {
      const bool ok = r < m;
      cp_async_4(smem_addr(cs + r * wp + c),
                 ok ? static_cast<const void*>(cq + (size_t)r * w + c)
                    : static_cast<const void*>(tab),
                 ok);
      r += step_r;
      c += step_c;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
  }
  cp_async_commit();
  // the validity flags, in flight beside the copies
  bool live[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int i = lane + 32 * c;
    live[c] = i < m && valid[(size_t)qi * m + i];
  }
  if (!tab16)
    for (int e = lane; e < fp; e += 32) const_cast<T*>(stab)[e] = tab[e];
  cp_async_wait<0>();
  __syncwarp();

  float s[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) s[c] = 0.0f;
  for (int j = 0; j < w; ++j) {
    uint32_t word[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) word[c] = cs[(lane + 32 * c) * wp + j];
    const T* t = stab + j * CPW * P;
#pragma unroll
    for (int f = 0; f < CPW; ++f)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        s[c] = __fadd_rn(
            s[c], entry(t, f * P + (int)((word[c] >> (f * BITS)) & (P - 1))));
  }

  uint64_t v[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    v[c] = live[c] ? select_value(s[c], lane + 32 * c) : 0ull;
  float* os = out_s + (size_t)qi * top_k;
  int32_t* op = out_pos + (size_t)qi * top_k;
  int r = 0;
  for (; r < top_k; ++r) {
    uint64_t best = v[0];
#pragma unroll
    for (int c = 1; c < CPL; ++c) best = v[c] > best ? v[c] : best;
    const uint32_t hi = (uint32_t)(best >> 32);
    const uint32_t mh = __reduce_max_sync(LUT_FULL, hi);
    const uint32_t ml =
        __reduce_max_sync(LUT_FULL, hi == mh ? (uint32_t)best : 0u);
    const uint64_t win = ((uint64_t)mh << 32) | ml;
    if (win == 0) break;  // warp-uniform: nothing is left
    if (lane == 0) {
      os[r] = select_score(win);
      op[r] = select_key(win);
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (v[c] == win) v[c] = 0ull;
  }
  for (int j = r + lane; j < top_k; j += 32) {
    os[j] = -INFINITY;
    op[j] = -1;
  }
}

template <typename T, int BITS, int CPL>
cudaError_t launch_warp_t(const void* tables, const uint32_t* cand,
                          const uint8_t* valid, float* out_s,
                          int32_t* out_pos, int nq, int m, int w, int top_k,
                          int warps, cudaStream_t st) {
  const int fp = (w * (32 / BITS)) << BITS;
  const size_t smem = (size_t)warps * rw_warp_bytes(fp, sizeof(T), w, CPL);
  const auto kernel = lut_rerank_warp<T, BITS, CPL>;
  if (smem > 48 * 1024) {  // above the default: opened for this size
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tab16 = reinterpret_cast<uintptr_t>(tables) % 16 == 0;
  kernel<<<(nq + warps - 1) / warps, 32 * warps, smem, st>>>(
      static_cast<const T*>(tables), cand, valid, out_s, out_pos, nq, m, w,
      top_k, fp, tab16);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch_warp_b(const void* tables, const uint32_t* cand,
                          const uint8_t* valid, float* out_s,
                          int32_t* out_pos, int nq, int m, int w, int top_k,
                          int cpl, int warps, cudaStream_t st) {
#define RW_ARGS tables, cand, valid, out_s, out_pos, nq, m, w, top_k, warps, st
  switch (cpl) {
    case 1: return launch_warp_t<T, BITS, 1>(RW_ARGS);
    case 2: return launch_warp_t<T, BITS, 2>(RW_ARGS);
    case 4: return launch_warp_t<T, BITS, 4>(RW_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef RW_ARGS
}

template <typename T>
cudaError_t launch_warp(const void* tables, const uint32_t* cand,
                        const uint8_t* valid, float* out_s, int32_t* out_pos,
                        int nq, int m, int w, int bits, int top_k, int cpl,
                        int warps, cudaStream_t st) {
  if (m > 32 * cpl || warps < 1 || warps > 32) return cudaErrorInvalidValue;
#define RW_ARGS tables, cand, valid, out_s, out_pos, nq, m, w, top_k, cpl, warps, st
  switch (bits) {
    case 1: return launch_warp_b<T, 1>(RW_ARGS);
    case 2: return launch_warp_b<T, 2>(RW_ARGS);
    case 4: return launch_warp_b<T, 4>(RW_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef RW_ARGS
}

}  // namespace

// tab_dtype: 0 float32, 1 bf16. The block form: scratch [nq, m] float32.
extern "C" int packed_lut_rerank_launch(const void* tables, int tab_dtype,
                                        const uint32_t* cand,
                                        const uint8_t* valid, float* scratch,
                                        float* out_s, int32_t* out_pos,
                                        int nq, int m, int w, int bits,
                                        int top_k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      tab_dtype == 0
          ? launch<float>(tables, cand, valid, scratch, out_s, out_pos, nq, m,
                          w, bits, top_k, st)
          : launch<uint16_t>(tables, cand, valid, scratch, out_s, out_pos, nq,
                             m, w, bits, top_k, st);
  return (int)err;
}

// The warp form of a plan (packed_lut.rerank_plan): bits 1, 2 or 4, CPL =
// cpl (1, 2 or 4) candidates a lane, m <= 32 cpl, `warps` queries a block.
extern "C" int packed_lut_rerank_warp_launch(const void* tables,
                                             int tab_dtype,
                                             const uint32_t* cand,
                                             const uint8_t* valid,
                                             float* out_s, int32_t* out_pos,
                                             int nq, int m, int w, int bits,
                                             int top_k, int cpl, int warps,
                                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      tab_dtype == 0
          ? launch_warp<float>(tables, cand, valid, out_s, out_pos, nq, m, w,
                               bits, top_k, cpl, warps, st)
          : launch_warp<uint16_t>(tables, cand, valid, out_s, out_pos, nq, m,
                                  w, bits, top_k, cpl, warps, st);
  return (int)err;
}
