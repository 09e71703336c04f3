// Re-rank of gathered per-query candidates by LUT score.
//
// Replaces src/repro/kernels/packed_lut.py::packed_lut_rerank_pallas:
// float32 or bf16 tables [Q, F*P], candidate words [Q, M, W] and their
// validity [Q, M] -> the stable top_k by (score desc, position asc) as
// (scores float32, positions int32) [Q, top_k]; invalid candidates score
// -inf and empty slots are (-inf, -1).
//
// Bound on this card: bytes, and at the main path's sizes (Q = 256,
// M = 64, W = 16, 2-bit) barely those: about 2.1 MB of tables and
// candidate words, under a microsecond at 3.35 TB/s, so the launch
// itself is what a call costs. The scoring is one table lookup and one
// float add per (candidate, field): Q*M*F = 4.2M of each.
//
// Design. The TPU kernel streams the candidate axis through a running
// top-k merged with lax.top_k. Here one block takes one query: its
// table row goes to shared memory when it fits (4 KB at the main path;
// 8- and 16-bit tables can exceed it and are read from device memory),
// each thread scores candidates in the reference's (word, field) order
// (lut_common.cuh) into a [Q, M] scratch, and the block selects the
// top_k by repeated block-wide maxima over unique 64-bit (score, -position)
// values, so equal scores go to the lower position as in the stable sort.
// M is unbounded: the selection rescans only the winner's strided share.
#include "lut_common.cuh"

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

}  // namespace

// tab_dtype: 0 float32, 1 bf16. scratch: [nq, m] float32.
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
