// All-pairs collision counts on packed words.
//
// Replaces src/repro/kernels/packed_collision.py::
// packed_collision_counts_pallas: query words [Q, W] x corpus words
// [N, W] -> int32 counts [Q, N], count = k - sum_w popcount(fold(q XOR
// db)) with packed_topk.cu's field fold (topk_common.cuh).
//
// Bound on this card: operations. One popcount per (query, row, word),
// Q*N*W = 1.7e10 at the main path's LSH chunk (Q = 256, N = 4.2M,
// W = 16), 4.1 ms at the popcount rate, with the int32 pipe tied at
// b = 2; writing the [Q, N] result is 4.3 GB, 1.3 ms at 3.35 TB/s.
//
// Design. The TPU kernel tiles (query, row, word) and accumulates over
// word tiles in VMEM. Here a block of 128 threads takes 128 consecutive
// rows and qt queries (32 by default; the wrapper's block_q, which
// changes no bit): the queries' words sit in shared memory (read as
// broadcasts), each thread holds its row's words in registers (W <= 16
// or 64; wider rows are read from device memory) and writes its qt
// counts, so each warp's stores are 128 contiguous bytes of one output
// row. Every corpus word is read once per qt queries.
#include "topk_common.cuh"

namespace {

constexpr int ROWS = 128;

template <int WR>
__global__ void __launch_bounds__(ROWS)
packed_counts(const uint32_t* __restrict__ q, const uint32_t* __restrict__ db,
              int32_t* __restrict__ out, int nq, int n, int w, int bits,
              int k, int qt, uint32_t lsb) {
  extern __shared__ uint32_t qs[];  // [qt][w]
  const int q0 = blockIdx.y * qt;
  const int nqt = min(qt, nq - q0);
  for (int e = threadIdx.x; e < nqt * w; e += ROWS)
    qs[e] = q[(size_t)q0 * w + e];
  __syncthreads();
  const int row = blockIdx.x * ROWS + threadIdx.x;
  if (row >= n) return;
  const uint32_t* dr = db + (size_t)row * w;
  uint32_t r[WR > 0 ? WR : 1];
  if constexpr (WR > 0) {
#pragma unroll
    for (int j = 0; j < WR; ++j) r[j] = j < w ? dr[j] : 0u;
  }
  for (int i = 0; i < nqt; ++i) {
    const uint32_t* qw = qs + i * w;
    int mism = 0;
    if constexpr (WR > 0) {
#pragma unroll
      for (int j = 0; j < WR; ++j)
        if (j < w) mism += field_mismatches(qw[j] ^ r[j], bits, lsb);
    } else {
      for (int j = 0; j < w; ++j)
        mism += field_mismatches(qw[j] ^ dr[j], bits, lsb);
    }
    out[(size_t)(q0 + i) * n + row] = k - mism;
  }
}

template <int WR>
cudaError_t launch(const uint32_t* q, const uint32_t* db, int32_t* out,
                   int nq, int n, int w, int bits, int k, int qt,
                   uint32_t lsb, cudaStream_t st) {
  const size_t smem = (size_t)qt * w * 4;
  cudaError_t err = cudaFuncSetAttribute(
      packed_counts<WR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + ROWS - 1) / ROWS, (nq + qt - 1) / qt);
  packed_counts<WR><<<grid, ROWS, smem, st>>>(q, db, out, nq, n, w, bits, k,
                                              qt, lsb);
  return cudaGetLastError();
}

}  // namespace

// out: [nq, n] int32; qt: queries a block (their words in shared memory).
extern "C" int packed_counts_launch(const uint32_t* q, const uint32_t* db,
                                    int32_t* out, int nq, int n, int w,
                                    int bits, int k, int qt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t lsb = 0;
  for (int i = 0; i < 32 / bits; ++i) lsb |= 1u << (i * bits);
  cudaError_t err;
  if (w <= 16)
    err = launch<16>(q, db, out, nq, n, w, bits, k, qt, lsb, st);
  else if (w <= 64)
    err = launch<64>(q, db, out, nq, n, w, bits, k, qt, lsb, st);
  else
    err = launch<0>(q, db, out, nq, n, w, bits, k, qt, lsb, st);
  return (int)err;
}
