// All-pairs collision counts over unpacked int32 codes.
//
// Replaces src/repro/kernels/collision.py::collision_counts_pallas:
// codes_q [Q, K] and codes_db [N, K], int32 of any value -> int32 [Q, N],
// counts[q, n] = #{j < K : codes_q[q, j] == codes_db[n, j]}. The TPU
// kernel pads K with sentinels that never match (-2 for queries, -1 for
// the corpus); here the loop stops at K, so nothing is padded.
//
// Bound on this card: operations. Each (query, row, position) is one
// int32 compare and one add (2*Q*N*K = 5.5e11 at Q = 256, N = 4,194,304,
// K = 256: 33 ms at 64 int32 results an SM a clock), against 4 bytes of
// codes a (row, position) and 4 bytes a count: 8.6 GB, 2.6 ms.
//
// Design. The TPU kernel tiles (queries, rows, K) with an int32
// accumulator in VMEM carried across the K grid steps. Here a block
// computes a BQ x BN tile of counts in registers: 256 threads in a
// 16 x 16 layout, each holding (BQ/16) x (BN/16) int32 accumulators,
// while the K axis streams through shared memory 32 positions at a time
// (query and corpus slabs, rows padded to 33 words so a warp's reads hit
// distinct banks). Each position a thread loads BQ/16 query codes and
// BN/16 corpus codes from shared memory and does (BQ/16)(BN/16)
// compare-adds. The counts are integers, so the tile sizes change no
// bit: BQ and BN (32, 64 or 128) are the wrapper's block_q and block_n.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256, KT = 32, KP = KT + 1;

template <int BQ, int BN>
__global__ void __launch_bounds__(THREADS)
collision_counts_kernel(const int32_t* __restrict__ cq,
                        const int32_t* __restrict__ cdb,
                        int32_t* __restrict__ out, int nq, int n, int k) {
  constexpr int TQ = BQ / 16, TN = BN / 16;
  __shared__ int32_t qs[BQ][KP];
  __shared__ int32_t ds[BN][KP];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * BQ;
  const int n0 = blockIdx.x * BN;
  int acc[TQ][TN];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < k; k0 += KT) {
    const int kt = min(KT, k - k0);
    __syncthreads();  // the previous slabs are consumed
    for (int e = threadIdx.x; e < BQ * KT; e += THREADS) {
      const int r = e / KT, c = e % KT;
      const int q = q0 + r;
      if (c < kt && q < nq) qs[r][c] = cq[(size_t)q * k + k0 + c];
    }
    for (int e = threadIdx.x; e < BN * KT; e += THREADS) {
      const int r = e / KT, c = e % KT;
      const int row = n0 + r;
      if (c < kt && row < n) ds[r][c] = cdb[(size_t)row * k + k0 + c];
    }
    __syncthreads();
    for (int c = 0; c < kt; ++c) {
      int a[TQ], b[TN];
#pragma unroll
      for (int i = 0; i < TQ; ++i) a[i] = qs[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ds[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] == b[j];
    }
  }
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= nq) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int row = n0 + tx + 16 * j;
      if (row < n) out[(size_t)q * n + row] = acc[i][j];
    }
  }
}

template <int BQ, int BN>
cudaError_t launch(const int32_t* cq, const int32_t* cdb, int32_t* out,
                   int nq, int n, int k, cudaStream_t st) {
  const dim3 grid((n + BN - 1) / BN, (nq + BQ - 1) / BQ);
  collision_counts_kernel<BQ, BN><<<grid, THREADS, 0, st>>>(cq, cdb, out, nq,
                                                            n, k);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t launch_bn(int block_n, const int32_t* cq, const int32_t* cdb,
                      int32_t* out, int nq, int n, int k, cudaStream_t st) {
  if (block_n == 32) return launch<BQ, 32>(cq, cdb, out, nq, n, k, st);
  if (block_n == 64) return launch<BQ, 64>(cq, cdb, out, nq, n, k, st);
  if (block_n == 128) return launch<BQ, 128>(cq, cdb, out, nq, n, k, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// out: [nq, n] int32; block_q, block_n: 32, 64 or 128.
extern "C" int collision_counts_launch(const int32_t* cq, const int32_t* cdb,
                                       int32_t* out, int nq, int n, int k,
                                       int block_q, int block_n,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (block_q == 32)
    return (int)launch_bn<32>(block_n, cq, cdb, out, nq, n, k, st);
  if (block_q == 64)
    return (int)launch_bn<64>(block_n, cq, cdb, out, nq, n, k, st);
  if (block_q == 128)
    return (int)launch_bn<128>(block_n, cq, cdb, out, nq, n, k, st);
  return (int)cudaErrorInvalidValue;
}
