// Coded projection on Hopper: z = x @ R in IEEE float32, then the coding
// scheme (and, for encode_fused, the b-bit pack) applied to the
// accumulator tile in registers and shared memory.
//
// Replaces two TPU kernels of the JAX reference:
//   coded_project  <- src/repro/kernels/proj_code.py::coded_project_pallas
//                     (int32 codes [M, K])
//   encode_fused   <- src/repro/kernels/encode_fused.py::encode_fused_pallas
//                     (packed uint32 words [M, ceil(K*b/32)])
//
// Bound on this card: at the main path's shape (D = 1024, K = 256) the
// product does 2*M*D*K flops on (M*D + D*K)*4 bytes, about 128 flops a
// byte, far above the float32 ridge, so the float32 CUDA-core rate bounds
// it. The parity contract is IEEE float32 (no TF32, no tensor cores), so
// this is a shared-memory tiled SIMT GEMM: a 128x64 output tile per
// block of 128 threads, 16-deep slabs of x and R staged in shared memory
// with register prefetch of the next slab (double buffering), 8x8
// outputs a thread accumulated with fmaf in k order. What the design
// keeps out of device memory is what the TPU kernel keeps out of HBM:
// neither the float32 projections nor (for encode_fused) the int32 codes
// are ever written; the only write-back is codes or packed words.
//
// Uniform and offset codes take floor(z / w) with a true IEEE division,
// as the reference oracle does (build without --use_fast_math). Fields
// past K are code 0. The 64-column tile holds whole words for every
// bits in {1, 2, 4, 8, 16}, so each word is assembled in one block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 64, BK = 16, THREADS = 128;
constexpr int AS_LD = BM + 4;  // padded transposed x slab: fewer bank conflicts

enum Scheme { SIGN = 0, TWO_BIT = 1, UNIFORM = 2, OFFSET = 3 };

__device__ __forceinline__ int code_of(float z, float qv, int scheme, float w,
                                       int n_side) {
  if (scheme == SIGN) return z >= 0.f ? 1 : 0;
  if (scheme == TWO_BIT)
    return (z >= -w ? 1 : 0) + (z >= 0.f ? 1 : 0) + (z >= w ? 1 : 0);
  float v = scheme == OFFSET ? z + qv : z;
  float c = floorf(__fdiv_rn(v, w));
  c = fminf(fmaxf(c, (float)-n_side), (float)(n_side - 1));
  return (int)c + n_side;
}

// Accumulates the block's 128x64 tile of x @ r into acc (8x8 per thread).
// Thread (tx, ty) = (t % 8, t / 8) owns rows {ty*4 + i, 64 + ty*4 + i} and
// columns {tx*4 + j, 32 + tx*4 + j}, i, j < 4.
__device__ __forceinline__ void gemm_tile(const float* __restrict__ x,
                                          const float* __restrict__ r, int m,
                                          int d, int k, int m0, int n0,
                                          float (*as)[BK][AS_LD],
                                          float (*bs)[BK][BN],
                                          float acc[8][8]) {
  const int t = threadIdx.x, tx = t % 8, ty = t / 8;
  float pa[16], pb[8];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // x slab: 128 rows x 16 cols
      int e = t + i * THREADS, row = m0 + e / BK, col = k0 + e % BK;
      pa[i] = (row < m && col < d) ? x[(size_t)row * d + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // r slab: 16 rows x 64 cols
      int e = t + i * THREADS, row = k0 + e / BN, col = n0 + e % BN;
      pb[i] = (row < d && col < k) ? r[(size_t)row * k + col] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int e = t + i * THREADS;
      as[buf][e % BK][e / BK] = pa[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int e = t + i * THREADS;
      bs[buf][e / BN][e % BN] = pb[i];
    }
  };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_slabs = (d + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < n_slabs; ++s) {
    const int cur = s & 1;
    if (s + 1 < n_slabs) load((s + 1) * BK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][kk][32 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < n_slabs) store(cur ^ 1);
    __syncthreads();
  }
}

__device__ __forceinline__ int tile_row(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x / 8) * 4 + (i & 3);
}
__device__ __forceinline__ int tile_col(int j) {
  return (j < 4 ? 0 : 32) + (threadIdx.x % 8) * 4 + (j & 3);
}

__global__ void __launch_bounds__(THREADS)
coded_project_kernel(const float* __restrict__ x, const float* __restrict__ r,
                     const float* __restrict__ q, int32_t* __restrict__ out,
                     int m, int d, int k, int scheme, float w, int n_side) {
  __shared__ __align__(16) float as[2][BK][AS_LD];
  __shared__ __align__(16) float bs[2][BK][BN];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8];
  gemm_tile(x, r, m, d, k, m0, n0, as, bs, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + tile_col(j);
    if (col >= k) continue;
    const float qv = scheme == OFFSET ? q[col] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + tile_row(i);
      if (row < m) out[(size_t)row * k + col] = code_of(acc[i][j], qv, scheme, w, n_side);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
encode_fused_kernel(const float* __restrict__ x, const float* __restrict__ r,
                    const float* __restrict__ q, uint32_t* __restrict__ out,
                    int m, int d, int k, int scheme, float w, int n_side,
                    int bits) {
  __shared__ __align__(16) float as[2][BK][AS_LD];
  __shared__ __align__(16) float bs[2][BK][BN];
  __shared__ uint16_t codes[BM][BN];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8];
  gemm_tile(x, r, m, d, k, m0, n0, as, bs, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tile_col(j), col = n0 + c;
    const float qv = (scheme == OFFSET && col < k) ? q[col] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      codes[tile_row(i)][c] =
          col < k ? (uint16_t)code_of(acc[i][j], qv, scheme, w, n_side) : 0;
  }
  __syncthreads();
  const int cpw = 32 / bits, words_per_row = BN / cpw;
  const int n_words = (k + cpw - 1) / cpw, w0 = n0 / cpw;
  for (int e = threadIdx.x; e < BM * words_per_row; e += THREADS) {
    const int row = e / words_per_row, wc = e % words_per_row;
    if (m0 + row >= m || w0 + wc >= n_words) continue;
    uint32_t word = 0;
    for (int f = 0; f < cpw; ++f)
      word += (uint32_t)codes[row][wc * cpw + f] << (f * bits);
    out[(size_t)(m0 + row) * n_words + w0 + wc] = word;
  }
}

}  // namespace

extern "C" int coded_project_launch(const float* x, const float* r,
                                    const float* q, int32_t* out, int m, int d,
                                    int k, int scheme, float w, int n_side,
                                    void* stream) {
  dim3 grid((m + BM - 1) / BM, (k + BN - 1) / BN);
  coded_project_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, r, q, out, m, d, k, scheme, w, n_side);
  return (int)cudaGetLastError();
}

extern "C" int encode_fused_launch(const float* x, const float* r,
                                   const float* q, uint32_t* out, int m, int d,
                                   int k, int scheme, float w, int n_side,
                                   int bits, void* stream) {
  dim3 grid((m + BM - 1) / BM, (k + BN - 1) / BN);
  encode_fused_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, r, q, out, m, d, k, scheme, w, n_side, bits);
  return (int)cudaGetLastError();
}
