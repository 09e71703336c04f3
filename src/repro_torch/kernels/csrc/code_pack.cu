// The coding and packing epilogue alone: float32 or bf16 projections
// z [M, K] -> uint32 words [M, ceil(K*b/32)].
//
// Replaces src/repro/kernels/encode_fused.py::code_pack_pallas, the
// finalize of every unit-streamed and CSR chunk. Each value is coded by
// code_of (code_common.cuh), the same function as the GEMM epilogues of
// coded_gemm.cu; fields past K are code 0, and the offset scheme reads
// q[col]. Words are the uint32 sum of code << (f*b), LSB first. bf16 z
// (a bf16 sketch's streamed projections) widens exactly on load, as the
// reference's code_pack_ref casts z to float32 before coding.
//
// Bound on this card: bytes. It reads M*K*4 and writes M*W*4 bytes and
// does a few operations a value. One thread builds one output word from
// its 32/b values; consecutive threads take consecutive words of a row,
// so a warp's reads cover one contiguous stretch of z (served through
// L1 across the field loop) and its word writes are coalesced. The
// threads a block are the wrapper's launch knob; they change no bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "code_common.cuh"

namespace {

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}

template <typename T>
__global__ void code_pack_kernel(const T* __restrict__ z,
                                 const float* __restrict__ q,
                                 uint32_t* __restrict__ out, int m, int k,
                                 int scheme, float w, int n_side, int bits) {
  const int cpw = 32 / bits, n_words = (k + cpw - 1) / cpw;
  const size_t total = (size_t)m * n_words;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t row = e / n_words;
    const int c0 = (int)(e % n_words) * cpw;
    const T* src = z + row * k;
    uint32_t word = 0;
    for (int f = 0; f < cpw && c0 + f < k; ++f) {
      const int col = c0 + f;
      const float qv = scheme == OFFSET ? q[col] : 0.f;
      word += (uint32_t)code_of(as_f32(src[col]), qv, scheme, w, n_side) << (f * bits);
    }
    out[e] = word;
  }
}

}  // namespace

// z_bf16: 0 for float32 z, 1 for bf16 z; threads: a block's threads.
extern "C" int code_pack_launch(const void* z, int z_bf16, const float* q,
                                uint32_t* out, int m, int k, int scheme,
                                float w, int n_side, int bits, int threads,
                                void* stream) {
  const int cpw = 32 / bits;
  const size_t total = (size_t)m * ((k + cpw - 1) / cpw);
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  if (blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (z_bf16)
    code_pack_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const uint16_t*>(z), q, out, m, k, scheme, w, n_side,
        bits);
  else
    code_pack_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(z), q, out, m, k, scheme, w, n_side, bits);
  return (int)cudaGetLastError();
}
