// The coding schemes of one projected value, shared by coded_gemm.cu (the
// GEMM epilogues) and code_pack.cu (the epilogue alone), so that every
// kernel codes a value the same way.
//
// Uniform and offset codes take floor(z / w) with a true IEEE division,
// as the reference oracle does (build without --use_fast_math).
#pragma once
#include <cuda_runtime.h>

namespace {

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

}  // namespace
