// One unit of the canonical projection matrix R drawn on the card:
// out [width, k] = jax.random.normal(fold_in(PRNGKey(seed), u), (width, k)),
// bit-identical to core/prng.py's normal and so to the JAX reference.
//
// Stands in for src/repro/core/sketch.py:104 (_block_r), which JAX
// draws inside the jit trace of every streamed and CSR step; there is
// no Pallas kernel for it. The unit key fold_in(key, u) is computed once
// on the host and passed as two uint32 words.
//
// Element i (flat index row*k + col, 64 bits split into hi and lo) takes
// threefry2x32 of (hi, lo) under the unit key, bits = x0 ^ x1, the float
// f in [0, 1) of its top 23 bits, u = max(lo, f*(1 - lo) + lo) and
// sqrt(2) * erfinv(u), with XLA's float32 erfinv, log1p and log term
// for term (core/prng.py:87-196). Every step that XLA fuses is written
// __fmaf_rn; every step that it rounds twice is written __fmul_rn then
// __fadd_rn/__fsub_rn, so nvcc's FMA contraction cannot change a
// result; division and square root are the IEEE-rounded __fdiv_rn and
// __fsqrt_rn. The constants are the float32 values of prng.py's, as
// exact hex literals. normal_bits_launch applies the same mapping to
// given bits, so that a check can cover all 2^23 mantissas.
//
// normal_unit_bf16_launch draws a bf16 unit (SketchConfig(dtype=
// "bfloat16")), as JAX's bf16 normal does (core/prng.py:
// bf16_normal_of_index): the same 32-bit bits give the uniform index
// m = (bits >> 1) & 127, u = m/64 - 255/256 (exact), erfinv(u) in float32
// rounded to bf16 (nearest, ties to even), times bf16(sqrt 2) = 1.4140625
// (an exact float32 product) rounded to bf16.
//
// normal_units_launch draws up to 16 units in one launch (the CSR
// path's group of units): their keys, buffer slots and widths go by value
// in the kernel's parameters, blockIdx.y picks the unit, and the draw of
// each element is the one above, so that a unit's bits do not depend on
// its group. normal_unit_launch and normal_unit_bf16_launch are its
// launch of one unit.
//
// Bound on this card: integer operations. threefry's 20 rounds (an add,
// a rotate and a xor each) and its key injections are about 100 int32
// operations an element against some 40 float32 ones for erfinv; the
// only memory traffic is the 4-byte write of each element. One thread
// draws one element (grid-stride), writes coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

// XLA's CPU float32 log (Cephes logf), core/prng.py:_log_xla.
__device__ __forceinline__ float log_xla(float v) {
  v = fmaxf(v, 0x1p-126f);
  const int b = __float_as_int(v);
  float e = (float)((b >> 23) - 0x7E);
  const float m = __int_as_float((b & ~0x7F800000) | 0x3F000000);
  const bool small = m < 0x1.6a09e6p-1f;
  float x;
  if (small) {
    e = __fsub_rn(e, 1.0f);
    x = __fsub_rn(__fadd_rn(m, m), 1.0f);
  } else {
    x = __fsub_rn(m, 1.0f);
  }
  const float x2 = __fmul_rn(x, x), x3 = __fmul_rn(x2, x);
  float y = __fmaf_rn(__fmaf_rn(0x1.204376p-4f, x, -0x1.d7a37p-4f), x,
                      0x1.de4a34p-4f);
  const float y1 = __fmaf_rn(__fmaf_rn(-0x1.fcba9ep-4f, x, 0x1.23d37ep-3f),
                             x, -0x1.555cap-3f);
  const float y2 = __fmaf_rn(__fmaf_rn(0x1.999d58p-3f, x, -0x1.fffff8p-3f),
                             x, 0x1.555554p-2f);
  y = __fmaf_rn(__fmaf_rn(y, x3, y1), x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  x = __fsub_rn(x, __fmul_rn(x2, 0.5f));
  x = __fadd_rn(x, y);
  return __fadd_rn(x, __fmul_rn(e, 0x1.63p-1f));
}

// XLA's float32 log1p, core/prng.py:_log1p_xla.
__device__ __forceinline__ float log1p_xla(float x) {
  if (!(fabsf(x) < 0x1.a8279ap-2f)) return log_xla(__fadd_rn(x, 1.0f));
  const float num[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f,
                        0x1.de9738p+4f, 0x1.e798ecp+5f, 0x1.c8e75ap+5f,
                        0x1.40a202p+4f};
  const float den[7] = {0x1p+0f, 0x1.e2035ap+3f, 0x1.4c30b6p+6f,
                        0x1.bb865ap+7f, 0x1.351946p+8f, 0x1.b0db14p+7f,
                        0x1.e0f304p+5f};
  float pn = 0.f, pd = 0.f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    pn = __fmaf_rn(pn, x, num[i]);
    pd = __fmaf_rn(pd, x, den[i]);
  }
  const float x2 = __fmul_rn(x, x);
  const float r = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(pn, pd));
  return __fadd_rn(x, __fmaf_rn(-0.5f, x2, r));
}

// XLA's float32 erf_inv (Giles), core/prng.py:erfinv_xla.
__device__ __forceinline__ float erfinv_xla(float x) {
  const float w = -log1p_xla(__fmul_rn(-x, x));
  const float lt5[9] = {0x1.e2cb1p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
                        -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
                        -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
  const float ge5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                        -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f,
                        0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};
  const bool lt = w < 5.0f;
  const float ww = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, ww, lt ? lt5[i] : ge5[i]);
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7F800000));
  return __fmul_rn(p, x);
}

// bits -> standard normal, core/prng.py:normal_from_bits.
__device__ __forceinline__ float normal_of_bits(uint32_t bits) {
  const float lo = -0x1.fffffep-1f;  // nextafter(-1, 0)
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, lo)), lo));
  return __fmul_rn(0x1.6a09e6p+0f, erfinv_xla(u));
}

// float32 -> bf16 bits, round to nearest even (no NaN reaches it).
__device__ __forceinline__ uint16_t bf16_rne(float x) {
  const uint32_t b = __float_as_uint(x);
  return (uint16_t)((b + 0x7FFFu + ((b >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ uint16_t bf16_normal_of_bits(uint32_t bits) {
  const float m = (float)((bits >> 1) & 127u);
  const float u = __fsub_rn(__fmul_rn(m, 0x1p-6f), 0x1.fep-1f);  // exact
  const float e = __uint_as_float((uint32_t)bf16_rne(erfinv_xla(u)) << 16);
  return bf16_rne(__fmul_rn(e, 0x1.6ap+0f));  // bf16(sqrt 2), exact product
}

constexpr int MAX_UNITS = 16;

// the units of one launch, passed by value: no copy to the card
struct Units {
  uint32_t k0[MAX_UNITS], k1[MAX_UNITS];  // fold_in(PRNGKey(seed), u)
  uint32_t slot[MAX_UNITS];               // unit j goes to out + slot * stride
  uint32_t width[MAX_UNITS];              // rows of unit j
};

__device__ __forceinline__ void store_normal(float* o, uint32_t bits) {
  *o = normal_of_bits(bits);
}
__device__ __forceinline__ void store_normal(uint16_t* o, uint32_t bits) {
  *o = bf16_normal_of_bits(bits);
}

// T float32, or uint16_t for bf16 bits
template <typename T>
__global__ void normal_units_kernel(Units units, T* __restrict__ out,
                                    uint64_t stride, int k) {
  const int j = blockIdx.y;
  const uint32_t k0 = units.k0[j], k1 = units.k1[j];
  const uint64_t n = (uint64_t)units.width[j] * k;
  T* o = out + units.slot[j] * stride;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x)
    store_normal(o + i, threefry_bits(k0, k1, (uint32_t)(i >> 32),
                                      (uint32_t)i));
}

__global__ void normal_bits_kernel(const uint32_t* __restrict__ bits,
                                   float* __restrict__ out, uint64_t n) {
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x)
    out[i] = normal_of_bits(bits[i]);
}

unsigned grid_for(uint64_t n, int threads) {
  uint64_t blocks = (n + threads - 1) / threads;
  return (unsigned)(blocks > 132 * 32 ? 132 * 32 : blocks);  // grid-stride
}

int launch_units(const Units& units, int n_units, uint32_t max_width,
                 int k, int bf16, void* out, uint64_t stride,
                 void* stream) {
  const uint64_t n = (uint64_t)max_width * k;
  if (n == 0 || n_units == 0) return 0;
  if (n_units < 0 || n_units > MAX_UNITS) return (int)cudaErrorInvalidValue;
  // the grid-stride cap of one unit, shared by the group's units
  unsigned x = grid_for(n, 256) / n_units;
  const dim3 grid(x ? x : 1, n_units);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    normal_units_kernel<uint16_t><<<grid, 256, 0, st>>>(
        units, static_cast<uint16_t*>(out), stride, k);
  else
    normal_units_kernel<float><<<grid, 256, 0, st>>>(
        units, static_cast<float*>(out), stride, k);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: 2 * n_units uint32 (k0, k1 of each unit), slots and widths:
// n_units each, host arrays; out: [slots, stride] float32 or bf16 bits
// (bf16 = 1), unit j written to out + slots[j] * stride as [widths[j], k].
extern "C" int normal_units_launch(const uint32_t* keys, const int32_t* slots,
                                   const int32_t* widths, int n_units, int k,
                                   int bf16, void* out, uint64_t stride,
                                   void* stream) {
  if (n_units < 0 || n_units > MAX_UNITS) return (int)cudaErrorInvalidValue;
  Units units = {};
  uint32_t max_width = 0;
  for (int j = 0; j < n_units; ++j) {
    units.k0[j] = keys[2 * j];
    units.k1[j] = keys[2 * j + 1];
    units.slot[j] = (uint32_t)slots[j];
    units.width[j] = (uint32_t)widths[j];
    if (units.width[j] > max_width) max_width = units.width[j];
  }
  return launch_units(units, n_units, max_width, k, bf16, out, stride,
                      stream);
}

// one unit: out [n] float32 under the key (k0, k1)
extern "C" int normal_unit_launch(uint32_t k0, uint32_t k1, float* out,
                                  uint64_t n, void* stream) {
  Units units = {};
  units.k0[0] = k0, units.k1[0] = k1, units.width[0] = (uint32_t)n;
  return n > 0xFFFFFFFFull ? (int)cudaErrorInvalidValue
                           : launch_units(units, 1, (uint32_t)n, 1, 0, out,
                                          0, stream);
}

// one unit: out bf16 bits [n]
extern "C" int normal_unit_bf16_launch(uint32_t k0, uint32_t k1,
                                       uint16_t* out, uint64_t n,
                                       void* stream) {
  Units units = {};
  units.k0[0] = k0, units.k1[0] = k1, units.width[0] = (uint32_t)n;
  return n > 0xFFFFFFFFull ? (int)cudaErrorInvalidValue
                           : launch_units(units, 1, (uint32_t)n, 1, 1, out,
                                          0, stream);
}

extern "C" int normal_bits_launch(const uint32_t* bits, float* out,
                                  uint64_t n, void* stream) {
  if (n == 0) return 0;
  normal_bits_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      bits, out, n);
  return (int)cudaGetLastError();
}
