// LUT scoring and the block-wide stable top-k selection shared by
// packed_lut.cu and fused_scored.cu (and the scoring by packed_linear.cu).
//
// A row's score adds, in (word, field) order, the table entry its b-bit
// code selects at each of the W * 32/b field slots, one rounded float32
// add at a time (__fadd_rn, so no contraction can change a bit): the
// order of ref.lut_scores_rowwise_ref. bf16 entries widen exactly (their
// 16 bits shifted up). int8 tables sum each word's entries exactly in
// int32 and join the total as score + scale[w] * float(isum), a rounded
// multiply and a rounded add (ref.lut_scores_rowwise_int8_ref).
//
// Selection takes the top_k of n scored candidates by (score desc, key
// asc), where the key is the candidate's position (re-rank) or corpus id
// (fused). Each candidate maps to a unique 64-bit value: the score's
// order-preserving bits above, the complement of the key below, so the
// largest value is the best candidate and no two are equal. Each thread
// keeps the best value among its strided share; a round reduces the
// block's maximum, emits it, and only the thread that owned it rescans
// its share for the best value below it. -inf scores (invalid or empty
// candidates) map to 0 and are never emitted: once the maximum is 0 the
// remaining slots are (-inf, -1), as torch.sort/lax.top_k leave them.
#pragma once
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned LUT_FULL = 0xffffffffu;

__device__ __forceinline__ float entry(const float* t, int i) { return t[i]; }
__device__ __forceinline__ float entry(const uint16_t* t, int i) {
  return __uint_as_float((uint32_t)t[i] << 16);
}

// CB float tables (float32 or bf16 bits) fp entries apart, scored at
// once: each field is decoded once and its code selects an entry of every
// table; s[c] adds them in (word, field) order from 0.0.
template <int CB, typename T>
__device__ __forceinline__ void score_row_classes(const T* tab, size_t fp,
                                                  const uint32_t* row, int w,
                                                  int bits, float* s) {
  const int cpw = 32 / bits, p = 1 << bits;
  const uint32_t mask = (uint32_t)p - 1u;
#pragma unroll
  for (int c = 0; c < CB; ++c) s[c] = 0.0f;
  for (int j = 0; j < w; ++j) {
    const uint32_t word = row[j];
    const T* t = tab + (size_t)j * cpw * p;
    for (int f = 0; f < cpw; ++f) {
      const int e = f * p + (int)((word >> (f * bits)) & mask);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        s[c] = __fadd_rn(s[c], entry(t + c * fp, e));
    }
  }
}

// One float table; scales unused.
template <typename T>
__device__ float score_row(const T* tab, const float* /*scales*/,
                           const uint32_t* row, int w, int bits) {
  float s;
  score_row_classes<1>(tab, 0, row, w, bits, &s);
  return s;
}

// int8 tables with one float32 scale a word.
__device__ inline float score_row(const int8_t* tab, const float* scales,
                           const uint32_t* row, int w, int bits) {
  const int cpw = 32 / bits, p = 1 << bits;
  const uint32_t mask = (uint32_t)p - 1u;
  float s = 0.0f;
  for (int j = 0; j < w; ++j) {
    const uint32_t word = row[j];
    const int8_t* t = tab + (size_t)j * cpw * p;
    int isum = 0;
    for (int f = 0; f < cpw; ++f)
      isum += t[f * p + (int)((word >> (f * bits)) & mask)];
    s = __fadd_rn(s, __fmul_rn(scales[j], (float)isum));
  }
  return s;
}

__device__ __forceinline__ uint64_t select_value(float s, int key) {
  if (s == -INFINITY) return 0ull;
  uint32_t b = __float_as_uint(__fadd_rn(s, 0.0f));  // -0 -> +0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)b << 32) | (uint64_t)(0xffffffffu - (uint32_t)key);
}

__device__ __forceinline__ float select_score(uint64_t v) {
  const uint32_t b = (uint32_t)(v >> 32);
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

__device__ __forceinline__ int select_key(uint64_t v) {
  return (int)(0xffffffffu - (uint32_t)v);
}

// Block-wide: the top_k of candidates i < n with scores[i] and keys
// key_of(i), into out_s/out_k [top_k]. Every thread of the block calls
// it; red is shared scratch of 64 values. blockDim.x: a multiple of 32.
template <typename KeyFn>
__device__ void block_select(const float* scores, int n, KeyFn key_of,
                             int top_k, float* out_s, int32_t* out_k,
                             uint64_t* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nw = nt / 32;
  uint64_t mine = 0;
  for (int i = tid; i < n; i += nt) {
    const uint64_t v = select_value(scores[i], key_of(i));
    mine = v > mine ? v : mine;
  }
  for (int r = 0; r < top_k; ++r) {
    uint64_t v = mine;
    for (int o = 16; o; o >>= 1) {
      const uint64_t x = __shfl_xor_sync(LUT_FULL, v, o);
      v = x > v ? x : v;
    }
    uint64_t* buf = red + (r & 1) * 32;  // two buffers: one barrier a round
    if (lane == 0) buf[warp] = v;
    __syncthreads();
    uint64_t best = 0;
    for (int j = 0; j < nw; ++j) best = buf[j] > best ? buf[j] : best;
    if (best == 0) {  // block-uniform: nothing is left
      for (int j = r + tid; j < top_k; j += nt) {
        out_s[j] = -INFINITY;
        out_k[j] = -1;
      }
      return;
    }
    if (tid == 0) {
      out_s[r] = select_score(best);
      out_k[r] = select_key(best);
    }
    if (mine == best) {  // the owner finds its best value below the winner
      uint64_t nb = 0;
      for (int i = tid; i < n; i += nt) {
        const uint64_t x = select_value(scores[i], key_of(i));
        nb = (x < best && x > nb) ? x : nb;
      }
      mine = nb;
    }
  }
}

}  // namespace
