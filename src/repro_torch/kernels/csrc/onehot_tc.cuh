// The int8 one-hot product of b-bit codes on Hopper's tensor cores, for
// 1- and 2-bit codes: the building blocks shared by the count sweep of
// the top-k kernels (topk_tc.cuh) and the all-pairs count kernel
// (packed_counts.cu).
//
// With onehot(x)[f*P + v] = 1 iff field f of x holds code v (P = 2^b,
// over all F = 32W/b field slots, padding included), a collision count is
// an exact integer dot product, count = k - F + onehot(q) . onehot(row),
// over K = F*P = 64W u8 columns at b = 1 and 2. Queries are wgmma's N
// side, their one-hot u8 in shared memory, K-major in chunks of 128
// K-bytes under the 128-byte swizzle ([chunk][QB][128]); corpus rows are
// the M side, each thread building wgmma's register A fragment of a
// 32-byte k-step straight from its two rows' packed words.
#pragma once
#include "wgmma_common.cuh"

namespace {

// D[64 x 64] (+)= A[64 x 32] (registers) * B[64 x 32]^T (shared memory),
// u8 operands, s32 accumulators
__device__ __forceinline__ void mma_u8_n64(int32_t* d, const uint32_t* a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 32] (registers) * B[128 x 32]^T (shared memory),
// u8 operands, s32 accumulators
__device__ __forceinline__ void mma_u8_n128(int32_t* d, const uint32_t* a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int QB>
__device__ __forceinline__ void mma_u8(int32_t* d, const uint32_t* a,
                                       uint64_t b, int accumulate) {
  static_assert(QB == 64 || QB == 128, "query block");
  if constexpr (QB == 128)
    mma_u8_n128(d, a, b, accumulate);
  else
    mma_u8_n64(d, a, b, accumulate);
}

// One 32-bit register of one-hot bytes, for the code bits in bits 0-1 of
// x: at b = 2 one field (byte `code` is 1), at b = 1 two fields (byte c0
// and byte 2 + c1).
template <int BITS>
__device__ __forceinline__ uint32_t onehot4(uint32_t x) {
  if constexpr (BITS == 2)
    return 1u << ((x & 3u) << 3);
  else
    return (1u << ((x & 1u) << 3)) | (0x10000u << ((x & 2u) << 2));
}

// onehot4 of a fragment register from a word prepared by tc_issue: at
// b = 2 the low 5 bits of z are 8 * code, and a funnel shift, which takes
// its count mod 32, gives 1 << (8 * code) in one instruction; at b = 1 z
// holds the two code bits as they are.
template <int BITS>
__device__ __forceinline__ uint32_t onehot_z(uint32_t z) {
  if constexpr (BITS == 2)
    return __funnelshift_l(0u, 1u, z);
  else
    return onehot4<1>(z);
}

constexpr int TC_KW = 4;  // packed words a batch: 8 wgmmas

// K runs over whole pairs of batches: 2 TC_KW words, 128 TC_KW bytes of
// one-hot, a row. The one-hot queries are zero past the row's 64W bytes,
// so the padding k-steps add nothing, and no wgmma sits in a branch
// (where the compiler would fence before each one).
__host__ __device__ inline int tc_k_words(int w) {
  return (w + 2 * TC_KW - 1) / (2 * TC_KW) * (2 * TC_KW);
}
__host__ __device__ inline size_t tc_onehot_bytes(int w, int qb) {
  return (size_t)tc_k_words(w) / 2 * qb * 128;
}

// Issues one batch of k-steps: words j0 .. j0 + TC_KW - 1 of the
// thread's two rows (0 past w) into wgmma's A fragments `a`, then their
// wgmmas, committed as one group. Word j feeds k-steps 2j (its bytes 0,
// 1) and 2j + 1 (bytes 2, 3); register v of a step is row lr0 + 8 (v & 1),
// byte v >> 1. K-step s reads the one-hot at chunk s / 4, 32 (s % 4)
// bytes in.
template <int BITS, int QB>
__device__ __forceinline__ void tc_issue(int32_t* acc,
                                         uint32_t (&a)[2 * TC_KW][4],
                                         const uint32_t* rlo,
                                         const uint32_t* rhi, int j0, int w,
                                         int sh, uint64_t desc0) {
  // z: the thread's 4 codes of a word (bits 2 tig of each byte), each at
  // bits 3-4 of its byte, so byte b's low 5 bits are 8 * code
  uint32_t zlo[TC_KW], zhi[TC_KW];
#pragma unroll
  for (int jj = 0; jj < TC_KW; ++jj) {
    const bool in = j0 + jj < w;
    zlo[jj] = in ? rlo[j0 + jj] >> sh : 0u;
    zhi[jj] = in ? rhi[j0 + jj] >> sh : 0u;
  }
#pragma unroll
  for (int jj = 0; jj < TC_KW; ++jj) {
    if constexpr (BITS == 2) {
      zlo[jj] = (zlo[jj] & 0x03030303u) << 3;
      zhi[jj] = (zhi[jj] & 0x03030303u) << 3;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[2 * jj + h][0] = onehot_z<BITS>(zlo[jj] >> (16 * h));
      a[2 * jj + h][1] = onehot_z<BITS>(zhi[jj] >> (16 * h));
      a[2 * jj + h][2] = onehot_z<BITS>(zlo[jj] >> (16 * h + 8));
      a[2 * jj + h][3] = onehot_z<BITS>(zhi[jj] >> (16 * h + 8));
      fence_regs<4>(a[2 * jj + h]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < TC_KW; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * (j0 + jj) + h;
      mma_u8<QB>(acc, a[2 * jj + h], desc0 + (s >> 2) * QB * 8 + (s & 3) * 2,
                 s > 0);
    }
  wgmma_commit();
}

// Writes the one-hot of queries q0 .. q0 + QB - 1 (zero past nq and past
// the row's 64W bytes) into `onehot`, [tc_k_words(w) / 2][QB][128] u8
// under the 128-byte swizzle, threads tid .. of nthreads each a share. The
// caller fences (fence_proxy_async) and syncs before wgmma reads it.
// 16-byte slot (c, row, t8) holds the one-hot of byte 8c + t8 of query
// row's packed words: K columns 128c + 16 t8 ... + 15.
template <int BITS, int QB>
__device__ __forceinline__ void tc_onehot_queries(uint8_t* onehot,
                                                  const uint32_t* q, int q0,
                                                  int nq, int w, int tid,
                                                  int nthreads) {
  const int chunks = tc_k_words(w) / 2;
  for (int e = tid; e < chunks * QB * 8; e += nthreads) {
    const int c = e / (QB * 8), row = (e / 8) % QB, t8 = e % 8;
    const int t = 8 * c + t8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + row < nq && t < 4 * w) {
      const uint32_t x = q[(size_t)(q0 + row) * w + t / 4] >> (8 * (t % 4));
      v = make_uint4(onehot4<BITS>(x), onehot4<BITS>(x >> 2),
                     onehot4<BITS>(x >> 4), onehot4<BITS>(x >> 6));
    }
    *reinterpret_cast<uint4*>(onehot + (size_t)c * QB * 128 + row * 128 +
                              ((t8 ^ (row & 7)) << 4)) = v;
  }
}

}  // namespace
