// The count sweep of the exact top-k kernels on Hopper's int8 tensor
// cores, for 1- and 2-bit codes (included by packed_topk.cu and
// fused_scored.cu).
//
// Replaces the sweep under four TPU kernels of the JAX reference:
//   src/repro/kernels/packed_collision.py::packed_topk_pallas,
//   ::packed_topk_masked_pallas,
//   src/repro/kernels/fused_scored.py::fused_scored_topk_pallas and
//   ::fused_scored_topk_masked_pallas (m in place of top_k).
// It writes the partial lists [S, Q, top_k] that topk_common.cuh's
// packed_topk_partial writes, bit for bit; that kernel keeps 4-, 8- and
// 16-bit codes and the widths whose one-hot does not fit (the wrappers'
// plan chooses by shape, before the launch).
//
// Arithmetic. With onehot(x)[f*P + v] = 1 iff field f of x holds code v
// (P = 2^b, over all F = 32W/b field slots, padding included), a
// collision count is an exact integer dot product:
//   count[q, n] = k - F + onehot(q) . onehot(db[n]),
// over K = F*P = 64W u8 columns at b = 1 and 2 (1,024 at W = 16). The
// sums are integers, so any order gives the same bits.
//
// Bound on this card: operations, 2*Q*N*K int8 products at 1,979 TOPS
// (1.11 ms at Q = 256, N = 4,194,304, W = 16), a quarter of the popcount
// rate that bounds packed_topk_partial (4.11 ms there); the corpus's
// N*W*4 bytes take 0.08 ms.
//
// Design.
// * Queries are wgmma's N side. At block start the block writes the
//   one-hot of its QB queries (128 or 64) as u8, K-major in chunks of 128
//   K-bytes under the 128-byte swizzle, [chunk][QB][128], kept for the
//   block's life: 128 KB at QB = 128 and W = 16. K runs over whole pairs
//   of batches (8 words); the padding is zero, so it adds nothing.
// * Corpus rows are the M side. Two consumer warpgroups each walk their
//   own contiguous corpus range (range 2 * blockIdx.y + g) in tiles of 64
//   rows, in rising order. Packed rows stream through a 2-stage cp.async
//   ring a warpgroup (rows at an odd word stride, so the 8 rows a warp
//   reads at once sit in 8 banks). Each thread builds wgmma's register A
//   fragment of a 32-byte k-step straight from its two rows' words: at
//   b = 2 one register is one field's one-hot, 1 << (8 * code), at b = 1
//   it holds two fields. The corpus's one-hot never exists in memory.
//   K-steps go in batches of 8 wgmmas (4 words) committed as one group;
//   two fragment buffers alternate, so a batch is built while the last
//   one runs. No wgmma sits in a branch and every fragment is pinned
//   before the fence: otherwise the compiler fences again before each
//   wgmma, which then waits for the one before.
// * The s32 accumulator [64 x QB] gives count = k - F + acc, or -1 for a
//   row past the range or dead in the mask (the masked kernels' bit is
//   read here, from its own word), staged in shared memory as int16
//   [QB][72]. Each thread also holds its counts against each query's
//   threshold (its list's last value, in shared memory; an offer must
//   beat it), and a warp OR marks the queries with a row that can enter.
//   Only for those does the warp that owns the query (qq % 4) offer its 64
//   rows, in ascending order, with warp_insert's rule, the list held in
//   registers meanwhile when top_k <= 64 (offer_regs): an entry must
//   strictly beat the last, so ties keep the lower id and the lists are
//   packed_topk_partial's at any S. After a range's first tiles few
//   queries have such a row: at Q = 256 and N = 4,194,304 about 2 of a
//   warp's 32 a tile.
// * The two warpgroups' tiles interleave on the tensor cores: while one
//   stages and offers, the other's wgmmas run.
// * Lists live in shared memory, [2][2][QB][top_k], when they fit, else
//   in the partial output they are written to, by the same rule
//   (topk_common.cuh).
#pragma once
#include "topk_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int TC_WG = 2;               // consumer warpgroups: a range each
constexpr int TC_THREADS = TC_WG * 128;
constexpr int TC_ROWS = 64;            // corpus rows a tile: wgmma's M
constexpr int TC_STAGES = 2;           // corpus tiles in a warpgroup's ring
constexpr int TC_LD = TC_ROWS + 8;     // int16 counts a query when staged

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

// Shared memory in bytes after the 1024-byte alignment (the wrappers'
// packed_collision.tc_layout mirrors it): the one-hot queries, the two
// warpgroups' rings, their staged counts with each query's threshold and
// its warps' hit words, then the lists.
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
__host__ __device__ inline size_t tc_ring_bytes(int w) {
  return (size_t)TC_WG * TC_STAGES * TC_ROWS * (w | 1) * 4;
}
__host__ __device__ inline size_t tc_staged_bytes(int qb) {
  return (size_t)TC_WG * (qb * (TC_LD * 2 + 4) + qb / 2);
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

// Offers a tile's 64 rows of one query, c0 (rows row0 + lane) then c1
// (rows row0 + 32 + lane), to its list (top_k <= 32 L, last value
// `last`), held in registers meanwhile: entry 32 l + lane in v[l], d[l].
// The rule is warp_insert's: an offer must strictly beat the last entry
// and goes after every entry of a value >= its own, so the list is the
// same. Returns the new last value.
template <int L>
__device__ __forceinline__ int offer_regs(int* lv, int* li, int top_k,
                                          int last, int c0, int c1, int row0,
                                          int lane) {
  int v[L], d[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = 32 * l + lane;
    v[l] = i < top_k ? lv[i] : -1;
    d[l] = i < top_k ? li[i] : -1;
  }
  const int last_l = (top_k - 1) / 32, last_lane = (top_k - 1) % 32;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int c = b ? c1 : c0;
    unsigned cand = __ballot_sync(FULL, c > last);
    while (cand) {
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      const int cc = __shfl_sync(FULL, c, src);
      if (cc <= last) continue;
      int p = 0;
#pragma unroll
      for (int l = 0; l < L; ++l)
        p += __popc(__ballot_sync(FULL, 32 * l + lane < top_k && v[l] >= cc));
      int uv[L], ud[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        uv[l] = __shfl_up_sync(FULL, v[l], 1);
        ud[l] = __shfl_up_sync(FULL, d[l], 1);
      }
#pragma unroll
      for (int l = 1; l < L; ++l) {
        const int cv = __shfl_sync(FULL, v[l - 1], 31);
        const int cd = __shfl_sync(FULL, d[l - 1], 31);
        if (lane == 0) {
          uv[l] = cv;
          ud[l] = cd;
        }
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int i = 32 * l + lane;
        if (i > p) {
          v[l] = uv[l];
          d[l] = ud[l];
        } else if (i == p) {
          v[l] = cc;
          d[l] = row0 + 32 * b + src;
        }
      }
      last = __shfl_sync(FULL, last_l == 0 ? v[0] : v[L - 1], last_lane);
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = 32 * l + lane;
    if (i < top_k) {
      lv[i] = v[l];
      li[i] = d[l];
    }
  }
  __syncwarp();
  return last;
}

template <int BITS, int QB>
__global__ void __launch_bounds__(TC_THREADS, 1)
packed_topk_tc(const uint32_t* __restrict__ q, const uint32_t* __restrict__ db,
               const uint32_t* __restrict__ valid,
               int32_t* __restrict__ part_vals, int32_t* __restrict__ part_ids,
               int nq, int n, int w, int k, int top_k, int n_ranges,
               int rows_per_range, int lists_in_smem) {
  extern __shared__ uint8_t tc_raw[];
  uint8_t* smem = tc_raw + ((1024 - (smem_addr(tc_raw) & 1023)) & 1023);
  const int wp = w | 1;
  uint8_t* onehot = smem;
  uint32_t* rings =
      reinterpret_cast<uint32_t*>(smem + tc_onehot_bytes(w, QB));
  uint8_t* staged_all = reinterpret_cast<uint8_t*>(rings) + tc_ring_bytes(w);
  int* lists = reinterpret_cast<int*>(staged_all + tc_staged_bytes(QB));
  const int q0 = blockIdx.x * QB;

  // 16-byte slot (c, row, t8) holds the one-hot of byte 8c + t8 of query
  // row's packed words: K columns 128c + 16 t8 ... + 15
  const int chunks = tc_k_words(w) / 2;
  for (int e = threadIdx.x; e < chunks * QB * 8; e += TC_THREADS) {
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
  fence_proxy_async();
  __syncthreads();

  const int g = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int range = blockIdx.y * TC_WG + g;
  if (range >= n_ranges) return;  // the whole warpgroup: no block barrier below
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int bar = 1 + g;
  const int nqb = min(QB, nq - q0);  // the block's queries
  // the warpgroup's staged counts [QB][TC_LD] int16, each query's list
  // threshold thr [QB] (at most its last entry: an offer that does not
  // beat it cannot enter) and each warp's hit words [4][QB / 32] (bit qq:
  // one of the warp's rows beats query qq's threshold)
  uint8_t* stg = staged_all + (size_t)g * tc_staged_bytes(QB) / TC_WG;
  int16_t* st = reinterpret_cast<int16_t*>(stg);
  int* thr = reinterpret_cast<int*>(stg + QB * TC_LD * 2);
  uint32_t* hits = reinterpret_cast<uint32_t*>(thr + QB);
  // list of query qq of the block: [g][0][qq] values, [g][1][qq] ids in
  // shared memory, else its partial output
  const size_t out0 = ((size_t)range * nq + q0) * top_k;
  int* lv0 = lists_in_smem ? lists + (size_t)2 * g * QB * top_k
                           : part_vals + out0;
  int* li0 = lists_in_smem ? lists + (size_t)(2 * g + 1) * QB * top_k
                           : part_ids + out0;
  for (int qq = warp; qq < QB; qq += 4) {
    if (lane == 0) thr[qq] = -1;
    if (qq < nqb)
      for (int i = lane; i < top_k; i += 32) {
        lv0[(size_t)qq * top_k + i] = -1;
        li0[(size_t)qq * top_k + i] = -1;
      }
  }
  __syncwarp();

  const int r0 = (int)min((long long)n, (long long)range * rows_per_range);
  const int r1 = min(n, r0 + rows_per_range);
  const int tiles = (r1 - r0 + TC_ROWS - 1) / TC_ROWS;
  uint32_t* ring = rings + (size_t)g * TC_STAGES * TC_ROWS * wp;
  // a tile's 64 * w words, element e = tid + 128 i at (row e / w, word
  // e % w), stepped without a division
  const int step_r = 128 / w, step_c = 128 % w;
  const int e_r = tid / w, e_c = tid % w;
  auto load_tile = [&](int t) {
    const uint32_t dst = smem_addr(ring + (t & 1) * TC_ROWS * wp);
    const int row0 = r0 + t * TC_ROWS;
    int r = e_r, c = e_c;
    while (r < TC_ROWS) {
      const bool ok = row0 + r < n;
      cp_async_4(dst + (r * wp + c) * 4,
                 db + (ok ? (size_t)(row0 + r) * w + c : 0), ok);
      r += step_r;
      c += step_c;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
    cp_async_commit();
  };

  int32_t acc[QB / 2];
#pragma unroll
  for (int i = 0; i < QB / 2; ++i) acc[i] = 0;
  uint32_t a0[2 * TC_KW][4], a1[2 * TC_KW][4];
#pragma unroll
  for (int i = 0; i < 2 * TC_KW; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) a0[i][v] = a1[i][v] = 0u;
  const uint64_t desc0 = desc_sw128(smem_addr(onehot));
  const int lr0 = warp * 16 + gid, lr1 = lr0 + 8;  // the thread's tile rows
  const int base = k - (32 / BITS) * w;            // k - F
  const int sh = 2 * tig;
  if (tiles > 0) load_tile(0);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles)
      load_tile(t + 1);
    else
      cp_async_commit();  // an empty group: tile t is then the one waited on
    cp_async_wait<1>();
    bar_sync(bar, 128);   // tile t landed; every warp is past tile t - 1

    const uint32_t* tile = ring + (t & 1) * TC_ROWS * wp;
    const uint32_t* rlo = tile + lr0 * wp;
    const uint32_t* rhi = tile + lr1 * wp;
    fence_regs<QB / 2>(acc);
    for (int j0 = 0; j0 < w; j0 += 2 * TC_KW) {
      tc_issue<BITS, QB>(acc, a0, rlo, rhi, j0, w, sh, desc0);
      wgmma_wait<1>();  // the batch before: a1 is free
#pragma unroll
      for (int i = 0; i < 2 * TC_KW; ++i) keep_regs<4>(a1[i]);
      tc_issue<BITS, QB>(acc, a1, rlo, rhi, j0 + TC_KW, w, sh, desc0);
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < 2 * TC_KW; ++i) keep_regs<4>(a0[i]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 2 * TC_KW; ++i) keep_regs<4>(a1[i]);
    fence_regs<QB / 2>(acc);

    // acc[4j + e] is tile row lr0 + 8 (e >> 1), query 8j + 2 tig + (e & 1)
    const int row0 = r0 + t * TC_ROWS;
    const int ra = row0 + lr0, rb = row0 + lr1;
    const bool oka = ra < r1 && (valid == nullptr ||
                                 ((valid[ra >> 5] >> (ra & 31)) & 1u));
    const bool okb = rb < r1 && (valid == nullptr ||
                                 ((valid[rb >> 5] >> (rb & 31)) & 1u));
    // bit (col % 32) of hm[col / 32]: one of the thread's rows beats
    // query col's threshold; then the warp's OR of them
    uint32_t hm[QB / 32];
#pragma unroll
    for (int i = 0; i < QB / 32; ++i) hm[i] = 0u;
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
      const int2 tj = *reinterpret_cast<const int2*>(thr + 8 * j + 2 * tig);
      const int t0 = tj.x - base, t1 = tj.y - base;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (((e >> 1) ? okb : oka) && acc[4 * j + e] > ((e & 1) ? t1 : t0))
          hm[j / 4] |= 1u << (8 * (j % 4) + 2 * tig + (e & 1));
    }
#pragma unroll
    for (int i = 0; i < QB / 32; ++i) {
      hm[i] = __reduce_or_sync(FULL, hm[i]);
      if (lane == 0) hits[warp * (QB / 32) + i] = hm[i];
    }
#pragma unroll
    for (int j = 0; j < QB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[(8 * j + 2 * tig + (e & 1)) * TC_LD + ((e >> 1) ? lr1 : lr0)] =
            (int16_t)(((e >> 1) ? okb : oka) ? base + acc[4 * j + e] : -1);
    bar_sync(bar, 128);   // hits and counts staged

    // the warp's queries (qq % 4 == warp) with a row that beats their
    // threshold, each over its 64 rows in ascending order; lane i < QB / 32
    // holds word i of their bits
    uint32_t hw = 0u;
    if (lane < QB / 32 && 32 * lane < nqb) {
      hw = (hits[lane] | hits[QB / 32 + lane] | hits[2 * (QB / 32) + lane] |
            hits[3 * (QB / 32) + lane]) & (0x11111111u << warp);
      if (nqb - 32 * lane < 32) hw &= (1u << (nqb - 32 * lane)) - 1u;
    }
#pragma unroll
    for (int i = 0; i < QB / 32; ++i)
      for (uint32_t h = __shfl_sync(FULL, hw, i); h; h &= h - 1) {
        const int qq = 32 * i + __ffs(h) - 1;
        const int c0 = st[qq * TC_LD + lane], c1 = st[qq * TC_LD + 32 + lane];
        int* lv = lv0 + (size_t)qq * top_k;
        int* li = li0 + (size_t)qq * top_k;
        int last = thr[qq];  // the list's last value
        if (top_k <= 32) {
          last = offer_regs<1>(lv, li, top_k, last, c0, c1, row0, lane);
        } else if (top_k <= 64) {
          last = offer_regs<2>(lv, li, top_k, last, c0, c1, row0, lane);
        } else {
          offer_batch<int>(lv, li, top_k, c0, row0 + lane, lane);
          offer_batch<int>(lv, li, top_k, c1, row0 + 32 + lane, lane);
          last = lv[top_k - 1];
        }
        if (lane == 0) thr[qq] = last;
      }
  }
  if (lists_in_smem)
    for (int qq = warp; qq < nqb; qq += 4)
      for (int i = lane; i < top_k; i += 32) {
        part_vals[out0 + (size_t)qq * top_k + i] = lv0[(size_t)qq * top_k + i];
        part_ids[out0 + (size_t)qq * top_k + i] = li0[(size_t)qq * top_k + i];
      }
}

template <int BITS, int QB>
cudaError_t launch_tc_t(const uint32_t* q, const uint32_t* db,
                        const uint32_t* valid, int32_t* pv, int32_t* pi,
                        int nq, int n, int w, int k, int top_k, int n_ranges,
                        size_t smem, int in_smem, cudaStream_t st) {
  const auto kernel = packed_topk_tc<BITS, QB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rpr = (n + n_ranges - 1) / n_ranges;
  const dim3 grid((nq + QB - 1) / QB, (n_ranges + TC_WG - 1) / TC_WG);
  kernel<<<grid, TC_THREADS, smem, st>>>(q, db, valid, pv, pi, nq, n, w, k,
                                         top_k, n_ranges, rpr, in_smem);
  return cudaGetLastError();
}

// Blocks of the tensor-core sweep an SM holds at `smem` bytes.
inline cudaError_t tc_occupancy(int bits, int qb, size_t smem, int* blocks) {
  const void* fn =
      bits == 1 ? (qb == 128 ? (const void*)packed_topk_tc<1, 128>
                             : (const void*)packed_topk_tc<1, 64>)
                : (qb == 128 ? (const void*)packed_topk_tc<2, 128>
                             : (const void*)packed_topk_tc<2, 64>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, TC_THREADS,
                                                       smem);
}

// The count sweep of a plan: per query, the stable top_k of each of
// n_ranges contiguous corpus ranges into part_vals/part_ids [n_ranges, nq,
// top_k]. qb > 0: the tensor-core kernel, QB = qb (64 or 128), `smem`
// bytes, lists in shared memory when lists_in_smem (the wrappers' plan);
// qb == 0: packed_topk_partial. valid: the rows' bitmask, or null.
inline cudaError_t launch_sweep(const uint32_t* q, const uint32_t* db,
                                const uint32_t* valid, int32_t* pv,
                                int32_t* pi, int nq, int n, int w, int bits,
                                int k, int top_k, int n_ranges, int qb,
                                size_t smem, int in_smem, cudaStream_t st) {
  if (qb == 0)
    return launch_partial_ranges(q, db, valid, pv, pi, nq, n, w, bits, k,
                                 top_k, n_ranges, st);
  if ((bits != 1 && bits != 2) || (qb != 64 && qb != 128))
    return cudaErrorInvalidValue;
#define TC_ARGS q, db, valid, pv, pi, nq, n, w, k, top_k, n_ranges, smem, in_smem, st
  if (bits == 1)
    return qb == 128 ? launch_tc_t<1, 128>(TC_ARGS) : launch_tc_t<1, 64>(TC_ARGS);
  return qb == 128 ? launch_tc_t<2, 128>(TC_ARGS) : launch_tc_t<2, 64>(TC_ARGS);
#undef TC_ARGS
}

}  // namespace
