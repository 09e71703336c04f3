// All-pairs collision counts on packed words.
//
// Replaces src/repro/kernels/packed_collision.py::
// packed_collision_counts_pallas: query words [Q, W] x corpus words
// [N, W] -> int32 counts [Q, N], query-major, count = k - sum_w
// popcount(fold(q XOR db)) with packed_topk.cu's field fold
// (topk_common.cuh). Two kernels; the wrapper's counts_plan picks one by
// shape, before the launch, and a failed launch raises:
//
// * packed_counts_tc, for 1- and 2-bit codes whose one-hot queries fit
//   shared memory: the count as an exact int8 product on the tensor
//   cores, count = k - F + onehot(q) . onehot(row) (onehot_tc.cuh).
// * packed_counts, the popcount kernel, for 4-, 8- and 16-bit codes and
//   rows too wide for the tensor kernel.
//
// Bound on this card: bytes. The [Q, N] int32 result is written whole:
// 4.29 GB at the main path's LSH chunk (Q = 256, N = 4,194,304, W = 16),
// 1.28 ms at 3.35 TB/s. The one-hot product is 2 Q N 64W int8 operations,
// 1.11 ms at 1,979 TOPS; the popcount fold one popc a (query, row,
// word), 4.11 ms at the popcount rate.
//
// Design of packed_counts_tc. The one-hot queries, the corpus ring and the
// A fragments are the count sweep's (topk_tc.cuh); the epilogue is new,
// as the kernel's bound is its stores:
// * A block holds QB queries' one-hot (128, or 64 where it does not fit
//   or there are at most 64 queries), u8 K-major under the 128-byte
//   swizzle, for its life. Its two warpgroups each walk their own tiles
//   of 64 corpus rows: the grid is the card's resident blocks over the
//   query blocks (the wrapper's plan), and warpgroup i of the grid's
//   columns takes tiles i, i + 2 gridDim.y, ... (blocks of one column
//   and different query blocks read the same rows at about the same
//   time, the second from L2). Packed rows stream through a 2-stage
//   cp.async ring a warpgroup; each thread builds its A fragments from
//   its two rows' words; wgmma m64nQBk32 s32.u8.u8 in batches of 8.
// * Epilogue: k - F + acc, staged in shared memory query-major as two
//   [QB][32] int32 halves of 128-byte rows under the 128-byte swizzle
//   (the 16-byte chunk index XOR query % 8: a warp's 32 writes fall in
//   32 banks), then written out, each query's 64 rows as 256 contiguous
//   bytes, by TMA 2-D stores of both halves from shared memory (issued
//   by one thread; they clip rows past N and queries past Q). TMA needs
//   a 16-byte row stride, so where N is not a multiple of 4 the
//   warpgroup writes the staged tile itself with 4-byte streaming
//   stores. The plan picks the form by N. (16-byte st.global.cs.v4
//   stores from the warpgroup took 11-12 % longer than TMA's at the
//   main path's shape, so they went.)
// * The two warpgroups take turns on the tensor cores: while one stages
//   and stores a tile, the other's wgmmas run, so the store stream
//   overlaps the products. The staging is single-buffered a
//   warpgroup: a TMA store reads 32 KB of shared memory in well under a
//   tile's wgmmas, and the next staging waits for that read. A second
//   staging buffer does not fit at QB 128 and W 16: 215,040 bytes now,
//   65,536 more past the 232,448 a block may have.
// * Rows past N are zero-filled in the ring and never written; nor are
//   queries past Q. The sums are integers, so the bits are the popcount
//   kernel's at any tile order.
//
// Design of packed_counts. The TPU kernel tiles (query, row, word) and
// accumulates over word tiles in VMEM. Here a block of 128 threads takes
// 128 consecutive rows and qt queries (32 by default; the wrapper's
// block_q, which changes no bit): the queries' words sit in shared
// memory (read as broadcasts), each thread holds its row's words in
// registers (W <= 16 or 64; wider rows are read from device memory) and
// writes its qt counts, so each warp's stores are 128 contiguous bytes of
// one output row. Every corpus word is read once per qt queries.
//
// Errors from the tensor kernel's launch: a CUDA error code; 999 when
// libcuda's cuTensorMapEncodeTiled cannot be found; 1000 + its CUresult
// when it refuses the output's tensor map.
#include <cuda.h>
#include <dlfcn.h>

#include "onehot_tc.cuh"
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

// ---- packed_counts_tc -------------------------------------------------

constexpr int CT_WG = 2;               // warpgroups a block, tiles of their own
constexpr int CT_THREADS = CT_WG * 128;
constexpr int CT_ROWS = 64;            // corpus rows a tile: wgmma's M
constexpr int CT_STAGES = 2;           // corpus tiles in a warpgroup's ring

// Shared memory after the 1024-byte alignment (the wrapper's
// packed_collision.counts_layout mirrors it): the one-hot queries, the
// two warpgroups' staged counts [2][QB][32] int32, their rings.
__host__ __device__ inline size_t ct_staged_bytes(int qb) {
  return (size_t)qb * CT_ROWS * 4;     // a warpgroup's
}
__host__ __device__ inline size_t ct_smem_bytes(int w, int qb) {
  return 1024 + tc_onehot_bytes(w, qb) + CT_WG * ct_staged_bytes(qb) +
         (size_t)CT_WG * CT_STAGES * CT_ROWS * (w | 1) * 4;
}

// TMA 2-D store of a box from shared memory at coordinates (c0, c1),
// innermost first, in the thread's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// waits until the thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// waits until the thread's bulk stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int BITS, int QB, bool TMA>
__global__ void __launch_bounds__(CT_THREADS, 1)
packed_counts_tc(const __grid_constant__ CUtensorMap omap,
                 const uint32_t* __restrict__ q,
                 const uint32_t* __restrict__ db, int32_t* __restrict__ out,
                 int nq, int n, int w, int k) {
  extern __shared__ uint8_t ct_raw[];
  uint8_t* smem = ct_raw + ((1024 - (smem_addr(ct_raw) & 1023)) & 1023);
  const int wp = w | 1;
  uint8_t* onehot = smem;
  uint8_t* staged = smem + tc_onehot_bytes(w, QB);
  uint32_t* rings =
      reinterpret_cast<uint32_t*>(staged + CT_WG * ct_staged_bytes(QB));
  const int q0 = blockIdx.x * QB;
  tc_onehot_queries<BITS, QB>(onehot, q, q0, nq, w, threadIdx.x, CT_THREADS);
  fence_proxy_async();
  __syncthreads();

  const int g = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tiles = (n + CT_ROWS - 1) / CT_ROWS;
  const int wg0 = blockIdx.y * CT_WG + g, n_wg = gridDim.y * CT_WG;
  if (wg0 >= tiles) return;  // the whole warpgroup: no block barrier below
  const int my_tiles = (tiles - 1 - wg0) / n_wg + 1;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int bar = 1 + g;
  const int nqb = min(QB, nq - q0);
  // the warpgroup's staged counts: half h (rows 32h ..) of query p at
  // h QB 128 + p 128 bytes, 16-byte chunk c of it at (c ^ p % 8) 16
  uint8_t* stg = staged + (size_t)g * ct_staged_bytes(QB);
  uint32_t* ring = rings + (size_t)g * CT_STAGES * CT_ROWS * wp;
  // a tile's 64 * w words, element e = tid + 128 i at (row e / w, word
  // e % w), stepped without a division
  const int step_r = 128 / w, step_c = 128 % w;
  const int e_r = tid / w, e_c = tid % w;
  auto load_tile = [&](int i) {
    const uint32_t dst = smem_addr(ring + (i & 1) * CT_ROWS * wp);
    const int row0 = (wg0 + i * n_wg) * CT_ROWS;
    int r = e_r, c = e_c;
    while (r < CT_ROWS) {
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
  load_tile(0);
  for (int i = 0; i < my_tiles; ++i) {
    if (i + 1 < my_tiles)
      load_tile(i + 1);
    else
      cp_async_commit();  // an empty group: tile i is then the one waited on
    cp_async_wait<1>();
    bar_sync(bar, 128);   // tile i landed; every warp is past tile i - 1

    const uint32_t* tile = ring + (i & 1) * CT_ROWS * wp;
    const uint32_t* rlo = tile + lr0 * wp;
    const uint32_t* rhi = tile + lr1 * wp;
    fence_regs<QB / 2>(acc);
    for (int j0 = 0; j0 < w; j0 += 2 * TC_KW) {
      tc_issue<BITS, QB>(acc, a0, rlo, rhi, j0, w, sh, desc0);
      wgmma_wait<1>();  // the batch before: a1 is free
#pragma unroll
      for (int t = 0; t < 2 * TC_KW; ++t) keep_regs<4>(a1[t]);
      tc_issue<BITS, QB>(acc, a1, rlo, rhi, j0 + TC_KW, w, sh, desc0);
      wgmma_wait<1>();
#pragma unroll
      for (int t = 0; t < 2 * TC_KW; ++t) keep_regs<4>(a0[t]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 2 * TC_KW; ++t) keep_regs<4>(a1[t]);
    fence_regs<QB / 2>(acc);

    const int row0 = (wg0 + i * n_wg) * CT_ROWS;
    if constexpr (TMA) {
      if (tid == 0) bulk_wait_read();  // tile i - 1's stores read the staging
      bar_sync(bar, 128);
    }
    // acc[4j + e] is tile row lr0 + 8 (e >> 1), query 8j + 2 tig + (e & 1)
#pragma unroll
    for (int j = 0; j < QB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 8 * j + 2 * tig + (e & 1);
        const int r = (e >> 1) ? lr1 : lr0;
        const int rr = r & 31;
        *reinterpret_cast<int32_t*>(
            stg + (r >> 5) * QB * 128 + p * 128 +
            ((((rr >> 2) ^ (p & 7)) << 4) | ((rr & 3) << 2))) =
            base + acc[4 * j + e];
      }
    if constexpr (TMA) {
      fence_proxy_async();  // the staging, visible to the TMA unit
      bar_sync(bar, 128);
      if (tid == 0) {
        tma_store_2d(&omap, smem_addr(stg), row0, q0);
        tma_store_2d(&omap, smem_addr(stg + QB * 128), row0 + 32, q0);
        bulk_commit();
      }
    } else {
      bar_sync(bar, 128);  // counts staged
      // lanes 0-15 write query p's 64 rows (256 bytes), 16-31 query p + 1
      const int h = (lane >> 3) & 1, c = lane & 7;
      const int r = row0 + 32 * h + 4 * c;
      for (int p = 2 * warp + (lane >> 4); p < nqb; p += 8) {
        const int4 v = *reinterpret_cast<const int4*>(
            stg + h * QB * 128 + p * 128 + ((c ^ (p & 7)) << 4));
        int32_t* dst = out + (size_t)(q0 + p) * n + r;
        if (r < n) __stcs(dst, v.x);
        if (r + 1 < n) __stcs(dst + 1, v.y);
        if (r + 2 < n) __stcs(dst + 2, v.z);
        if (r + 3 < n) __stcs(dst + 3, v.w);
      }
    }
  }
  if constexpr (TMA) {
    if (tid == 0) bulk_wait();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor-map encoder of libcuda, which the process has already
// loaded (this library links no libcuda stub).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

template <int BITS, int QB, bool TMA>
const void* tc_kernel() {
  return (const void*)packed_counts_tc<BITS, QB, TMA>;
}

const void* tc_kernel_of(int bits, int qb, int tma) {
  if (bits == 1)
    return qb == 128 ? (tma ? tc_kernel<1, 128, true>() : tc_kernel<1, 128, false>())
                     : (tma ? tc_kernel<1, 64, true>() : tc_kernel<1, 64, false>());
  return qb == 128 ? (tma ? tc_kernel<2, 128, true>() : tc_kernel<2, 128, false>())
                   : (tma ? tc_kernel<2, 64, true>() : tc_kernel<2, 64, false>());
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

// The tensor kernel of a plan (packed_collision.counts_plan): bits 1 or
// 2, QB = qb (64 or 128), grid (ceil(nq / qb), grid_y), `smem` bytes
// (ct_smem_bytes), TMA stores when tma (n a multiple of 4), else 4-byte
// stores. out: [nq, n] int32, 16-byte aligned.
extern "C" int packed_counts_tc_launch(const uint32_t* q, const uint32_t* db,
                                       int32_t* out, int nq, int n, int w,
                                       int bits, int k, int qb, int grid_y,
                                       int smem, int tma, void* stream) {
  if ((bits != 1 && bits != 2) || (qb != 64 && qb != 128) || grid_y < 1 ||
      (size_t)smem < ct_smem_bytes(w, qb) || (tma && n % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const void* fn = tc_kernel_of(bits, qb, tma);
  cudaError_t err = open_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap omap = {};
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return 999;
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)nq};
    const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
    const cuuint32_t box[2] = {32, (cuuint32_t)qb};
    const cuuint32_t ones[2] = {1, 1};
    const CUresult res = encode(
        &omap, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, out, dims, strides, box,
        ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return 1000 + (int)res;
  }
  const dim3 grid((nq + qb - 1) / qb, grid_y);
  void* args[] = {&omap, (void*)&q, (void*)&db, (void*)&out, &nq, &n, &w, &k};
  err = cudaLaunchKernel(fn, grid, dim3(CT_THREADS), args, (size_t)smem,
                         (cudaStream_t)stream);
  return (int)err;
}

// Blocks of the tensor kernel an SM holds at `smem` bytes.
extern "C" int packed_counts_tc_occupancy(int bits, int qb, int tma, int smem,
                                          int* blocks) {
  if ((bits != 1 && bits != 2) || (qb != 64 && qb != 128))
    return (int)cudaErrorInvalidValue;
  const void* fn = tc_kernel_of(bits, qb, tma);
  const cudaError_t err = open_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                           CT_THREADS, smem);
}
