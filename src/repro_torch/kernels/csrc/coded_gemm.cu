// Coded projection on Hopper's tensor cores: z = x @ R to float32
// accuracy as three TF32 products (3xTF32), then the coding scheme (and,
// for encode_fused, the b-bit pack) applied to the accumulator in
// registers and shared memory.
//
// Replaces two TPU kernels of the JAX reference, which do their product
// on the MXU (a jnp.dot in the kernel body):
//   coded_project  <- src/repro/kernels/proj_code.py::coded_project_pallas
//                     (int32 codes [M, K])
//   encode_fused   <- src/repro/kernels/encode_fused.py::encode_fused_pallas
//                     (packed uint32 words [M, ceil(K*b/32)])
// As there, neither the float32 projections nor (for encode_fused) the
// int32 codes are ever written to device memory: the only write-back is
// codes or packed words.
//
// Bound on this card: tensor-core issue. At the main path's shape
// (D = 1024, K = 256) the product does 2*M*D*K flops on (M*D + D*K)*4
// bytes, about 128 flops a byte. TF32 alone keeps 11 significant bits,
// about 1e-3 relative, far outside the port's contract (codes may differ
// from the IEEE float32 product only within 1e-5 of a bin edge). So each
// operand is split into TF32 parts, v = hi + lo with hi = rna_tf32(v) and
// lo = rna_tf32(v - hi) (v - hi is exact), and the kernel takes
// lo_x*hi_r + hi_x*lo_r + hi_x*hi_r, dropping lo_x*lo_r: each product
// term then errs by about 3 * 2^-22 of |x_i r_i|, some 1e-6 on z for unit
// rows at D = 1024. That is three tensor-core products a multiply-add, so
// the bound is 3 * 2*M*D*K / 495 TFLOP/s (0.208 ms at M = 65,536), above
// the bytes' 0.082 ms. A bf16 R is exact in TF32: its lo plane is zero,
// is neither stored nor loaded, and the kernel takes two products.
//
// Design:
// * Operands. wgmma reads 32-bit operands from shared memory only
//   K-major, so R enters as R^T, split once by the wrapper's split_r
//   (the encoder caches it beside R): float32 planes [P, K, Dp], hi and
//   lo (P = 2) or hi alone (P = 1, bf16 R), Dp = D rounded up to a
//   multiple of 4 with zero columns. x [M, D] is K-major as it is; each
//   consumer thread splits its own fragment (cvt.rna.tf32.f32) and feeds
//   wgmma's register A operand, so x's parts never touch shared memory.
// * Pipeline. A ring of shared-memory stages (4), each a 32-deep slab of D:
//   the x tile [BM x 32] and the R^T hi and lo tiles [BN x 32], all
//   128-byte swizzled. One producer warp keeps them in flight with TMA
//   and mbarriers (full: bytes landed; empty: every consumer warp done).
//   TMA needs a 16-byte-aligned row stride, so an x with D % 4 != 0 (or
//   an unaligned base) is copied by the producer warp with 4-byte
//   cp.async, zero-filled past M and D, written in the same swizzled
//   layout; R^T's padded planes always go by TMA.
// * Accumulation. For each slab, a warpgroup issues, for each of its
//   four 8-deep steps, lo_x*hi_r, hi_x*lo_r, then hi_x*hi_r into one
//   float32 accumulator that the slab's first product starts afresh
//   (scale-d 0); after the slab's wgmmas complete, the accumulator is
//   added into a float32 sum in registers with IEEE adds. The tensor
//   cores' own accumulation rounds each of their steps with no IEEE
//   guarantee; restarting it every slab keeps what it adds up to 12
//   steps of a 32-term partial, and the 32 slab partials (at D = 1024)
//   add with round-to-nearest. This costs a second register array, so a
//   warpgroup holds 64 rows x 128 columns (64 + 64 floats a thread), not
//   K = 256 whole: encode_fused's blocks are 128 x 128 (two consumer
//   warpgroups that take turns on the tensor cores), the two column
//   blocks of a row block launched next to each other so that x comes
//   from device memory once and from L2 the second time.
// * Register A. wgmma reads the A fragments until its wait, but the
//   compiler counts them dead once the instruction is issued: keep_regs
//   uses them after the wait, so their registers are not reused while
//   the tensor cores read them. (A version that loaded the next slab's
//   fragments while the products ran gave other bits from launch to
//   launch.)
// * The sum order is fixed by D alone: slabs in ascending order, the
//   same three products a step in both kernels, no split of D, no
//   atomics. A row's bits therefore depend neither on M, nor on the tile
//   or ring, nor on the run; coded_project and encode_fused code a row
//   alike.
// * coded_project fills the card at M = 1,024 with 64 x 32 blocks (one
//   consumer warpgroup): 128 blocks. Its time is one block's latency,
//   32 slabs in sequence, at every M up to 1,024; only a split of D
//   would shorten it, and that changes the sum order.
// * Tiles and rings are constants (CP_*, EF_* below);
//   scripts/gemm_tile_sweep.py builds and times other values, each held
//   bit-identical to these, which it found the fastest at the main
//   path's shapes.
// * Epilogue. code_of (code_common.cuh, shared with code_pack.cu) codes
//   each sum in registers; fields past K are code 0. coded_project
//   stores its codes straight from the fragments (each quad of threads
//   covers 8 consecutive columns of a row); encode_fused stages 16-bit
//   codes in the drained ring and writes each packed word once, a row's
//   words by consecutive threads.
//
// Errors from the launch function: a CUDA error code; 999 when
// libcuda's cuTensorMapEncodeTiled cannot be found; 1000 + its CUresult
// when it refuses a tensor map.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "code_common.cuh"
#include "wgmma_common.cuh"

namespace {

// Tiles and rings: consumer warpgroups (64 rows each), tile width and
// stages of coded_project (CP_) and encode_fused (EF_).
// scripts/gemm_tile_sweep.py times other values in copies of this file;
// none changes a bit, as a row's sum order is fixed by D alone.
constexpr int CP_WG = 1, CP_BN = 32, CP_STAGES = 4;
constexpr int EF_WG = 2, EF_BN = 128, EF_STAGES = 4;
constexpr int SLAB = 32;            // D-depth of a stage: 128 bytes of float32
constexpr int ROW_BYTES = SLAB * 4;

// Byte offset of element (row, col < 32) in a tile of 128-byte rows under
// the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B on a
// 1024-byte-aligned tile): the 16-byte chunk index XOR row % 8.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * ROW_BYTES + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2));
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);  // exact
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// D[64 x 16] (+)= A[64 x 8] (registers) * B[16 x 8]^T (shared memory)
__device__ __forceinline__ void mma_n16(float* d, const uint32_t* a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 8] (registers) * B[32 x 8]^T (shared memory)
__device__ __forceinline__ void mma_n32(float* d, const uint32_t* a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] (registers) * B[64 x 8]^T (shared memory)
__device__ __forceinline__ void mma_n64(float* d, const uint32_t* a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 8] (registers) * B[128 x 8]^T (shared memory)
__device__ __forceinline__ void mma_n128(float* d, const uint32_t* a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
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
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b,
                                    int accumulate) {
  static_assert(BN == 16 || BN == 32 || BN == 64 || BN == 128, "tile width");
  if constexpr (BN == 128)
    mma_n128(d, a, b, accumulate);
  else if constexpr (BN == 64)
    mma_n64(d, a, b, accumulate);
  else if constexpr (BN == 32)
    mma_n32(d, a, b, accumulate);
  else
    mma_n16(d, a, b, accumulate);
}

// A fragments of a slab's four 8-deep steps, split into TF32 parts:
// element v of step kk is tile row r0 + 8 * (v & 1), column
// 8 * kk + tig + 4 * (v >> 1) (wgmma's register layout for 32-bit A)
__device__ __forceinline__ void load_a(const uint8_t* xs, int r0, int tig,
                                       uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float xv = *reinterpret_cast<const float*>(
          xs + swz(r0 + 8 * (v & 1), 8 * kk + tig + 4 * (v >> 1)));
      split_tf32(xv, hi[kk][v], lo[kk][v]);
    }
}

// WG consumer warpgroups of 64 rows each (the block's BM = 64 * WG rows),
// BN columns, one producer warp, a ring of STAGES slabs. PACK: packed
// words of `bits` bits, else int32 codes. THREE: R has a lo plane
// (float32 R), else two products.
template <int WG, int BN, int STAGES, bool PACK, bool THREE>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
coded_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap rmap,
                  const float* __restrict__ x, int tma_x,
                  const float* __restrict__ q, void* __restrict__ out, int m,
                  int d, int k, int scheme, float w, int n_side, int bits) {
  static_assert(!PACK || BN % 32 == 0, "a tile holds whole words");
  constexpr int BM = 64 * WG;
  constexpr int X_BYTES = BM * ROW_BYTES, R_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = X_BYTES + 2 * R_BYTES;
  constexpr int CONSUMERS = WG * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;

  const int n_cb = (k + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_cb) * BM, n0 = (blockIdx.x % n_cb) * BN;
  const int n_slabs = (d + SLAB - 1) / SLAB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, tma_x ? 1 : 33);  // + 32 cp.async arrivals
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp
    const uint32_t tx = (tma_x ? X_BYTES : 0) + R_BYTES * (THREE ? 2 : 1);
    for (int s = 0; s < n_slabs; ++s) {
      const int st = s % STAGES;
      const uint32_t stage = base + st * STAGE_BYTES;
      mbar_wait(empty + 8 * st, ((s / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full + 8 * st, tx);
        if (tma_x) tma_2d(stage, &xmap, full + 8 * st, s * SLAB, m0);
        tma_3d(stage + X_BYTES, &rmap, full + 8 * st, s * SLAB, n0, 0);
        if (THREE)
          tma_3d(stage + X_BYTES + R_BYTES, &rmap, full + 8 * st, s * SLAB, n0, 1);
      }
      if (!tma_x) {
        const int col = s * SLAB + lane;
        for (int row = 0; row < BM; ++row) {
          const bool ok = m0 + row < m && col < d;
          cp_async_4(stage + swz(row, lane),
                     ok ? x + (size_t)(m0 + row) * d + col : x, ok);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                         full + 8 * st)
                     : "memory");
      }
    }
    if (!tma_x) asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumers: thread (gid, tig) of warp wi in warpgroup g holds tile rows
  // r0 and r0 + 8; sum[4j + e] is row r0 + 8 * (e >> 1), column
  // 8j + 2 * tig + (e & 1)
  const int g = warp / 4, wi = warp % 4, gid = lane / 4, tig = lane % 4;
  const int r0 = g * 64 + wi * 16 + gid;
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;

  for (int s = 0; s < n_slabs; ++s) {
    const int st = s % STAGES;
    const uint32_t stage = base + st * STAGE_BYTES;
    mbar_wait(full + 8 * st, (s / STAGES) & 1);
    uint32_t ahi[4][4], alo[4][4];
    load_a(smem + st * STAGE_BYTES, r0, tig, ahi, alo);
    const uint64_t dhi = desc_sw128(stage + X_BYTES);
    const uint64_t dlo = desc_sw128(stage + X_BYTES + R_BYTES);
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma<BN>(acc, alo[kk], dhi + 2 * kk, kk > 0);
      if (THREE) mma<BN>(acc, ahi[kk], dlo + 2 * kk, 1);
      mma<BN>(acc, ahi[kk], dhi + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BN / 2>(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      keep_regs<4>(ahi[kk]);
      keep_regs<4>(alo[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
  }

  if constexpr (!PACK) {
    int32_t* codes = static_cast<int32_t*>(out);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + r0 + 8 * (e >> 1), col = n0 + 8 * j + 2 * tig + (e & 1);
        if (row < m && col < k)
          codes[(size_t)row * k + col] = code_of(
              sum[4 * j + e], scheme == OFFSET ? q[col] : 0.f, scheme, w, n_side);
      }
  } else {
    // codes [BM][BN + 2] (uint16) in the drained ring: the padding puts
    // the 8 rows of a quad's store in 8 banks
    constexpr int CLD = BN + 2;
    uint16_t* codes = reinterpret_cast<uint16_t*>(smem);
    bar_sync(1, CONSUMERS);  // every warpgroup is past the ring
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tig + (e & 1), col = n0 + c;
        codes[(r0 + 8 * (e >> 1)) * CLD + c] =
            col < k ? (uint16_t)code_of(sum[4 * j + e],
                                        scheme == OFFSET ? q[col] : 0.f,
                                        scheme, w, n_side)
                    : 0;
      }
    bar_sync(1, CONSUMERS);
    const int cpw = 32 / bits, wpr = BN / cpw;
    const int n_words = (k + cpw - 1) / cpw, w0 = n0 / cpw;
    uint32_t* words = static_cast<uint32_t*>(out);
    for (int e = threadIdx.x; e < BM * wpr; e += CONSUMERS) {
      const int row = e / wpr, wc = e % wpr;
      if (m0 + row >= m || w0 + wc >= n_words) continue;
      uint32_t word = 0;
      for (int f = 0; f < cpw; ++f)
        word |= (uint32_t)codes[row * CLD + wc * cpw + f] << (f * bits);
      words[(size_t)(m0 + row) * n_words + w0 + wc] = word;
    }
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

// float32 tensor map of `rank` dims (innermost first), box `box`, the
// 128-byte swizzle; out-of-bounds elements read as zero
int tensor_map(CUtensorMap* map, const void* ptr, int rank,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return 999;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                          const_cast<void*>(ptr), dims, strides, box, ones,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + (int)res;
}

template <int WG, int BN, int STAGES, bool PACK, bool THREE>
int launch(const float* x, const float* rsplit, int planes, int dp,
           const float* q, void* out, int m, int d, int k, int scheme, float w,
           int n_side, int bits, cudaStream_t stream) {
  constexpr int BM = 64 * WG;
  constexpr int SMEM = STAGES * (BM + 2 * BN) * ROW_BYTES + 16 * STAGES + 1024;
  const auto kernel = coded_gemm_kernel<WG, BN, STAGES, PACK, THREE>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap xmap = {}, rmap = {};
  const int tma_x = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (d > 0) {
    if (tma_x) {
      const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)m};
      const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
      const cuuint32_t box[2] = {SLAB, BM};
      if (int err = tensor_map(&xmap, x, 2, dims, strides, box)) return err;
    }
    const cuuint64_t dims[3] = {(cuuint64_t)dp, (cuuint64_t)k, (cuuint64_t)planes};
    const cuuint64_t strides[2] = {(cuuint64_t)dp * 4, (cuuint64_t)k * dp * 4};
    const cuuint32_t box[3] = {SLAB, BN, 1};
    if (int err = tensor_map(&rmap, rsplit, 3, dims, strides, box)) return err;
  }
  const long long blocks = (long long)((m + BM - 1) / BM) * ((k + BN - 1) / BN);
  kernel<<<(unsigned)blocks, WG * 128 + 32, SMEM, stream>>>(
      xmap, rmap, x, tma_x, q, out, m, d, k, scheme, w, n_side, bits);
  return (int)cudaGetLastError();
}

}  // namespace

// rsplit: R^T's TF32 planes [planes, K, dp] float32 (planes 2: hi, lo;
// planes 1: hi of a bf16 R), dp = D rounded up to a multiple of 4.
// bits = 0: int32 codes [M, K] (coded_project); else packed words of
// `bits` bits [M, ceil(K*bits/32)] (encode_fused).
extern "C" int coded_gemm_launch(const float* x, const float* rsplit,
                                 int planes, int dp, const float* q, void* out,
                                 int m, int d, int k, int scheme, float w,
                                 int n_side, int bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CODED_GEMM_ARGS x, rsplit, planes, dp, q, out, m, d, k, scheme, w, n_side, bits, st
  if (bits == 0)
    return planes == 2
               ? launch<CP_WG, CP_BN, CP_STAGES, false, true>(CODED_GEMM_ARGS)
               : launch<CP_WG, CP_BN, CP_STAGES, false, false>(CODED_GEMM_ARGS);
  return planes == 2
             ? launch<EF_WG, EF_BN, EF_STAGES, true, true>(CODED_GEMM_ARGS)
             : launch<EF_WG, EF_BN, EF_STAGES, true, false>(CODED_GEMM_ARGS);
#undef CODED_GEMM_ARGS
}
