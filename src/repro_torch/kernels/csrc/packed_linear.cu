// Linear classifier kernels on packed codes: margins and table gradients.
//
// Replaces src/repro/kernels/packed_linear.py:
//   packed_linear_fwd_pallas (:110) and packed_linear_fwd_masked_pallas
//   (:154): class weight tables float32 [C, F*P] x words [N, W] -> margins
//   float32 [C, N]; margin[c, n] adds, in (word, field) order from 0.0, the
//   entry each b-bit field of row n selects; the masked form writes 0.0
//   for a row whose validity bit is clear.
//   packed_linear_bwd_pallas (:216) and packed_linear_bwd_masked_pallas
//   (:273): margin gradients g float32 [C, N] x words -> table gradients
//   float32 [C, F*P], dT[c, f*P + v] = sum of g[c, n] over the rows whose
//   field f holds code v; the masked form leaves dead rows out.
//
// Bound on this card: bytes. At the learn path's shapes (N = 2,330,594
// rows, W = 16 words of 2-bit fields, C = 1) the forward reads 149 MB of
// words and writes 9 MB of margins, about 0.047 ms at 3.35 TB/s, against
// N*F = 597M float adds (0.009 ms at 67 TFLOP/s); the backward reads the
// same words and 9 MB of g.
//
// Forward design. The TPU kernel streams corpus tiles through a select
// tree with one class tile resident. Here one thread scores one row for
// every class of its block's class tile: the tile's tables sit in shared
// memory (4 KB a class at 2-bit and k = 256; a tile holds what fits in 96
// KB, and wider tables are read from device memory). The row is decoded
// once for up to 8 classes: score_row_classes of lut_common.cuh (the LUT
// kernels' score_row is its one-class case), the (word, field) order with
// __fadd_rn for each class, with 8, 4, 2 or 1 accumulators in registers. One kernel serves both forms: the bitmask
// pointer is null for the plain one.
//
// Backward design. The TPU kernel expands each row tile to a one-hot tile
// in registers and accumulates g_tile @ onehot on the MXU. On this card a
// float atomic per (row, field) would make the sum order, and so the
// result, change from run to run. Two kernels instead fix the order of
// ref.packed_linear_bwd_ref: the first writes one partial per block_n
// chunk of rows, [chunks, C, F*P], one thread per (chunk, class, field)
// walking the chunk's rows in ascending order and adding g onto its own P
// entries (in registers for P <= 16, read-modify-write in the zeroed
// partial buffer for 8- and 16-bit fields); the second adds the partials
// onto the accumulator in chunk order, one thread per output entry. Chunks
// go in groups whose partials fit the scratch the wrapper gives (about 19
// MB a class at the learn path's shape, one group); a later group's fold
// continues from the accumulator, so the order is the same. A dead row is
// skipped, which equals adding 0.0 (a partial that starts at +0.0 is never
// -0.0). Phantom field slots and entries are computed like any other; the
// caller masks them (learn.features.entry_mask).
#include "lut_common.cuh"

namespace {

constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 256;
constexpr int FOLD_THREADS = 256;

__device__ __forceinline__ bool row_live(const uint32_t* valid, int r) {
  return valid == nullptr || ((valid[r >> 5] >> (r & 31)) & 1u);
}

// CB classes of one row -> out[c * n] (0.0 for a dead row).
template <int CB>
__device__ __forceinline__ void score_block(const float* tab, int fp,
                                            const uint32_t* row, int w,
                                            int bits, bool live, float* out,
                                            int n) {
  float s[CB];
  if (live) {
    score_row_classes<CB>(tab, fp, row, w, bits, s);
  } else {
#pragma unroll
    for (int c = 0; c < CB; ++c) s[c] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < CB; ++c) out[(size_t)c * n] = s[c];
}

__global__ void __launch_bounds__(FWD_THREADS)
linear_fwd(const float* __restrict__ tables, const uint32_t* __restrict__ words,
           const uint32_t* __restrict__ valid, float* __restrict__ out, int c,
           int n, int w, int bits, int fp, int class_tile, int in_smem) {
  extern __shared__ __align__(16) float stab[];
  const int c0 = blockIdx.y * class_tile;
  const int nc = min(class_tile, c - c0);
  const float* tab = tables + (size_t)c0 * fp;
  if (in_smem) {
    for (int i = threadIdx.x; i < nc * fp; i += FWD_THREADS) stab[i] = tab[i];
    __syncthreads();
    tab = stab;
  }
  const int row = blockIdx.x * FWD_THREADS + threadIdx.x;
  if (row >= n) return;
  const bool live = row_live(valid, row);
  const uint32_t* r = words + (size_t)row * w;
  float* o = out + (size_t)c0 * n + row;
  for (int j = 0; j < nc;) {
    const float* t = tab + (size_t)j * fp;
    float* oj = o + (size_t)j * n;
    const int m = nc - j;
    if (m >= 8) {
      score_block<8>(t, fp, r, w, bits, live, oj, n);
      j += 8;
    } else if (m >= 4) {
      score_block<4>(t, fp, r, w, bits, live, oj, n);
      j += 4;
    } else if (m >= 2) {
      score_block<2>(t, fp, r, w, bits, live, oj, n);
      j += 2;
    } else {
      score_block<1>(t, fp, r, w, bits, live, oj, n);
      j += 1;
    }
  }
}

// One thread per (chunk of the group, class, field); P <= 16 entries
// accumulate in registers, each row's add predicated on its code and, in
// the masked form, on its validity bit (no branch, so the loads of
// successive rows overlap; a dead row's word and g are read, not added).
template <int P>
__global__ void __launch_bounds__(BWD_THREADS)
linear_bwd_partial_reg(const float* __restrict__ g,
                       const uint32_t* __restrict__ words,
                       const uint32_t* __restrict__ valid,
                       float* __restrict__ part, int c, int n, int w, int bits,
                       int block_n, int chunk0, int n_chunks) {
  const int cpw = 32 / bits, f_all = w * cpw;
  const long long t = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  const long long per_chunk = (long long)c * f_all;
  if (t >= per_chunk * n_chunks) return;
  const int ch = (int)(t / per_chunk);
  const int rem = (int)(t - ch * per_chunk);
  const int cls = rem / f_all, f = rem - cls * f_all;
  const int lo = (chunk0 + ch) * block_n, hi = min(lo + block_n, n);
  const uint32_t* wd = words + f / cpw;
  const int shift = (f % cpw) * bits;
  const float* gc = g + (size_t)cls * n;
  float acc[P];
#pragma unroll
  for (int e = 0; e < P; ++e) acc[e] = 0.0f;
  for (int r = lo; r < hi; ++r) {
    const uint32_t word = wd[(size_t)r * w];
    const float gv = gc[r];
    const int code = row_live(valid, r)
        ? (int)((word >> shift) & (uint32_t)(P - 1)) : -1;
#pragma unroll
    for (int e = 0; e < P; ++e)
      if (code == e) acc[e] = __fadd_rn(acc[e], gv);
  }
  float* o = part + (size_t)t * P;
#pragma unroll
  for (int e = 0; e < P; ++e) o[e] = acc[e];
}

// The same for 8- and 16-bit fields: each thread adds onto its own P
// entries of the zeroed partial buffer, one row after the other.
__global__ void __launch_bounds__(BWD_THREADS)
linear_bwd_partial_mem(const float* __restrict__ g,
                       const uint32_t* __restrict__ words,
                       const uint32_t* __restrict__ valid,
                       float* __restrict__ part, int c, int n, int w, int bits,
                       int block_n, int chunk0, int n_chunks) {
  const int cpw = 32 / bits, f_all = w * cpw, p = 1 << bits;
  const long long t = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  const long long per_chunk = (long long)c * f_all;
  if (t >= per_chunk * n_chunks) return;
  const int ch = (int)(t / per_chunk);
  const int rem = (int)(t - ch * per_chunk);
  const int cls = rem / f_all, f = rem - cls * f_all;
  const int lo = (chunk0 + ch) * block_n, hi = min(lo + block_n, n);
  const uint32_t* wd = words + f / cpw;
  const int shift = (f % cpw) * bits;
  const float* gc = g + (size_t)cls * n;
  float* o = part + (size_t)t * p;
  for (int r = lo; r < hi; ++r) {
    if (!row_live(valid, r)) continue;
    const uint32_t code = (wd[(size_t)r * w] >> shift) & (uint32_t)(p - 1);
    o[code] = __fadd_rn(o[code], gc[r]);
  }
}

// out[j] (+)= part[0][j] + part[1][j] + ... in chunk order, from 0.0 for
// the first group.
__global__ void __launch_bounds__(FOLD_THREADS)
linear_bwd_fold(const float* __restrict__ part, float* __restrict__ out,
                long long cols, int n_chunks, int first) {
  const long long j = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (j >= cols) return;
  float a = first ? 0.0f : out[j];
#pragma unroll 8
  for (int ch = 0; ch < n_chunks; ++ch)
    a = __fadd_rn(a, part[(size_t)ch * cols + j]);
  out[j] = a;
}

cudaError_t launch_partial(const float* g, const uint32_t* words,
                           const uint32_t* valid, float* part, int c, int n,
                           int w, int bits, int block_n, int chunk0,
                           int n_chunks, cudaStream_t st) {
  const long long threads = (long long)n_chunks * c * w * (32 / bits);
  const unsigned blocks = (unsigned)((threads + BWD_THREADS - 1) / BWD_THREADS);
  switch (bits) {
    case 1:
      linear_bwd_partial_reg<2><<<blocks, BWD_THREADS, 0, st>>>(
          g, words, valid, part, c, n, w, bits, block_n, chunk0, n_chunks);
      break;
    case 2:
      linear_bwd_partial_reg<4><<<blocks, BWD_THREADS, 0, st>>>(
          g, words, valid, part, c, n, w, bits, block_n, chunk0, n_chunks);
      break;
    case 4:
      linear_bwd_partial_reg<16><<<blocks, BWD_THREADS, 0, st>>>(
          g, words, valid, part, c, n, w, bits, block_n, chunk0, n_chunks);
      break;
    default: {
      const size_t bytes = (size_t)threads * ((size_t)1 << bits) * sizeof(float);
      const cudaError_t err = cudaMemsetAsync(part, 0, bytes, st);
      if (err != cudaSuccess) return err;
      linear_bwd_partial_mem<<<blocks, BWD_THREADS, 0, st>>>(
          g, words, valid, part, c, n, w, bits, block_n, chunk0, n_chunks);
    }
  }
  return cudaGetLastError();
}

}  // namespace

// tables [c, fp] float32, fp = w * (32/bits) << bits; valid: null or
// [ceil(n/32)]; out [c, n]. class_tile: classes a block scores; in_smem:
// whether class_tile tables fit the block's shared memory.
extern "C" int packed_linear_fwd_launch(const float* tables,
                                        const uint32_t* words,
                                        const uint32_t* valid, float* out,
                                        int c, int n, int w, int bits,
                                        int class_tile, int in_smem,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int fp = (w * (32 / bits)) << bits;
  const size_t smem = in_smem ? (size_t)class_tile * fp * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      linear_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + FWD_THREADS - 1) / FWD_THREADS),
                  (unsigned)((c + class_tile - 1) / class_tile));
  linear_fwd<<<grid, FWD_THREADS, smem, st>>>(tables, words, valid, out, c, n,
                                              w, bits, fp, class_tile, in_smem);
  return (int)cudaGetLastError();
}

// g [c, n] float32; valid: null or [ceil(n/32)]; part: scratch of
// group_chunks * c * fp floats; out [c, fp]. Chunks of block_n rows go in
// groups of group_chunks: partial kernel, then fold, group after group.
extern "C" int packed_linear_bwd_launch(const float* g, const uint32_t* words,
                                        const uint32_t* valid, float* part,
                                        float* out, int c, int n, int w,
                                        int bits, int block_n,
                                        int group_chunks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long cols = (long long)c * ((w * (32 / bits)) << bits);
  const int n_chunks = (n + block_n - 1) / block_n;
  for (int c0 = 0; c0 < n_chunks; c0 += group_chunks) {
    const int m = n_chunks - c0 < group_chunks ? n_chunks - c0 : group_chunks;
    cudaError_t err = launch_partial(g, words, valid, part, c, n, w, bits,
                                     block_n, c0, m, st);
    if (err != cudaSuccess) return (int)err;
    linear_bwd_fold<<<(unsigned)((cols + FOLD_THREADS - 1) / FOLD_THREADS),
                      FOLD_THREADS, 0, st>>>(part, out, cols, m, c0 == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
