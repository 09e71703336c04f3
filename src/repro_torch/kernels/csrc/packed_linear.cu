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
// N*F = 597M float adds (0.018 ms at 128 adds a clock an SM); the
// backward reads the same words and 9 MB of g. At C = 8 both are bound
// by the adds (0.143 ms). A forward whose tables sit in shared memory
// reads one entry a (row, class, field): one wavefront a warp's 32 rows,
// a floor of 0.0713 ms at C = 1 and 0.5707 ms at C = 8 (one wavefront a
// clock an SM at 1.98 GHz). A backward whose order is fixed issues P adds
// a (row, class, field), each predicated on the code, so its own floor is
// P times the add bound plus the decoding.
//
// Forward design. The TPU kernel streams corpus tiles through a select
// tree with one class tile resident. Here, for 1-, 2-, 4- and 8-bit
// fields (templated on the width, and on masked), a block copies its
// class tile's tables into shared memory once (4 KB a class at 2-bit and
// k = 256; a tile holds what fits in 96 KB) and then walks row tiles of
// 256 rows, blockIdx.x, + gridDim.x, ...: the wrapper's plan sizes the
// grid to the card's resident blocks, or to the tiles there are. One
// thread scores one row for every class of the tile, 8, 4, 2 or 1 a
// decode, loading its row in 16-byte loads four words ahead of the adds.
// A word's fields are unrolled: each is a constant shift, one and-or that
// joins the code's byte offset to the word's (a multiple of 4P), a
// shared-memory load whose field offset is a constant, and a __fadd_rn a
// class, in (word, field) order from 0.0: about 4 issue slots and one
// wavefront a (row, field) at C = 1, at the floors above. Masked, a warp
// whose 32 rows are all dead writes 0.0 and reads no table; in a warp
// with a live row, its dead rows go through the same instructions and
// write 0.0. Tables too wide for shared memory (16-bit fields, wide 8-bit
// rows) take the memory form: a block a row tile, the tables read from
// device memory through score_row_classes of lut_common.cuh, at runtime
// width. One kernel of each form serves both forms of the TPU kernel:
// the bitmask pointer is null for the plain one.
//
// Backward design. The TPU kernel expands each row tile to a one-hot tile
// in registers and accumulates g_tile @ onehot on the MXU. On this card a
// float atomic per (row, field) would make the sum order, and so the
// result, change from run to run. Two kernels instead fix the order of
// ref.packed_linear_bwd_ref: the partial kernel writes one partial per
// block_n chunk of rows, [chunks, C, F*P], each adding the chunk's rows
// in ascending order from +0.0; the fold adds the partials onto the
// accumulator in chunk order.
//
// Partial kernel (1-, 2- and 4-bit fields). A block walks a run of
// consecutive chunks, each in row tiles of at most tile_rows rows, and
// stages every tile once in shared memory with 4-byte cp.async: the tile's
// words transposed to [word][row], its g entries for the block's classes
// as [row][class], and the validity words that cover it. Two slots, so
// the next tile (of this chunk or the next) copies while this one adds. A
// thread owns FT fields of one word and CT classes, FT * P * CT = 32
// accumulators in registers. Four rows at a time, it reads its word of
// each in one 16-byte load, their g in CT 16-byte loads and their
// validity bits in one funnel shift; it shifts each word to its first
// field once, decodes each field once (a mask and P - 1 compares), and
// adds g onto the entry the code selects, for every class (an add
// predicated on the code; a dead row's g is replaced by 0.0, which leaves
// a partial that started at +0.0 unchanged, as the plain version's zeroed
// g does). At a chunk's last tile it stores its P * FT entries a class in
// 16-byte stores. The wrapper's plan takes CT 1 at one class, else the
// most classes whose accumulators fit (8 at 1- and 2-bit fields, 2 at
// 4-bit), and spreads the chunks over the card's resident blocks once. What
// binds it is issue: at 2 bits about 9 instructions a (row, field), 4 of
// them on the half-rate integer pipe. 8- and 16-bit fields (and rows too
// wide for two slots) keep the earlier form: one thread per (chunk,
// class, field) adding in the zeroed partial buffer in device memory.
//
// Fold. A block owns a slab of 8 entries (32 bytes a chunk); its threads
// stream the slab's rows, 64 chunks a stage, through a ring of 8 stages
// with 16-byte cp.async, and 8 threads add them in chunk order, so many
// loads are in flight ahead of each entry's serial chain and the entries
// spread over the card; the chain of dependent adds binds it.
//
// Chunks go in groups whose partials fit the scratch the wrapper gives
// (about 19 MB a class at the learn path's shape, one group); a later
// group's fold continues from the accumulator, so the order is the same.
// Phantom field slots and entries are computed like any other; the
// caller masks them (learn.features.entry_mask).
#include <map>
#include <mutex>
#include <utility>

#include "lut_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int FWD_THREADS = 256;   // rows a forward tile: one thread a row
constexpr int BWD_THREADS = 256;   // the 8- and 16-bit partial kernel
constexpr int PART_THREADS = 256;  // the most threads a tiled partial block
constexpr int PART_MIN_BLOCKS = 3; // blocks of 256 an SM: at most 85 registers
constexpr int FOLD_THREADS = 128;
constexpr int FOLD_SLAB = 8;       // entries a fold block adds
constexpr int FOLD_ROWS = FOLD_THREADS * 4 / FOLD_SLAB;  // chunks a stage
constexpr int FOLD_STAGES = 8;

__device__ __forceinline__ bool row_live(const uint32_t* valid, int r) {
  return valid == nullptr || ((valid[r >> 5] >> (r & 31)) & 1u);
}

// CB classes of one row -> out[c * n] (0.0 for a dead row), tables read
// where tab points (device memory: the forward's memory form).
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

// The memory form, for tables too wide for shared memory (16-bit fields,
// wide 8-bit rows): one thread a row, every class, tables read from
// device memory.
__global__ void __launch_bounds__(FWD_THREADS)
linear_fwd_mem(const float* __restrict__ tables,
               const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ valid, float* __restrict__ out,
               int c, int n, int w, int bits) {
  const int fp = (w * (32 / bits)) << bits;
  const int row = blockIdx.x * FWD_THREADS + threadIdx.x;
  if (row >= n) return;
  const bool live = row_live(valid, row);
  const uint32_t* r = words + (size_t)row * w;
  for (int j = 0; j < c;) {
    const float* t = tables + (size_t)j * fp;
    float* oj = out + (size_t)j * n + row;
    const int m = c - j;
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

// One word of a row for CB classes: its CPW fields in order, each decoded
// once and selecting the entry of every class's table (shared memory from
// t, fp floats apart). jb, the byte offset of the word's entries, is a
// multiple of 4P, so the code's byte offset joins it in one shift and one
// and-or, and the field's own offset is the load's constant.
template <int BITS, int CB>
__device__ __forceinline__ void add_word(const float* t, int fp,
                                         uint32_t word, uint32_t jb,
                                         float* s) {
  constexpr int P = 1 << BITS, CPW = 32 / BITS;
  constexpr uint32_t M4 = (uint32_t)(P - 1) << 2;
  const char* base = reinterpret_cast<const char*>(t);
#pragma unroll
  for (int f = 0; f < CPW; ++f) {
    const int sh = f * BITS - 2;
    const uint32_t x = sh >= 0 ? word >> (sh & 31) : word << (-sh & 31);
    const char* e = base + ((x & M4) | jb) + f * P * 4;
#pragma unroll
    for (int c = 0; c < CB; ++c)
      s[c] = __fadd_rn(s[c],
                       *reinterpret_cast<const float*>(e + (size_t)c * fp * 4));
  }
}

// A row's words in device memory: 16-byte loads where the row is
// 16-byte aligned (vec), else 4-byte ones.
struct RowWords {
  const uint32_t* r;
  bool vec;
  __device__ __forceinline__ uint4 chunk(int j) const {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(r + j));
    return make_uint4(__ldg(r + j), __ldg(r + j + 1), __ldg(r + j + 2),
                      __ldg(r + j + 3));
  }
};

// CB classes of a row -> o[c * n]: (word, field) order from 0.0, four
// words at a time, the next four loaded before these are added; 0.0
// where the row is dead.
template <int BITS, int CB>
__device__ __forceinline__ void fwd_group(const float* t, int fp, int w,
                                          const RowWords& row, bool live,
                                          float* o, int n) {
  constexpr int WB = ((32 / BITS) << BITS) * 4;   // bytes of a word's entries
  float s[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) s[c] = 0.0f;
  const int w4 = w & ~3;
  if (w4 > 0) {
    uint4 cur = row.chunk(0);
    for (int j = 0; j < w4; j += 4) {
      const uint4 nxt = j + 4 < w4 ? row.chunk(j + 4) : cur;
      const uint32_t jb = (uint32_t)j * WB;
      add_word<BITS, CB>(t, fp, cur.x, jb, s);
      add_word<BITS, CB>(t, fp, cur.y, jb + WB, s);
      add_word<BITS, CB>(t, fp, cur.z, jb + 2 * WB, s);
      add_word<BITS, CB>(t, fp, cur.w, jb + 3 * WB, s);
      cur = nxt;
    }
  }
  for (int j = w4; j < w; ++j)
    add_word<BITS, CB>(t, fp, __ldg(row.r + j), (uint32_t)j * WB, s);
#pragma unroll
  for (int c = 0; c < CB; ++c) o[(size_t)c * n] = live ? s[c] : 0.0f;
}

// The shared-memory form: a block copies its class tile's tables into
// shared memory once, then walks the row tiles blockIdx.x, + gridDim.x,
// ..., one thread a row, each loading its own row's words, and scores
// every class of the tile, 8, 4, 2 or 1 a decode. Masked: a warp whose
// rows are all dead writes 0.0 and reads no table; in a warp with a live
// row the dead rows are scored with it (the same instructions), and their
// margins replaced by 0.0.
template <int BITS, bool MASKED>
__global__ void __launch_bounds__(FWD_THREADS)
linear_fwd_smem(const float* __restrict__ tables,
                const uint32_t* __restrict__ words,
                const uint32_t* __restrict__ valid, float* __restrict__ out,
                int c, int n, int w, int class_tile, int vec) {
  extern __shared__ __align__(16) float stab[];
  const int tid = threadIdx.x;
  const int fp = (w * (32 / BITS)) << BITS;
  const int c0 = blockIdx.y * class_tile, nc = min(class_tile, c - c0);
  const float* tab = tables + (size_t)c0 * fp;
  if ((reinterpret_cast<uintptr_t>(tab) & 15) == 0) {   // fp % 4 == 0
    const float4* src = reinterpret_cast<const float4*>(tab);
    float4* dst = reinterpret_cast<float4*>(stab);
    for (int i = tid; i < nc * fp / 4; i += FWD_THREADS) dst[i] = __ldg(src + i);
  } else {
    for (int i = tid; i < nc * fp; i += FWD_THREADS) stab[i] = __ldg(tab + i);
  }
  __syncthreads();
  const int n_tiles = (n + FWD_THREADS - 1) / FWD_THREADS;
  float* o = out + (size_t)c0 * n;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row = t * FWD_THREADS + tid;
    bool live = true;
    if (MASKED) {
      live = row < n && ((__ldg(valid + (row >> 5)) >> (row & 31)) & 1u);
      if (!__any_sync(0xffffffffu, live)) {
        if (row < n)
          for (int j = 0; j < nc; ++j) o[(size_t)j * n + row] = 0.0f;
        continue;
      }
    }
    if (row >= n) continue;
    const RowWords rw{words + (size_t)row * w, vec != 0};
    for (int j = 0; j < nc;) {
      const float* tj = stab + (size_t)j * fp;
      float* oj = o + (size_t)j * n + row;
      const int m = nc - j;
      if (m >= 8) {
        fwd_group<BITS, 8>(tj, fp, w, rw, live, oj, n);
        j += 8;
      } else if (m >= 4) {
        fwd_group<BITS, 4>(tj, fp, w, rw, live, oj, n);
        j += 4;
      } else if (m >= 2) {
        fwd_group<BITS, 2>(tj, fp, w, rw, live, oj, n);
        j += 2;
      } else {
        fwd_group<BITS, 1>(tj, fp, w, rw, live, oj, n);
        j += 1;
      }
    }
  }
}

// 16 bytes global -> shared
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Fields a thread owns at CT classes a thread: FT * P * CT = 32
// accumulators (the plan's fields_per_thread).
__host__ __device__ constexpr int fields_per_thread(int bits, int ct) {
  return (32 >> bits) / ct > 0 ? (32 >> bits) / ct : 1;
}

// The row tile k of a block whose chunks start at ch_first: chunk ch, rows
// [r0, r1) (empty when r0 >= r1: tiles past a short last chunk), and
// whether it is the chunk's last.
struct Tile {
  int ch, r0, r1;
  bool last;
};

__device__ __forceinline__ Tile tile_at(int k, int ch_first, int tpc, int tr,
                                        int block_n, int n) {
  Tile t;
  t.ch = ch_first + k / tpc;
  const long long lo = (long long)t.ch * block_n;
  const long long hi = lo + block_n < n ? lo + block_n : n;
  const long long r0 = lo + (long long)(k % tpc) * tr;
  t.r0 = (int)(r0 < hi ? r0 : hi);
  t.r1 = (int)(r0 + tr < hi ? r0 + tr : hi);
  t.last = t.r0 < t.r1 && t.r1 == hi;
  return t;
}

// The shared-memory slot of one tile, in 4-byte words: the words
// transposed, [W][row_pitch] (row_pitch: tile_rows rounded to 4, and to 4
// more where that is a multiple of 8, so that the 16-byte loads of a
// warp's 8 words of one row group fall in 8 distinct bank groups), g
// [tile_rows][class_pitch], and the validity words (tile_rows / 32 + 2,
// and one more that a funnel shift of the last may read). The plan
// computes the same.
__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ __forceinline__ int row_pitch(int tr) {
  return round4(tr) % 8 == 0 ? round4(tr) + 4 : round4(tr);
}
__host__ __device__ __forceinline__ int slot_words(int tr, int w) {
  return w * row_pitch(tr);
}
__host__ __device__ __forceinline__ int slot_g(int tr, int gp) {
  return round4(tr * gp);
}
__host__ __device__ __forceinline__ int slot_valid(int tr) {
  return round4(tr / 32 + 3);
}

template <int CT>
__device__ __forceinline__ void load_g(const float* s, float* gv) {
  if constexpr (CT == 1) {
    gv[0] = s[0];
  } else if constexpr (CT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    gv[0] = v.x;
    gv[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < CT / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(s)[q];
      gv[4 * q] = v.x;
      gv[4 * q + 1] = v.y;
      gv[4 * q + 2] = v.z;
      gv[4 * q + 3] = v.w;
    }
  }
}

// Items (class group, field group) over blockIdx.y * blockDim.x + tid;
// blockIdx.x a run of cpb chunks of the group [chunk0, chunk0 + n_chunks).
template <int BITS, int CT, bool MASKED>
__global__ void __launch_bounds__(PART_THREADS, PART_MIN_BLOCKS)
linear_bwd_partial_tiled(const float* __restrict__ g,
                         const uint32_t* __restrict__ words,
                         const uint32_t* __restrict__ valid,
                         float* __restrict__ part, int c, int n, int w,
                         int block_n, int chunk0, int n_chunks, int cpb,
                         int tr, int tpc, int gp) {
  constexpr int P = 1 << BITS, CPW = 32 / BITS;
  constexpr int FT = fields_per_thread(BITS, CT);
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfg = w * CPW / FT, fp = w * CPW * P;
  const int items = (c + CT - 1) / CT * nfg;
  const int i0 = blockIdx.y * nt, it = i0 + tid;
  const bool active = it < items;
  const int cg0 = i0 / nfg, cls_lo = cg0 * CT;
  const int cls_hi = min(c, ((min(items, i0 + nt) - 1) / nfg + 1) * CT);
  const int ncls = cls_hi - cls_lo;
  const int cg = it / nfg, fg = it - cg * nfg;
  const int wi = fg * FT / CPW, s0 = fg * FT % CPW * BITS;
  const int rp = row_pitch(tr), step_r = nt / w, step_j = nt - step_r * w;
  const int sw_n = slot_words(tr, w), sg_n = slot_g(tr, gp);
  const int slot = sw_n + sg_n + slot_valid(tr);
  const int ch_first = chunk0 + blockIdx.x * cpb;
  const int ch_end = min(chunk0 + n_chunks, ch_first + cpb);
  const int n_tiles = (ch_end - ch_first) * tpc;

  auto stage = [&](int k) {
    const Tile t = tile_at(k, ch_first, tpc, tr, block_n, n);
    if (t.r0 >= t.r1) return;
    uint32_t* dst = smem + (k & 1) * slot;
    const int nr = t.r1 - t.r0;
    // word j of row r to [j][r]: consecutive threads read consecutive
    // words of the tile
    const uint32_t sw = smem_addr(dst);
    const uint32_t* src = words + (size_t)t.r0 * w;
    int rr = tid / w, jj = tid - rr * w;
    for (int i = tid; i < nr * w; i += nt) {
      cp_async_4(sw + 4 * (jj * rp + rr), src + i, true);
      rr += step_r;
      jj += step_j;
      if (jj >= w) {
        jj -= w;
        ++rr;
      }
    }
    const uint32_t sg = smem_addr(dst + sw_n);
    for (int i = tid; i < nr * ncls; i += nt) {
      const int cl = i / nr, r = i - cl * nr;
      cp_async_4(sg + 4 * (r * gp + cl),
                 g + (size_t)(cls_lo + cl) * n + t.r0 + r, true);
    }
    if (MASKED) {
      const int v0 = t.r0 >> 5, nv = ((t.r1 - 1) >> 5) - v0 + 1;
      const uint32_t sv = smem_addr(dst + sw_n + sg_n);
      for (int i = tid; i < nv; i += nt)
        cp_async_4(sv + 4 * i, valid + v0 + i, true);
    }
  };

  float acc[CT][FT][P];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int f = 0; f < FT; ++f)
#pragma unroll
      for (int e = 0; e < P; ++e) acc[j][f][e] = 0.0f;

  stage(0);
  cp_async_commit();
  for (int k = 0; k < n_tiles; ++k) {
    // the slot of tile k + 1 was last read in iteration k - 1, before its
    // closing barrier
    if (k + 1 < n_tiles) stage(k + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Tile t = tile_at(k, ch_first, tpc, tr, block_n, n);
    if (active && t.r0 < t.r1) {
      const uint32_t* buf = smem + (k & 1) * slot;
      const uint32_t* sw = buf + wi * rp;   // row r's word at sw[r]
      const float* sg =
          reinterpret_cast<const float*>(buf + sw_n) + (cg - cg0) * CT;
      const uint32_t* sv = buf + sw_n + sg_n;
      const int vb = t.r0 & 31, nr = t.r1 - t.r0;
      // one row: its word shifted to the thread's first field, its g
      auto add_row = [&](uint32_t y, const float* gv) {
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          const uint32_t m = y & ((uint32_t)(P - 1) << (f * BITS));
#pragma unroll
          for (int e = 0; e < P; ++e) {
            if (m == (uint32_t)e << (f * BITS)) {
#pragma unroll
              for (int j = 0; j < CT; ++j)
                acc[j][f][e] = __fadd_rn(acc[j][f][e], gv[j]);
            }
          }
        }
      };
      int r = 0;
      for (; r + 4 <= nr; r += 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(sw + r);
        const uint32_t y[4] = {x.x >> s0, x.y >> s0, x.z >> s0, x.w >> s0};
        float gv[4][CT];
        if (gp == CT) {   // the four rows' g, 4 * CT floats in a row
#pragma unroll
          for (int q = 0; q < CT; ++q) {
            const float4 v = reinterpret_cast<const float4*>(sg + r * CT)[q];
            gv[(4 * q) / CT][(4 * q) % CT] = v.x;
            gv[(4 * q + 1) / CT][(4 * q + 1) % CT] = v.y;
            gv[(4 * q + 2) / CT][(4 * q + 2) % CT] = v.z;
            gv[(4 * q + 3) / CT][(4 * q + 3) % CT] = v.w;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) load_g<CT>(sg + (r + q) * gp, gv[q]);
        }
        if (MASKED) {
          // the four rows' bits, from the two words that hold them
          const int b = vb + r;
          const uint32_t live =
              __funnelshift_r(sv[b >> 5], sv[(b >> 5) + 1], b & 31);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (!((live >> q) & 1u)) {
#pragma unroll
              for (int j = 0; j < CT; ++j) gv[q][j] = 0.0f;
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) add_row(y[q], gv[q]);
      }
      for (; r < nr; ++r) {
        float gv[CT];
        load_g<CT>(sg + r * gp, gv);
        if (MASKED) {
          const int b = vb + r;
          if (!((sv[b >> 5] >> (b & 31)) & 1u)) {
#pragma unroll
            for (int j = 0; j < CT; ++j) gv[j] = 0.0f;
          }
        }
        add_row(sw[r] >> s0, gv);
      }
      if (t.last) {
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int cl = cg * CT + j;
          if (cl < c) {
            float4* o = reinterpret_cast<float4*>(
                part + ((size_t)(t.ch - chunk0) * c + cl) * fp +
                (size_t)fg * FT * P);
#pragma unroll
            for (int q = 0; q < FT * P / 4; ++q)
              o[q] = make_float4(acc[j][(4 * q) / P][(4 * q) % P],
                                 acc[j][(4 * q + 1) / P][(4 * q + 1) % P],
                                 acc[j][(4 * q + 2) / P][(4 * q + 2) % P],
                                 acc[j][(4 * q + 3) / P][(4 * q + 3) % P]);
          }
#pragma unroll
          for (int f = 0; f < FT; ++f)
#pragma unroll
            for (int e = 0; e < P; ++e) acc[j][f][e] = 0.0f;
        }
      }
    }
    __syncthreads();
  }
}

// 8- and 16-bit fields: one thread per (chunk of the group, class, field)
// adds onto its own P entries of the zeroed partial buffer, one row after
// the other.
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
// the first group; a block a slab of FOLD_SLAB entries (cols is a multiple
// of 64 and part 16-byte aligned).
__global__ void __launch_bounds__(FOLD_THREADS)
linear_bwd_fold(const float* __restrict__ part, float* __restrict__ out,
                long long cols, int n_chunks, int first) {
  __shared__ __align__(16) float ring[FOLD_STAGES][FOLD_ROWS * FOLD_SLAB];
  const int tid = threadIdx.x;
  const long long j0 = (long long)blockIdx.x * FOLD_SLAB;
  const int n_stages = (n_chunks + FOLD_ROWS - 1) / FOLD_ROWS;
  const int row = tid / (FOLD_SLAB / 4), q = tid % (FOLD_SLAB / 4);
  auto issue = [&](int s) {
    const int ch = s * FOLD_ROWS + row;
    if (s < n_stages && ch < n_chunks)
      cp_async_16(smem_addr(&ring[s % FOLD_STAGES][row * FOLD_SLAB + 4 * q]),
                  part + (size_t)ch * cols + j0 + 4 * q);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < FOLD_STAGES - 1; ++s) issue(s);
  float a = 0.0f;
  if (tid < FOLD_SLAB && !first) a = out[j0 + tid];
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<FOLD_STAGES - 2>();
    __syncthreads();
    // the stage refilled here was read in iteration s - 1
    issue(s + FOLD_STAGES - 1);
    if (tid < FOLD_SLAB) {
      const float* st = ring[s % FOLD_STAGES] + tid;
      const int m = n_chunks - s * FOLD_ROWS;
      if (m >= FOLD_ROWS) {   // a whole stage: its loads issue ahead
        float v[FOLD_ROWS];
#pragma unroll
        for (int r = 0; r < FOLD_ROWS; ++r) v[r] = st[r * FOLD_SLAB];
#pragma unroll
        for (int r = 0; r < FOLD_ROWS; ++r) a = __fadd_rn(a, v[r]);
      } else {
        for (int r = 0; r < m; ++r) a = __fadd_rn(a, st[r * FOLD_SLAB]);
      }
    }
  }
  if (tid < FOLD_SLAB) out[j0 + tid] = a;
}

using PartKernel = void (*)(const float*, const uint32_t*, const uint32_t*,
                            float*, int, int, int, int, int, int, int, int,
                            int, int);

template <int BITS, int CT>
PartKernel tiled_kernel(bool masked) {
  return masked ? linear_bwd_partial_tiled<BITS, CT, true>
                : linear_bwd_partial_tiled<BITS, CT, false>;
}

// The tiled partial kernel of (bits, ct, masked): CT 1, or the plan's
// other CT (8 at 1- and 2-bit fields, 2 at 4-bit); null where there is
// none.
PartKernel part_kernel(int bits, int ct, bool masked) {
  switch (bits * 16 + ct) {
    case 1 * 16 + 1: return tiled_kernel<1, 1>(masked);
    case 1 * 16 + 8: return tiled_kernel<1, 8>(masked);
    case 2 * 16 + 1: return tiled_kernel<2, 1>(masked);
    case 2 * 16 + 8: return tiled_kernel<2, 8>(masked);
    case 4 * 16 + 1: return tiled_kernel<4, 1>(masked);
    case 4 * 16 + 2: return tiled_kernel<4, 2>(masked);
    default: return nullptr;
  }
}

using FwdKernel = void (*)(const float*, const uint32_t*, const uint32_t*,
                           float*, int, int, int, int, int);

// The shared-memory form of the forward at (bits, masked); null for
// 16-bit fields, whose tables never fit.
FwdKernel fwd_kernel(int bits, bool masked) {
  switch (bits) {
    case 1: return masked ? linear_fwd_smem<1, true> : linear_fwd_smem<1, false>;
    case 2: return masked ? linear_fwd_smem<2, true> : linear_fwd_smem<2, false>;
    case 4: return masked ? linear_fwd_smem<4, true> : linear_fwd_smem<4, false>;
    case 8: return masked ? linear_fwd_smem<8, true> : linear_fwd_smem<8, false>;
    default: return nullptr;
  }
}

// Opens kernel k to smem bytes of dynamic shared memory on the current
// device. The attribute is set only when it must grow, so a launch of a
// size seen before costs no call, and it never shrinks below what an
// earlier plan was given.
std::mutex smem_mu;
std::map<std::pair<int, const void*>, int> smem_open;   // (device, kernel)

cudaError_t open_smem(const void* k, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(smem_mu);
  int& granted = smem_open[{dev, k}];
  if (smem <= granted) return cudaSuccess;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

int tiled_smem(int tr, int w, int gp) {
  return 2 * 4 * (slot_words(tr, w) + slot_g(tr, gp) + slot_valid(tr));
}

}  // namespace

// tables [c, fp] float32, fp = w * (32/bits) << bits; valid: null or
// [ceil(n/32)]; out [c, n]. From the wrapper's plan: class_tile 0, the
// memory form (a block a row tile); else the shared-memory form on a grid
// of grid_x blocks a class tile of class_tile classes, with smem bytes of
// dynamic shared memory (class_tile tables).
extern "C" int packed_linear_fwd_launch(const float* tables,
                                        const uint32_t* words,
                                        const uint32_t* valid, float* out,
                                        int c, int n, int w, int bits,
                                        int class_tile, int smem, int grid_x,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (class_tile == 0) {
    linear_fwd_mem<<<(unsigned)((n + FWD_THREADS - 1) / FWD_THREADS),
                     FWD_THREADS, 0, st>>>(tables, words, valid, out, c, n, w,
                                           bits);
    return (int)cudaGetLastError();
  }
  const int fp = (w * (32 / bits)) << bits;
  const FwdKernel k = fwd_kernel(bits, valid != nullptr);
  if (k == nullptr || class_tile < 1 || grid_x < 1 ||
      smem != 4 * class_tile * fp)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = open_smem((const void*)k, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      w % 4 == 0 && (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  const dim3 grid((unsigned)grid_x,
                  (unsigned)((c + class_tile - 1) / class_tile));
  k<<<grid, FWD_THREADS, smem, st>>>(tables, words, valid, out, c, n, w,
                                     class_tile, vec);
  return (int)cudaGetLastError();
}

// Blocks of the forward's shared-memory form (bits, masked) an SM holds at
// `smem` bytes of dynamic shared memory, into *blocks.
extern "C" int packed_linear_fwd_occupancy(int bits, int masked, int smem,
                                           int* blocks) {
  const FwdKernel k = fwd_kernel(bits, masked != 0);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = open_smem((const void*)k, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, FWD_THREADS, (size_t)smem);
}

// Blocks of the tiled partial kernel (bits, ct, masked) an SM holds at
// `threads` threads and `smem` bytes of dynamic shared memory, into
// *blocks.
extern "C" int packed_linear_bwd_occupancy(int bits, int ct, int masked,
                                           int threads, int smem,
                                           int* blocks) {
  const PartKernel k = part_kernel(bits, ct, masked != 0);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = open_smem((const void*)k, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads,
                                                            (size_t)smem);
}

namespace {

// The partial kernel over the group [chunk0, chunk0 + m): the tiled form
// for ct > 0, else the 8- and 16-bit form.
cudaError_t launch_partial(const float* g, const uint32_t* words,
                           const uint32_t* valid, float* part, int c, int n,
                           int w, int bits, int block_n, int chunk0, int m,
                           int ct, int threads, int item_groups, int tr,
                           int tpc, int gp, int smem, int blocks_per_group,
                           cudaStream_t st) {
  if (ct > 0) {
    const PartKernel k = part_kernel(bits, ct, valid != nullptr);
    if (k == nullptr || smem != tiled_smem(tr, w, gp) || threads < 32 ||
        threads > PART_THREADS || blocks_per_group < 1)
      return cudaErrorInvalidValue;
    const cudaError_t err = open_smem((const void*)k, smem);
    if (err != cudaSuccess) return err;
    const int cpb = (m + blocks_per_group - 1) / blocks_per_group;
    const dim3 grid((unsigned)((m + cpb - 1) / cpb), (unsigned)item_groups);
    k<<<grid, threads, smem, st>>>(g, words, valid, part, c, n, w, block_n,
                                   chunk0, m, cpb, tr, tpc, gp);
  } else {
    const long long t = (long long)m * c * w * (32 / bits);
    const cudaError_t err = cudaMemsetAsync(
        part, 0, (size_t)t * ((size_t)1 << bits) * sizeof(float), st);
    if (err != cudaSuccess) return err;
    linear_bwd_partial_mem<<<(unsigned)((t + BWD_THREADS - 1) / BWD_THREADS),
                             BWD_THREADS, 0, st>>>(
        g, words, valid, part, c, n, w, bits, block_n, chunk0, m);
  }
  return cudaGetLastError();
}

cudaError_t launch_fold(const float* part, float* out, long long cols, int m,
                        int first, cudaStream_t st) {
  linear_bwd_fold<<<(unsigned)(cols / FOLD_SLAB), FOLD_THREADS, 0, st>>>(
      part, out, cols, m, first);
  return cudaGetLastError();
}

}  // namespace

// g [c, n] float32; valid: null or [ceil(n/32)]; part: scratch of
// group_chunks * c * fp floats; out [c, fp]. Chunks of block_n rows go in
// groups of group_chunks: partial kernel, then fold, group after group.
// ct: classes a thread of the tiled partial kernel (0: the 8- and 16-bit
// form); threads, item_groups, tr (tile rows), tpc (tiles a chunk), gp
// (g's class pitch), smem and blocks_per_group (the blocks a group's
// chunks spread over) come from the wrapper's plan; smem must equal the
// layout's own size.
extern "C" int packed_linear_bwd_launch(
    const float* g, const uint32_t* words, const uint32_t* valid, float* part,
    float* out, int c, int n, int w, int bits, int block_n, int group_chunks,
    int ct, int threads, int item_groups, int tr, int tpc, int gp, int smem,
    int blocks_per_group, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long cols = (long long)c * ((w * (32 / bits)) << bits);
  const int n_chunks = (int)(((long long)n + block_n - 1) / block_n);
  for (int c0 = 0; c0 < n_chunks; c0 += group_chunks) {
    const int m = n_chunks - c0 < group_chunks ? n_chunks - c0 : group_chunks;
    cudaError_t err = launch_partial(g, words, valid, part, c, n, w, bits,
                                     block_n, c0, m, ct, threads, item_groups,
                                     tr, tpc, gp, smem, blocks_per_group, st);
    if (err != cudaSuccess) return (int)err;
    err = launch_fold(part, out, cols, m, c0 == 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The two halves apart, for timing and checks: the partials of chunks
// [0, n_chunks) (one group), and their fold onto out from 0.0.
extern "C" int packed_linear_bwd_partial_launch(
    const float* g, const uint32_t* words, const uint32_t* valid, float* part,
    int c, int n, int w, int bits, int block_n, int n_chunks, int ct,
    int threads, int item_groups, int tr, int tpc, int gp, int smem,
    int blocks_per_group, void* stream) {
  return (int)launch_partial(g, words, valid, part, c, n, w, bits, block_n, 0,
                             n_chunks, ct, threads, item_groups, tr, tpc, gp,
                             smem, blocks_per_group, (cudaStream_t)stream);
}

extern "C" int packed_linear_bwd_fold_launch(const float* part, float* out,
                                             long long cols, int n_chunks,
                                             void* stream) {
  return (int)launch_fold(part, out, cols, n_chunks, 1, (cudaStream_t)stream);
}
