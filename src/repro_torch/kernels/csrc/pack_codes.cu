// Bit packing of b-bit codes into 32-bit words.
//
// Replaces src/repro/kernels/pack_codes.py::pack_codes_pallas: int32
// codes [M, K] -> uint32 words [M, W = ceil(K*b/32)], 32/b codes a word,
// LSB first, fields past K zero. Each word is the uint32 sum of
// u32(code) << (i*b) over its codes, as the reference's integer dot with
// the shift vector: a sum, not an or, so codes outside [0, 2^b) give the
// reference's bits too.
//
// Bound on this card: bytes. It reads M*K*4 and writes M*W*4 bytes and
// does a handful of integer operations a code. A lane owns one slot of a
// row at a time: 4 consecutive codes read by one 16-byte load (VEC 4:
// rows 16-byte aligned, K % 4 == 0 and an aligned base), or one code read
// by one 4-byte load (VEC 1: any other row). A warp's 32 slots are
// consecutive, so one load instruction reads 512 (or 128) contiguous
// bytes. The lanes that share a word (32/b codes over VEC, 1 to 32 of
// them) add their partial words with __shfl_xor_sync: addition mod 2^32
// is associative, so any order gives the sum's bits (a ballot or an or
// would not, for codes out of range). The first lane of a word stores it;
// at 16 bits and VEC 4 a lane owns two words and stores both in one
// 8-byte store. A row's slots are padded to whole words, so no word spans
// two rows, and a slot past K loads nothing and adds zero (where K fills
// whole words, the common case, slots are indexed over the whole array).
//
// The grid is pack_codes.pack_plan's: enough blocks to give every lane a
// slot (at least the card's SMs where the slots allow it, the block cut
// to whole warps), capped at the card's resident blocks, which then walk
// the slots grid-stride, UNROLL strides a step so that several loads of a
// lane are in flight. The threads a block are the wrapper's launch knob;
// they change no bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 4;   // strides a lane loads before it adds

// DENSE: a row's slots hold exactly its K codes (K % (32/b) == 0, or 16-bit
// codes at VEC 4), so slot s reads codes [s*VEC, s*VEC + VEC) and its word
// is s*VEC / (32/b) of the whole array: no row is tracked. Otherwise a
// lane keeps its (row, slot) and steps it by (drow, dj), the stride's rows
// and slots, computed on the host.
template <int BITS, int VEC, bool DENSE>
__global__ void __launch_bounds__(1024)
pack_codes_kernel(const int32_t* __restrict__ codes,
                  uint32_t* __restrict__ out, long long m, int k, int slots,
                  int w, long long drow, int dj) {
  constexpr int CPW = 32 / BITS;
  constexpr int LANES = CPW >= VEC ? CPW / VEC : 1;  // lanes a word
  constexpr int WORDS = VEC > CPW ? VEC / CPW : 1;   // words a lane
  const long long total = m * slots;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the grid's lanes number fewer than 2^32 (pack_plan caps the grid)
  const unsigned s0 = blockIdx.x * blockDim.x + threadIdx.x;
  long long row = s0 / (unsigned)slots;  // not DENSE: this lane's slot
  int j = (int)(s0 % (unsigned)slots);
  // the loop runs on the warp's first slot, so a warp's lanes take every
  // step together and meet at every shuffle
  for (long long base = s0 - (threadIdx.x & 31); base < total;
       base += UNROLL * stride) {
    uint32_t part[UNROLL][WORDS];
    long long word[UNROLL];
    bool store[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int x = 0; x < WORDS; ++x) part[u][x] = 0;
      const int32_t* src;
      bool live;
      int pos;  // the first code's place in its word
      if constexpr (DENSE) {
        const long long s = base + (threadIdx.x & 31) + u * stride;
        live = s < total;
        src = codes + s * VEC;
        word[u] = s * VEC / CPW;
        pos = (int)(s & (LANES - 1)) * VEC;
        store[u] = live && (s & (LANES - 1)) == 0;
      } else {
        live = row < m && j * VEC < k;
        src = codes + row * k + (long long)j * VEC;
        word[u] = row * w + (long long)j * VEC / CPW;
        pos = (j & (LANES - 1)) * VEC;
        store[u] = row < m && (j & (LANES - 1)) == 0;
        j += dj;
        row += drow;
        if (j >= slots) {
          j -= slots;
          ++row;
        }
      }
      if (live) {
        int c[VEC];
        if constexpr (VEC == 4) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(src));
          c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
        } else {
          c[0] = __ldg(src);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          part[u][i / CPW] += (uint32_t)c[i] << (((pos + i) % CPW) * BITS);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1)
        part[u][0] += __shfl_xor_sync(0xffffffffu, part[u][0], o);
      if (store[u]) {
        if constexpr (WORDS == 2)
          *reinterpret_cast<uint2*>(out + word[u]) =
              make_uint2(part[u][0], part[u][1]);
        else
          out[word[u]] = part[u][0];
      }
    }
  }
}

template <int BITS, int VEC>
int launch(const int32_t* codes, uint32_t* out, long long m, int k, int slots,
           int w, long long drow, int dj, int blocks, int threads,
           cudaStream_t stream) {
  if ((long long)slots * VEC == k)
    pack_codes_kernel<BITS, VEC, true><<<blocks, threads, 0, stream>>>(
        codes, out, m, k, slots, w, drow, dj);
  else
    pack_codes_kernel<BITS, VEC, false><<<blocks, threads, 0, stream>>>(
        codes, out, m, k, slots, w, drow, dj);
  return (int)cudaGetLastError();
}

}  // namespace

// vec 4 (the 16-byte form) needs K % 4 == 0 and a 16-byte aligned base;
// threads a whole number of warps; (drow, dj) the grid's stride in rows
// and slots. Returns a CUDA error code (0: launched).
extern "C" int pack_codes_launch(const int32_t* codes, uint32_t* out,
                                 long long m, int k, int bits, int vec,
                                 int slots, int w, long long drow, int dj,
                                 int blocks, int threads, void* stream) {
  if (blocks <= 0 || m <= 0 || w <= 0) return 0;
  if (threads % 32 != 0 || slots <= 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && (k % 4 != 0 || (uintptr_t)codes % 16 != 0)) ||
      (long long)blocks * threads != drow * slots + dj)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PACK_CASE(B)                                                        \
  case B:                                                                   \
    return vec == 4 ? launch<B, 4>(codes, out, m, k, slots, w, drow, dj,    \
                                   blocks, threads, s)                      \
                    : launch<B, 1>(codes, out, m, k, slots, w, drow, dj,    \
                                   blocks, threads, s);
  switch (bits) {
    PACK_CASE(1)
    PACK_CASE(2)
    PACK_CASE(4)
    PACK_CASE(8)
    PACK_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PACK_CASE
}
