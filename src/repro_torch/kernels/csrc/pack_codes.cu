// Bit packing of b-bit codes into 32-bit words.
//
// Replaces src/repro/kernels/pack_codes.py::pack_codes_pallas: int32
// codes [M, K] -> uint32 words [M, ceil(K*b/32)], 32/b codes a word, LSB
// first, fields past K zero. Each word is the uint32 sum of
// code << (i*b), as the reference's integer dot with the shift vector.
//
// Bound on this card: bytes. It reads M*K*4 and writes M*W*4 bytes and
// does a handful of integer operations a code. One thread builds one
// output word from its 32/b codes; consecutive threads take consecutive
// words of a row, so the code reads of a warp cover one contiguous
// stretch of the row and the word writes are coalesced. The threads a
// block are the wrapper's launch knob; they change no bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pack_codes_kernel(const int32_t* __restrict__ codes,
                                  uint32_t* __restrict__ out, int m, int k,
                                  int bits) {
  const int cpw = 32 / bits, n_words = (k + cpw - 1) / cpw;
  const size_t total = (size_t)m * n_words;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t row = e / n_words;
    const int c0 = (int)(e % n_words) * cpw;
    const int32_t* src = codes + row * k;
    uint32_t word = 0;
    for (int f = 0; f < cpw && c0 + f < k; ++f)
      word += (uint32_t)src[c0 + f] << (f * bits);
    out[e] = word;
  }
}

}  // namespace

extern "C" int pack_codes_launch(const int32_t* codes, uint32_t* out, int m,
                                 int k, int bits, int threads, void* stream) {
  const int cpw = 32 / bits;
  const size_t total = (size_t)m * ((k + cpw - 1) / cpw);
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  if (blocks == 0) return 0;
  pack_codes_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      codes, out, m, k, bits);
  return (int)cudaGetLastError();
}
