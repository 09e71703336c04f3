// Shared-memory throughput of one warp load (LDS.32, LDS.64, LDS.128) by
// address pattern, for scripts/lds_wavefront_probe.py.
//
// Lane l loads WIDTH bytes at (l % distinct) * WIDTH within a 512-byte
// slot; 16 loads an iteration go to 16 slots at immediate offsets
// (multiples of 512 bytes: the banks stay put), so a warp's load reads
// `distinct` different entries, distinct * WIDTH contiguous bytes. Each
// load feeds one xor: about two issue slots a load, under the
// shared-memory pipe's cost of even one wavefront a load. The loads are
// volatile, so that the compiler keeps every one of them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256, UNROLL = 16;

template <int WIDTH>
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t x, y, z, w;
  if constexpr (WIDTH == 4)
    asm volatile("ld.volatile.shared.u32 %0, [%1];" : "=r"(x) : "r"(addr));
  else if constexpr (WIDTH == 8)
    asm volatile("ld.volatile.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(x), "=r"(y)
                 : "r"(addr));
  else
    asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(x), "=r"(y), "=r"(z), "=r"(w)
                 : "r"(addr));
  return x;
}

template <int WIDTH>
__global__ void __launch_bounds__(THREADS)
lds_probe(int distinct, int iters, uint32_t* out) {
  __shared__ __align__(16) uint32_t buf[UNROLL * 128];
  for (int i = threadIdx.x; i < UNROLL * 128; i += THREADS)
    buf[i] = i * 2654435761u;
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(buf) +
                        (threadIdx.x % 32 % distinct) * WIDTH;
  uint32_t a = 0;
  for (int it = 0; it < iters; it += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) a ^= lds<WIDTH>(base + u * 512);
  }
  out[blockIdx.x * THREADS + threadIdx.x] = a;
}

}  // namespace

// blocks x 256 threads, each `iters` loads (a multiple of 16) of `width`
// bytes (4, 8 or 16) with `distinct` entries a warp (1 to 32); out: one
// word a thread.
extern "C" int lds_probe_launch(int width, int distinct, int iters,
                                int blocks, uint32_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (width == 4)
    lds_probe<4><<<blocks, THREADS, 0, st>>>(distinct, iters, out);
  else if (width == 8)
    lds_probe<8><<<blocks, THREADS, 0, st>>>(distinct, iters, out);
  else if (width == 16)
    lds_probe<16><<<blocks, THREADS, 0, st>>>(distinct, iters, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
