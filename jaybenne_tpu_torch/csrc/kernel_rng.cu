// raw_bits kernel: evaluates the K2 counter hash (kernel_rng.cuh) on a list of
// (lane, it, tag) triples, so that a test can hold the device hash against the
// PyTorch version in ops/kernel_rng.py bit for bit. The census kernel inlines the
// same device functions; this kernel exists only for that comparison.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_rng.cuh"

namespace {

__global__ void raw_bits_kernel(uint32_t seed, const int32_t* __restrict__ lane,
                                const int32_t* __restrict__ it,
                                const int32_t* __restrict__ tag,
                                uint32_t* __restrict__ out, int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < n) {
    out[s] = jb_raw_bits(seed, (uint32_t)lane[s], (uint32_t)it[s], (uint32_t)tag[s]);
  }
}

}  // namespace

extern "C" int jb_raw_bits_launch(int seed, const void* lane, const void* it,
                                  const void* tag, void* out, int n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    raw_bits_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t)seed, (const int32_t*)lane, (const int32_t*)it, (const int32_t*)tag,
        (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
