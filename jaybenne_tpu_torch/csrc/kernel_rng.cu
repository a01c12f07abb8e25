// raw_bits kernel: evaluates the K2 counter hash (kernel_rng.cuh) on a list of
// (lane, it, tag) triples, so that a test can hold the device hash against the
// PyTorch version in ops/kernel_rng.py bit for bit; the draws_f64 kernel does the
// same for the float64 census's variates (Draw<double>). The census kernel inlines
// the same device functions; these kernels exist only for that comparison.
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

// per triple the five float64 variates of ops/kernel_rng.py::draws_f64_plain:
// u23, u16 high half, exp23, circle cos and sin of the word of tag ``tag``
__global__ void draws_f64_kernel(uint32_t seed, const int32_t* __restrict__ lane,
                                 const int32_t* __restrict__ it,
                                 const int32_t* __restrict__ tag, double* __restrict__ out,
                                 int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < n) {
    using D = Draw<double>;
    const D::Word w = D::raw(seed, (uint32_t)lane[s], (uint32_t)it[s], (uint32_t)tag[s]);
    double* o = out + 5 * (size_t)s;
    o[0] = D::u23(w);
    o[1] = D::u16_hi(w);
    o[2] = D::exp23(w);
    D::circle(w, o + 3, o + 4);
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

extern "C" int jb_draws_f64_launch(int seed, const void* lane, const void* it,
                                   const void* tag, void* out, int n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    draws_f64_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t)seed, (const int32_t*)lane, (const int32_t*)it, (const int32_t*)tag,
        (double*)out, n);
  }
  return (int)cudaGetLastError();
}
