// Instruction-count probes for the census kernel's bound. Each probe applies one
// device function of the census event (logf, the IEEE divide, the K2 hash, and
// the non-gray opacity's expf and sqrtf) to
// values loaded per thread, so that `cuobjdump -sass` of the kernel library shows
// how many instructions the function compiles to: the probe's count less that of
// the probe with the same loads and stores and a single FADD in its place
// (chip_smoke.py counts them). The probes are compiled with the library's flags
// and never launched; ``jb_census_words_launch`` and ``jb_empty_launch`` at the
// end are launched. The
// ``_f64`` probes count the float64 census's functions the same way against a
// baseline with one DADD: the double log, divide, exp, sqrt and cos, and the
// double draw (two hash words made one 53-bit uniform, kernel_rng.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_rng.cuh"

extern "C" __global__ void jb_probe_load1(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = a[i];
}

extern "C" __global__ void jb_probe_load2(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = a[i] + a[i + 64];
}

extern "C" __global__ void jb_probe_logf(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = logf(a[i]);
}

extern "C" __global__ void jb_probe_div(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = a[i] / a[i + 64];
}

extern "C" __global__ void jb_probe_hash(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = __uint_as_float(
      jb_raw_bits(__float_as_uint(a[i]), (uint32_t)i, __float_as_uint(a[i + 64]), 1u));
}

extern "C" __global__ void jb_probe_expf(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = expf(a[i]);
}

extern "C" __global__ void jb_probe_sqrtf(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = sqrtf(a[i]);
}

extern "C" __global__ void jb_probe_load1_f64(const double* a, double* o) {
  const int i = threadIdx.x;
  o[i] = a[i];
}

extern "C" __global__ void jb_probe_load2_f64(const double* a, double* o) {
  const int i = threadIdx.x;
  o[i] = a[i] + a[i + 64];
}

extern "C" __global__ void jb_probe_log_f64(const double* a, double* o) {
  const int i = threadIdx.x;
  o[i] = log(a[i]);
}

extern "C" __global__ void jb_probe_div_f64(const double* a, double* o) {
  const int i = threadIdx.x;
  o[i] = a[i] / a[i + 64];
}

extern "C" __global__ void jb_probe_exp_f64(const double* a, double* o) {
  const int i = threadIdx.x;
  o[i] = exp(a[i]);
}

extern "C" __global__ void jb_probe_sqrt_f64(const double* a, double* o) {
  const int i = threadIdx.x;
  o[i] = sqrt(a[i]);
}

extern "C" __global__ void jb_probe_cos_f64(const double* a, double* o) {
  const int i = threadIdx.x;
  o[i] = cos(a[i]);
}

extern "C" __global__ void jb_probe_u53(const double* a, double* o) {
  const int i = threadIdx.x;
  const uint32_t key = jb_key((uint32_t)__double2hiint(a[i]), (uint32_t)i,
                              (uint32_t)__double2hiint(a[i + 64]));
  o[i] = jb_u53(jb_word(key, 4u), jb_word(key, 5u));
}

namespace {

// The K2 words of one census alone: thread l hashes the words its lane draws in
// its n_events[l] events, ``words`` tags an event (2 for the 1D gray IMC event
// without absorption: the exp23 word and the u16 word), and writes their xor, so
// that no word is left out.
__global__ void census_words_kernel(uint32_t seed, const int32_t* __restrict__ n_events,
                                    uint32_t* __restrict__ out, int n, int words) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  uint32_t acc = 0u;
  const int events = n_events[l];
  for (int it = 0; it < events; ++it)
    for (int tag = 0; tag < words; ++tag)
      acc ^= jb_raw_bits(seed, (uint32_t)l, (uint32_t)it, (uint32_t)tag);
  out[l] = acc;
}

}  // namespace

extern "C" int jb_census_words_launch(int seed, const void* n_events, void* out, int n,
                                      int words, void* stream) {
  if (n > 0) {
    const int threads = 256;
    census_words_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t)seed, (const int32_t*)n_events, (uint32_t*)out, n, words);
  }
  return (int)cudaGetLastError();
}

namespace {

// Nothing: the floor of a launch, timed where a kernel of the same grid would run
// (chip_smoke.py's table_check and call split; census_bench.py --only
// census_table).
__global__ void empty_kernel() {}

}  // namespace

// An empty kernel on a grid of blocks_x x blocks_y blocks of threads threads.
extern "C" int jb_empty_launch(int blocks_x, int blocks_y, int threads, void* stream) {
  empty_kernel<<<dim3(blocks_x, blocks_y), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
