// Instruction-count probes for the census kernel's bound. Each probe applies one
// device function of the census event (logf, the IEEE divide, the K2 hash, and
// the non-gray opacity's expf and sqrtf) to
// values loaded per thread, so that `cuobjdump -sass` of the kernel library shows
// how many instructions the function compiles to: the probe's count less that of
// the probe with the same loads and stores and a single FADD in its place
// (chip_smoke.py counts them). The probes are compiled with the library's flags
// and never launched.
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
