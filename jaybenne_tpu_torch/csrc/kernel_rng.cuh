// Counter-hash uniform variates of the census kernel (K2).
//
// Port of jaybenne_tpu/ops/pallas_rng.py: make_raw_bits in interpret mode (the
// murmur3-finalizer hash keyed by (seed, lane, iteration, tag)) and the
// DrawPool transforms. With lane = ledger slot, a CUDA thread draws exactly the
// variates that the JAX kernel draws for that slot under interpret=True, and
// that ops/kernel_rng.py draws in PyTorch.
//
// Tags follow the DrawPool's allocation order inside one event: in the gray IMC
// body without absorption, tag 0 feeds exp23 and tag 1 feeds u16 (low half).
// u16 has 1/65536 granularity and must never feed a threshold test u < p.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t jb_raw_bits(uint32_t seed, uint32_t lane,
                                                uint32_t it, uint32_t tag) {
  uint32_t x = seed + lane + it * 0x9E3779B9u + tag * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// 23-bit-mantissa uniform on [0, 1) from one word
__device__ __forceinline__ float jb_u23(uint32_t b) {
  return (float)((b >> 9) & 0x7FFFFFu) * (1.0f / 8388608.0f);
}

// two 16-bit uniforms per word: the low half is drawn first, the high half is
// the pool's spare for the next u16 of the same event
__device__ __forceinline__ float jb_u16_lo(uint32_t b) {
  return (float)(b & 0xFFFFu) * (1.0f / 65536.0f);
}

__device__ __forceinline__ float jb_u16_hi(uint32_t b) {
  return (float)((b >> 16) & 0xFFFFu) * (1.0f / 65536.0f);
}

// unit-rate exponential, -log(u23) with the same floor as the JAX kernel
__device__ __forceinline__ float jb_exp23(uint32_t b) {
  return -logf(fmaxf(jb_u23(b), 1.0e-37f));
}

// (cos phi, sin phi) for phi ~ U[0, 2pi) from one word: cos(pi u23), and the
// sign of sin from the word's lowest bit
__device__ __forceinline__ void jb_circle(uint32_t b, float* cph, float* sph) {
  const float c = cosf(3.14159265358979f * jb_u23(b));
  const float s = sqrtf(fmaxf(1.0f - c * c, 0.0f));
  *cph = c;
  *sph = (b & 1u) ? -s : s;
}
