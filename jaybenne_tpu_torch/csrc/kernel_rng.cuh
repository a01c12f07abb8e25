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
//
// The float64 census draws 53-bit uniforms (``Draw<double>`` below, the scheme of
// ops/kernel_rng.py's float64 DrawPool): its tags are allocated as the float32
// census's, but the word of tag t is four hash words, of tags 4t .. 4t + 3. A
// uniform is u53(hi, lo) = ((hi >> 5) 2^26 + (lo >> 6)) 2^-53 of the words 4t and
// 4t + 1 (u23, a u16 low half, exp23, circle); a u16 high half is u53 of 4t + 2
// and 4t + 3, a full double uniform too; circle takes the sign of the sine from
// bit 0 of word 4t + 1; exp23 floors its uniform at the smallest normal double.
#pragma once

#include <cstdint>

// A word is the hash of key + tag * kTagStep, where the key of (seed, lane,
// iteration) is seed + lane + iteration * kItStep: a lane's next iteration has the
// key + kItStep (uint32 arithmetic wraps, so the words are the same however the
// key is reached).
constexpr uint32_t kItStep = 0x9E3779B9u;
constexpr uint32_t kTagStep = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t jb_key(uint32_t seed, uint32_t lane, uint32_t it) {
  return seed + lane + it * kItStep;
}

__device__ __forceinline__ uint32_t jb_word(uint32_t key, uint32_t tag) {
  uint32_t x = key + tag * kTagStep;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t jb_raw_bits(uint32_t seed, uint32_t lane,
                                                uint32_t it, uint32_t tag) {
  return jb_word(jb_key(seed, lane, it), tag);
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

// 53-bit uniform on [0, 1) from two words (numpy's and jax.random's float64 draw)
__device__ __forceinline__ double jb_u53(uint32_t hi, uint32_t lo) {
  return (double)((uint64_t)(hi >> 5) * 67108864ull + (uint64_t)(lo >> 6)) *
         (1.0 / 9007199254740992.0);
}

// The census's variates at its working precision. Draw<float> is the float32
// census's words and transforms above, unchanged; Draw<double> the float64 ones.
// ``Word`` is what an event carries for a tag: the hashed word in float32, the key
// and tag in float64, hashed where a transform takes them.
template <class Real>
struct Draw;

template <>
struct Draw<float> {
  using Word = uint32_t;
  __device__ static __forceinline__ Word word(uint32_t key, uint32_t tag) {
    return jb_word(key, tag);
  }
  __device__ static __forceinline__ Word raw(uint32_t seed, uint32_t lane, uint32_t it,
                                             uint32_t tag) {
    return jb_raw_bits(seed, lane, it, tag);
  }
  __device__ static __forceinline__ float u23(Word b) { return jb_u23(b); }
  __device__ static __forceinline__ float u16_lo(Word b) { return jb_u16_lo(b); }
  __device__ static __forceinline__ float u16_hi(Word b) { return jb_u16_hi(b); }
  __device__ static __forceinline__ float exp23(Word b) { return jb_exp23(b); }
  __device__ static __forceinline__ void circle(Word b, float* cph, float* sph) {
    jb_circle(b, cph, sph);
  }
};

template <>
struct Draw<double> {
  struct Word {
    uint32_t key, tag;
  };
  __device__ static __forceinline__ Word word(uint32_t key, uint32_t tag) {
    return Word{key, tag};
  }
  __device__ static __forceinline__ Word raw(uint32_t seed, uint32_t lane, uint32_t it,
                                             uint32_t tag) {
    return Word{jb_key(seed, lane, it), tag};
  }
  __device__ static __forceinline__ double u23(Word b) {
    return jb_u53(jb_word(b.key, 4u * b.tag), jb_word(b.key, 4u * b.tag + 1u));
  }
  __device__ static __forceinline__ double u16_lo(Word b) { return u23(b); }
  __device__ static __forceinline__ double u16_hi(Word b) {
    return jb_u53(jb_word(b.key, 4u * b.tag + 2u), jb_word(b.key, 4u * b.tag + 3u));
  }
  __device__ static __forceinline__ double exp23(Word b) {
    return -log(fmax(u23(b), 2.2250738585072014e-308));
  }
  __device__ static __forceinline__ void circle(Word b, double* cph, double* sph) {
    const uint32_t lo = jb_word(b.key, 4u * b.tag + 1u);
    const double c = cos(3.141592653589793 * jb_u53(jb_word(b.key, 4u * b.tag), lo));
    const double s = sqrt(fmax(1.0 - c * c, 0.0));
    *cph = c;
    *sph = (lo & 1u) ? -s : s;
  }
};
