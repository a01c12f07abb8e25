// Census transport kernel K1(a): single block, gray, IMC, no absorption, 1D.
//
// Replaces jaybenne_tpu/ops/pallas_transport.py::_transport_kernel in that
// configuration (the stepdiff main path). It computes what the JAX kernel
// computes there, per particle, and does not copy its tile structure:
//
//   * one thread per ledger slot runs its own history while
//     alive && tau < 1 && it < max_iters, with its own iteration counter. A lane
//     of the JAX tile is active from iteration 0 until census, so the thread's
//     counter equals the tile's for every draw the lane makes, and the variates
//     (kernel_rng.cuh, keyed by seed, slot, it, tag) are the JAX kernel's
//     interpret-mode variates;
//   * per event: d_coll = exp23 * inv_sigt[cell]; d_end = c dt (1 - tau);
//     d_geom = min(dx, d_end); the face distance c (face - x) / vx; then
//     collision, else crossing of x, else census when d_end <= dx (tau = 1
//     exactly); a collision redraws mu = 1 - 2 u16 with vx = c mu,
//     vy = c sqrt(1 - mu^2), vz = 0 (1D: the azimuth is unobservable);
//   * domain walls use the half-finest-cell tolerant hit test and clip of the
//     JAX kernel's apply_bc (an exact comparison livelocks); after a wall hit the
//     cell index is re-derived from the rebased position, every other crossing
//     updates the integer index;
//   * the per-cell table holds f32 1/sigma_t (the TPU kernel's bf16 pair packing
//     only halved its chunk scans); it is a few hundred bytes and stays in L1;
//   * events are summed per block and added with one int64 atomicAdd, the
//     iteration maximum with one int32 atomicMax: integer atomics, so the
//     statistics repeat exactly.
//
// What bounds it on an H100: the latency of a divergent per-thread loop of about
// a thousand events (a warp runs to its slowest lane) and the throughput of logf
// and the IEEE divide, not bytes: each particle is read and written once per call.
// The design keeps every particle in registers for the whole census and reads
// only the L1-resident table inside the loop.
//
// Built without --use_fast_math and with --fmad=false, so that every operation
// rounds as the plain PyTorch version's does.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;

enum Bc : int { kPeriodic = 0, kOutflow = 1, kReflecting = 2 };

struct Geom1D {
  int nx;          // cells in the (collapsed) single block
  float dx;        // cell size
  float inv_dx;    // f32(1 / dx)
  float org;       // block origin (domain lower bound)
  float lo, hi;    // domain bounds
  float lo_half;   // lo + half a finest cell
  float hi_half;   // hi - half a finest cell
  float span;      // f32(hi - lo)
  int bc_lo, bc_hi;
  float c, inv_c;  // speed of light and its f32 reciprocal
  float cdt;       // c * dt
  float inv_cdt;   // 1 / (c * dt)
  int max_iters;
  uint32_t seed;
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
    transport_1d_kernel(float* __restrict__ x, float* __restrict__ vx,
                        float* __restrict__ vy, float* __restrict__ vz,
                        float* __restrict__ tau, int32_t* __restrict__ ci,
                        uint8_t* __restrict__ alive,
                        const float* __restrict__ inv_sigt, int n, Geom1D g,
                        unsigned long long* __restrict__ events,
                        int32_t* __restrict__ iters) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  int it = 0;
  if (s < n && alive[s] != 0 && tau[s] < 1.0f) {
    float px = x[s], pvx = vx[s], pvy = vy[s], pvz = vz[s], ptau = tau[s];
    int pci = ci[s];
    bool palive = true;
    const uint32_t lane = (uint32_t)s;
    while (palive && ptau < 1.0f && it < g.max_iters) {
      const float d_coll =
          jb_exp23(jb_raw_bits(g.seed, lane, (uint32_t)it, 0u)) * __ldg(inv_sigt + pci);
      const float d_end = g.cdt * (1.0f - ptau);
      const float d_geom = fminf(g.dx, d_end);
      const float fi = (float)pci;
      const float xl = fi * g.dx;
      const float xu = (fi + 1.0f) * g.dx;
      const float fxd = pvx != 0.0f ? g.c * ((pvx > 0.0f ? xu : xl) - px) / pvx : kBig;
      const float d_push = fminf(d_geom, fxd);
      const bool coll = d_coll < d_push;
      const bool cross = !coll && fxd <= d_geom;
      const bool census = !coll && !cross && d_end <= g.dx;
      const float d = coll ? d_coll : d_push;

      ptau = census ? 1.0f : ptau + d * g.inv_cdt;
      float nx = px + pvx * (d * g.inv_c);
      int nci = pci;
      if (cross) {
        nx = pvx > 0.0f ? xu : xl;
        nci += pvx > 0.0f ? 1 : -1;
      }
      if (coll) {  // isotropic scatter
        const float mu =
            1.0f - 2.0f * jb_u16_lo(jb_raw_bits(g.seed, lane, (uint32_t)it, 1u));
        pvx = g.c * mu;
        pvy = g.c * sqrtf(fmaxf(1.0f - mu * mu, 0.0f));
        pvz = 0.0f;
      }

      const bool out_lo = nci < 0;
      const bool out_hi = nci >= g.nx;
      if (out_lo || out_hi) {  // domain boundary
        float gx = g.org + nx;
        const bool hit_lo = out_lo && gx <= g.lo_half;
        const bool hit_hi = out_hi && gx >= g.hi_half;
        if (hit_lo) {
          if (g.bc_lo == kReflecting) {
            gx = clip(2.0f * g.lo - gx, g.lo, g.hi);
            pvx = -pvx;
          } else if (g.bc_lo == kPeriodic) {
            gx = clip(gx + g.span, g.lo, g.hi);
          } else {
            palive = false;
          }
        }
        if (hit_hi) {
          if (g.bc_hi == kReflecting) {
            gx = clip(2.0f * g.hi - gx, g.lo, g.hi);
            pvx = -pvx;
          } else if (g.bc_hi == kPeriodic) {
            gx = clip(gx - g.span, g.lo, g.hi);
          } else {
            palive = false;
          }
        }
        if (palive) {  // rebase into the block and re-derive the cell
          nx = gx - g.org;
          nci = min(max((int)(nx * g.inv_dx), 0), g.nx - 1);
        } else {
          nci = min(max(nci, 0), g.nx - 1);
        }
      }
      px = nx;
      pci = nci;
      ++it;
    }
    x[s] = px;
    vx[s] = pvx;
    vy[s] = pvy;
    vz[s] = pvz;
    tau[s] = ptau;
    ci[s] = pci;
    alive[s] = palive ? 1 : 0;
  }

  // block reduction of the per-thread event counts (one event per iteration)
  unsigned long long ev = (unsigned long long)it;
  int mx = it;
  for (int off = 16; off > 0; off >>= 1) {
    ev += __shfl_down_sync(0xFFFFFFFFu, ev, off);
    mx = max(mx, __shfl_down_sync(0xFFFFFFFFu, mx, off));
  }
  __shared__ unsigned long long s_ev[kThreads / 32];
  __shared__ int s_mx[kThreads / 32];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_ev[warp] = ev;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      ev += s_ev[w];
      mx = max(mx, s_mx[w]);
    }
    if (ev > 0) {
      atomicAdd(events, ev);
      atomicMax(iters, mx);
    }
  }
}

}  // namespace

extern "C" int jb_transport_1d_launch(
    void* x, void* vx, void* vy, void* vz, void* tau, void* ci, void* alive,
    const void* inv_sigt, int n, int nx, float dx, float inv_dx, float org, float lo,
    float hi, float lo_half, float hi_half, float span, int bc_lo, int bc_hi, float c,
    float inv_c, float cdt, float inv_cdt, int max_iters, int seed, void* events,
    void* iters, void* stream) {
  const Geom1D g{nx,      dx,      inv_dx, org,   lo,    hi,   lo_half,   hi_half,
                 span,    bc_lo,   bc_hi,  c,     inv_c, cdt,  inv_cdt,   max_iters,
                 (uint32_t)seed};
  if (n > 0) {
    transport_1d_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (float*)x, (float*)vx, (float*)vy, (float*)vz, (float*)tau, (int32_t*)ci,
        (uint8_t*)alive, (const float*)inv_sigt, n, g, (unsigned long long*)events,
        (int32_t*)iters);
  }
  return (int)cudaGetLastError();
}
