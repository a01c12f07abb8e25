// Census transport kernel: gray IMC, and hybrid IMC/DDMC, on a uniform
// single-level mesh, 1D/2D/3D, with or without absorption. One source, twelve
// instantiations (NDIM in {1, 2, 3} x ABSORB x DDMC).
//
// Replaces, in their gray configurations on a uniform (max_level == 0) forest,
// both census kernels of the JAX package:
//
//   * jaybenne_tpu/ops/pallas_transport.py::_transport_kernel (:382; K1), the
//     VMEM-resident kernel with its has_absorption (K1(b)), multi_d/three_d
//     (K1(e), gray part) and use_ddmc (K1(c)) branches;
//   * jaybenne_tpu/ops/pallas_grid.py::_grid_kernel (:678; K3), the kernel the
//     JAX package runs on meshes past K1's 5120-cell VMEM limit.
//
// The two exist separately on the TPU only because of VMEM. Here one kernel
// tracks global cells on the collapsed single block and gathers its per-cell
// table from global memory: the region slabs, halos, SIGMA_REFRESH stale lanes,
// pause-and-rebucket rounds, bucket sorts and bf16 pair packing of the TPU
// kernels are not carried over. It computes what they compute, per particle:
//
//   * one thread per ledger slot runs its own history while
//     alive && tau < 1 && it < max_iters, with its own iteration counter. A lane
//     of the JAX tile is active from iteration 0 until census or absorption, so
//     the thread's counter equals the tile's for every draw the lane makes, and
//     the variates (kernel_rng.cuh, keyed by seed, slot, it, tag) are the JAX
//     kernel's interpret-mode variates. Tags follow the JAX DrawPool's order:
//     exp23 is tag 0, then the u23 branch draw (ABSORB only), then the u16 word,
//     then the circle word (multi-D only);
//   * per event: d_coll = exp23 * inv_sigt[cell]; with ABSORB a u23 branch draw
//     (a u16 draw must never feed a threshold test); d_end = c dt (1 - tau);
//     d_geom = min(dmin, d_end); the face distances c (face - x) / v on the
//     active axes; then, in order, collision (absorb when u23 < p_abs, else
//     scatter), crossing of x, else y, else z (ties go to the lower axis), else
//     census when d_end <= dmin (tau = 1 exactly). Absorption clears alive, sets
//     absorbed and does not scatter. A 1D scatter draws mu = 1 - 2 u16 with
//     vx = c mu, vy = c sqrt(1 - mu^2), vz = 0 (the azimuth is unobservable); a
//     multi-D scatter draws the azimuth from the circle word:
//     (c st cos(phi), c st sin(phi), c mu);
//   * domain walls use the half-finest-cell tolerant hit test and clip of the
//     JAX kernel's apply_bc (an exact comparison livelocks). After any wall hit
//     every active axis's cell is re-derived from the rebased position; every
//     other crossing updates the integer index;
//   * the per-cell table holds the f32 pair (p_abs = fleck sigma_a / sigma_t,
//     1 / sigma_t) in global row-major cell order, one 8-byte float2 per cell
//     (the TPU kernels' bf16 packing only halved their chunk scans). At the
//     128-cell stepdiff gate it stays in L1; at the 64^3 feedback mesh it is
//     2 MB and each event's gather is served from L2;
//   * DDMC (pallas_transport.py:502-870, 893-939, 1166-1167): the table holds
//     one 32-byte record per cell, (ea = fleck sigma_a, es = sigma_s +
//     (1 - fleck) sigma_a, P_lower, P_upper of x, y, z), read as two float4.
//     A lane whose cell has dmin sigma_t > tau_ddmc runs the DDMC event: the
//     albedo test 2 P (1 +- 1.5 v / c) against the extrapolated face
//     probability when it arrived at a face by an IMC crossing (rejection
//     bounces it into the neighbour cell eps_imc dx from the face, with no time
//     advance); else an exponential event time at rate c (ea + sum of the leak
//     rates P_face / dx) against the time to census: absorption, a leak eps_ddmc
//     dx beyond the face chosen by cumulative sum in the order x_lo, x_hi, y_lo,
//     y_hi, z_lo, z_hi (the numerical fall-through takes the last face) with the
//     transverse coordinates at the cell centre and a hemisphere direction, or
//     census with a uniform position in the cell and an isotropic direction.
//     Any other lane runs the IMC event with the JAX kernel's DDMC-mode
//     rounding (d_coll = exp23 / (sigma_t + tiny), absorption when u23 sigma_t
//     < ea) and records the face-arrival code +-(axis + 1) of a crossing (0
//     otherwise; a reflecting wall negates it). The ledger's face column is read
//     and written only by the DDMC instantiations. Draw tags continue the IMC
//     event's (the DrawPool's order): the albedo u23, the hemisphere mu from the
//     high half of the IMC scatter's u16 word, exp23, the leak u23, then u16
//     words for the leak mu, the census position and the census mu, each
//     followed by a circle word in 2D/3D where the JAX kernel draws one;
//   * events are summed per block and added with one int64 atomicAdd, the
//     iteration maximum with one int32 atomicMax: integer atomics, so the
//     statistics repeat exactly.
//
// What bounds it on an H100: the latency of a divergent per-thread loop of about
// a thousand events (a warp runs to its slowest lane) and the throughput of
// logf, the IEEE divides and the hash per event, not bytes: each particle is
// read and written once per call, and the one table gather per event hits L1
// or L2. The design keeps every particle in registers for the whole census.
//
// Built without --use_fast_math and with --fmad=false, so that every operation
// rounds as the plain PyTorch version's does. NDIM = 1 without absorption or DDMC
// executes the same float operations as the first (1D-only) version of this
// kernel, so the stepdiff gate reproduces its events and error to every digit;
// every line the DDMC parameter adds is dead code when it is false.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;

enum Bc : int { kPeriodic = 0, kOutflow = 1, kReflecting = 2 };

// Float32 scalars of the event body, each rounded on the host as the JAX
// kernel rounds it. Per-axis arrays are (x, y, z); only the first NDIM are read.
struct Geom {
  int n[3];           // cells per axis of the collapsed single block
  int bc[6];          // (ix1, ox1, ix2, ox2, ix3, ox3)
  int max_iters;
  uint32_t seed;
  float dx[3];        // cell size
  float inv_dx[3];    // f32(1 / dx)
  float org[3];       // block origin (domain lower bound)
  float lo[3], hi[3]; // domain bounds
  float lo_half[3];   // lo + half a finest cell
  float hi_half[3];   // hi - half a finest cell
  float span[3];      // f32(hi - lo)
  float dmin;         // smallest cell size over the active axes
  float c, inv_c;     // speed of light and its f32 reciprocal
  float cdt;          // c * dt
  float inv_cdt;      // 1 / (c * dt)
  // DDMC only
  float tau_ddmc;     // a lane is on the DDMC branch when dmin sigma_t > tau_ddmc
  float eps_imc;      // albedo bounce-back offset, in cells
  float eps_ddmc;     // leak offset, in cells
  float dt;           // f32(dt)
  float inv_dt;       // f32(1) / f32(dt)
  float lam2;         // f32(2 lambda_ext)
  float pf2_num;      // f32(2 (2 / 3))
};
constexpr int kGeomInts = 11;
constexpr int kGeomFloats = 36;

struct Ledger {
  float* x[3];        // x, y, z
  float* v[3];        // vx, vy, vz
  float* tau;
  int32_t* ci[3];     // i, j, k
  uint8_t* alive;
  uint8_t* absorbed;
  int32_t* face;      // face-arrival code (DDMC instantiations only)
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The DDMC event of one lane (pallas_transport.py:655-870): writes the lane's
// new position, cell index, velocity, tau and absorption; the face code it
// leaves is 0. ``pf`` holds the cell's (P_lower, P_upper) of x, y, z.
template <int NDIM, bool ABSORB>
__device__ __forceinline__ void ddmc_event(const Geom& g, uint32_t lane, uint32_t it,
                                           int face, float ea, float sig_t,
                                           const float (&pf)[6], const float (&p)[3],
                                           const int (&ci)[3], float (&v)[3],
                                           float (&np_)[3], int (&nci)[3], float& ptau,
                                           bool& palive, bool& pabsorbed) {
  constexpr bool kMultiD = NDIM >= 2;
  constexpr uint32_t kTagU16 = ABSORB ? 2u : 1u;  // the IMC scatter's u16 word
  constexpr uint32_t kTagAlbedo = kTagU16 + (kMultiD ? 2u : 1u);
  constexpr uint32_t kTagExp = kTagAlbedo + (kMultiD ? 2u : 1u);
  constexpr uint32_t kTagXi = kTagExp + 1u;
  constexpr uint32_t kTagW2 = kTagXi + 1u;         // leak mu (lo), census x (hi)
  constexpr uint32_t kTagW3 = kTagW2 + (kMultiD ? 2u : 1u);
  float flo[3], fhi[3];
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    const float f = (float)ci[a];
    flo[a] = f * g.dx[a];
    fhi[a] = (f + 1.0f) * g.dx[a];
    np_[a] = p[a];
    nci[a] = ci[a];
  }
  // albedo test on arrival at a face: +code at the lower face, -code at the upper
  bool rejected = false;
  if (face != 0) {
    float prob = 0.0f;
#pragma unroll
    for (int a = 0; a < NDIM; ++a) {
      const float pf2 = g.pf2_num / (sig_t * g.dx[a] + g.lam2);
      const float drift = 1.5f * v[a] * g.inv_c;
      if (face == a + 1) prob = pf2 * (1.0f + drift);
      if (face == -(a + 1)) prob = pf2 * (1.0f - drift);
    }
    rejected = jb_u23(jb_raw_bits(g.seed, lane, it, kTagAlbedo)) > prob;
  }
  if (rejected) {  // bounce back into the neighbour cell, no time advance
    const float amu = sqrtf(jb_u16_hi(jb_raw_bits(g.seed, lane, it, kTagU16)));
    const float anu = sqrtf(fmaxf(1.0f - amu * amu, 0.0f));
    float a2 = anu, a3 = 0.0f;
    if constexpr (kMultiD) {
      float cph, sph;
      jb_circle(jb_raw_bits(g.seed, lane, it, kTagAlbedo + 1u), &cph, &sph);
      a2 = anu * cph;
      a3 = anu * sph;
    }
#pragma unroll
    for (int a = 0; a < NDIM; ++a) {
      if (face == a + 1 || face == -(a + 1)) {
        const bool lower = face > 0;
        np_[a] = lower ? flo[a] - g.eps_imc * g.dx[a] : fhi[a] + g.eps_imc * g.dx[a];
        nci[a] = ci[a] + (lower ? -1 : 1);
        v[a] = (g.c * (lower ? -1.0f : 1.0f)) * amu;
        v[(a + 1) % 3] = g.c * a2;
        v[(a + 2) % 3] = g.c * a3;
      }
    }
    return;
  }
  // in-cell step: leak rates P_face / dx, event time against census
  float lk[2 * NDIM];
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    lk[2 * a] = pf[2 * a] * g.inv_dx[a];
    lk[2 * a + 1] = pf[2 * a + 1] * g.inv_dx[a];
  }
  float leak_tot = lk[0] + lk[1];
#pragma unroll
  for (int e = 2; e < 2 * NDIM; ++e) leak_tot = leak_tot + lk[e];
  const float cdf = (ABSORB ? ea + leak_tot : leak_tot) + 1.0e-37f;
  const float dt_ev = jb_exp23(jb_raw_bits(g.seed, lane, it, kTagExp)) / (g.c * cdf);
  const float dt_rem = g.dt * (1.0f - ptau);
  const uint32_t w2 = jb_raw_bits(g.seed, lane, it, kTagW2);
  if (dt_ev < dt_rem) {
    ptau = ptau + dt_ev * g.inv_dt;
    const float xi = cdf * jb_u23(jb_raw_bits(g.seed, lane, it, kTagXi));
    if (ABSORB && xi < ea) {
      palive = false;
      pabsorbed = true;
      return;
    }
    const float xim = ABSORB ? xi - ea : xi;
    int leak = 2 * NDIM - 1;  // the numerical fall-through takes the last face
    bool found = false;
    float cum = 0.0f;
#pragma unroll
    for (int e = 0; e < 2 * NDIM; ++e) {
      if (!found && xim < cum + lk[e]) {
        leak = e;
        found = true;
      }
      cum = cum + lk[e];
    }
    const float bmu = sqrtf(jb_u16_lo(w2));
    const float bnu = sqrtf(fmaxf(1.0f - bmu * bmu, 0.0f));
    float b2 = bnu, b3 = 0.0f;
    if constexpr (kMultiD) {
      float cph, sph;
      jb_circle(jb_raw_bits(g.seed, lane, it, kTagW2 + 1u), &cph, &sph);
      b2 = bnu * cph;
      b3 = bnu * sph;
    }
#pragma unroll
    for (int a = 0; a < NDIM; ++a) {
      if (leak >> 1 == a) {
        const bool lower = (leak & 1) == 0;
        np_[a] = lower ? flo[a] - g.eps_ddmc * g.dx[a] : fhi[a] + g.eps_ddmc * g.dx[a];
        nci[a] = ci[a] + (lower ? -1 : 1);
        v[a] = (g.c * (lower ? -1.0f : 1.0f)) * bmu;
        v[(a + 1) % 3] = g.c * b2;
        v[(a + 2) % 3] = g.c * b3;
      } else {
        np_[a] = flo[a] + 0.5f * g.dx[a];  // transverse: the cell centre
      }
    }
    return;
  }
  // census: uniform position in the cell, isotropic direction
  ptau = 1.0f;
  np_[0] = flo[0] + jb_u16_hi(w2) * g.dx[0];
  const uint32_t w3 = jb_raw_bits(g.seed, lane, it, kTagW3);
  float cmu;
  if constexpr (NDIM == 1) {
    cmu = 1.0f - 2.0f * jb_u16_lo(w3);
  } else {
    np_[1] = flo[1] + jb_u16_lo(w3) * g.dx[1];
    if constexpr (NDIM == 2) {
      cmu = 1.0f - 2.0f * jb_u16_hi(w3);
    } else {
      np_[2] = flo[2] + jb_u16_hi(w3) * g.dx[2];
      cmu = 1.0f - 2.0f * jb_u16_lo(jb_raw_bits(g.seed, lane, it, kTagW3 + 1u));
    }
  }
  const float cst = sqrtf(fmaxf(1.0f - cmu * cmu, 0.0f));
  if constexpr (NDIM == 1) {
    v[0] = g.c * cmu;
    v[1] = g.c * cst;
    v[2] = 0.0f;
  } else {
    float cph, sph;
    jb_circle(jb_raw_bits(g.seed, lane, it, kTagW3 + (NDIM == 2 ? 1u : 2u)), &cph, &sph);
    v[0] = g.c * cst * cph;
    v[1] = g.c * cst * sph;
    v[2] = g.c * cmu;
  }
}

template <int NDIM, bool ABSORB, bool DDMC>
__global__ void __launch_bounds__(kThreads)
    transport_kernel(Ledger L, const float* __restrict__ table, int n, Geom g,
                     unsigned long long* __restrict__ events,
                     int32_t* __restrict__ iters) {
  constexpr uint32_t kTagU16 = ABSORB ? 2u : 1u;
  constexpr uint32_t kTagCircle = kTagU16 + 1u;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  int it = 0;
  if (s < n && L.alive[s] != 0 && L.tau[s] < 1.0f) {
    float p[3], v[3];
    int ci[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      p[a] = a < NDIM ? L.x[a][s] : 0.0f;
      v[a] = L.v[a][s];
      ci[a] = a < NDIM ? L.ci[a][s] : 0;
    }
    float ptau = L.tau[s];
    bool palive = true;
    bool pabsorbed = false;
    int pface = DDMC ? L.face[s] : 0;
    const uint32_t lane = (uint32_t)s;
    while (palive && ptau < 1.0f && it < g.max_iters) {
      int cell = ci[0];
      if (NDIM == 2) cell = ci[1] * g.n[0] + ci[0];
      if (NDIM == 3) cell = (ci[2] * g.n[1] + ci[1]) * g.n[0] + ci[0];
      float2 tab;        // (p_abs, 1 / sigma_t) without DDMC
      float ea = 0.0f;   // with DDMC: fleck sigma_a
      float sig_t = 0.0f;
      float pf[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      bool is_ddmc = false;
      if constexpr (DDMC) {
        const float4* rec = reinterpret_cast<const float4*>(table) + 2 * (size_t)cell;
        const float4 r0 = __ldg(rec);  // (ea, es, Px_lo, Px_hi)
        if (ABSORB) ea = r0.x;
        sig_t = ABSORB ? r0.x + r0.y : r0.y;
        pf[0] = r0.z;
        pf[1] = r0.w;
        if (NDIM >= 2) {
          const float4 r1 = __ldg(rec + 1);  // (Py_lo, Py_hi, Pz_lo, Pz_hi)
          pf[2] = r1.x;
          pf[3] = r1.y;
          pf[4] = r1.z;
          pf[5] = r1.w;
        }
        is_ddmc = g.dmin * sig_t > g.tau_ddmc;
      } else {
        tab = __ldg(reinterpret_cast<const float2*>(table) + cell);
      }
      float np_[3];
      int nci[3];
      int nface = 0;
      if (DDMC && is_ddmc) {
        ddmc_event<NDIM, ABSORB>(g, lane, (uint32_t)it, pface, ea, sig_t, pf, p, ci, v, np_,
                                 nci, ptau, palive, pabsorbed);
      } else {
        float d_coll;
        if constexpr (DDMC) {
          d_coll = jb_exp23(jb_raw_bits(g.seed, lane, (uint32_t)it, 0u)) / (sig_t + 1.0e-37f);
        } else {
          d_coll = jb_exp23(jb_raw_bits(g.seed, lane, (uint32_t)it, 0u)) * tab.y;
        }
        float u_branch = 0.0f;
        if (ABSORB) u_branch = jb_u23(jb_raw_bits(g.seed, lane, (uint32_t)it, 1u));
        const float d_end = g.cdt * (1.0f - ptau);
        const float d_geom = fminf(g.dmin, d_end);

        float flo[3], fhi[3], fd[3];
#pragma unroll
        for (int a = 0; a < NDIM; ++a) {
          const float f = (float)ci[a];
          flo[a] = f * g.dx[a];
          fhi[a] = (f + 1.0f) * g.dx[a];
          fd[a] = v[a] != 0.0f ? g.c * ((v[a] > 0.0f ? fhi[a] : flo[a]) - p[a]) / v[a]
                               : kBig;
        }
        float d_push = fminf(d_geom, fd[0]);
        if (NDIM == 2) d_push = fminf(d_push, fd[1]);
        if (NDIM == 3) d_push = fminf(d_push, fminf(fd[1], fd[2]));

        const bool coll = d_coll < d_push;
        bool absorb = false;
        if constexpr (ABSORB && DDMC) absorb = coll && u_branch * sig_t < ea;
        if constexpr (ABSORB && !DDMC) absorb = coll && u_branch < tab.x;
        const bool scatter = coll && !absorb;
        bool cr[3] = {false, false, false};
        cr[0] = !coll && fd[0] <= d_geom;
        if (NDIM >= 2) cr[0] = cr[0] && fd[0] <= fd[1];
        if (NDIM == 3) cr[0] = cr[0] && fd[0] <= fd[2];
        if (NDIM >= 2) cr[1] = !coll && !cr[0] && fd[1] <= d_geom;
        if (NDIM == 3) cr[1] = cr[1] && fd[1] <= fd[2];
        if (NDIM == 3) cr[2] = !coll && !cr[0] && !cr[1] && fd[2] <= d_geom;
        const bool census = !coll && !cr[0] && !cr[1] && !cr[2] && d_end <= g.dmin;
        const float d = coll ? d_coll : d_push;

        ptau = census ? 1.0f : ptau + d * g.inv_cdt;
        const float step = d * g.inv_c;
#pragma unroll
        for (int a = 0; a < NDIM; ++a) {
          np_[a] = p[a] + v[a] * step;
          nci[a] = ci[a];
          if (cr[a]) {
            np_[a] = v[a] > 0.0f ? fhi[a] : flo[a];
            nci[a] += v[a] > 0.0f ? 1 : -1;
            if (DDMC) nface = v[a] > 0.0f ? a + 1 : -(a + 1);
          }
        }
        if (scatter) {  // isotropic scatter
          const float mu =
              1.0f - 2.0f * jb_u16_lo(jb_raw_bits(g.seed, lane, (uint32_t)it, kTagU16));
          const float st = sqrtf(fmaxf(1.0f - mu * mu, 0.0f));
          if (NDIM == 1) {
            v[0] = g.c * mu;
            v[1] = g.c * st;
            v[2] = 0.0f;
          } else {
            float cph, sph;
            jb_circle(jb_raw_bits(g.seed, lane, (uint32_t)it, kTagCircle), &cph, &sph);
            v[0] = g.c * st * cph;
            v[1] = g.c * st * sph;
            v[2] = g.c * mu;
          }
        }
        if (absorb) {
          palive = false;
          pabsorbed = true;
        }
      }

      bool out_lo[3], out_hi[3];
      bool any_out = false;
#pragma unroll
      for (int a = 0; a < NDIM; ++a) {
        out_lo[a] = nci[a] < 0;
        out_hi[a] = nci[a] >= g.n[a];
        any_out = any_out || out_lo[a] || out_hi[a];
      }
      if (any_out) {  // domain boundary
        float gp[3];
#pragma unroll
        for (int a = 0; a < NDIM; ++a) {
          gp[a] = g.org[a] + np_[a];
          const bool hit_lo = out_lo[a] && gp[a] <= g.lo_half[a];
          const bool hit_hi = out_hi[a] && gp[a] >= g.hi_half[a];
          if (hit_lo) {
            if (g.bc[2 * a] == kReflecting) {
              gp[a] = clip(2.0f * g.lo[a] - gp[a], g.lo[a], g.hi[a]);
              v[a] = -v[a];
              if (DDMC) nface = -nface;
            } else if (g.bc[2 * a] == kPeriodic) {
              gp[a] = clip(gp[a] + g.span[a], g.lo[a], g.hi[a]);
            } else {
              palive = false;
            }
          }
          if (hit_hi) {
            if (g.bc[2 * a + 1] == kReflecting) {
              gp[a] = clip(2.0f * g.hi[a] - gp[a], g.lo[a], g.hi[a]);
              v[a] = -v[a];
              if (DDMC) nface = -nface;
            } else if (g.bc[2 * a + 1] == kPeriodic) {
              gp[a] = clip(gp[a] - g.span[a], g.lo[a], g.hi[a]);
            } else {
              palive = false;
            }
          }
        }
#pragma unroll
        for (int a = 0; a < NDIM; ++a) {
          if (palive) {  // rebase into the block and re-derive every cell
            np_[a] = gp[a] - g.org[a];
            nci[a] = min(max((int)(np_[a] * g.inv_dx[a]), 0), g.n[a] - 1);
          } else {
            nci[a] = min(max(nci[a], 0), g.n[a] - 1);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < NDIM; ++a) {
        p[a] = np_[a];
        ci[a] = nci[a];
      }
      pface = nface;
      ++it;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (a < NDIM) {
        L.x[a][s] = p[a];
        L.ci[a][s] = ci[a];
      }
      L.v[a][s] = v[a];
    }
    L.tau[s] = ptau;
    L.alive[s] = palive ? 1 : 0;
    if (ABSORB && pabsorbed) L.absorbed[s] = 1;
    if (DDMC) L.face[s] = pface;
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

template <int NDIM, bool ABSORB, bool DDMC>
void launch(const Ledger& L, const float* table, int n, const Geom& g,
            unsigned long long* events, int32_t* iters, cudaStream_t stream) {
  transport_kernel<NDIM, ABSORB, DDMC>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(L, table, n, g, events, iters);
}

template <int NDIM>
void launch_dim(bool absorb, bool ddmc, const Ledger& L, const float* table, int n,
                const Geom& g, unsigned long long* events, int32_t* iters,
                cudaStream_t stream) {
  if (!absorb && !ddmc) launch<NDIM, false, false>(L, table, n, g, events, iters, stream);
  if (absorb && !ddmc) launch<NDIM, true, false>(L, table, n, g, events, iters, stream);
  if (!absorb && ddmc) launch<NDIM, false, true>(L, table, n, g, events, iters, stream);
  if (absorb && ddmc) launch<NDIM, true, true>(L, table, n, g, events, iters, stream);
}

}  // namespace

// ptrs: 13 device pointers x y z vx vy vz tau i j k alive absorbed face.
// table: per cell, the float2 (p_abs, 1 / sigma_t) without DDMC, the 8 floats
// (ea, es, Px_lo, Px_hi, Py_lo, Py_hi, Pz_lo, Pz_hi) with it (16-byte aligned).
// igeom: n[3] bc[6] max_iters seed; fgeom: dx[3] inv_dx[3] org[3] lo[3] hi[3]
// lo_half[3] hi_half[3] span[3] dmin c inv_c cdt inv_cdt tau_ddmc eps_imc eps_ddmc
// dt inv_dt lam2 pf2_num (host arrays).
// Returns cudaGetLastError() after the launch, or -1 for an unknown ndim.
extern "C" int jb_transport_launch(int ndim, int absorb, int ddmc, void* const* ptrs,
                                   const void* table, int n, const int* igeom,
                                   const float* fgeom, void* events, void* iters,
                                   void* stream) {
  Ledger L;
  for (int a = 0; a < 3; ++a) {
    L.x[a] = (float*)ptrs[a];
    L.v[a] = (float*)ptrs[3 + a];
    L.ci[a] = (int32_t*)ptrs[7 + a];
  }
  L.tau = (float*)ptrs[6];
  L.alive = (uint8_t*)ptrs[10];
  L.absorbed = (uint8_t*)ptrs[11];
  L.face = (int32_t*)ptrs[12];

  Geom g;
  const int* ip = igeom;
  for (int a = 0; a < 3; ++a) g.n[a] = *ip++;
  for (int a = 0; a < 6; ++a) g.bc[a] = *ip++;
  g.max_iters = *ip++;
  g.seed = (uint32_t)*ip++;
  const float* fp = fgeom;
  float* dst[8] = {g.dx, g.inv_dx, g.org, g.lo, g.hi, g.lo_half, g.hi_half, g.span};
  for (int k = 0; k < 8; ++k)
    for (int a = 0; a < 3; ++a) dst[k][a] = *fp++;
  g.dmin = *fp++;
  g.c = *fp++;
  g.inv_c = *fp++;
  g.cdt = *fp++;
  g.inv_cdt = *fp++;
  g.tau_ddmc = *fp++;
  g.eps_imc = *fp++;
  g.eps_ddmc = *fp++;
  g.dt = *fp++;
  g.inv_dt = *fp++;
  g.lam2 = *fp++;
  g.pf2_num = *fp++;
  static_assert(kGeomInts == 11 && kGeomFloats == 36, "geometry layout");

  if (ndim < 1 || ndim > 3) return -1;
  if (n > 0) {
    const float* tab = (const float*)table;
    auto* ev = (unsigned long long*)events;
    auto* itp = (int32_t*)iters;
    auto st = (cudaStream_t)stream;
    const bool ab = absorb != 0, dd = ddmc != 0;
    if (ndim == 1) launch_dim<1>(ab, dd, L, tab, n, g, ev, itp, st);
    if (ndim == 2) launch_dim<2>(ab, dd, L, tab, n, g, ev, itp, st);
    if (ndim == 3) launch_dim<3>(ab, dd, L, tab, n, g, ev, itp, st);
  }
  return (int)cudaGetLastError();
}
