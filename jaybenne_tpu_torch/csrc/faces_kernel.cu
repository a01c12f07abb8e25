// The DDMC face probabilities of every local shard's blocks in one launch, from
// a side map built once per mesh: bitwise the plain version in float32 and
// float64.
//
// Replaces no TPU kernel: it is the port of what XLA makes of the JAX package's
// ddmc_face_probs and ddmc_face_probs_spatial (jaybenne_tpu/ops/fleck.py:70-146,
// :203-283), the face probabilities that the DDMC census kernels read. Its plain
// version is ops/fleck.py::ddmc_face_probs (a uniform forest's index neighbours
// by to_global_cells, cat and movedim; a refined forest's two sides sampled a
// quarter local cell from the face and located in the forest) and
// ddmc_face_probs_spatial (the same on a shard's own blocks, its neighbours' from
// the all-gathered boundary surfaces). Which cell holds each side of each face
// depends on the mesh and the field BCs alone, so ops/fleck.py::face_sides makes
// it once per mesh by the plain version's own code, each side's flat cell id in
// place of its tau, and keeps it in mesh.derived; what is left a step is, for
// each face of an active axis:
//   tau_s = sigma_t[cell_s] * dx[block(cell_s), axis]   (the run's precision)
//   tau_s = tau_s > tau_ddmc ? tau_s : 2 lambda_ext
//   P     = 2 / (3 (tau_lower + tau_upper))
// in the plain version's order of operations (built without FMA contraction).
// A thread a face: over every local shard's blocks [off0 + g bl, off0 + (g + 1)
// bl), each active axis's faces of a block in turn; a padding block past the
// mesh's last gets 0. A side in the shard's own blocks reads its sigma_t; one in
// another shard's block reads that block's all-gathered boundary surface (0 for
// an interior cell, as the plain version's ``visible`` array holds it). An
// inactive axis's zeros are written where its array is made, not here.
//
// Bounds on the card: the bytes, the map (two int32 a face), each face's
// probability written, sigma_t and the block table read (in L2 after the first
// touch). Nothing waits for the device and every shape is static: a CUDA graph
// captures the launch. Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// phase 46, device ms from torch.profiler): the 64^3 DDMC row's 884736 faces
// 0.0104 ms (float64 0.0109; its bound 0.0014) where the plain version's some 30
// kernels took 0.26; the 8-shard spatial head of a refined forest 0.0023 ms (the
// plain version a shard at a time 22 ms).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 16;  // local shards a launch writes

struct Plan {
  const int32_t* lower[3];  // each active axis's map: the flat cell of a face's
  const int32_t* upper[3];  // lower and upper side, faces of every block in order
  long long fpb[3];         // faces a block along each axis (0: inactive)
  const void* dx;           // T, n_blocks x 3: each block's cell size
  const int32_t* surf_index;  // a cell's place in its block's surface, -1 inside;
                              // null: every side lies in the shard's own blocks
  int S;                    // surface cells a block
  int ncell, n_blocks, bl, off0, parts;
  long long per_part;       // faces a part: bl (fpb[0] + fpb[1] + fpb[2])
  double tau, thin;         // tau_ddmc and 2 lambda_ext, in the run's precision
  const void* sigma[kMaxParts];  // T, part g's sigma_t [bl ncell] (stride sstep)
  int sstep;                     // 1, or 0 where sigma_t is one value broadcast
  const void* surf[kMaxParts];   // T, part g's all-gathered surfaces [blocks, S]
  void* out[kMaxParts][3];       // T, part g's face arrays
};

template <typename T>
__device__ __forceinline__ T side_tau(const Plan& P, int g, int axis, int cell) {
  const int b = cell / P.ncell;
  const int r = cell - b * P.ncell;
  const int own = b - (P.off0 + g * P.bl);
  T sig;
  if (own >= 0 && own < P.bl) {
    sig = static_cast<const T*>(P.sigma[g])[(long long)(own * P.ncell + r) * P.sstep];
  } else {
    const int q = P.surf_index[r];
    sig = q < 0 ? T(0) : static_cast<const T*>(P.surf[g])[(long long)b * P.S + q];
  }
  const T tau = sig * static_cast<const T*>(P.dx)[b * 3 + axis];
  return tau > (T)P.tau ? tau : (T)P.thin;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) face_probs_kernel(Plan P) {
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (t >= P.per_part * P.parts) return;
  const int g = (int)(t / P.per_part);
  long long r = t - g * P.per_part;
  int axis = 0;
  long long span = P.bl * P.fpb[0];
  while (r >= span) {  // the axis whose faces hold r
    r -= span;
    ++axis;
    span = P.bl * P.fpb[axis];
  }
  const long long lb = r / P.fpb[axis];
  const long long gb = P.off0 + (long long)g * P.bl + lb;
  T p = T(0);
  if (gb < P.n_blocks) {
    const long long f = gb * P.fpb[axis] + (r - lb * P.fpb[axis]);
    const T lo = side_tau<T>(P, g, axis, P.lower[axis][f]);
    const T up = side_tau<T>(P, g, axis, P.upper[axis][f]);
    p = T(2) / (T(3) * (lo + up));
  }
  static_cast<T*>(P.out[g][axis])[r] = p;
}

template <typename T>
int launch(Plan P, const void* const* sigma, const void* const* surf, void* const* out,
           cudaStream_t st) {
  const int parts = P.parts;
  for (int p0 = 0; p0 < parts; p0 += kMaxParts) {
    P.parts = std::min(kMaxParts, parts - p0);
    for (int p = 0; p < kMaxParts; ++p) {
      const bool on = p < P.parts;
      P.sigma[p] = on ? sigma[p0 + p] : nullptr;
      P.surf[p] = on && surf != nullptr ? surf[p0 + p] : nullptr;
      for (int a = 0; a < 3; ++a) P.out[p][a] = on ? out[3 * (p0 + p) + a] : nullptr;
    }
    const long long n = P.per_part * P.parts;
    if (n > 0)
      face_probs_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(P);
    P.off0 += kMaxParts * P.bl;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// double_: 1 where sigma_t, the block table and the outputs are float64, else
// float32. lower, upper: host arrays of 3 device pointers, each active axis's
// side map (null for an inactive axis); fpb: host array of 3 faces a block.
// dx: the block table's cell sizes [n_blocks, 3]. surf_index: [ncell] int32
// (device), or null where every side lies in a part's own blocks (one part of
// every block); S: surface cells a block. ncell: cells a block; bl: blocks a
// part; off0: the first part's first block (part g's is off0 + g bl). tau,
// thin: tau_ddmc and 2 lambda_ext, rounded to the run's precision. parts: the
// local shards; sigma, surf: host arrays of parts device pointers (surf null
// without surfaces); sstep: sigma_t's element stride, 1 or 0; out: host array
// of 3 parts device pointers, part g's px py pz (null for an inactive axis).
// stream: the CUDA stream. One launch for every 16 parts. Returns
// cudaGetLastError() after the launches, -1 for arguments it does not take.
extern "C" int jb_faces_launch(int double_, const void* const* lower, const void* const* upper,
                               const long long* fpb, const void* dx, const void* surf_index,
                               int S, int ncell, int n_blocks, int bl, int off0, double tau,
                               double thin, int parts, const void* const* sigma, int sstep,
                               const void* const* surf, void* const* out, void* stream) {
  if (parts < 1 || ncell < 1 || bl < 1 || n_blocks < 1 || off0 < 0 ||
      (sstep != 0 && sstep != 1) ||
      (surf_index != nullptr && surf == nullptr) ||
      (surf_index == nullptr && (parts != 1 || off0 != 0 || bl < n_blocks)) ||
      (long long)n_blocks * ncell >= (1LL << 31))
    return -1;
  Plan P;
  P.per_part = 0;
  for (int a = 0; a < 3; ++a) {
    if (fpb[a] < 0 || (fpb[a] > 0) != (lower[a] != nullptr) ||
        (fpb[a] > 0) != (upper[a] != nullptr))
      return -1;
    P.lower[a] = (const int32_t*)lower[a];
    P.upper[a] = (const int32_t*)upper[a];
    P.fpb[a] = fpb[a];
    P.per_part += (long long)bl * fpb[a];
  }
  if (P.per_part == 0) return -1;
  P.dx = dx;
  P.surf_index = (const int32_t*)surf_index;
  P.S = S;
  P.ncell = ncell;
  P.n_blocks = n_blocks;
  P.bl = bl;
  P.off0 = off0;
  P.parts = parts;
  P.tau = tau;
  P.thin = thin;
  P.sstep = sstep;
  auto st = (cudaStream_t)stream;
  return double_ ? launch<double>(P, sigma, surf, out, st) : launch<float>(P, sigma, surf, out, st);
}
