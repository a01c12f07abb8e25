// The census's move of a ledger on a uniform multi-block mesh to the one
// synthetic block its kernel tracks global cells on, and back (the port of the
// JAX wrapper's _uniform_view, jaybenne_tpu/ops/pallas_transport.py:335-379,
// which XLA fuses around K1 and K3).
//
// collapse: every slot's block-local position and cell index shift by its
// block's offset, x += f32(bx) * Dx and i += bx * nx on each axis, with
// (bx, by, bz) = (block mod nrbx, (block // nrbx) mod nrby, block // (nrbx nrby))
// in Python's floor semantics, and the block becomes 0. expand: the inverse,
// bk = i // nx, i -= bk * nx, x -= f32(bk) * Dx on each axis and block =
// (bz nrby + by) nrbx + bx. The same float32 and int32 operations on every slot
// as the plain PyTorch version (ops/transport_kernel.py: collapse_plain,
// expand_plain), in the same order on all three axes, so the bits are the same;
// built without FMA contraction.
//
// What bounds it on an H100: bytes. The collapse reads and writes each slot's
// three positions, three indices and block (56 bytes, 0.0111 ms for the 64^3 DDMC
// row's 663168 slots at 3.35 TB/s); the expansion reads the positions and indices
// and writes all seven (52 bytes, 0.0103 ms). The plain version makes 21
// (collapse) and 23 (expand) elementwise passes, a launch each: 0.077 and 0.088 ms
// there, of a 0.44 ms census call. One pass each: 0.015 ms each (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py phase 14), and the census call 0.437 -> 0.312 ms
// (census_bench.py, in turns against the plain passes).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Python's floor division and modulo of an int32 by a positive divisor.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

struct Columns {
  float* x[3];
  int32_t* i[3];
  int32_t* block;
};

__global__ void __launch_bounds__(kThreads)
    collapse_kernel(Columns c, int n, int nrbx, int nrby, int3 nloc, float3 shift) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n) return;
  const int b = c.block[q];
  const int bk[3] = {floor_mod(b, nrbx), floor_mod(floor_div(b, nrbx), nrby),
                     floor_div(b, nrbx * nrby)};
  const int nl[3] = {nloc.x, nloc.y, nloc.z};
  const float d[3] = {shift.x, shift.y, shift.z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float off = (float)bk[a] * d[a];
    c.x[a][q] = c.x[a][q] + off;
    c.i[a][q] = c.i[a][q] + bk[a] * nl[a];
  }
  c.block[q] = 0;
}

__global__ void __launch_bounds__(kThreads)
    expand_kernel(Columns c, int n, int nrbx, int nrby, int3 nloc, float3 shift) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n) return;
  const int nl[3] = {nloc.x, nloc.y, nloc.z};
  const float d[3] = {shift.x, shift.y, shift.z};
  int bk[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int idx = c.i[a][q];
    bk[a] = floor_div(idx, nl[a]);
    c.i[a][q] = idx - bk[a] * nl[a];
    const float off = (float)bk[a] * d[a];
    c.x[a][q] = c.x[a][q] - off;
  }
  c.block[q] = (bk[2] * nrby + bk[1]) * nrbx + bk[0];
}

}  // namespace

// cols: 7 device pointers x y z (float32) i j k block (int32) of ``n`` slots;
// nrbx, nrby: root blocks along x and y; nx ny nz: cells a block; dx dy dz: the
// f32 extent of a block. expand: 0 collapses the ledger to one block, 1 expands
// it back. Returns cudaGetLastError() after the launch.
extern "C" int jb_ledger_shift_launch(int expand, void* const* cols, int n, int nrbx, int nrby,
                                      int nx, int ny, int nz, float dx, float dy, float dz,
                                      void* stream) {
  Columns c;
  for (int a = 0; a < 3; ++a) {
    c.x[a] = (float*)cols[a];
    c.i[a] = (int32_t*)cols[3 + a];
  }
  c.block = (int32_t*)cols[6];
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const int3 nloc = make_int3(nx, ny, nz);
    const float3 shift = make_float3(dx, dy, dz);
    auto st = (cudaStream_t)stream;
    if (expand)
      expand_kernel<<<blocks, kThreads, 0, st>>>(c, n, nrbx, nrby, nloc, shift);
    else
      collapse_kernel<<<blocks, kThreads, 0, st>>>(c, n, nrbx, nrby, nloc, shift);
  }
  return (int)cudaGetLastError();
}
