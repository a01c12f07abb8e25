// The census's per-cell table in one pass: the rows that the census kernel's
// ``gather`` reads (csrc/transport_kernel.cuh), built from the coefficient columns
// of one step as ops/transport_kernel.py::prepare receives them.
//
// Replaces no TPU kernel: it is the port of the XLA ops that the JAX package
// fuses around K1 and K3 to lay out their tables (pallas_transport.py:335-379,
// _to_global_cells and _pack_rows; pallas_grid.py:445-510, _face_pair_vectors and
// the z-slab layout of a spatial round). Its plain version is
// ops/transport_kernel.py::_pair_table, which made one elementwise pass a column
// (a copy per permuted column, a copy per face column, the stack): 2 passes on
// stepdiff_ddmc, 5 on the 64^3 ep_bremss row, 16 on the 64^3 DDMC row.
//
// One thread writes one row, so the rows are written in order (coalesced); the
// row's cell is found by index arithmetic:
//
//   * on a uniform forest of several blocks run collapsed to one block, row r
//     of a range is the cell (x, y, z) of global row-major order over the range's
//     whole z planes of blocks (x = r mod X, y = (r / X) mod Y, z = r / (X Y), X =
//     nrbx nx, Y = nrby ny), which is the cell ((((bz nrby + by) nrbx + bx) nz +
//     k) ny + j) nx + i of block cell order, with (bx, i) = divmod(x, nx) and so
//     on: the permutation of to_global_cells as a reshape and permute;
//   * otherwise (one block, or a forest run block by block) row r is cell r;
//   * the face probabilities of cell (b, k, j, i) are read straight from the face
//     arrays px [B, nz, ny, nx + 1], py [B, nz, ny + 1, nx] and pz [B, nz + 1, ny,
//     nx]: P_lower at (b, k, j, i) and P_upper one face on (_face_pairs);
//   * a spatial round's shards (up to kMaxRanges a launch; the host makes one
//     launch a group) each bring their own columns and the first row of their
//     range in the table: grid.y is the range. A range of a uniform mesh is whole
//     z planes of blocks, so its rows are its cells in the permuted order.
//
// The record (one row) by kind: the gray pair (ea / (ea + es + tiny), 1 / (ea +
// es + tiny)); gray DDMC (ea, es, Px_lo, Px_hi, Py_lo, Py_hi, Pz_lo, Pz_hi), on
// a uniform 1D mesh (ea, es, Px_lo, Px_hi, lk, cdf, c cdf, 0) with the lower
// face's leak rate lk = Px_lo f32(1 / dx) and cdf = (ea + (lk + Px_hi f32(1 /
// dx))) + tiny, what the 1D DDMC event reads instead of making it;
// non-gray (rho, T, fleck, sigma_s), with DDMC followed by the six face
// probabilities and two zeros; with ABSORB ea = fleck sigma_a and es = sigma_s +
// (1 - fleck) sigma_a, without ea = 0 and es = sigma_s. The same float
// operations in the same order as the plain version, IEEE divides, built without
// FMA contraction, so the rows are bitwise the plain version's. One kernel at
// two precisions: float32 (jb_table_launch) and, for precision = f64, float64
// (jb_table_launch_f64, its rows of doubles written as double2 pairs); the float32
// layout is unchanged.
//
// What bounds it on an H100: bytes, each coefficient read once and each row
// written once (the face arrays' one extra face a row of cells is read too).
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's table_check): the 64^3
// DDMC row's 262144 rows of 8 floats in 0.0115 ms (bound 0.0039, the plain
// version's passes 0.094), the 64^3 ep_bremss row's rows of 4 in 0.0075 (bound
// 0.0025, plain 0.032): one launch, a few microseconds of it the launch itself.
// Where the non-gray record is a verbatim copy of four coefficient columns (no
// DDMC, one range, one block or a forest run block by block) the census kernel
// reads the columns and this pass is not run: it took 0.005 of stepdiff's 0.021
// ms ep_bremss call (census_bench.py, the same card); it still builds every
// other record, and that one where asked (the tests hold it to the same rows).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanges = 16;

enum Kind : int { kPair = 0, kDdmc = 1, kNongray = 2, kNongrayDdmc = 3, kDdmc1d = 4 };

// One range's coefficient columns (Real, contiguous; null where its kind reads
// none), its cells and its first row in the table.
template <class Real>
struct Range {
  const Real* sa;
  const Real* ss;
  const Real* fl;
  const Real* rho;
  const Real* temp;
  const Real* px;
  const Real* py;
  const Real* pz;
  int cells;
  int row;
};

template <class Real>
struct Ranges {
  Range<Real> r[kMaxRanges];
};

// cells a block along x, y, z; root blocks along x and y; whether rows are in
// the collapsed block's global row-major order; Real(1 / dx) and c (kDdmc1d)
template <class Real>
struct Layout {
  int nx, ny, nz;
  int nrbx, nrby;
  int permute;
  Real inv_dx, c;
};

// the floor added before a divide: 1e-37 in float32, the smallest normal double
// in float64 (ops/transport_kernel.py, limits)
template <class Real>
constexpr Real kTiny = Real(2.2250738585072014e-308);
template <>
constexpr float kTiny<float> = 1.0e-37f;

// Row element i of 4 (or 2) reals: one float4 (float2) store in float32, two
// double2 stores (one) in float64.
__device__ __forceinline__ void store4(float* out, size_t i, float a, float b, float c,
                                       float d) {
  reinterpret_cast<float4*>(out)[i] = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(double* out, size_t i, double a, double b, double c,
                                       double d) {
  reinterpret_cast<double2*>(out)[2 * i] = make_double2(a, b);
  reinterpret_cast<double2*>(out)[2 * i + 1] = make_double2(c, d);
}

__device__ __forceinline__ void store2(float* out, size_t i, float a, float b) {
  reinterpret_cast<float2*>(out)[i] = make_float2(a, b);
}

__device__ __forceinline__ void store2(double* out, size_t i, double a, double b) {
  reinterpret_cast<double2*>(out)[i] = make_double2(a, b);
}

template <int KIND, bool ABSORB, class Real>
__global__ void __launch_bounds__(kThreads)
    table_kernel(Real* __restrict__ out, Ranges<Real> R, Layout<Real> m) {
  const Range<Real> rg = R.r[blockIdx.y];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rg.cells) return;
  int c = r;
  if (m.permute) {
    const int X = m.nrbx * m.nx, Y = m.nrby * m.ny;
    const int x = r % X, y = (r / X) % Y, z = r / (X * Y);
    const int bx = x / m.nx, by = y / m.ny, bz = z / m.nz;
    c = ((((bz * m.nrby + by) * m.nrbx + bx) * m.nz + (z - bz * m.nz)) * m.ny +
         (y - by * m.ny)) * m.nx + (x - bx * m.nx);
  }
  const size_t row = (size_t)rg.row + r;
  constexpr bool kFaces = KIND == kDdmc || KIND == kNongrayDdmc || KIND == kDdmc1d;
  Real f[6] = {Real(0), Real(0), Real(0), Real(0), Real(0), Real(0)};
  if constexpr (kFaces) {
    const int cpb = m.nx * m.ny * m.nz;
    const int b = c / cpb;
    const int l = c - b * cpb;
    const int i = l % m.nx, j = (l / m.nx) % m.ny, k = l / (m.nx * m.ny);
    const size_t ix = ((size_t)(b * m.nz + k) * m.ny + j) * (m.nx + 1) + i;
    const size_t iy = ((size_t)(b * m.nz + k) * (m.ny + 1) + j) * m.nx + i;
    const size_t iz = ((size_t)(b * (m.nz + 1) + k) * m.ny + j) * m.nx + i;
    f[0] = __ldg(rg.px + ix);
    f[1] = __ldg(rg.px + ix + 1);
    f[2] = __ldg(rg.py + iy);
    f[3] = __ldg(rg.py + iy + m.nx);
    f[4] = __ldg(rg.pz + iz);
    f[5] = __ldg(rg.pz + iz + (size_t)m.ny * m.nx);
  }
  constexpr Real tiny = kTiny<Real>;
  if constexpr (KIND == kNongray || KIND == kNongrayDdmc) {
    const size_t o = (KIND == kNongrayDdmc ? 3 : 1) * row;
    store4(out, o, __ldg(rg.rho + c), __ldg(rg.temp + c), __ldg(rg.fl + c), __ldg(rg.ss + c));
    if constexpr (KIND == kNongrayDdmc) {
      store4(out, o + 1, f[0], f[1], f[2], f[3]);
      store4(out, o + 2, f[4], f[5], Real(0), Real(0));
    }
  } else {
    const Real ss = __ldg(rg.ss + c);
    Real ea = Real(0), es = ss;
    if constexpr (ABSORB) {
      const Real sa = __ldg(rg.sa + c), fl = __ldg(rg.fl + c);
      ea = fl * sa;
      es = ss + (Real(1) - fl) * sa;
    }
    if constexpr (KIND == kDdmc) {
      store4(out, 2 * row, ea, es, f[0], f[1]);
      store4(out, 2 * row + 1, f[2], f[3], f[4], f[5]);
    } else if constexpr (KIND == kDdmc1d) {
      // what the 1D DDMC event makes from its cell alone, by its own operations
      const Real lk = f[0] * m.inv_dx;
      const Real leak_tot = lk + f[1] * m.inv_dx;
      const Real cdf = (ABSORB ? ea + leak_tot : leak_tot) + tiny;
      store4(out, 2 * row, ea, es, f[0], f[1]);
      store4(out, 2 * row + 1, lk, cdf, cdf * m.c, Real(0));
    } else {
      const Real inv = Real(1) / (ea + es + tiny);
      store2(out, row, ea * inv, inv);
    }
  }
}

template <int KIND, class Real>
void launch(bool absorb, Real* out, const Ranges<Real>& R, const Layout<Real>& m, dim3 grid,
            cudaStream_t st) {
  if (absorb)
    table_kernel<KIND, true, Real><<<grid, kThreads, 0, st>>>(out, R, m);
  else
    table_kernel<KIND, false, Real><<<grid, kThreads, 0, st>>>(out, R, m);
}

template <class Real>
int table_entry(int kind, int absorb, void* out, int n_ranges, void* const* cols,
                const int* ranges, int nx, int ny, int nz, int nrbx, int nrby, int permute,
                Real inv_dx, Real c, void* stream) {
  if (kind < kPair || kind > kDdmc1d || n_ranges < 1 || n_ranges > kMaxRanges) return -1;
  Ranges<Real> R;
  int most = 0;
  for (int k = 0; k < n_ranges; ++k) {
    const Real* const* p = reinterpret_cast<const Real* const*>(cols) + 8 * k;
    R.r[k] = Range<Real>{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], ranges[2 * k],
                         ranges[2 * k + 1]};
    most = ranges[2 * k] > most ? ranges[2 * k] : most;
  }
  const Layout<Real> m{nx, ny, nz, nrbx, nrby, permute, inv_dx, c};
  if (most > 0) {
    const dim3 grid((most + kThreads - 1) / kThreads, n_ranges);
    auto* o = (Real*)out;
    auto st = (cudaStream_t)stream;
    const bool ab = absorb != 0;
    if (kind == kPair) launch<kPair>(ab, o, R, m, grid, st);
    if (kind == kDdmc) launch<kDdmc>(ab, o, R, m, grid, st);
    if (kind == kNongray) launch<kNongray>(ab, o, R, m, grid, st);
    if (kind == kNongrayDdmc) launch<kNongrayDdmc>(ab, o, R, m, grid, st);
    if (kind == kDdmc1d) launch<kDdmc1d>(ab, o, R, m, grid, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out: the table, rows of 2 (kind 0: the gray pair), 8 (1: gray DDMC; 4: gray
// DDMC on a uniform 1D mesh), 4 (2: non-gray) or 12 (3: non-gray DDMC) floats,
// 16-byte aligned. cols: n_ranges x 8
// device pointers sa ss fleck rho temp px py pz (null where the kind reads none);
// ranges: n_ranges x (cells, first row) (host arrays). nx ny nz: cells a block;
// nrbx nrby: root blocks along x and y; permute: rows in the collapsed block's
// global row-major order; inv_dx, c: f32(1 / dx) and c of kind 4. Returns
// cudaGetLastError() after the launch, -1 for an unknown kind or a range count the
// kernel does not take.
extern "C" int jb_table_launch(int kind, int absorb, void* out, int n_ranges,
                               void* const* cols, const int* ranges, int nx, int ny, int nz,
                               int nrbx, int nrby, int permute, float inv_dx, float c,
                               void* stream) {
  return table_entry<float>(kind, absorb, out, n_ranges, cols, ranges, nx, ny, nz, nrbx, nrby,
                            permute, inv_dx, c, stream);
}

// jb_table_launch in float64 (precision = f64): rows of doubles, columns of doubles,
// inv_dx and c as doubles.
extern "C" int jb_table_launch_f64(int kind, int absorb, void* out, int n_ranges,
                                   void* const* cols, const int* ranges, int nx, int ny,
                                   int nz, int nrbx, int nrby, int permute, double inv_dx,
                                   double c, void* stream) {
  return table_entry<double>(kind, absorb, out, n_ranges, cols, ranges, nx, ny, nz, nrbx,
                             nrby, permute, inv_dx, c, stream);
}
