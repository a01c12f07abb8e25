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
// Where a row's cell is: a range's rows are the cells (x, y, z) of global row-major
// order over its whole z planes (x fastest; X = nrbx nx cells a line, Y = nrby ny
// lines a plane), the cell ((((bz nrby + by) nrbx + bx) nz + k) ny + j) nx + i of
// block cell order with (bx, i) = divmod(x, nx), (by, j) = divmod(y, ny) and (bz,
// k) = divmod(z, nz): the permutation of to_global_cells as a reshape and
// permute. One block, or a forest run block by block, is the same layout with
// nrbx = nrby = 1 (row r is cell r). The face probabilities of cell (b, k, j, i)
// are read straight from the face arrays px [B, nz, ny, nx + 1], py [B, nz, ny +
// 1, nx] and pz [B, nz + 1, ny, nx]: P_lower at (b, k, j, i) and P_upper one face
// on (_face_pairs). A spatial round's shards (up to kMaxRanges a launch; the host
// makes one launch a group) each bring their own columns and the first row of
// their range in the table: grid.y is the range.
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
// (jb_table_launch_f64).
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700.00 W): bytes on the large
// tables, each coefficient read once and each row written once (the face arrays'
// one extra face a row of cells is read too), and the launch on the small ones
// (128 rows: 0.0012-0.0017 ms on the device, 0.0049 ms of an event window around
// an empty launch). The one-row-a-thread kernel that this design replaced ran the
// 64^3 DDMC table in 0.00730 ms on the device, 0.53 of its bytes bound: ten runtime
// integer divisions a row before any load, each thread's loads behind them, and
// each row's two 16-byte stores writing half of each sector a warp instruction
// touches. The design:
//   (a) no runtime division on a row's path: the host's plan
//       (ops/transport_kernel.py::table_plan) gives every divisor (a line's runs,
//       Y, nx, ny, nz) as a multiply-high and a shift (quo), and the face indices
//       come from the same (b, k, j, i) as the cell;
//   (b) several rows a thread: where a row is at most 16 bytes (the gray pair;
//       the float32 non-gray record) a thread takes a run of RUN = 4 cells of one
//       block's x line (nx % 4 == 0 and every column 16-byte aligned), every load
//       of them issued before the first store, each column's four as one 16-byte
//       word; a wider row is made one a thread (the same kernel, a run of 1: the
//       plan decides, and the kernel takes either run for any record);
//   (c) coalesced row stores: a block's rows are staged in shared memory (16-byte
//       words, their slots swizzled so that neither phase conflicts on a bank)
//       and stored as contiguous words, a warp instruction writing 512
//       contiguous bytes;
//   (d) the table's launch zeroes the census's counters (the events and iteration
//       maxima the census adds to), so that a census call that launches a table
//       queues no memset between the two.
// Measured (census_bench.py --only census_table, in turns against that kernel;
// torch.profiler's kernel durations, medians of 28): the 64^3 DDMC table 0.00730
// -> 0.00432 ms on the device (0.90 of its bound; rows of one), the 64^3 ep_bremss
// table 0.00360 -> 0.00274 (0.92), the 8-shard big_mesh_spatial table 0.00338 ->
// 0.00210 (0.45); no runtime division left in any instantiation; the counters'
// memset (0.0022 ms of a call's event window) gone. Candidates in one turn:
// without (c) the 64^3 DDMC table's window took 0.0148 ms against 0.0089; runs of
// four on rows of 32 bytes took 0.00456 ms on the device against 0.00429 at one a
// thread, on rows of 16 and 8 bytes 0.00277 and 0.00208 against 0.00298 and
// 0.00288, hence the bound of 16 bytes in (b). Built and dropped: the census launched as the table's
// programmatic dependent (griddepcontrol, cudaLaunchKernelEx), bitwise and
// capturable, but its calls moved by -0.0028 to +0.0040 ms, not consistently
// shorter (PERF.md section 6).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRanges = 16;

enum Kind : int { kPair = 0, kDdmc = 1, kNongray = 2, kNongrayDdmc = 3, kDdmc1d = 4 };

// the reals a row of each kind holds
__host__ __device__ constexpr int width(int kind) {
  return kind == kPair ? 2 : kind == kNongray ? 4 : kind == kNongrayDdmc ? 12 : 8;
}

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

// n / d for 0 <= n < 2^31 as umulhi(n, mul) >> shift, mul 0 where d is 1 (the
// host's table_plan makes them)
struct Div {
  unsigned d, mul, shift;
};

__device__ __forceinline__ unsigned quo(unsigned n, const Div& v) {
  return (v.mul ? __umulhi(n, v.mul) : n) >> v.shift;
}

// the launch's plan: the divisors of a line's runs (X / RUN), of Y, nx, ny and
// nz; root blocks along x and y (1 and 1 where rows are in block cell order);
// Real(1 / dx) and c (kDdmc1d); the counters to zero (zero_words 64-bit words,
// by the block (0, 0)), or null
template <class Real>
struct Plan {
  Div runs, lines, nx, ny, nz;
  int nrbx, nrby;
  Real inv_dx, c;
  unsigned long long* zero;
  int zero_words;
};

// the floor added before a divide: 1e-37 in float32, the smallest normal double
// in float64 (ops/transport_kernel.py, limits)
template <class Real>
constexpr Real kTiny = Real(2.2250738585072014e-308);
template <>
constexpr float kTiny<float> = 1.0e-37f;

// RUN consecutive reals at p into v: 16-byte words where RUN is 4 (p then 16-byte
// aligned), else scalars
template <int RUN>
__device__ __forceinline__ void load(float* v, const float* p) {
  if constexpr (RUN == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < RUN; ++k) v[k] = __ldg(p + k);
  }
}

template <int RUN>
__device__ __forceinline__ void load(double* v, const double* p) {
  if constexpr (RUN % 2 == 0) {
#pragma unroll
    for (int k = 0; k < RUN; k += 2) {
      const double2 q = __ldg(reinterpret_cast<const double2*>(p + k));
      v[k] = q.x;
      v[k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < RUN; ++k) v[k] = __ldg(p + k);
  }
}

// The staging word of a thread's rows (RUN x W reals of BYTES bytes): 16 bytes
// where they fill whole ones, else 8 (a float32 pair alone)
template <class Real, int BYTES>
using Word = typename std::conditional<
    std::is_same<Real, double>::value, double2,
    typename std::conditional<BYTES % 16 == 0, float4, float2>::type>::type;

__device__ __forceinline__ float4 word(const float* r, float4*) {
  return make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ float2 word(const float* r, float2*) { return make_float2(r[0], r[1]); }
__device__ __forceinline__ double2 word(const double* r, double2*) {
  return make_double2(r[0], r[1]);
}

// The staging slot of word w of a block's rows, K words a thread: the low three
// bits of w XOR the thread's, so that the eight threads of a 16-byte phase write
// eight banks' words and the copy-out reads them so too (a permutation of each
// aligned group of eight words where K is 2, 4 or a multiple of 8; other K keep w)
template <int K>
__device__ __forceinline__ int slot(int w) {
  if constexpr (K == 2 || K == 4 || K % 8 == 0)
    return w ^ ((w / K) & 7);
  else
    return w;
}

template <int KIND, bool ABSORB, int RUN, class Real>
__global__ void __launch_bounds__(kThreads)
    table_kernel(Real* __restrict__ out, Ranges<Real> R, Plan<Real> m) {
  constexpr int W = width(KIND);
  constexpr int kBytes = RUN * W * (int)sizeof(Real);
  using Wd = Word<Real, kBytes>;
  constexpr int K = kBytes / (int)sizeof(Wd);
  constexpr int E = (int)(sizeof(Wd) / sizeof(Real));  // reals a word
  __shared__ Wd stage[kThreads * K];

  if (m.zero != nullptr && blockIdx.x == 0 && blockIdx.y == 0)
    for (int w = threadIdx.x; w < m.zero_words; w += kThreads) m.zero[w] = 0ull;
  const Range<Real> rg = R.r[blockIdx.y];
  const int first = blockIdx.x * kThreads * RUN;  // the block's first row of its range
  if (first >= rg.cells) return;
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;  // the thread's run
  if ((int)(t * RUN) < rg.cells) {
    // (x, y, z) of the run's first cell, then its block and cell in the block
    const unsigned line = quo(t, m.runs);
    const unsigned x = (t - line * m.runs.d) * RUN;
    const unsigned z = quo(line, m.lines);
    const unsigned y = line - z * m.lines.d;
    const unsigned bx = quo(x, m.nx), by = quo(y, m.ny), bz = quo(z, m.nz);
    const unsigned nx = m.nx.d, ny = m.ny.d, nz = m.nz.d;
    const unsigned i = x - bx * nx, j = y - by * ny, k = z - bz * nz;
    const size_t b = ((size_t)bz * m.nrby + by) * m.nrbx + bx;
    const size_t c = ((b * nz + k) * ny + j) * nx + i;

    // every load of the run before any row is made
    constexpr bool kFaces = KIND == kDdmc || KIND == kNongrayDdmc || KIND == kDdmc1d;
    constexpr bool kNg = KIND == kNongray || KIND == kNongrayDdmc;
    Real ss[RUN], sa[RUN], fl[RUN], rho[RUN], temp[RUN];
    Real fx[RUN + 1], ylo[RUN], yhi[RUN], zlo[RUN], zhi[RUN];
    load<RUN>(ss, rg.ss + c);
    if constexpr (kNg) {
      load<RUN>(rho, rg.rho + c);
      load<RUN>(temp, rg.temp + c);
      load<RUN>(fl, rg.fl + c);
    } else if constexpr (ABSORB) {
      load<RUN>(sa, rg.sa + c);
      load<RUN>(fl, rg.fl + c);
    }
    if constexpr (kFaces) {
      const size_t ix = ((b * nz + k) * ny + j) * (nx + 1) + i;
      const size_t iy = ((b * nz + k) * (ny + 1) + j) * nx + i;
      const size_t iz = ((b * (nz + 1) + k) * ny + j) * nx + i;
#pragma unroll
      for (int v = 0; v <= RUN; ++v) fx[v] = __ldg(rg.px + ix + v);
      load<RUN>(ylo, rg.py + iy);
      load<RUN>(yhi, rg.py + iy + nx);
      load<RUN>(zlo, rg.pz + iz);
      load<RUN>(zhi, rg.pz + iz + (size_t)ny * nx);
    }

    constexpr Real tiny = kTiny<Real>;
    Real row[RUN * W];
#pragma unroll
    for (int v = 0; v < RUN; ++v) {
      Real* o = row + v * W;
      if constexpr (kNg) {
        o[0] = rho[v];
        o[1] = temp[v];
        o[2] = fl[v];
        o[3] = ss[v];
        if constexpr (KIND == kNongrayDdmc) {
          o[4] = fx[v];
          o[5] = fx[v + 1];
          o[6] = ylo[v];
          o[7] = yhi[v];
          o[8] = zlo[v];
          o[9] = zhi[v];
          o[10] = Real(0);
          o[11] = Real(0);
        }
      } else {
        Real ea = Real(0), es = ss[v];
        if constexpr (ABSORB) {
          ea = fl[v] * sa[v];
          es = ss[v] + (Real(1) - fl[v]) * sa[v];
        }
        if constexpr (KIND == kPair) {
          const Real inv = Real(1) / (ea + es + tiny);
          o[0] = ea * inv;
          o[1] = inv;
        } else {
          o[0] = ea;
          o[1] = es;
          o[2] = fx[v];
          o[3] = fx[v + 1];
          if constexpr (KIND == kDdmc) {
            o[4] = ylo[v];
            o[5] = yhi[v];
            o[6] = zlo[v];
            o[7] = zhi[v];
          } else {
            // what the 1D DDMC event makes from its cell alone, by its own operations
            const Real lk = fx[v] * m.inv_dx;
            const Real leak_tot = lk + fx[v + 1] * m.inv_dx;
            const Real cdf = (ABSORB ? ea + leak_tot : leak_tot) + tiny;
            o[4] = lk;
            o[5] = cdf;
            o[6] = cdf * m.c;
            o[7] = Real(0);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q)
      stage[slot<K>(threadIdx.x * K + q)] = word(row + q * E, (Wd*)nullptr);
  }
  __syncthreads();
  // the block's rows, contiguous in the table, as contiguous words
  const int rows = min(kThreads * RUN, rg.cells - first);
  const int words = rows * W / E;
  Wd* dst = reinterpret_cast<Wd*>(out + ((size_t)rg.row + first) * W);
  for (int w = threadIdx.x; w < words; w += kThreads) dst[w] = stage[slot<K>(w)];
}

template <int KIND, bool ABSORB, class Real>
void launch(int run, Real* out, const Ranges<Real>& R, const Plan<Real>& m, dim3 grid,
            cudaStream_t st) {
  if (run == 4)
    table_kernel<KIND, ABSORB, 4, Real><<<grid, kThreads, 0, st>>>(out, R, m);
  else
    table_kernel<KIND, ABSORB, 1, Real><<<grid, kThreads, 0, st>>>(out, R, m);
}

template <int KIND, class Real>
void launch(bool absorb, int run, Real* out, const Ranges<Real>& R, const Plan<Real>& m,
            dim3 grid, cudaStream_t st) {
  if (absorb)
    launch<KIND, true, Real>(run, out, R, m, grid, st);
  else
    launch<KIND, false, Real>(run, out, R, m, grid, st);
}

template <class Real>
int table_entry(int kind, int absorb, int run, void* out, int n_ranges, void* const* cols,
                const int* ranges, const unsigned* divisors, int nrbx, int nrby, int blocks,
                Real inv_dx, Real c, void* zero, int zero_words, void* stream) {
  if (kind < kPair || kind > kDdmc1d || n_ranges < 1 || n_ranges > kMaxRanges ||
      (run != 1 && run != 4) || blocks < 1 || zero_words < 0)
    return -1;
  Ranges<Real> R;
  for (int k = 0; k < n_ranges; ++k) {
    const Real* const* p = reinterpret_cast<const Real* const*>(cols) + 8 * k;
    R.r[k] = Range<Real>{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], ranges[2 * k],
                         ranges[2 * k + 1]};
    if (ranges[2 * k] % run != 0 || ranges[2 * k + 1] % run != 0) return -1;
  }
  Div d[5];
  for (int k = 0; k < 5; ++k) d[k] = Div{divisors[3 * k], divisors[3 * k + 1], divisors[3 * k + 2]};
  const Plan<Real> m{d[0], d[1], d[2], d[3], d[4], nrbx, nrby, inv_dx, c,
                     (unsigned long long*)zero, zero != nullptr ? zero_words : 0};
  const dim3 grid(blocks, n_ranges);
  auto* o = (Real*)out;
  auto st = (cudaStream_t)stream;
  const bool ab = absorb != 0;
  if (kind == kPair) launch<kPair>(ab, run, o, R, m, grid, st);
  if (kind == kDdmc) launch<kDdmc>(ab, run, o, R, m, grid, st);
  if (kind == kNongray) launch<kNongray>(ab, run, o, R, m, grid, st);
  if (kind == kNongrayDdmc) launch<kNongrayDdmc>(ab, run, o, R, m, grid, st);
  if (kind == kDdmc1d) launch<kDdmc1d>(ab, run, o, R, m, grid, st);
  return (int)cudaGetLastError();
}

}  // namespace

// out: the table, rows of 2 (kind 0: the gray pair), 8 (1: gray DDMC; 4: gray
// DDMC on a uniform 1D mesh), 4 (2: non-gray) or 12 (3: non-gray DDMC) floats,
// 16-byte aligned. run: the cells a thread takes (4 or 1, table_plan). cols:
// n_ranges x 8 device pointers sa ss fleck rho temp px py pz (null where the kind
// reads none; 16-byte aligned where run is 4); ranges: n_ranges x (cells, first
// row), each a multiple of run (host arrays). divisors: 5 x (d, mul, shift) of a
// line's runs, Y, nx, ny, nz (host array); nrbx nrby: root blocks along x and y,
// 1 and 1 where rows are in block cell order; blocks: grid.x, of 128 threads;
// inv_dx, c: f32(1 / dx) and c of kind 4; zero: zero_words 64-bit words that the
// launch zeroes (the census's counters), or null. Returns cudaGetLastError() after
// the launch, -1 for an unknown kind or a plan the kernel does not take.
extern "C" int jb_table_launch(int kind, int absorb, int run, void* out, int n_ranges,
                               void* const* cols, const int* ranges, const unsigned* divisors,
                               int nrbx, int nrby, int blocks, float inv_dx, float c,
                               void* zero, int zero_words, void* stream) {
  return table_entry<float>(kind, absorb, run, out, n_ranges, cols, ranges, divisors, nrbx,
                            nrby, blocks, inv_dx, c, zero, zero_words, stream);
}

// jb_table_launch in float64 (precision = f64): rows of doubles, columns of doubles,
// inv_dx and c as doubles.
extern "C" int jb_table_launch_f64(int kind, int absorb, int run, void* out, int n_ranges,
                                   void* const* cols, const int* ranges,
                                   const unsigned* divisors, int nrbx, int nrby, int blocks,
                                   double inv_dx, double c, void* zero, int zero_words,
                                   void* stream) {
  return table_entry<double>(kind, absorb, run, out, n_ranges, cols, ranges, divisors, nrbx,
                             nrby, blocks, inv_dx, c, zero, zero_words, stream);
}
