// The radiation-energy tally and the absorption deposit in fixed point: every
// local shard's slots summed into per-cell bins in one pass of three launches,
// bitwise the plain version whatever order the atomics land in.
//
// Replaces no TPU kernel: it is the port of what XLA makes of the JAX package's
// segment sums (jaybenne_tpu/ops/tally.py:34-67, segment_sum) behind
// evaluate_radiation_energy and accumulate_absorption. What it computes is the
// port's deterministic_segment_sum (ops/tally.py): a slot's contribution, in
// the run's precision, is weight / block_volume[block] where the slot is alive
// (the tally) and weight where it was absorbed this step (the deposit), each
// only where its block is the shard's own under the spatial decomposition; the
// contribution is widened to double, and its bin's scale is 2^(bits - emax),
// emax the largest frexp exponent of the bin's contributions and bits = 62 -
// ceil(log2 n), n the slots summed (every slot of the ledger, dead ones too, so
// that the bits stay those of the plain version). Each contribution rounded to
// an integer at that scale (half to even) is added to the bin's int64 sum, and
// the bin's value is that sum over the scale. Integer addition is associative,
// so every order of the atomics gives the same bits. Its plain version is
// ops/tally.py::deterministic_segment_sum and sharded_segment_sum, with the
// terms _tally_terms and _deposit_terms.
//
// The slots are the local shards' adjacent slices of one ledger, m slices of
// cap_l slots. Under the particle decomposition every slice goes into one set
// of global bins (the sum over shards, taken here in the integer domain as
// sharded_segment_sum takes it); under the spatial decomposition slice g goes
// into its own shard's bins, its cells at block offset off0 + g bl. Up to two
// bin arrays, the tally's and the deposit's, are filled from one read of each
// slot. The launches:
//   1. tally_exponent_kernel: a thread a slot; a nonzero contribution's frexp
//      exponent goes to its bin by an int32 atomicMax (a dead slot costs one
//      read of its flags);
//   2. tally_sum_kernel: the contribution again, times its bin's scale, rounded
//      by __double2ll_rn (as torch.round, then an exact conversion), added to
//      its bin by a 64-bit integer atomicAdd;
//   3. tally_cell_kernel: a thread a bin: the sum over the scale, cast to the
//      field's precision, written into every output shard that reads the bin
//      (the tally replaces energy_tally; the deposit is added to energy_delta
//      in its precision), and the bin's scratch reset (exponent to kNoExp, sum
//      to 0) for the next call, so a captured step queues no memset.
// Where the bins fit in shared memory (few cells: stepdiff's 128), each block of
// the slot passes keeps its own bins, over a grid of a few blocks a SM, and adds
// them once to the global bins; the 64^3 meshes (one slot a cell or so) send
// their atomics to global memory. Between launches 1 and 2, and 2 and 3, a
// process group reduces the exponents (max) and the sums (sum) over its ranks,
// as sharded_segment_sum does; the C entry runs the stages it is asked for.
//
// Bounds on the card: the bytes, each slot's flags read once and a live slot's
// weight, block and cell indices (twice, once a slot pass, the second in L2),
// each bin's exponent and sum read and written, each output written and a
// deposit's energy_delta read. Nothing waits for the device and every shape is
// static: a CUDA graph captures the three launches. Measured (NVIDIA H100 80GB
// HBM3, 700.00 W; chip_smoke.py phase 46, device ms from torch.profiler): the 64^3
// DDMC row's tally 0.0146 ms (exponents 0.0052, sums 0.0054, cells 0.0039; its
// bound 0.0017) where the plain version's scatter_reduce and index_add_ took
// 0.91; the 64^3 feedback row's deposit and tally 0.0221 (plain 1.83); stepdiff's
// 128 shared bins 0.0110 (plain 0.154). Each launch is a few microseconds, most of
// it the launch and the grid's tail.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kNoExp = -1100;      // the exponent of no contribution (ops/tally.py _NO_EXP)
constexpr int kSharedWords = 6144;  // bins (of all kinds) a block keeps in shared memory
constexpr int kMaxParts = 32;       // output shards a cell launch writes

struct Slots {
  const void* weight;  // T, n
  const int32_t* block;
  const int32_t* k;
  const int32_t* j;
  const int32_t* i;
  const uint8_t* alive;
  const uint8_t* absorbed;  // or null: no deposit
  const void* volume;       // T, the cell volume of each block
  long long n;              // m cap_l slots
  long long cap_l;
  int n_blocks, nx, ny, nz;
  int spatial, off0, bl;  // spatial: slice g's blocks [off0 + g bl, off0 + (g + 1) bl)
  long long bins;         // bins of one kind
  int bits;
};

struct Bins {
  int32_t* emax;           // kinds x bins: the tally's, then the deposit's
  unsigned long long* acc;  // kinds x bins
};

struct Term {
  double tally, deposit;
  long long bin;
};

// Slot s's contributions and bin (0.0 where it gives none).
template <typename T>
__device__ __forceinline__ Term term_of(const Slots& S, long long s) {
  Term t{0.0, 0.0, 0};
  const bool live = S.alive[s] != 0;
  const bool absorbed = S.absorbed != nullptr && S.absorbed[s] != 0;
  if (!live && !absorbed) return t;
  const int b = S.block[s];
  long long base = 0;
  int bl = b;
  if (S.spatial) {
    const int g = (int)(s / S.cap_l);
    bl = b - (S.off0 + g * S.bl);
    if (bl < 0 || bl >= S.bl) return t;  // another shard's block: not owned
    base = (long long)g * S.bl;
  }
  t.bin = (((base + bl) * S.nz + S.k[s]) * S.ny + S.j[s]) * (long long)S.nx + S.i[s];
  const T w = static_cast<const T*>(S.weight)[s];
  if (live) {
    const int bv = min(max(b, 0), S.n_blocks - 1);
    t.tally = (double)(w / static_cast<const T*>(S.volume)[bv]);
  }
  if (absorbed) t.deposit = (double)w;
  return t;
}

__device__ __forceinline__ int exponent_of(double v) {
  int e;
  frexp(v, &e);
  return e;
}

// 2^(bits - emax), built from its bit pattern (ops/tally.py _scales).
__device__ __forceinline__ double scale_of(int emax, int bits) {
  const long long shift = min(max((long long)bits - emax, -1000LL), 1000LL);
  return __longlong_as_double((shift + 1023) << 52);
}

// 1. Each bin's largest exponent.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads) tally_exponent_kernel(Slots S, Bins B, int kinds) {
  extern __shared__ int32_t sh_exp[];
  if (kShared) {
    for (long long q = threadIdx.x; q < kinds * S.bins; q += kThreads) sh_exp[q] = kNoExp;
    __syncthreads();
  }
  int32_t* dst = kShared ? sh_exp : B.emax;
  for (long long s = blockIdx.x * (long long)kThreads + threadIdx.x; s < S.n;
       s += (long long)gridDim.x * kThreads) {
    const Term t = term_of<T>(S, s);
    if (t.tally != 0.0) atomicMax(dst + t.bin, exponent_of(t.tally));
    if (t.deposit != 0.0) atomicMax(dst + S.bins + t.bin, exponent_of(t.deposit));
  }
  if (kShared) {
    __syncthreads();
    for (long long q = threadIdx.x; q < kinds * S.bins; q += kThreads)
      if (sh_exp[q] != kNoExp) atomicMax(B.emax + q, sh_exp[q]);
  }
}

__device__ __forceinline__ unsigned long long fixed_of(double v, int emax, int bits) {
  return (unsigned long long)__double2ll_rn(v * scale_of(emax, bits));
}

// 2. Each bin's int64 sum of its contributions quantised at its scale.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads) tally_sum_kernel(Slots S, Bins B, int kinds) {
  extern __shared__ unsigned long long sh_acc[];
  if (kShared) {
    for (long long q = threadIdx.x; q < kinds * S.bins; q += kThreads) sh_acc[q] = 0ULL;
    __syncthreads();
  }
  unsigned long long* dst = kShared ? sh_acc : B.acc;
  for (long long s = blockIdx.x * (long long)kThreads + threadIdx.x; s < S.n;
       s += (long long)gridDim.x * kThreads) {
    const Term t = term_of<T>(S, s);
    if (t.tally != 0.0) atomicAdd(dst + t.bin, fixed_of(t.tally, B.emax[t.bin], S.bits));
    if (t.deposit != 0.0) {
      const long long q = S.bins + t.bin;
      atomicAdd(dst + q, fixed_of(t.deposit, B.emax[q], S.bits));
    }
  }
  if (kShared) {
    __syncthreads();
    for (long long q = threadIdx.x; q < kinds * S.bins; q += kThreads)
      if (sh_acc[q] != 0ULL) atomicAdd(B.acc + q, sh_acc[q]);
  }
}

struct Outputs {
  void* tally[kMaxParts];           // T
  const void* delta_in[kMaxParts];  // T, or null: no deposit
  void* delta[kMaxParts];
  int parts;      // output shards of this launch
  int spatial;    // 1: part p reads the bins of its own cells; 0: every part every bin
  long long cells;  // cells a part
  long long first;  // spatial: the first bin of this launch's first part
  int reset;        // reset the bins' scratch after reading them
};

// 3. Each bin's value into every output that reads it; its scratch reset.
template <typename T>
__global__ void __launch_bounds__(kThreads) tally_cell_kernel(Bins B, Outputs O, long long bins,
                                                              int kinds, int bits) {
  const long long q = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long span = O.spatial ? O.parts * O.cells : bins;
  if (q >= span) return;
  const long long bin = O.spatial ? O.first + q : q;
  double tally = 0.0, deposit = 0.0;
  for (int kind = 0; kind < kinds; ++kind) {
    const long long w = kind * bins + bin;
    const double sum = (double)(long long)B.acc[w] / scale_of(B.emax[w], bits);
    if (kind == 0) tally = sum;
    else deposit = sum;
    if (O.reset) {
      B.emax[w] = kNoExp;
      B.acc[w] = 0ULL;
    }
  }
  const int p0 = O.spatial ? (int)(q / O.cells) : 0;
  const int p1 = O.spatial ? p0 + 1 : O.parts;
  const long long c = O.spatial ? q - p0 * O.cells : q;
  for (int p = p0; p < p1; ++p) {
    static_cast<T*>(O.tally[p])[c] = (T)tally;
    if (O.delta[p] != nullptr)
      static_cast<T*>(O.delta[p])[c] = static_cast<const T*>(O.delta_in[p])[c] + (T)deposit;
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <typename T>
int launch(int stages, const Slots& S, const Bins& B, int kinds, int parts, void* const* tally,
           const void* const* delta_in, void* const* delta, cudaStream_t st) {
  const long long words = kinds * S.bins;
  const bool shared = words <= kSharedWords;
  const long long slot_blocks = (S.n + kThreads - 1) / kThreads;
  if (stages & 3) {
    if (S.n > 0) {
      const unsigned grid =
          (unsigned)(shared ? std::min(slot_blocks, 2LL * sm_count()) : slot_blocks);
      if (stages & 1) {
        if (shared)
          tally_exponent_kernel<T, true><<<grid, kThreads, words * sizeof(int32_t), st>>>(
              S, B, kinds);
        else
          tally_exponent_kernel<T, false><<<grid, kThreads, 0, st>>>(S, B, kinds);
      }
      if (stages & 2) {
        if (shared)
          tally_sum_kernel<T, true><<<grid, kThreads, words * sizeof(unsigned long long), st>>>(
              S, B, kinds);
        else
          tally_sum_kernel<T, false><<<grid, kThreads, 0, st>>>(S, B, kinds);
      }
    }
  }
  if (stages & 4) {
    const long long cells = S.spatial ? S.bins / parts : S.bins;
    for (int p0 = 0; p0 < parts; p0 += kMaxParts) {
      Outputs O;
      O.parts = std::min(kMaxParts, parts - p0);
      O.spatial = S.spatial;
      O.cells = cells;
      O.first = S.spatial ? p0 * cells : 0;
      O.reset = S.spatial || p0 + O.parts == parts;
      for (int p = 0; p < kMaxParts; ++p) {
        const bool on = p < O.parts;
        O.tally[p] = on ? tally[p0 + p] : nullptr;
        O.delta_in[p] = on && delta_in != nullptr ? delta_in[p0 + p] : nullptr;
        O.delta[p] = on && delta != nullptr ? delta[p0 + p] : nullptr;
      }
      const long long span = O.spatial ? O.parts * cells : S.bins;
      const unsigned grid = (unsigned)((span + kThreads - 1) / kThreads);
      if (grid > 0) tally_cell_kernel<T><<<grid, kThreads, 0, st>>>(B, O, S.bins, kinds, S.bits);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// stages: a mask of the launches to run (1 exponents, 2 sums, 4 cells; 7 all
// three, with no process group between them). double_: 1 where the ledger's
// reals and the fields are float64, else float32. weight block k j i: the joined
// ledger's columns (device); alive, absorbed (or null: no deposit): its bool
// flags; volume: the cell volume of each of n_blocks blocks
// (the ledger's precision). n slots, cap_l a slice. spatial, off0, bl: slice g
// tallies its own blocks [off0 + g bl, off0 + (g + 1) bl) into bins g bl cells
// on; else every slice into one set of global bins. nx ny nz: cells of a block.
// bins: the bins of one kind; bits: the scale's bits (62 - ceil(log2 n), n the
// slots one sum takes). emax: kinds x bins int32, acc: kinds x bins int64
// (device; kNoExp and 0 before the first call, and left so by the cell launch).
// parts: the output shards; tally, delta_in, delta: host arrays of parts device
// pointers (delta_in and delta null without the deposit). stream: the CUDA stream.
// Returns cudaGetLastError() after the launches, -1 for arguments it does not
// take.
extern "C" int jb_tally_launch(int stages, int double_, const void* weight, const void* block,
                               const void* k, const void* j, const void* i, const void* alive,
                               const void* absorbed, const void* volume, int n_blocks,
                               long long n, long long cap_l, int spatial, int off0, int bl,
                               int nx, int ny, int nz, long long bins, int bits, void* emax,
                               void* acc, int parts, void* const* tally,
                               const void* const* delta_in, void* const* delta, void* stream) {
  const int kinds = absorbed != nullptr ? 2 : 1;
  if (alive == nullptr || tally == nullptr || parts < 1 || n < 0 || cap_l < 1 || n % cap_l != 0 || n_blocks < 1 ||
      bins < 1 || (spatial && (bl < 1 || bins % parts != 0 || n / cap_l != parts)) ||
      (delta != nullptr) != (absorbed != nullptr) ||
      (delta_in != nullptr) != (delta != nullptr))
    return -1;
  Slots S;
  S.weight = weight;
  S.block = (const int32_t*)block;
  S.k = (const int32_t*)k;
  S.j = (const int32_t*)j;
  S.i = (const int32_t*)i;
  S.alive = (const uint8_t*)alive;
  S.absorbed = (const uint8_t*)absorbed;
  S.volume = volume;
  S.n = n;
  S.cap_l = cap_l;
  S.n_blocks = n_blocks;
  S.nx = nx;
  S.ny = ny;
  S.nz = nz;
  S.spatial = spatial;
  S.off0 = off0;
  S.bl = bl;
  S.bins = bins;
  S.bits = bits;
  Bins B{(int32_t*)emax, (unsigned long long*)acc};
  auto st = (cudaStream_t)stream;
  return double_ ? launch<double>(stages, S, B, kinds, parts, tally, delta_in, delta, st)
                 : launch<float>(stages, S, B, kinds, parts, tally, delta_in, delta, st);
}
