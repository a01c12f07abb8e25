// The step's and the spatial round's counts: each local shard's live particles
// and those alive short of census (tau < 1), over every local shard's adjacent
// slice of one ledger in one launch, and in a spatial round the round's
// counters folded in, so that a round's bookkeeping is this one launch.
//
// Replaces no TPU kernel: it is the port of what XLA makes of the JAX package's
// sums and carry adds around its census kernels: jaybenne_tpu/parallel/
// spatial.py:480-488 (local_unfinished = sum(alive & tau < 1), the psum's local
// term, and the round loop's carry: rounds + 1, iters_acc + iters, ev_acc + ev,
// drop_acc + dropped, sent_acc + n_sent), jaybenne_tpu/step.py:280 and :317 (the
// step's unfinished and num_alive) and jaybenne_tpu/particles.py:78-79
// (num_alive). Its plain version is ops/counts.py's counts_plain and
// round_counts_plain.
//
// One launch of m x tiles blocks, block b reading tile b % tiles of local shard
// b / tiles: kTile consecutive slots of the shard's slice, kPerThread a thread,
// each slot's alive flag and tau read once (tau compared with 1 at the ledger's
// precision). A block sums its counts by warp reductions and adds them to its
// shard's two int64 sums in the scratch with integer atomics, so every order of
// the blocks gives the same bits; then it takes a ticket. The block that takes
// the last ticket reads the sums, writes each shard's counts and their totals
// (the live count's sum and max, the unfinished count's sum), folds in the
// round's counters (the census's iterations and events, the cap hits, the
// migration's dropped and sent, the round, gated by the round's go flag), and
// resets the scratch and the ticket to 0 for the next launch, so a captured step
// queues no memset. The scratch is zeroed once when it is made (ops/counts.py),
// outside any capture.
//
// Bounds on the card: the bytes, each slot's flag and tau read once (5 bytes a
// slot in float32, 9 in float64). At the 8-shard spatial steps that is some 3
// MB, about a microsecond at the memory rate, so the launch itself bounds it.
// Nothing waits for the device and every shape is static: a CUDA graph captures
// it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // slots a block
constexpr int kWarps = kThreads / 32;

struct Outputs {
  long long* per;     // 2 m: the shards' live counts, then their unfinished counts; or null
  long long* totals;  // 3: the live counts' sum and max, the unfinished counts' sum; or null
};

// A spatial round's counters (all null outside one): what the round's census and
// migration made, and the step's accumulators they are added to.
struct Round {
  const uint8_t* go;      // the round's flag, or null: the round has work
  const int32_t* it;      // m: the census's iteration maxima
  const long long* ev;    // m: its events
  const long long* drop;  // m: the migration's dropped, or null (nothing migrates)
  const long long* sent;  // m: its sent, or null
  int max_iters;
  int32_t* iters;         // m: += it
  long long* events;      // m: += ev
  long long* hits;        // m: += go && it >= max_iters
  long long* dropped;     // m: += drop
  long long* sent_acc;    // m: += sent
  long long* rounds;      // 1: += go
  long long* unfinished;  // 1: = the unfinished counts' sum
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    round_counts_kernel(const uint8_t* __restrict__ alive, const T* __restrict__ tau,
                        long long cap_l, int tiles, int m, unsigned long long* scratch,
                        Outputs O, Round R) {
  __shared__ unsigned s_live[kWarps], s_short[kWarps];
  __shared__ long long s_sum[kWarps], s_max[kWarps], s_unf[kWarps];
  __shared__ bool s_last;
  const int shard = blockIdx.x / tiles;
  const long long lo = (long long)shard * cap_l;
  const long long base = (long long)(blockIdx.x % tiles) * kTile + threadIdx.x;
  unsigned live = 0, short_of = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long q = base + k * kThreads;
    if (q < cap_l) {
      const bool a = alive[lo + q] != 0;
      const T t = tau[lo + q];
      live += a;
      short_of += a && t < T(1);
    }
  }
  live = __reduce_add_sync(0xffffffffu, live);
  short_of = __reduce_add_sync(0xffffffffu, short_of);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_live[warp] = live;
    s_short[warp] = short_of;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned a = 0, u = 0;
    for (int w = 0; w < kWarps; ++w) {
      a += s_live[w];
      u += s_short[w];
    }
    if (a) atomicAdd(scratch + shard, (unsigned long long)a);
    if (u) atomicAdd(scratch + m + shard, (unsigned long long)u);
    __threadfence();  // the sums land before the ticket
    s_last = atomicAdd(scratch + 2 * m, 1ULL) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: every other block's sums have landed
  const bool go = R.go == nullptr || *R.go != 0;
  long long sum = 0, mx = 0, unf = 0;
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const long long a = (long long)__ldcg(scratch + k);
    const long long u = (long long)__ldcg(scratch + m + k);
    scratch[k] = 0ULL;
    scratch[m + k] = 0ULL;
    if (O.per != nullptr) {
      O.per[k] = a;
      O.per[m + k] = u;
    }
    sum += a;
    mx = a > mx ? a : mx;
    unf += u;
    if (R.iters != nullptr) {
      const int32_t it = R.it[k];
      R.iters[k] += it;
      R.events[k] += R.ev[k];
      R.hits[k] += (go && it >= R.max_iters) ? 1 : 0;
      if (R.drop != nullptr) R.dropped[k] += R.drop[k];
      if (R.sent != nullptr) R.sent_acc[k] += R.sent[k];
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, d);
    const long long o = __shfl_down_sync(0xffffffffu, mx, d);
    mx = o > mx ? o : mx;
    unf += __shfl_down_sync(0xffffffffu, unf, d);
  }
  if (lane == 0) {
    s_sum[warp] = sum;
    s_max[warp] = mx;
    s_unf[warp] = unf;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      sum += s_sum[w];
      mx = s_max[w] > mx ? s_max[w] : mx;
      unf += s_unf[w];
    }
    if (O.totals != nullptr) {
      O.totals[0] = sum;
      O.totals[1] = mx;
      O.totals[2] = unf;
    }
    if (R.rounds != nullptr) {
      *R.rounds += go ? 1 : 0;
      *R.unfinished = unf;
    }
    scratch[2 * m] = 0ULL;  // the ticket
  }
}

}  // namespace

// The count launch over m adjacent slices of cap_l slots each: alive (bool) and
// tau (real_bytes 4: float, 8: double) of the joined ledger; scratch, 2 m + 1
// uint64 at 0 (left so by every launch); per (2 m int64) and totals (3 int64),
// each null or written; the round's counters (round_ptrs: null outside a spatial
// round, else a host array of the 12 pointers of Round's order, go, drop and sent
// among them null where absent) with max_iters. Returns cudaGetLastError() after
// the launch, -1 for arguments the kernel does not take.
extern "C" int jb_counts_launch(const void* alive, const void* tau, int real_bytes, int m,
                                long long cap_l, void* scratch, void* per, void* totals,
                                const void* const* round_ptrs, int max_iters, void* stream) {
  if ((real_bytes != 4 && real_bytes != 8) || m < 1 || cap_l < 0 ||
      (long long)m * cap_l >= (1LL << 31))
    return -1;
  Outputs O{(long long*)per, (long long*)totals};
  Round R{};
  if (round_ptrs != nullptr) {
    const void* const* r = round_ptrs;
    R.go = (const uint8_t*)r[0];
    R.it = (const int32_t*)r[1];
    R.ev = (const long long*)r[2];
    R.drop = (const long long*)r[3];
    R.sent = (const long long*)r[4];
    R.iters = (int32_t*)r[5];
    R.events = (long long*)r[6];
    R.hits = (long long*)r[7];
    R.dropped = (long long*)r[8];
    R.sent_acc = (long long*)r[9];
    R.rounds = (long long*)r[10];
    R.unfinished = (long long*)r[11];
    R.max_iters = max_iters;
    if (!R.it || !R.ev || !R.iters || !R.events || !R.hits || !R.rounds || !R.unfinished ||
        (R.drop != nullptr) != (R.dropped != nullptr) ||
        (R.sent != nullptr) != (R.sent_acc != nullptr))
      return -1;
  }
  const int tiles = cap_l > 0 ? (int)((cap_l + kTile - 1) / kTile) : 1;
  auto st = (cudaStream_t)stream;
  auto* sc = (unsigned long long*)scratch;
  const unsigned blocks = (unsigned)(m * tiles);
  const auto* a = (const uint8_t*)alive;
  if (real_bytes == 4)
    round_counts_kernel<float><<<blocks, kThreads, 0, st>>>(a, (const float*)tau, cap_l, tiles, m,
                                                            sc, O, R);
  else
    round_counts_kernel<double><<<blocks, kThreads, 0, st>>>(a, (const double*)tau, cap_l, tiles,
                                                             m, sc, O, R);
  return (int)cudaGetLastError();
}
