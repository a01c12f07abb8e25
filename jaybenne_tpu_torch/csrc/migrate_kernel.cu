// The spatial migration's sort and pack in one pass of two launches: each local
// shard's in-transit slots ranked by destination shard with scans written here,
// and the first K of each destination written as rows into its [n, K] send
// buffer, over the adjacent slices of every local shard at once.
//
// Replaces no TPU kernel: it is the port of what XLA makes of the JAX package's
// migrate (jaybenne_tpu/parallel/spatial.py:77-138, with ops/pallas_grid.py::
// _pack_cols :554-578): the stable argsort of every slot by destination, the
// searchsorted, the rank, the scatter of the map from buffer row to source slot,
// the column pack with its appended zero row, the row gather and the ``sent``
// scatter, around the TPU kernels K3s and K4s. What it computes is that pack: a
// slot is in transit when it is alive, the round goes on (``go``) and its block
// lies outside its shard's [off, off + bl); its destination is clamp(block / bl,
// 0, n - 1); its rank is the count of earlier in-transit slots of its slice with
// the same destination, since the sort is stable; a slot of rank below K is
// written to row rank of its destination's buffer, cleared from ``alive`` and
// counted as sent; the rest stay in transit for the next round. A row holds the
// MIGRATE_FIELDS' words in order (two for a float64 column, low word first), a
// zero pad word where a float64 row would have an odd count, and the valid word
// 1. Every row that no slot takes gets valid word 0 (its other words are not
// read: the insert copies valid rows only). Its plain version is
// parallel/spatial.py::pack_plain (the sort, the map and the row gather).
//
// The ledger is m slices of cap_l slots, cut into tiles of kTile slots that never
// straddle a slice:
//   1. migrate_count_kernel: a block a tile counts its in-transit slots by
//      destination (warp matches, then shared sums), in kItems rounds of
//      kThreads consecutive slots;
//   2. migrate_pack_kernel: a block a tile loads the rows of its in-transit
//      slots, adds the counts of the tiles before it in its slice and of all of
//      them, writes valid word 0 into its share of the slice's rows that no slot
//      takes (and, the slice's first tile, its sent count), ranks its slots in
//      the same rounds (a lane's rank: the ranks taken before the round, the
//      counts of the lower warps and its place among the lanes of its warp with
//      the same destination, __match_any_sync) and then stores its rows.
// No atomic decides a rank; the shared sums are of integers, so every rank and
// count is the same in any order, and the buffer rows are the plain version's bit
// for bit. The rows go where the in-process exchange would put them, an [n, m, K]
// buffer of rows by receiver, then sender (the receivers' layout), so nothing is
// stacked; with one local shard that is the sender's own [n, K]. ``go`` is read
// from device memory: with go false no slot is in transit, so the kernels write
// valid words 0 and the counts 0 and change nothing. Nothing waits for the device
// and every shape is static: a CUDA graph captures both launches.
//
// Bounds on the card: the bytes, each slot's alive flag and block read once (5
// bytes a slot; twice, once a launch, in L2 for the second), the leaving rows'
// columns read and their rows written, and a valid word for each empty row (a
// 32-byte sector each: the rows are 64 or 104 bytes apart). Measured (NVIDIA H100
// 80GB HBM3, 700.00 W; chip_smoke.py's migration_reading, device ms by launch from
// torch.profiler, on big_mesh_spatial's first round at 8 shards: 663168 slots,
// 63930 sent, K 5181): the parent's round (a stable argsort of every slot, the
// map, the row cat and gather, the sent scatter, the stack, the insert) 1.665 ms;
// over a step its eager migrate span held 37.3 ms of radix sort in 159.9
// (census_bench.py's eager profile). This kernel's pack launch, first with each lane
// loading its 15 columns and storing its row a word at a time in each of 8 rounds
// between barriers (a store may alias a later load, so the loads waited in turn),
// 0.0706 ms; with the loads first, the row in registers and 8-byte stores, 0.0231;
// with the ranks of all 8 rounds before any row, 0.0227 (the f64 round, with
// fewer slots, rows and sends but fewer blocks too, 0.0361); with tiles of 512
// slots (four times the blocks) and the rows loaded while the block ranks,
// 0.0177-0.0184, the count 0.0040, the whole round (pack and insert) 0.0527, a
// round with go false 0.028 (census_bench.py --only migrate, a fresh process;
// read late in chip_smoke.py's long process, the profiler's sum over five calls
// gave the pack 0.0034-0.0067 while the window between CUDA events stayed 0.030,
// so launch_split now also counts the launches a trace holds: PERF.md section 6).
// The receivers' layout took the stack's 0.013 ms a round off (the 8-shard step
// 60.3-62.1 -> 58.9-59.0 ms of device time). The pack stays
// above its bound (0.0037); not read apart: the 331000 scattered valid words of
// the empty rows, each in a 32-byte sector of its own, which the insert reads
// again.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 2;
constexpr int kTile = kThreads * kItems;  // slots a tile, in one slice
constexpr int kWarps = kThreads / 32;
constexpr int kReals = 9;  // x y z vx vy vz tau weight energy, of the run's precision
constexpr int kInts = 6;   // block i j k face leak, int32
constexpr int kMaxShards = 1024;  // the shared counts: (kWarps + 2) n int32

// A row's int32 words: the columns', a zero pad where a float64 row would be odd,
// the valid word.
template <bool WIDE>
constexpr int kWords = WIDE ? 2 * kReals + kInts + 2 : kReals + kInts + 1;

struct Fields {
  const void* src[kReals + kInts];  // the joined ledger's columns, in row order
};

struct Plan {
  uint8_t* alive;        // the joined ledger's, m cap_l slots; cleared where sent
  const int32_t* block;  // the joined ledger's
  const uint8_t* go;     // the round's flag (nonzero: go on), or null
  int n, cap_l, bl, off0, lt, K;
  long long stride_s, stride_d;  // rows between local shards (K) and destinations (m K)
  int32_t* buf;                  // the rows
  int* counts;                   // m lt n: a tile's in-transit slots by destination
  long long* sent;               // m
};

// The destinations of a thread's kItems slots of tile j of slice s (round i:
// slot j kTile + i kThreads + threadIdx.x), n where a slot is not in transit. The
// loads come first, all of them, so that a thread waits for memory once.
__device__ __forceinline__ void dests_of(const Plan& P, int s, int j, int (&d)[kItems]) {
  const bool go = P.go == nullptr || *P.go != 0;
  const long long q0 = (long long)s * P.cap_l;
  uint8_t al[kItems];
  int32_t b[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = j * kTile + i * kThreads + threadIdx.x;
    al[i] = e < P.cap_l ? P.alive[q0 + e] : 0;
    b[i] = e < P.cap_l ? P.block[q0 + e] : 0;
  }
  const int lo = P.off0 + s * P.bl;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool transit = go && al[i] && (b[i] < lo || b[i] >= lo + P.bl);
    // b / bl truncates where the plain version floors: either is below 1 for b < bl
    d[i] = transit ? min(max(b[i] / P.bl, 0), P.n - 1) : P.n;
  }
}

// 1. A tile's in-transit slots by destination.
__global__ void __launch_bounds__(kThreads) migrate_count_kernel(Plan P) {
  extern __shared__ int cnt[];  // n
  const int s = blockIdx.x / P.lt, j = blockIdx.x - s * P.lt;
  const int lane = threadIdx.x & 31;
  int d[kItems];
  dests_of(P, s, j, d);
  for (int k = threadIdx.x; k < P.n; k += kThreads) cnt[k] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned same = __match_any_sync(0xffffffffu, d[i]);
    if (d[i] < P.n && lane == __ffs(same) - 1) atomicAdd(&cnt[d[i]], __popc(same));
  }
  __syncthreads();
  int* out = P.counts + (long long)blockIdx.x * P.n;
  for (int k = threadIdx.x; k < P.n; k += kThreads) out[k] = cnt[k];
}

// Slot q's row's words, loaded through the read-only path (no launch writes the
// columns), all at once.
template <bool WIDE>
__device__ __forceinline__ void load_row(const Fields& F, long long q,
                                         uint32_t (&w)[kWords<WIDE>]) {
  constexpr int W = kWords<WIDE>;
#pragma unroll
  for (int f = 0; f < kReals; ++f) {
    if (WIDE) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(F.src[f]) + q);
      w[2 * f] = v.x;
      w[2 * f + 1] = v.y;
    } else {
      w[f] = __ldg(reinterpret_cast<const uint32_t*>(F.src[f]) + q);
    }
  }
  constexpr int r0 = WIDE ? 2 * kReals : kReals;
#pragma unroll
  for (int f = 0; f < kInts; ++f)
    w[r0 + f] = __ldg(reinterpret_cast<const uint32_t*>(F.src[kReals + f]) + q);
  if (WIDE) w[W - 2] = 0u;  // the pad word
  w[W - 1] = 1u;
}

// 2. The ranks of a tile's in-transit slots, its rows, its share of the empty
// rows' valid words and, in a slice's first tile, the slice's sent count.
template <bool WIDE>
__global__ void __launch_bounds__(kThreads) migrate_pack_kernel(Fields F, Plan P) {
  constexpr int W = kWords<WIDE>;
  extern __shared__ int sm[];
  const int n = P.n;
  int* wc = sm;                 // kWarps n: a round's slots of each warp by destination
  int* run = sm + kWarps * n;   // n: the ranks taken before the round
  int* tot = run + n;           // n: the slice's in-transit slots by destination
  const int s = blockIdx.x / P.lt, j = blockIdx.x - s * P.lt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int d[kItems];
  dests_of(P, s, j, d);
  // the rows of the in-transit slots, loaded while the block ranks them
  const long long q0 = (long long)s * P.cap_l + j * kTile + threadIdx.x;
  uint32_t w[kItems][W];
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (d[i] < n) load_row<WIDE>(F, q0 + i * kThreads, w[i]);
  for (int k = threadIdx.x; k < n; k += kThreads) run[k] = tot[k] = 0;
  __syncthreads();
  const int* cnt = P.counts + (long long)s * P.lt * n;
  for (int idx = threadIdx.x; idx < P.lt * n; idx += kThreads) {
    const int t = idx / n, k = idx - t * n;
    const int c = cnt[idx];
    if (c) {
      atomicAdd(&tot[k], c);
      if (t < j) atomicAdd(&run[k], c);
    }
  }
  __syncthreads();
  if (j == 0 && warp == 0) {
    long long v = 0;
    for (int k = lane; k < n; k += 32) v += min(tot[k], P.K);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) P.sent[s] = v;
  }
  // the rows (k, r) of this slice with r >= tot[k], a share a tile
  const int rows = n * P.K;
  const int chunk = (rows + P.lt - 1) / P.lt;
  const int r1 = min(rows, (j + 1) * chunk);
  for (int q = j * chunk + threadIdx.x; q < r1; q += kThreads) {
    const int k = q / P.K, r = q - k * P.K;
    if (r >= tot[k]) P.buf[(s * P.stride_s + k * P.stride_d + r) * W + W - 1] = 0;
  }
  bool any = false;  // a slot of this tile takes a row
  for (int k = threadIdx.x; k < n; k += kThreads) any |= cnt[j * n + k] > 0 && run[k] < P.K;
  if (!__syncthreads_or(any)) return;
  const unsigned below = (1u << lane) - 1u;
  int* mine = wc + warp * n;
  int rank[kItems];  // the ranks first, in shared memory alone; then the rows
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned same = __match_any_sync(0xffffffffu, d[i]);
    for (int k = lane; k < n; k += 32) mine[k] = 0;
    __syncwarp();
    if (d[i] < n && lane == __ffs(same) - 1) mine[d[i]] = __popc(same);
    __syncthreads();
    rank[i] = P.K;
    if (d[i] < n) {
      int r = run[d[i]] + __popc(same & below);
      for (int w = 0; w < warp; ++w) r += wc[w * n + d[i]];
      rank[i] = r;
    }
    __syncthreads();  // every lane has read the round's counts
    for (int k = threadIdx.x; k < n; k += kThreads) {
      int a = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += wc[w * n + k];
      run[k] += a;
    }
    __syncthreads();
  }
  // each row stored 8 bytes at a time: its words are even and it starts on an
  // 8-byte boundary
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (rank[i] < P.K) {
      uint2* row = reinterpret_cast<uint2*>(
          P.buf + (s * P.stride_s + d[i] * P.stride_d + rank[i]) * W);
#pragma unroll
      for (int k = 0; k < W; k += 2) row[k / 2] = make_uint2(w[i][k], w[i][k + 1]);
      P.alive[q0 + i * kThreads] = 0;
    }
  }
}

}  // namespace

// The MIGRATE_FIELDS columns of the joined ledger (src: a host array of 15 device
// pointers, the nine reals of real_bytes (4 or 8) bytes, then the six int32
// columns), packed into rows of ``words`` int32 words (16 in float32, 26 in
// float64). alive (bool), block (int32): the joined ledger's m x cap_l slots
// (device); go: a device bool, or null for go on. Local shard s owns blocks
// [off0 + s bl, off0 + (s + 1) bl); n shards in all; K rows a destination. Row r
// of local shard s's buffer for destination d starts at word (s K + d m K + r)
// words of buf (device): the receivers' layout, [n, m, K, words]. scratch:
// scratch_len int32 (device), which must be m lt n (lt = ceil(cap_l / kTile), the
// tiles a slice); sent: m int64 (device), written. stream: the CUDA stream. Two
// launches. Returns cudaGetLastError() after them, -1 for a count, width or size
// the kernels do not take.
extern "C" int jb_migrate_launch(const void* const* src, int real_bytes, int words, void* alive,
                                 const void* block, const void* go, int m, int n,
                                 long long cap_l, long long bl, long long off0, long long K,
                                 void* buf, void* scratch, long long scratch_len, void* sent,
                                 void* stream) {
  const bool wide = real_bytes == 8;
  if ((real_bytes != 4 && real_bytes != 8) || words != (wide ? kWords<true> : kWords<false>) ||
      m < 1 || n < 1 || n > kMaxShards || cap_l < 1 || bl < 1 || K < 1 ||
      (long long)m * cap_l >= (1LL << 31) || (long long)n * K >= (1LL << 31) || off0 < 0 ||
      off0 + (long long)(m + 1) * bl >= (1LL << 31) ||
      scratch_len != m * ((cap_l + kTile - 1) / kTile) * n)
    return -1;
  Fields F;
  for (int f = 0; f < kReals + kInts; ++f) F.src[f] = src[f];
  Plan P;
  P.alive = (uint8_t*)alive;
  P.block = (const int32_t*)block;
  P.go = (const uint8_t*)go;
  P.n = n;
  P.cap_l = (int)cap_l;
  P.bl = (int)bl;
  P.off0 = (int)off0;
  P.lt = (int)((cap_l + kTile - 1) / kTile);
  P.K = (int)K;
  P.stride_s = K;
  P.stride_d = (long long)m * K;
  P.buf = (int32_t*)buf;
  P.counts = (int*)scratch;
  P.sent = (long long*)sent;
  auto st = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)(m * P.lt);
  migrate_count_kernel<<<tiles, kThreads, n * sizeof(int), st>>>(P);
  const size_t shared = (kWarps + 2) * n * sizeof(int);
  if (wide)
    migrate_pack_kernel<true><<<tiles, kThreads, shared, st>>>(F, P);
  else
    migrate_pack_kernel<false><<<tiles, kThreads, shared, st>>>(F, P);
  return (int)cudaGetLastError();
}
