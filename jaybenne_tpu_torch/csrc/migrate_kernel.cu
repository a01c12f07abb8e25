// The spatial migration's sort and pack in one launch: each local shard's
// in-transit slots ranked by destination shard by a single-pass scan with a
// decoupled look-back, the first K of each destination written as rows into its
// [n, K] send buffer, and a valid flag a row in a byte array of its own, over the
// adjacent slices of every local shard at once.
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
// 1; its flag, one byte in a contiguous [n, m, K] array, is 1. A row that no slot
// takes is not written (the insert copies valid rows only and reads the flags);
// its flag is 0. Its plain version is parallel/spatial.py::pack_plain (the sort,
// the map and the row gather), whose rows' valid column the flags equal.
//
// The ledger is m slices of cap_l slots, cut into lt tiles of kTile slots a slice
// that never straddle a slice. A block takes its tile from a ticket (an atomic
// counter), so the tiles of a slice start in order and a tile waits only on tiles
// that already run. A block:
//   1. loads its tile's alive flags and blocks;
//   2. counts its slots by destination in each of kItems rounds of kThreads
//      consecutive slots, a warp at a time (__match_any_sync: a lane's count of
//      the lanes of its warp with its destination), and scans those counts over
//      the rounds and warps into each warp's offset in the tile, a thread a
//      destination: no shared atomics;
//   3. publishes its tile's count by destination (an aggregate; a slice's first
//      tile publishes an inclusive prefix at once), then looks back over the
//      tiles before it in its slice, a warp a destination and 32 tiles at a
//      time, adding aggregates until it meets an inclusive prefix, and publishes
//      its own inclusive prefix;
//   4. ranks each slot (its tile's prefix, its warp's offset and its place among
//      the lanes of its warp with its destination), and loads and stores the rows
//      of the ranks below K, 8 bytes a store (loaded here, not held in registers
//      through the look-back: 42-44 registers, not 64-80, so a wave holds every
//      tile of big_mesh_spatial's 8-shard round);
//   5. the slice's last tile, whose inclusive prefix is the slice's count by
//      destination, writes the slice's sent count and its n K flags (1 below
//      min(count, K)), 4 bytes a store.
// Every rank is a sum of integers, so every order of the blocks gives the same
// bits, and the rows are the plain version's bit for bit. The rows go where the
// in-process exchange would put them, an [n, m, K] buffer of rows by receiver,
// then sender (the receivers' layout), so nothing is stacked; with one local
// shard that is the sender's own [n, K]. ``go`` is read from device memory: with
// go false no slot is in transit, so each slice's last tile writes its flags and
// sent count 0 and every other block returns at once (no ticket is taken, no
// status word written), and nothing else changes.
//
// The scratch holds the ticket and a status word a tile and destination: the
// prefix or aggregate, a bit for which, and a tag, the launch's epoch. The ticket
// word holds the epoch above its count; the block that takes a launch's last
// ticket (every other block has taken its own by then) moves it to the next
// epoch with the count at 0, so a status word written by an earlier launch never
// reads as ready and no launch queues a memset. The scratch is zeroed once when
// it is made (parallel/spatial.py::MigrateScratch, outside any capture). Nothing
// waits for the host and every shape is static: a CUDA graph captures the launch.
//
// Bounds on the card: the bytes, each slot's alive flag and block read once (5 bytes a
// slot), the leaving rows' columns read and their rows written, their alive flags
// cleared, and a byte a row of flags. Measured (NVIDIA H100 80GB HBM3, 700.00 W;
// census_bench.py --only migrate, this kernel and the parent design in turns on
// big_mesh_spatial's first round at 8 shards: 663168 slots, 63930 sent, K 5181): the
// parent design, two launches (a count launch, then a pack launch whose every block
// summed all lt n tile counts of its slice with shared atomics on n addresses and
// wrote a 4-byte valid word, a 32-byte sector of its own, into each empty row),
// 0.0216-0.0218 ms on the device (count 0.0043, pack 0.0173-0.0176; its source cut
// apart while this kernel was designed, PERF.md section 6: its pack with the tile sums
// alone 0.0084, without the valid words 0.0136-0.0148); this kernel 0.0193-0.0195
// against a bound of 0.0035 (0.0121 with the sent slots' column reads in 32-byte
// sectors), its round with the insert 0.0401-0.0403 (0.0524-0.0545), a go-false round
// 0.0166 (0.0277). Cut apart the same way, it reaches its tiles' counts in 0.0054, its
// look-back takes 0.0045, its ranks and rows 0.008, its flags 0.001: latency, not
// bytes, bounds it. A count launch with pack blocks that each sum their slice's
// earlier tile counts measured faster on these rounds (0.0157-0.0162, PERF.md section
// 6), but it reads n lt^2 / 2 counts a slice, which grows with the square of a slice's
// tiles; census_bench.py --only migrate reads the kernels on one rank's slice of ten
// thousand tiles (MIGRATE_RANK). A launch that faults leaves the ticket mid-count, but
// a fault in a kernel loses the CUDA context, so no later launch reads it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // slots a tile, in one slice
constexpr int kWarps = kThreads / 32;
constexpr int kReals = 9;  // x y z vx vy vz tau weight energy, of the run's precision
constexpr int kInts = 6;   // block i j k face leak, int32
constexpr int kMaxShards = 1024;  // the shared counts: (kItems kWarps + 2) n int32

// A status word: the launch's tag (31 bits, never 0), the inclusive-prefix bit,
// the count.
constexpr unsigned long long kPrefix = 1ULL << 32;

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
  int n, cap_l, bl, off0, lt, tiles, K;
  long long stride_s, stride_d;  // rows between local shards (K) and destinations (m K)
  int32_t* buf;                  // the rows
  uint8_t* flags;                // a row's valid flag, [n, m, K]
  unsigned long long* ticket;    // the epoch (high 32 bits) and the tickets taken
  unsigned long long* status;    // tiles n: a tile's status word by destination
  long long* sent;               // m
};

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Slot q's row's words, loaded through the read-only path (no block writes the
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

// The count of tile t's slots with destination d before tile t in its slice (t:
// the tile's index in its slice, > 0), by warp ``lane``s of one warp: 32 tiles
// before it at a time, each lane spinning until its tile's word carries this
// launch's tag, the aggregates added up to the nearest inclusive prefix.
__device__ __forceinline__ int look_back(const unsigned long long* status, int n, int d,
                                         int t, unsigned long long tag, int lane) {
  int excl = 0;
  for (int top = t - 1;; top -= 32) {
    const int pred = top - lane;  // lane 0 the nearest
    unsigned long long w = kPrefix;  // before the slice's first tile: a prefix of 0
    if (pred >= 0) {
      const unsigned long long* p = status + (long long)pred * n + d;
      do {
        w = load_status(p);
      } while ((w >> 33) != tag);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, (w & kPrefix) != 0);
    const int first = prefixes ? __ffs(prefixes) - 1 : 32;  // the nearest prefix
    const int v = lane <= first ? (int)(uint32_t)w : 0;
    excl += __reduce_add_sync(0xffffffffu, (unsigned)v);
    if (prefixes) return excl;
  }
}

// Bytes [0, K) of a flag row: 1 below lim, else 0; 4 bytes a store where aligned.
__device__ __forceinline__ void write_flags(uint8_t* row, int K, int lim) {
  const int head = min(K, (int)((4 - ((uintptr_t)row & 3)) & 3));
  for (int r = threadIdx.x; r < head; r += kThreads) row[r] = r < lim;
  const int words = (K - head) >> 2;
  uint32_t* w = reinterpret_cast<uint32_t*>(row + head);
  for (int k = threadIdx.x; k < words; k += kThreads) {
    const int r = head + 4 * k;
    w[k] = (uint32_t)(r < lim) | (uint32_t)(r + 1 < lim) << 8 | (uint32_t)(r + 2 < lim) << 16 |
           (uint32_t)(r + 3 < lim) << 24;
  }
  for (int r = head + 4 * words + threadIdx.x; r < K; r += kThreads) row[r] = r < lim;
}

template <bool WIDE>
__global__ void __launch_bounds__(kThreads) migrate_kernel(Fields F, Plan P) {
  constexpr int W = kWords<WIDE>;
  extern __shared__ int sm[];
  const int n = P.n;
  int* off = sm;                      // kItems kWarps n: a round's warp's offset in the tile
  int* base = off + kItems * kWarps * n;  // n: the slots of the slice before the tile
  int* agg = base + n;                // n: the tile's slots by destination
  __shared__ int s_tile;
  __shared__ unsigned long long s_tag;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (P.go != nullptr && *P.go == 0) {
    // nothing is in transit: each slice's last tile writes its sent count and flags,
    // 0; no block takes a ticket or writes a status word
    const int b0 = blockIdx.x, s = b0 / P.lt;
    if (b0 - s * P.lt != P.lt - 1) return;
    if (threadIdx.x == 0) P.sent[s] = 0;
    for (int k = 0; k < n; ++k) write_flags(P.flags + s * P.stride_s + k * P.stride_d, P.K, 0);
    return;
  }
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(P.ticket, 1ULL);
    const unsigned epoch = (unsigned)(t >> 32);
    if ((unsigned)t == (unsigned)P.tiles - 1)  // the last ticket: the next launch's epoch
      atomicExch(P.ticket, (unsigned long long)(epoch + 1) << 32);
    s_tile = (int)(unsigned)t;
    s_tag = epoch % 0x7fffffffu + 1;
  }
  __syncthreads();
  const int s = s_tile / P.lt, j = s_tile - s * P.lt;
  const unsigned long long tag = s_tag;
  // 1. the tile's destinations (n where a slot is not in transit)
  const long long q0 = (long long)s * P.cap_l + j * kTile + threadIdx.x;
  const int e0 = j * kTile + threadIdx.x;
  uint8_t al[kItems];
  int32_t b[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    al[i] = e0 + i * kThreads < P.cap_l ? P.alive[q0 + i * kThreads] : 0;
    b[i] = e0 + i * kThreads < P.cap_l ? P.block[q0 + i * kThreads] : 0;
  }
  const int lo = P.off0 + s * P.bl;
  int d[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool transit = al[i] && (b[i] < lo || b[i] >= lo + P.bl);
    // b / bl truncates where the plain version floors: either is below 1 for b < bl
    d[i] = transit ? min(max(b[i] / P.bl, 0), n - 1) : n;
  }
  // 2. each round's warp's count by destination, then their offsets in the tile
  for (int k = threadIdx.x; k < kItems * kWarps * n; k += kThreads) off[k] = 0;
  __syncthreads();
  unsigned same[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    same[i] = __match_any_sync(0xffffffffu, d[i]);
    if (d[i] < n && lane == __ffs(same[i]) - 1)
      off[(i * kWarps + warp) * n + d[i]] = __popc(same[i]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    int run = 0;
    for (int c = 0; c < kItems * kWarps; ++c) {
      const int v = off[c * n + k];
      off[c * n + k] = run;
      run += v;
    }
    agg[k] = run;
  }
  __syncthreads();
  // 3. publish the aggregate (a slice's first tile: its prefix), look back, publish
  // the inclusive prefix; a destination's two words from one thread, so the
  // prefix lands after the aggregate
  unsigned long long* st = P.status + (long long)s_tile * n;
  for (int k = warp; k < n; k += kWarps) {
    if (lane == 0)
      store_status(st + k, tag << 33 | (j == 0 ? kPrefix : 0ULL) | (uint32_t)agg[k]);
  }
  const unsigned long long* first = P.status + (long long)(s * P.lt) * n;
  for (int k = warp; k < n; k += kWarps) {
    const int excl = j == 0 ? 0 : look_back(first, n, k, j, tag, lane);
    if (lane == 0) {
      base[k] = excl;
      if (j != 0) store_status(st + k, tag << 33 | kPrefix | (uint32_t)(excl + agg[k]));
    }
  }
  __syncthreads();
  // 4. the ranks, then the rows of those below K
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (d[i] < n) {
      const int rank = base[d[i]] + off[(i * kWarps + warp) * n + d[i]] +
                       __popc(same[i] & below);
      if (rank < P.K) {
        uint32_t w[W];
        load_row<WIDE>(F, q0 + i * kThreads, w);
        // each row stored 8 bytes at a time: its words are even and it starts on an
        // 8-byte boundary
        uint2* row = reinterpret_cast<uint2*>(
            P.buf + (s * P.stride_s + d[i] * P.stride_d + rank) * W);
#pragma unroll
        for (int k = 0; k < W; k += 2) row[k / 2] = make_uint2(w[k], w[k + 1]);
        P.alive[q0 + i * kThreads] = 0;
      }
    }
  }
  // 5. the slice's last tile: its sent count and flags
  if (j != P.lt - 1) return;
  if (warp == 0) {
    long long v = 0;
    for (int k = lane; k < n; k += 32) v += min(base[k] + agg[k], P.K);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) P.sent[s] = v;
  }
  for (int k = 0; k < n; ++k)
    write_flags(P.flags + s * P.stride_s + k * P.stride_d, P.K, base[k] + agg[k]);
}

}  // namespace

// The MIGRATE_FIELDS columns of the joined ledger (src: a host array of 15 device
// pointers, the nine reals of real_bytes (4 or 8) bytes, then the six int32
// columns), packed into rows of ``words`` int32 words (16 in float32, 26 in
// float64). alive (bool), block (int32): the joined ledger's m x cap_l slots
// (device); go: a device bool, or null for go on. Local shard s owns blocks
// [off0 + s bl, off0 + (s + 1) bl); n shards in all; K rows a destination. Row r
// of local shard s's buffer for destination d starts at word (s K + d m K + r)
// words of buf (device): the receivers' layout, [n, m, K, words]; its flag is
// byte s K + d m K + r of flags (device, every byte written). scratch:
// scratch_len uint64 (device), at least 1 + m lt n (lt = ceil(cap_l / kTile), the
// tiles a slice), zeroed when it was made and left ready by every launch; sent: m
// int64 (device), written. stream: the CUDA stream. One launch. Returns
// cudaGetLastError() after it, -1 for a count, width or size the kernel does not
// take.
extern "C" int jb_migrate_launch(const void* const* src, int real_bytes, int words, void* alive,
                                 const void* block, const void* go, int m, int n,
                                 long long cap_l, long long bl, long long off0, long long K,
                                 void* buf, void* flags, void* scratch, long long scratch_len,
                                 void* sent, void* stream) {
  const bool wide = real_bytes == 8;
  const long long lt = (cap_l + kTile - 1) / kTile;  // tiles a slice
  if ((real_bytes != 4 && real_bytes != 8) || words != (wide ? kWords<true> : kWords<false>) ||
      m < 1 || n < 1 || n > kMaxShards || cap_l < 1 || bl < 1 || K < 1 ||
      (long long)m * cap_l >= (1LL << 31) || (long long)n * m * K >= (1LL << 31) || off0 < 0 ||
      off0 + (long long)(m + 1) * bl >= (1LL << 31) ||
      scratch_len < 1 + m * lt * n)
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
  P.lt = (int)lt;
  P.tiles = (int)(m * lt);
  P.K = (int)K;
  P.stride_s = K;
  P.stride_d = (long long)m * K;
  P.buf = (int32_t*)buf;
  P.flags = (uint8_t*)flags;
  P.ticket = (unsigned long long*)scratch;
  P.status = P.ticket + 1;
  P.sent = (long long*)sent;
  auto st = (cudaStream_t)stream;
  const size_t shared = (kItems * kWarps + 2) * n * sizeof(int);
  void (*kernel)(Fields, Plan) = wide ? &migrate_kernel<true> : &migrate_kernel<false>;
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)P.tiles, kThreads, shared, st>>>(F, P);
  return (int)cudaGetLastError();
}
