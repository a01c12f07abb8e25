// The ledger insert in one pass of three launches: each valid candidate's
// destination from scans written here, and every column of every candidate
// placed written into its slot, over one ledger or over the adjacent slices of
// several shards at once, each slice scanned on its own.
//
// Replaces no TPU kernel: it is the port of what XLA makes of the JAX package's
// insert (jaybenne_tpu/particles.py:103-125): the ranks' cumsum, the stable
// free-first argsort of the ledger, the sums and one ``.at[dest].set(...,
// mode="drop")`` a column. What it computes is that insert's map: the r-th valid
// candidate, in flat index order, goes to the r-th slot that is neither alive nor
// reserved, in slot order; a candidate beyond the free count is dropped and
// counted. The sort's ``order[r]`` for r below the free count is the r-th free
// slot, so a scan of the free flags gives it without a sort. Its plain version
// is particles.py::insert_destinations (the same ranks by cumsum) and _put, a
// column at a time.
//
// The ledger is m segments of cap_l slots (the local shards' slices, adjacent)
// and the candidates m segments of nc; segment s's candidates go into slice s.
// Both are cut into tiles of kTile elements that never straddle a segment:
//   1. count_kernel: a block a tile counts its free slots or valid candidates;
//   2. list_kernel: a block a tile adds the counts of the tiles before it in its
//      segment, scans its flags (warp shuffles, then the warps' totals) and
//      writes each free slot's index at its rank in the free list and each valid
//      candidate's index at its rank in the candidate list, for the ranks below
//      lim = min(free, valid) of the segment alone; a segment's first block
//      writes its totals and its dropped count, valid - lim;
//   3. write_kernel: thread r of segment s copies candidate cand[r] into slot
//      free[r] for r < lim: consecutive threads take consecutive free slots and
//      consecutive valid candidates, so the writes land close together and no
//      thread of a live warp waits on an invalid candidate.
// No atomics: every count and slot is the same in any order of the blocks, and
// every destination is distinct, so the result is the plain version's bit for
// bit. Nothing waits for the device and every shape is static: a CUDA graph
// captures the three launches with their tables by value.
//
// Bounds on the card: the bytes, the flags read once (alive and reserved 2 bytes
// a slot, a valid flag a candidate) and the written rows' columns; the counts and
// the lists (4 bytes a rank) stay in L2. Small inserts are three launches' latency.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's insert_check, device
// ms by launch from torch.profiler): the 64^3 feedback emission's whole insert
// 0.155 ms with the stable sort -> 0.043 (counts 0.003, lists 0.008, writes
// 0.024), an 8-shard migration round's 0.84 ms of destinations alone -> 0.060 in
// one pass. The writes are most of it: the first free slots are the holes that
// absorbed, escaped and migrated particles left, so a warp's rows land on
// scattered slots and each 4-byte column write costs a 32-byte sector (the
// bound counts the 4 bytes). Loading every column before storing any measured
// the same (0.0241 ms) and went.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // elements a tile, in one segment
constexpr int kWarps = kThreads / 32;
constexpr int kMaxColumns = 24;

struct Column {
  char* dst;                // the ledger column
  const char* src;          // the candidates' values, or null: write fill
  long long s0, s1;         // byte strides of the [rows, k] candidate view
  int bytes;                // 1, 4 or 8
  unsigned long long fill;  // the fill's bytes, low first
};

struct Columns {
  Column c[kMaxColumns];
  int n;
  unsigned k;  // candidates a row of the view
};

// The scans' inputs and scratch. Tile j of segment s is block s (lt + ct) + j of
// the first two launches: a ledger tile for j < lt, else candidate tile j - lt.
struct Plan {
  const uint8_t* alive;     // the joined ledger's, m cap_l slots
  const uint8_t* reserved;  // or null
  const char* valid;        // a candidate's flag (nonzero: valid) at valid + g vstride
  long long vstride;
  int vbytes;  // 1 or 4
  int m, cap_l, nc, lt, ct;
  int* counts;     // m (lt + ct): a tile's free slots or valid candidates
  int* free_list;  // m nc: segment s's free slots by rank (below lim)
  int* cand_list;  // m nc: segment s's valid candidates by rank (below lim)
  int* lim;        // m: min(free, valid) of segment s
  long long* dropped;  // m: valid - lim of segment s
};

__device__ __forceinline__ bool flag_of(const Plan& P, bool ledger, int seg, int e) {
  if (ledger) {
    const int q = seg * P.cap_l + e;
    return P.alive[q] == 0 && (P.reserved == nullptr || P.reserved[q] == 0);
  }
  const long long g = (long long)seg * P.nc + e;
  const char* v = P.valid + g * P.vstride;
  return P.vbytes == 4 ? *reinterpret_cast<const int32_t*>(v) != 0 : *v != 0;
}

// Block b's tile: its segment, kind, first element and length.
struct Tile {
  int seg, j, first, len;
  bool ledger;
};

__device__ __forceinline__ Tile tile_of(const Plan& P, int b) {
  Tile t;
  t.seg = b / (P.lt + P.ct);
  t.j = b - t.seg * (P.lt + P.ct);
  t.ledger = t.j < P.lt;
  const int size = t.ledger ? P.cap_l : P.nc;
  t.first = (t.ledger ? t.j : t.j - P.lt) * kTile;
  t.len = min(kTile, size - t.first);
  return t;
}

// The sum of v over the block's threads, in every thread.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // scratch is free
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

// The exclusive prefix of v over the block's threads in thread order.
__device__ __forceinline__ int block_exclusive(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();  // scratch is free
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? scratch[w] : 0;
  return before + incl - v;
}

// 1. A tile's count of free slots or valid candidates.
__global__ void __launch_bounds__(kThreads) count_kernel(Plan P) {
  __shared__ int scratch[kWarps];
  const Tile t = tile_of(P, blockIdx.x);
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = i * kThreads + threadIdx.x;  // coalesced
    if (e < t.len) c += flag_of(P, t.ledger, t.seg, t.first + e);
  }
  c = block_sum(c, scratch);
  if (threadIdx.x == 0) P.counts[blockIdx.x] = c;
}

// 2. The ranks of a tile's free slots or valid candidates, and the lists.
__global__ void __launch_bounds__(kThreads) list_kernel(Plan P) {
  __shared__ int scratch[kWarps];
  const Tile t = tile_of(P, blockIdx.x);
  const int* cnt = P.counts + t.seg * (P.lt + P.ct);
  // the counts of the segment's tiles: of this kind before this one, and in all
  int before = 0, n_free = 0, n_valid = 0;
  for (int i = threadIdx.x; i < P.lt + P.ct; i += kThreads) {
    const int c = cnt[i];
    const bool led = i < P.lt;
    if (i < t.j && led == t.ledger) before += c;
    (led ? n_free : n_valid) += c;
  }
  before = block_sum(before, scratch);
  n_free = block_sum(n_free, scratch);
  n_valid = block_sum(n_valid, scratch);
  const int lim = min(n_free, n_valid);
  if (t.j == 0 && threadIdx.x == 0) {
    P.lim[t.seg] = lim;
    P.dropped[t.seg] = (long long)(n_valid - lim);
  }
  if (before >= lim) return;  // the whole block: every rank here is past lim
  // a thread's kItems consecutive elements, so the ranks follow thread order
  const int e0 = threadIdx.x * kItems;
  bool f[kItems];
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    f[i] = e0 + i < t.len && flag_of(P, t.ledger, t.seg, t.first + e0 + i);
    c += f[i];
  }
  int r = before + block_exclusive(c, scratch);
  int* list = (t.ledger ? P.free_list : P.cand_list) + (long long)t.seg * P.nc;
  const int base = t.ledger ? t.seg * P.cap_l : t.seg * P.nc;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (f[i]) {
      if (r < lim) list[r] = base + t.first + e0 + i;
      ++r;
    }
  }
}

template <class T>
__device__ __forceinline__ void put(const Column& col, long long off, long long d) {
  const T v = col.src ? *reinterpret_cast<const T*>(col.src + off) : (T)col.fill;
  reinterpret_cast<T*>(col.dst)[d] = v;
}

// 3. Rank r of segment blockIdx.y: candidate cand[r] into slot free[r].
__global__ void __launch_bounds__(kThreads) write_kernel(Columns C, Plan P) {
  const int s = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= P.lim[s]) return;
  const long long at = (long long)s * P.nc + r;
  const long long d = P.free_list[at];
  const unsigned g = (unsigned)P.cand_list[at];
  const unsigned row = C.k == 1 ? g : g / C.k, k = g - row * C.k;
  for (int j = 0; j < C.n; ++j) {
    const Column& col = C.c[j];
    const long long off = (long long)row * col.s0 + (long long)k * col.s1;
    switch (col.bytes) {
      case 4: put<uint32_t>(col, off, d); break;
      case 8: put<unsigned long long>(col, off, d); break;
      default: put<uint8_t>(col, off, d);
    }
  }
}

}  // namespace

// n_cols columns: dst (device, the joined ledger's), src (device, or null for a
// fill), strides (2 a column: the byte strides of the candidates' [rows, k]
// view), bytes (1, 4 or 8 a column) and fills (a column's fill bytes); host
// arrays. k: candidates a row. alive, reserved (or null): the joined ledger's
// m x cap_l flags (device). valid, vstride, vbytes: candidate g's flag at byte
// valid + g vstride, of vbytes (1 or 4) bytes, nonzero where valid; m x nc
// candidates, segment s's into slice s. scratch: m (lt + ct) + 2 m nc + m int32
// (device; lt, ct = the tiles of kTile a slice and a segment's candidates);
// dropped: m int64 (device), written. stream: the CUDA stream. Three launches,
// none where nc is 0. Returns cudaGetLastError() after them, -1 for a column
// count, width or size the kernel does not take.
extern "C" int jb_insert_launch(int n_cols, void* const* dst, const void* const* src,
                                const long long* strides, const int* bytes,
                                const unsigned long long* fills, long long k, const void* alive,
                                const void* reserved, const void* valid, long long vstride,
                                int vbytes, int m, long long cap_l, long long nc, void* scratch,
                                void* dropped, void* stream) {
  if (n_cols < 1 || n_cols > kMaxColumns || k < 1 || m < 1 || cap_l < 0 || nc < 0 ||
      (vbytes != 1 && vbytes != 4) || (long long)m * cap_l >= (1LL << 31) ||
      (long long)m * nc >= (1LL << 31))
    return -1;
  Columns C;
  std::memset(&C, 0, sizeof(C));
  C.n = n_cols;
  C.k = (unsigned)k;
  for (int j = 0; j < n_cols; ++j) {
    if (bytes[j] != 1 && bytes[j] != 4 && bytes[j] != 8) return -1;
    C.c[j] = Column{(char*)dst[j], (const char*)src[j], strides[2 * j], strides[2 * j + 1],
                    bytes[j], fills[j]};
  }
  if (nc == 0) return (int)cudaGetLastError();
  Plan P;
  P.alive = (const uint8_t*)alive;
  P.reserved = (const uint8_t*)reserved;
  P.valid = (const char*)valid;
  P.vstride = vstride;
  P.vbytes = vbytes;
  P.m = m;
  P.cap_l = (int)cap_l;
  P.nc = (int)nc;
  P.lt = (int)((cap_l + kTile - 1) / kTile);
  P.ct = (int)((nc + kTile - 1) / kTile);
  int* w = (int*)scratch;
  P.counts = w;
  w += m * (P.lt + P.ct);
  P.free_list = w;
  w += (long long)m * nc;
  P.cand_list = w;
  w += (long long)m * nc;
  P.lim = w;
  P.dropped = (long long*)dropped;
  auto st = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)(m * (P.lt + P.ct));
  count_kernel<<<tiles, kThreads, 0, st>>>(P);
  list_kernel<<<tiles, kThreads, 0, st>>>(P);
  const dim3 grid((unsigned)((nc + kThreads - 1) / kThreads), (unsigned)m);
  write_kernel<<<grid, kThreads, 0, st>>>(C, P);
  return (int)cudaGetLastError();
}

