// The ledger insert's writes in one pass: every column of every candidate that
// particles.py::insert_particles placed, into its slot, the candidates it
// dropped skipped.
//
// Replaces no TPU kernel: it is the port of the scatter that XLA makes of the
// JAX package's insert (jaybenne_tpu/particles.py:103-125, one
// ``.at[dest].set(..., mode="drop")`` a column). Its plain version is
// particles.py::_put, a column at a time: the column extended by one dump slot,
// the scatter, the copy back. Here one thread takes one candidate q: its
// destination dest[q] lies in [0, capacity], and capacity drops it; else the
// thread copies each column's element of q (a strided [rows, k] view of the
// candidate, q = row k + col) or the column's fill bytes (alive = true, and
// absorbed, face and leak = 0 where the candidates do not carry them) into the
// slot. The destinations of the candidates written are distinct, so the writes
// are the plain version's, bit for bit, in any order. Candidates in rank order
// go to free slots in slot order, so the writes of a warp land close together.
//
// No shape here depends on the data and nothing waits for the device: a CUDA
// graph captures the launch with its column table by value.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxColumns = 24;

struct Column {
  char* dst;             // the ledger column
  const char* src;       // the candidates' values, or null: write fill
  long long s0, s1;      // element strides of the [rows, k] candidate view
  int bytes;             // 1, 4 or 8
  unsigned long long fill;  // the fill's bytes, low first
};

struct Columns {
  Column c[kMaxColumns];
  int n;
  long long k;  // candidates a row of the view
};

template <int B>
struct Word;
template <>
struct Word<1> { using T = uint8_t; };
template <>
struct Word<4> { using T = uint32_t; };
template <>
struct Word<8> { using T = unsigned long long; };

template <int B>
__device__ __forceinline__ void put(const Column& col, long long off, long long d) {
  using T = typename Word<B>::T;
  const T v = col.src ? reinterpret_cast<const T*>(col.src)[off] : (T)col.fill;
  reinterpret_cast<T*>(col.dst)[d] = v;
}

__global__ void __launch_bounds__(kThreads)
    insert_kernel(Columns C, const long long* __restrict__ dest, long long n, long long cap) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= n) return;
  const long long d = dest[q];
  if (d < 0 || d >= cap) return;  // dropped
  const long long row = q / C.k, k = q - row * C.k;
  for (int j = 0; j < C.n; ++j) {
    const Column& col = C.c[j];
    const long long off = row * col.s0 + k * col.s1;
    if (col.bytes == 4)
      put<4>(col, off, d);
    else if (col.bytes == 8)
      put<8>(col, off, d);
    else
      put<1>(col, off, d);
  }
}

}  // namespace

// n_cols columns: dst (device, the ledger's), src (device, or null for a fill),
// strides (2 a column: the element strides of the candidates' [rows, k] view),
// bytes (1, 4 or 8 a column) and fills (a column's fill bytes); host arrays. k:
// candidates a row; dest: n int64 destinations (device), capacity meaning
// dropped; stream: the CUDA stream. Returns cudaGetLastError() after the launch,
// -1 for a column count or width the kernel does not take.
extern "C" int jb_insert_launch(int n_cols, void* const* dst, const void* const* src,
                                const long long* strides, const int* bytes,
                                const unsigned long long* fills, long long k,
                                const void* dest, long long n, long long cap, void* stream) {
  if (n_cols < 1 || n_cols > kMaxColumns || k < 1) return -1;
  Columns C;
  std::memset(&C, 0, sizeof(C));
  C.n = n_cols;
  C.k = k;
  for (int j = 0; j < n_cols; ++j) {
    if (bytes[j] != 1 && bytes[j] != 4 && bytes[j] != 8) return -1;
    C.c[j] = Column{(char*)dst[j], (const char*)src[j], strides[2 * j], strides[2 * j + 1],
                    bytes[j], fills[j]};
  }
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    insert_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        C, (const long long*)dest, n, cap);
  }
  return (int)cudaGetLastError();
}
