// The float64 census (precision = f64): the thirty-six double instantiations of the
// census kernel (transport_kernel.cuh) and their C entries, in a translation unit
// of their own, so that nvcc builds them beside the float32 ones.
//
// Replaces the JAX package's float64 census, its XLA event loop
// (jaybenne_tpu/ops/transport.py::_one_event, run by transport): the JAX step sends
// only float32 to Pallas (jaybenne_tpu/step.py:141). Its plain version is
// ops/transport_kernel.py's census at float64. It draws 53-bit uniforms
// (kernel_rng.cuh, Draw<double>) on the float32 census's tags, takes the largest
// and the smallest normal double where the float32 census takes 3e38 and 1e-37,
// and reads a record of four reals as two double2 loads. What bounds it on an
// H100: not bytes, but the double log, cos, exp and divide, each a long dependent
// instruction sequence (log 84 SASS instructions, divide 18), and too few resident
// warps to hide them: the lane's state takes two registers a value, so most
// instantiations hold half the resident blocks of their float32 twins. On a forest
// (stepdiff_smr; stepdiff at 8 spatial shards) the gray lane keeps only its cell's
// record, and so holds 3 and 4 resident blocks (transport_kernel.cuh: kLean;
// measured there): stepdiff_smr's census 3.14 -> 2.50 ms. On a uniform 1D mesh
// (stepdiff, stepdiff_ddmc) the census runs on the card's resident grid in rounds,
// so that its live lanes run on every SM (kRounds; measured there): stepdiff's
// census 1.46 -> 1.18 ms; so does the non-gray census on a 2D forest (stepdiff_smr
// with ep_bremss), whose ledger takes up to four rounds: 0.0590 -> 0.0553 ms.
#include "transport_kernel.cuh"

extern "C" int jb_transport_launch_f64(int ndim, int absorb, int ddmc, int smr, int nongray,
                                       void* const* ptrs, const void* table,
                                       const void* const* cols, const void* block_table,
                                       const void* levels, const void* lookup, int capacity,
                                       const int* igeom, const double* fgeom, int n_shards,
                                       const int* shards, const void* seeds, const void* go,
                                       int spread, int grid, int width, void* events, void* iters,
                                       int zeroed, void* stream) {
  return launch_entry<double>(ndim, absorb, ddmc, smr, nongray, ptrs, table, cols,
                              block_table, levels, lookup, capacity, igeom, fgeom, n_shards,
                              shards, seeds, go, spread, grid, width, events, iters, zeroed,
                              stream);
}

extern "C" int jb_transport_occupancy_f64(int ndim, int absorb, int ddmc, int smr,
                                          int nongray, int* blocks, int* rounds) {
  return occupancy_entry<double>(ndim, absorb, ddmc, smr, nongray, blocks, rounds);
}
