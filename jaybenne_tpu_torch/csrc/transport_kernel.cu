// The float32 census: the thirty-six float32 instantiations of the census kernel
// (transport_kernel.cuh, whose head describes it) and their C entries.
#include "transport_kernel.cuh"

extern "C" int jb_transport_launch(int ndim, int absorb, int ddmc, int smr, int nongray,
                                   void* const* ptrs, const void* table,
                                   const void* const* cols, const void* block_table,
                                   const void* levels, const void* lookup, int capacity,
                                   const int* igeom, const float* fgeom, int n_shards,
                                   const int* shards, const void* seeds, const void* go,
                                   int spread, int grid, int width, void* events, void* iters,
                                   int zeroed, void* stream) {
  return launch_entry<float>(ndim, absorb, ddmc, smr, nongray, ptrs, table, cols, block_table,
                             levels, lookup, capacity, igeom, fgeom, n_shards, shards, seeds, go,
                             spread, grid, width, events, iters, zeroed, stream);
}

extern "C" int jb_transport_occupancy(int ndim, int absorb, int ddmc, int smr, int nongray,
                                      int* blocks, int* rounds) {
  return occupancy_entry<float>(ndim, absorb, ddmc, smr, nongray, blocks, rounds);
}
