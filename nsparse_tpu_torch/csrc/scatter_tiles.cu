// K6: tile-granular scatter in place,
//   dst[ids[i] * tile + j] = vals[i * tile + j],  j < tile.
//
// Replaces gather_pallas.scatter_tiles (pallas_call :401), which patches
// the fallback tiles' values into flat_gather's output: one grid step per
// tile, the destination block chosen by a scalar-prefetched index map
// over an aliased output.  Here one block moves one tile, its threads
// striding over the tile's `tile` consecutive values on both sides, so
// reads and writes coalesce.
//
// Bound: device memory, a pure copy: per value one read and one write
// (plus one 4-byte tile id per tile).  f64 moves natively; the TPU split
// it into two uint32 planes.
#include "common.cuh"

namespace {

template <typename T>
__global__ void scatter_tiles_kernel(T* __restrict__ dst,
                                     const int32_t* __restrict__ ids,
                                     const T* __restrict__ vals,
                                     int64_t tile) {
  // one block per tile
  T* d = dst + static_cast<int64_t>(ids[blockIdx.x]) * tile;
  const T* v = vals + static_cast<int64_t>(blockIdx.x) * tile;
#pragma unroll 4
  for (int64_t k = threadIdx.x; k < tile; k += blockDim.x) d[k] = v[k];
}

template <typename T>
int launch_scatter_tiles(void* dst, const void* ids, int64_t n_ids,
                         const void* vals, int64_t tile, void* stream) {
  constexpr int kThreads = 256;
  if (n_ids > 0 && tile > 0) {
    scatter_tiles_kernel<T><<<static_cast<unsigned int>(n_ids), kThreads, 0,
                              nsp::as_stream(stream)>>>(
        static_cast<T*>(dst), static_cast<const int32_t*>(ids),
        static_cast<const T*>(vals), tile);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_scatter_tiles_f32(void* dst, const void* ids, int64_t n_ids,
                                     const void* vals, int64_t tile,
                                     void* stream) {
  return launch_scatter_tiles<float>(dst, ids, n_ids, vals, tile, stream);
}

NSP_EXPORT int nsp_scatter_tiles_f64(void* dst, const void* ids, int64_t n_ids,
                                     const void* vals, int64_t tile,
                                     void* stream) {
  return launch_scatter_tiles<double>(dst, ids, n_ids, vals, tile, stream);
}
