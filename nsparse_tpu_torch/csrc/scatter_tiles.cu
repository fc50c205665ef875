// K6: tile-granular scatter in place,
//   dst[ids[i] * tile + j] = vals[i * tile + j],  j < tile.
//
// Replaces gather_pallas.scatter_tiles (pallas_call :401), which patches
// the fallback tiles' values into flat_gather's output: one grid step per
// tile, the destination block chosen by a scalar-prefetched index map
// over an aliased output.  Here one block moves one tile.
//
// Bound: device memory, a pure copy: per value one read and one write
// (plus one 4-byte tile id per tile).  f64 moves natively; the TPU split
// it into two uint32 planes.  Design (K12's): where a tile is whole
// 16-byte vectors and both dst and vals are 16-byte aligned (every
// caller's 1024-value tiles), each thread issues its kVecPer vector loads
// before any store, neighbouring threads on neighbouring addresses, so a
// block keeps its whole tile in flight with few threads and many blocks
// fit an SM.  Any other tile or view takes the scalar loop.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;    // scalar loop
constexpr int kVecPer = 4;       // 16-byte vectors a thread holds at once
constexpr int kMaxVecThreads = 256;

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

__global__ void scatter_tiles_vec_kernel(uint4* __restrict__ dst,
                                         const int32_t* __restrict__ ids,
                                         const uint4* __restrict__ vals,
                                         int64_t tile_vecs) {
  // one block per tile of tile_vecs 16-byte vectors
  uint4* d = dst + static_cast<int64_t>(ids[blockIdx.x]) * tile_vecs;
  const uint4* v = vals + static_cast<int64_t>(blockIdx.x) * tile_vecs;
  const int64_t step = static_cast<int64_t>(kVecPer) * blockDim.x;
  for (int64_t base = threadIdx.x; base < tile_vecs; base += step) {
    uint4 r[kVecPer];
#pragma unroll
    for (int u = 0; u < kVecPer; ++u) {
      const int64_t k = base + static_cast<int64_t>(u) * blockDim.x;
      if (k < tile_vecs) r[u] = v[k];
    }
#pragma unroll
    for (int u = 0; u < kVecPer; ++u) {
      const int64_t k = base + static_cast<int64_t>(u) * blockDim.x;
      if (k < tile_vecs) d[k] = r[u];
    }
  }
}

template <typename T>
int launch_scatter_tiles(void* dst, const void* ids, int64_t n_ids,
                         const void* vals, int64_t tile, void* stream) {
  if (n_ids > 0 && tile > 0) {
    const auto grid = static_cast<unsigned int>(n_ids);
    const auto s = nsp::as_stream(stream);
    const int64_t bytes = tile * static_cast<int64_t>(sizeof(T));
    if (bytes % sizeof(uint4) == 0 && nsp::aligned16(dst) &&
        nsp::aligned16(vals)) {
      const int64_t tile_vecs = bytes / sizeof(uint4);
      // kVecPer vectors a thread, whole warps, at most kMaxVecThreads
      int64_t threads = (tile_vecs + kVecPer - 1) / kVecPer;
      threads = (threads + 31) / 32 * 32;
      if (threads > kMaxVecThreads) threads = kMaxVecThreads;
      scatter_tiles_vec_kernel<<<grid, static_cast<unsigned int>(threads), 0,
                                 s>>>(
          static_cast<uint4*>(dst), static_cast<const int32_t*>(ids),
          static_cast<const uint4*>(vals), tile_vecs);
    } else {
      scatter_tiles_kernel<T><<<grid, kThreads, 0, s>>>(
          static_cast<T*>(dst), static_cast<const int32_t*>(ids),
          static_cast<const T*>(vals), tile);
    }
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
