// K12: tile gather, out tile i = src tile ids[i], tiles of 1024 values
// (a zero tile where ids[i] is outside src).
//
// Replaces gather_pallas.gather_tiles8, which restored the piece
// expansion's class-major compact buffer to arena order with eight
// scalar-prefetch-indexed (8, 128) input blocks per grid step.  Here one
// block moves one tile.
//
// Bound: device memory, a pure copy — per output tile one 4-byte id, one
// tile read and one tile written (2 x 4 KB in f32; about 8.2 MB for the
// 1,006 tiles of R-MAT-14's fallback pool).  Design: 16-byte loads and
// stores (a tile is 256 of them in f32, 512 in f64), neighbouring threads
// on neighbouring addresses; the wrapper checks the 16-byte alignment.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;

template <typename T>
__global__ void gather_tiles8_kernel(const T* __restrict__ src,
                                     int64_t n_src_tiles,
                                     const int32_t* __restrict__ ids,
                                     T* __restrict__ out) {
  constexpr int kVecs = kTile * sizeof(T) / sizeof(uint4);
  const int64_t i = blockIdx.x;
  const int32_t id = ids[i];
  uint4* o = reinterpret_cast<uint4*>(out + i * kTile);
  if (id < 0 || id >= n_src_tiles) {
    for (int k = threadIdx.x; k < kVecs; k += blockDim.x) {
      o[k] = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const uint4* s =
      reinterpret_cast<const uint4*>(src + static_cast<int64_t>(id) * kTile);
  for (int k = threadIdx.x; k < kVecs; k += blockDim.x) o[k] = s[k];
}

template <typename T>
int launch_gather_tiles8(const void* src, int64_t n_src_tiles, const void* ids,
                         int64_t n_ids, void* out, void* stream) {
  constexpr int kThreads = 256;
  if (n_ids > 0) {
    gather_tiles8_kernel<T><<<static_cast<unsigned int>(n_ids), kThreads, 0,
                              nsp::as_stream(stream)>>>(
        static_cast<const T*>(src), n_src_tiles,
        static_cast<const int32_t*>(ids), static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_gather_tiles8_f32(const void* src, int64_t n_src_tiles,
                                     const void* ids, int64_t n_ids, void* out,
                                     void* stream) {
  return launch_gather_tiles8<float>(src, n_src_tiles, ids, n_ids, out, stream);
}

NSP_EXPORT int nsp_gather_tiles8_f64(const void* src, int64_t n_src_tiles,
                                     const void* ids, int64_t n_ids, void* out,
                                     void* stream) {
  return launch_gather_tiles8<double>(src, n_src_tiles, ids, n_ids, out,
                                      stream);
}
