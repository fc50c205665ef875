// K1: planned gather, out[i] = x[idx[i]] (0 where idx[i] is outside x).
//
// Replaces the TPU's routed permutation shuffle_pallas.planned_shuffle (a
// 3-stage slack-Clos of Benes roll/select passes, _benes_call).  The TPU
// has no vector gather, so it routed every permutation through log-depth
// networks; Hopper gathers in hardware, so the plan keeps plain indices
// and one pass moves each element once.  (The per-tile permutation,
// shuffle_pallas.tile_benes_apply, is read inside K3, fused_class.cu.)
//
// Bound: device memory.  Per output it reads a 4-byte index and one value
// and writes one value.  Design: one thread per output, so index reads and
// value writes are coalesced; the value reads follow the permutation and
// are scattered (the fallback pool's shuffles), served from L2.
#include "common.cuh"

namespace {

template <typename T>
__global__ void gather_kernel(const T* __restrict__ x, int64_t n_x,
                              const int32_t* __restrict__ idx,
                              T* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t j = idx[i];
  out[i] = (j >= 0 && j < n_x) ? x[j] : T(0);
}

template <typename T>
int launch_gather(const void* x, int64_t n_x, const void* idx, void* out,
                  int64_t n, void* stream) {
  constexpr int kThreads = 256;
  if (n > 0) {
    gather_kernel<T><<<nsp::blocks_for(n, kThreads), kThreads, 0,
                       nsp::as_stream(stream)>>>(
        static_cast<const T*>(x), n_x, static_cast<const int32_t*>(idx),
        static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_gather_f32(const void* x, int64_t n_x, const void* idx,
                              void* out, int64_t n, void* stream) {
  return launch_gather<float>(x, n_x, idx, out, n, stream);
}

NSP_EXPORT int nsp_gather_f64(const void* x, int64_t n_x, const void* idx,
                              void* out, int64_t n, void* stream) {
  return launch_gather<double>(x, n_x, idx, out, n, stream);
}

NSP_EXPORT const char* nsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
