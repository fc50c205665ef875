// K1: planned gather, out[i] = x[idx[i]] (0 where idx[i] is outside x,
// negative indices included).
//
// Replaces the TPU's routed permutation shuffle_pallas.planned_shuffle (a
// 3-stage slack-Clos of Benes roll/select passes, _benes_call).  The TPU
// has no vector gather, so it routed every permutation through log-depth
// networks; Hopper gathers in hardware, so the plan keeps plain indices
// and one pass moves each element once.  (The per-tile permutation,
// shuffle_pallas.tile_benes_apply, is read inside K3, fused_class.cu.)
//
// Bound: device memory.  Per output it reads a 4-byte index and writes one
// value; it reads each distinct x value its indices name.  The value
// reads follow the permutation and are scattered, served from L2.  Design:
// where idx and out are 16-byte aligned, a thread takes kVecPer vectors of
// 4 consecutive outputs: one int4 load of 4 indices each, then all their
// value loads issued together through the read-only path (8 in flight),
// then 16-byte stores (one float4, or two double2), neighbouring threads
// on neighbouring vectors.  The last n % 4 outputs take a scalar step in
// the last block of the same launch.  A misaligned idx or out takes the
// scalar kernel, one output per thread.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecPer = 2;  // 4-output vectors a thread holds at once

template <typename T>
__device__ __forceinline__ T value_at(const T* __restrict__ x, int64_t n_x,
                                      int32_t j) {
  return (j >= 0 && j < n_x) ? __ldg(x + j) : T(0);
}

template <typename T>
__global__ void gather_kernel(const T* __restrict__ x, int64_t n_x,
                              const int32_t* __restrict__ idx,
                              T* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = value_at(x, n_x, __ldg(idx + i));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_vec_kernel(const T* __restrict__ x, int64_t n_x,
                  const int32_t* __restrict__ idx, T* __restrict__ out,
                  int64_t n) {
  const int64_t n4 = n / 4;
  const int64_t v0 =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kVecPer) + threadIdx.x;
  int4 j[kVecPer];
#pragma unroll
  for (int u = 0; u < kVecPer; ++u) {
    const int64_t v = v0 + u * kThreads;
    j[u] = v < n4 ? __ldg(reinterpret_cast<const int4*>(idx) + v)
                  : make_int4(-1, -1, -1, -1);
  }
  T val[kVecPer][4];
#pragma unroll
  for (int u = 0; u < kVecPer; ++u) {
    val[u][0] = value_at(x, n_x, j[u].x);
    val[u][1] = value_at(x, n_x, j[u].y);
    val[u][2] = value_at(x, n_x, j[u].z);
    val[u][3] = value_at(x, n_x, j[u].w);
  }
#pragma unroll
  for (int u = 0; u < kVecPer; ++u) {
    const int64_t v = v0 + u * kThreads;
    if (v < n4) nsp::store4(out + 4 * v, val[u]);
  }
  // the tail of n % 4 outputs
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - 4 * n4) {
    const int64_t i = 4 * n4 + threadIdx.x;
    out[i] = value_at(x, n_x, __ldg(idx + i));
  }
}

template <typename T>
int launch_gather(const void* x, int64_t n_x, const void* idx, void* out,
                  int64_t n, void* stream) {
  if (n > 0) {
    const auto* xv = static_cast<const T*>(x);
    const auto* iv = static_cast<const int32_t*>(idx);
    auto* ov = static_cast<T*>(out);
    const auto s = nsp::as_stream(stream);
    if (nsp::aligned16(idx) && nsp::aligned16(out)) {
      const int64_t blocks = (n / 4 + kThreads * kVecPer - 1) /
                             (kThreads * kVecPer);
      gather_vec_kernel<T><<<blocks > 0 ? static_cast<unsigned int>(blocks)
                                        : 1u,
                             kThreads, 0, s>>>(xv, n_x, iv, ov, n);
    } else {
      gather_kernel<T><<<nsp::blocks_for(n, kThreads), kThreads, 0, s>>>(
          xv, n_x, iv, ov, n);
    }
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
