// Shared definitions of the port's Hopper kernels.
//
// Every kernel is exported through a plain C entry point (loaded with
// ctypes by nsparse_tpu_torch/ops/kernels/cuda_lib.py): pointers and the
// stream arrive as void*, the entry launches on that stream, never
// synchronises or allocates, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.  Each kernel is instantiated for
// float and double, but for K4's K-fold mode, which sums (float only, as
// on the TPU).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NSP_EXPORT extern "C" __attribute__((visibility("default")))

namespace nsp {

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

inline unsigned int blocks_for(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Four consecutive values as 16-byte vectors (one float4, or two
// double2): p must be 16-byte aligned.  load4 reads through the read-only
// path.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

}  // namespace nsp
