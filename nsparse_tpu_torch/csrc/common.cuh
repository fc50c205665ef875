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

}  // namespace nsp
