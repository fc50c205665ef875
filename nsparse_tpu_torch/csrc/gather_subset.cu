// K5: planned gather over a list of units,
//   out[p] = (0 <= idx[p] < n_src ? src[idx[p]] : 0) * other[p]
// for every slot p of the units listed in ids (unit = `unit` consecutive
// slots); other[p] counts as 0 past n_other and as 1 when other is null.
// Slots of units not listed are left as they are (the JAX output is
// aliased the same way).
//
// Replaces gather_pallas.gather_subset_window (pallas_call :283) and
// gather_subset_band (via _subset_call, pallas_call :164), which
// flat_gather launches once per class of its plan.  The TPU has no vector
// gather, so those kernels DMA the class's window [base, base + W) into
// VMEM and select each slot's value by a scan of lane rolls: O(W) steps a
// tile.  Hopper gathers in hardware, so each slot's src[idx[p]] is read
// straight from global memory, the bases go unused, and every class is
// the same gather: flat_gather lists the units of all its classes (8,192
// slots each) and launches this kernel once.
//
// No shared-memory staging of a window class's [base, base + W): on the
// card's paths every source fits in the 50 MB L2 (R-MAT-20's x is 4 MB in
// f32, 8 MB in f64), so a staged window would add W reads per subtile and
// no reuse beyond what L2 already gives.
//
// Bound: device memory.  Per slot it reads a 4-byte index and one `other`
// value and writes one value; it reads each distinct src value it names.
// Design: one block per listed unit, 32-bit offsets within it.  Where the
// unit is whole 16-byte vectors and idx, out and other are 16-byte
// aligned, a thread takes 4 consecutive slots per step and holds kVecPer
// steps at once: 16-byte loads of the indices, all their src loads issued
// together through the read-only path, a 16-byte load of `other` and a
// 16-byte store (two in f64), neighbouring threads on neighbouring
// addresses.  Whether `other` is given is a template parameter.  Any other
// unit or view takes the scalar loop, a slot per thread per step.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // scalar loop
constexpr int kVecPer = 2;        // 4-slot steps a thread holds at once
constexpr int kMaxVecThreads = 256;

template <typename T>
__device__ __forceinline__ T src_value(const T* __restrict__ src,
                                       int64_t n_src, int32_t j) {
  return (j >= 0 && j < n_src) ? __ldg(src + j) : T(0);
}

template <typename T, bool kOther>
__global__ void gather_subset_kernel(const T* __restrict__ src, int64_t n_src,
                                     const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ ids, int unit,
                                     const T* __restrict__ other,
                                     int64_t n_other, T* __restrict__ out) {
  // one block per listed unit
  const int64_t base = static_cast<int64_t>(ids[blockIdx.x]) * unit;
#pragma unroll 4
  for (int k = threadIdx.x; k < unit; k += blockDim.x) {
    const int64_t p = base + k;
    T v = src_value(src, n_src, __ldg(idx + p));
    if (kOther) v *= (p < n_other) ? __ldg(other + p) : T(0);
    out[p] = v;
  }
}

template <typename T, bool kOther>
__global__ void gather_subset_vec_kernel(
    const T* __restrict__ src, int64_t n_src, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ ids, int unit, const T* __restrict__ other,
    int64_t n_other, T* __restrict__ out) {
  // one block per listed unit of whole 16-byte vectors
  const int64_t base = static_cast<int64_t>(ids[blockIdx.x]) * unit;
  const int32_t* ib = idx + base;
  T* ob = out + base;
  const T* oth = kOther ? other + base : nullptr;
  int o_len = 0;  // slots of this unit that `other` reaches
  if (kOther) {
    const int64_t rest = n_other - base;
    o_len = rest <= 0 ? 0 : (rest >= unit ? unit : static_cast<int>(rest));
  }
  const int stride = 4 * blockDim.x;
  for (int k0 = 4 * threadIdx.x; k0 < unit; k0 += kVecPer * stride) {
    int4 j[kVecPer];
#pragma unroll
    for (int u = 0; u < kVecPer; ++u) {
      const int k = k0 + u * stride;
      j[u] = k < unit ? __ldg(reinterpret_cast<const int4*>(ib + k))
                      : make_int4(-1, -1, -1, -1);
    }
    T v[kVecPer][4];
#pragma unroll
    for (int u = 0; u < kVecPer; ++u) {
      v[u][0] = src_value(src, n_src, j[u].x);
      v[u][1] = src_value(src, n_src, j[u].y);
      v[u][2] = src_value(src, n_src, j[u].z);
      v[u][3] = src_value(src, n_src, j[u].w);
    }
#pragma unroll
    for (int u = 0; u < kVecPer; ++u) {
      const int k = k0 + u * stride;
      if (k >= unit) continue;
      if (kOther) {
        T o[4];
        if (k + 4 <= o_len) {
          nsp::load4(oth + k, o);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[e] = k + e < o_len ? __ldg(oth + k + e) : T(0);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) v[u][e] *= o[e];
      }
      nsp::store4(ob + k, v[u]);
    }
  }
}

template <typename T, bool kOther>
void dispatch(const T* src, int64_t n_src, const int32_t* idx,
              const int32_t* ids, unsigned int n_ids, int unit,
              const T* other, int64_t n_other, T* out, bool vec,
              cudaStream_t s) {
  if (vec) {
    // kVecPer 4-slot steps a thread, whole warps, at most kMaxVecThreads
    int threads = (unit / 4 + kVecPer - 1) / kVecPer;
    threads = (threads + 31) / 32 * 32;
    if (threads > kMaxVecThreads) threads = kMaxVecThreads;
    gather_subset_vec_kernel<T, kOther>
        <<<n_ids, static_cast<unsigned int>(threads), 0, s>>>(
            src, n_src, idx, ids, unit, other, n_other, out);
  } else {
    gather_subset_kernel<T, kOther><<<n_ids, kThreads, 0, s>>>(
        src, n_src, idx, ids, unit, other, n_other, out);
  }
}

template <typename T>
int launch_gather_subset(const void* src, int64_t n_src, const void* idx,
                         const void* ids, int64_t n_ids, int64_t unit,
                         const void* other, int64_t n_other, void* out,
                         void* stream) {
  if (n_ids < 0 || n_ids > INT_MAX || unit < 0 || unit > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_ids > 0 && unit > 0) {
    const bool vec = unit % 4 == 0 && nsp::aligned16(idx) &&
                     nsp::aligned16(out) &&
                     (other == nullptr || nsp::aligned16(other));
    const auto* sv = static_cast<const T*>(src);
    const auto* iv = static_cast<const int32_t*>(idx);
    const auto* uv = static_cast<const int32_t*>(ids);
    const auto* ov = static_cast<const T*>(other);
    auto* out_v = static_cast<T*>(out);
    const auto grid = static_cast<unsigned int>(n_ids);
    const auto u = static_cast<int>(unit);
    const auto s = nsp::as_stream(stream);
    if (other != nullptr) {
      dispatch<T, true>(sv, n_src, iv, uv, grid, u, ov, n_other, out_v, vec,
                        s);
    } else {
      dispatch<T, false>(sv, n_src, iv, uv, grid, u, ov, 0, out_v, vec, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_gather_subset_f32(const void* src, int64_t n_src,
                                     const void* idx, const void* ids,
                                     int64_t n_ids, int64_t unit,
                                     const void* other, int64_t n_other,
                                     void* out, void* stream) {
  return launch_gather_subset<float>(src, n_src, idx, ids, n_ids, unit, other,
                                     n_other, out, stream);
}

NSP_EXPORT int nsp_gather_subset_f64(const void* src, int64_t n_src,
                                     const void* idx, const void* ids,
                                     int64_t n_ids, int64_t unit,
                                     const void* other, int64_t n_other,
                                     void* out, void* stream) {
  return launch_gather_subset<double>(src, n_src, idx, ids, n_ids, unit,
                                      other, n_other, out, stream);
}
