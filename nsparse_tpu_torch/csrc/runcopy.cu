// K4: plan-listed run copies, in two modes.
//
// Fixed destinations.  For each run r:
//   out[dst[r] : dst[r] + len[r]] = src[src_off[r] : src_off[r] + len[r]];
// every output slot no run covers is 0.  Runs are sorted by dst and
// disjoint (the host checks both), so their ends ascend too.
//
// K-fold (the TPU's variable mode; destinations chosen by the planner).
// For each run r and p < len[r]:
//   out[dst[r] + p] = sum_{t < kfac[r]} src[src_off[r] + t * stride[r] + p],
// the terms added in t order from 0 (the plain version adds them in the
// same order, so the two agree bit for bit); every other slot is 0.
//
// Replaces runcopy.runcopy in fixed-destination mode (_rc_mspan_call and
// _rc_class_call over the CLASS_LIST_FIXED classes, plus scatter_tiles for
// dense tiles).  On the TPU a run is copied as phase-matched (8, 128)
// slices staged through VMEM; here a run is a contiguous copy.
//
// Bound: device memory — 2 x n_out values moved (8.9M on R-MAT-14), run
// descriptors negligible.  Design: one block per 2048-slot output tile;
// the block binary-searches the first run that reaches into its tile, then
// walks the runs in order, zero-filling the gaps and copying each overlap
// with consecutive threads on consecutive slots, so every slot is written
// exactly once with coalesced reads and writes.  The K-fold mode walks the
// runs the same way and reads kfac values per slot (runs come grouped by
// kfac, so a warp's loop counts agree); it replaces _rc_class_call over
// the (K, J, SUB) classes of CLASS_LIST, which staged K source blocks per
// piece through VMEM.  Bound: the K sub-runs read once and the output
// written once (2^24 slots in chip_smoke.py's K-fold phase).
#include "common.cuh"

namespace {

constexpr int kTile = 2048;
constexpr int kThreads = 256;

template <typename T>
__global__ void runcopy_kernel(const T* __restrict__ src,
                               const int32_t* __restrict__ src_off,
                               const int32_t* __restrict__ dst,
                               const int32_t* __restrict__ len,
                               int64_t n_runs, T* __restrict__ out,
                               int64_t n_out) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t t1 = t0 + kTile < n_out ? t0 + kTile : n_out;
  int64_t lo = 0, hi = n_runs;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(dst[mid]) + len[mid] > t0) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int64_t cur = t0;
  for (int64_t r = lo; r < n_runs && dst[r] < t1; ++r) {
    const int64_t d0 = dst[r];
    const int64_t s = d0 > t0 ? d0 : t0;
    const int64_t e = d0 + len[r] < t1 ? d0 + len[r] : t1;
    for (int64_t i = cur + threadIdx.x; i < s; i += blockDim.x) out[i] = T(0);
    const int64_t shift = static_cast<int64_t>(src_off[r]) - d0;
    for (int64_t i = s + threadIdx.x; i < e; i += blockDim.x) {
      out[i] = src[i + shift];
    }
    if (e > cur) cur = e;
  }
  for (int64_t i = cur + threadIdx.x; i < t1; i += blockDim.x) out[i] = T(0);
}

template <typename T>
int launch_runcopy(const void* src, const void* src_off, const void* dst,
                   const void* len, int64_t n_runs, void* out, int64_t n_out,
                   void* stream) {
  if (n_out > 0) {
    runcopy_kernel<T><<<nsp::blocks_for(n_out, kTile), kThreads, 0,
                        nsp::as_stream(stream)>>>(
        static_cast<const T*>(src), static_cast<const int32_t*>(src_off),
        static_cast<const int32_t*>(dst), static_cast<const int32_t*>(len),
        n_runs, static_cast<T*>(out), n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void runcopy_kfold_kernel(const T* __restrict__ src,
                                     const int32_t* __restrict__ src_off,
                                     const int32_t* __restrict__ dst,
                                     const int32_t* __restrict__ len,
                                     const int32_t* __restrict__ kfac,
                                     const int32_t* __restrict__ stride,
                                     int64_t n_runs, T* __restrict__ out,
                                     int64_t n_out) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t t1 = t0 + kTile < n_out ? t0 + kTile : n_out;
  int64_t lo = 0, hi = n_runs;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(dst[mid]) + len[mid] > t0) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int64_t cur = t0;
  for (int64_t r = lo; r < n_runs && dst[r] < t1; ++r) {
    const int64_t d0 = dst[r];
    const int64_t s = d0 > t0 ? d0 : t0;
    const int64_t e = d0 + len[r] < t1 ? d0 + len[r] : t1;
    for (int64_t i = cur + threadIdx.x; i < s; i += blockDim.x) out[i] = T(0);
    const int64_t shift = static_cast<int64_t>(src_off[r]) - d0;
    const int k = kfac[r];
    const int64_t step = stride[r];
    for (int64_t i = s + threadIdx.x; i < e; i += blockDim.x) {
      T acc = T(0);
      for (int t = 0; t < k; ++t) acc += src[i + shift + t * step];
      out[i] = acc;
    }
    if (e > cur) cur = e;
  }
  for (int64_t i = cur + threadIdx.x; i < t1; i += blockDim.x) out[i] = T(0);
}

}  // namespace

NSP_EXPORT int nsp_runcopy_kfold_f32(const void* src, const void* src_off,
                                     const void* dst, const void* len,
                                     const void* kfac, const void* stride,
                                     int64_t n_runs, void* out, int64_t n_out,
                                     void* stream) {
  if (n_out > 0) {
    runcopy_kfold_kernel<float><<<nsp::blocks_for(n_out, kTile), kThreads, 0,
                                  nsp::as_stream(stream)>>>(
        static_cast<const float*>(src), static_cast<const int32_t*>(src_off),
        static_cast<const int32_t*>(dst), static_cast<const int32_t*>(len),
        static_cast<const int32_t*>(kfac),
        static_cast<const int32_t*>(stride), n_runs,
        static_cast<float*>(out), n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

NSP_EXPORT int nsp_runcopy_f32(const void* src, const void* src_off,
                               const void* dst, const void* len,
                               int64_t n_runs, void* out, int64_t n_out,
                               void* stream) {
  return launch_runcopy<float>(src, src_off, dst, len, n_runs, out, n_out,
                               stream);
}

NSP_EXPORT int nsp_runcopy_f64(const void* src, const void* src_off,
                               const void* dst, const void* len,
                               int64_t n_runs, void* out, int64_t n_out,
                               void* stream) {
  return launch_runcopy<double>(src, src_off, dst, len, n_runs, out, n_out,
                                stream);
}
