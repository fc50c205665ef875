// K5: planned gather over one class's tile subset,
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
// straight from global memory; the bases go unused.
//
// Bound: device memory.  Per slot it reads a 4-byte index, one `other`
// value and one src value and writes one value.  Design: one block per
// listed unit, its threads striding over the unit's slots, so index,
// other and out are coalesced, and so are the src reads of a band class
// (neighbouring slots read neighbouring sources).  The src reads of a
// window class fall in [base, base + W) per 8x128 subtile: staging that
// window in shared memory, the analog of AMB's column segments, is left
// to a later PR.
#include "common.cuh"

namespace {

template <typename T>
__global__ void gather_subset_kernel(const T* __restrict__ src, int64_t n_src,
                                     const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ ids,
                                     int64_t unit,
                                     const T* __restrict__ other,
                                     int64_t n_other, T* __restrict__ out) {
  // one block per listed unit: no index arithmetic beyond one base
  const int64_t base = static_cast<int64_t>(ids[blockIdx.x]) * unit;
#pragma unroll 4
  for (int64_t k = threadIdx.x; k < unit; k += blockDim.x) {
    const int64_t p = base + k;
    const int32_t j = idx[p];
    T v = (j >= 0 && j < n_src) ? src[j] : T(0);
    if (other != nullptr) v *= (p < n_other) ? other[p] : T(0);
    out[p] = v;
  }
}

template <typename T>
int launch_gather_subset(const void* src, int64_t n_src, const void* idx,
                         const void* ids, int64_t n_ids, int64_t unit,
                         const void* other, int64_t n_other, void* out,
                         void* stream) {
  constexpr int kThreads = 256;
  if (n_ids > 0 && unit > 0) {
    gather_subset_kernel<T><<<static_cast<unsigned int>(n_ids), kThreads, 0,
                              nsp::as_stream(stream)>>>(
        static_cast<const T*>(src), n_src, static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(ids), unit, static_cast<const T*>(other),
        n_other, static_cast<T*>(out));
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
