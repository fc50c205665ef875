// K2: product expansion in arena order.
//
// For run r covering [run_start[r], run_start[r+1]):
//   out[run_start[r] + i] = a_val[aidx[r]] * b_val[b_start[r] + i]  for i < live_len[r]
//                         = 0                                        otherwise
// Gap runs (window slack, padding windows) have live_len 0.
//
// Replaces piecewise.piecewise_expand (_make_pw_kern through
// _pw_class_call), with the gathers that fed it on the TPU: build_bank's
// pre-rolled 8-aligned B tables, gather_tiles8 (class-major -> arena
// order), scatter_tiles (dense-tile fallback) and the flat_gather of
// per-piece A values.  The TPU needed all of these because it can only
// move aligned (8, 128) slices; here a run reads its B row straight from
// b_val and writes arena order directly.
//
// Bound: device memory — one product written per slot (23M slots on
// R-MAT-14), B rows read once per A entry.  Design: one warp per run, so
// the warp's B reads and output writes are both contiguous; the run
// descriptors are read once per warp, not once per slot.
#include "common.cuh"

namespace {

template <typename T>
__global__ void expand_kernel(const T* __restrict__ a_val,
                              const T* __restrict__ b_val,
                              const int32_t* __restrict__ run_start,
                              const int32_t* __restrict__ b_start,
                              const int32_t* __restrict__ live_len,
                              const int32_t* __restrict__ aidx,
                              int64_t n_runs, T* __restrict__ out) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_runs) return;
  const int64_t s = run_start[r];
  const int32_t len = static_cast<int32_t>(run_start[r + 1] - s);
  const int32_t live = live_len[r];
  const T av = live > 0 ? a_val[aidx[r]] : T(0);
  const int64_t b0 = b_start[r];
  for (int32_t i = lane; i < len; i += 32) {
    out[s + i] = i < live ? av * b_val[b0 + i] : T(0);
  }
}

template <typename T>
int launch_expand(const void* a_val, const void* b_val, const void* run_start,
                  const void* b_start, const void* live_len, const void* aidx,
                  int64_t n_runs, void* out, void* stream) {
  constexpr int kThreads = 256;  // 8 runs per block
  if (n_runs > 0) {
    expand_kernel<T><<<nsp::blocks_for(n_runs * 32, kThreads), kThreads, 0,
                       nsp::as_stream(stream)>>>(
        static_cast<const T*>(a_val), static_cast<const T*>(b_val),
        static_cast<const int32_t*>(run_start),
        static_cast<const int32_t*>(b_start),
        static_cast<const int32_t*>(live_len),
        static_cast<const int32_t*>(aidx), n_runs, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_expand_f32(const void* a_val, const void* b_val,
                              const void* run_start, const void* b_start,
                              const void* live_len, const void* aidx,
                              int64_t n_runs, void* out, void* stream) {
  return launch_expand<float>(a_val, b_val, run_start, b_start, live_len,
                              aidx, n_runs, out, stream);
}

NSP_EXPORT int nsp_expand_f64(const void* a_val, const void* b_val,
                              const void* run_start, const void* b_start,
                              const void* live_len, const void* aidx,
                              int64_t n_runs, void* out, void* stream) {
  return launch_expand<double>(a_val, b_val, run_start, b_start, live_len,
                               aidx, n_runs, out, stream);
}
