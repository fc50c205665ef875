// K10: windowed gather, out[t, l] = win[t, idx[t, l]] for l < 128, and 0
// where idx[t, l] lies outside [0, window): such an index neither faults
// nor reads outside its row.
//
// Replaces gather_pallas.windowed_gather (pallas_call :465).  The TPU has
// no vector gather, so its kernel builds each output by a roll-scan: one
// lane roll and select per window position, W/128 * 128 passes over the
// tile.  Hopper gathers in hardware, so each output is one read.
//
// Bound: device memory, the 4-byte indices and the outputs once each plus
// the window values the indices name.  Design: 128 threads per row (one
// per output lane) and kRows rows per block, so the index loads and output
// stores of a warp are 32 consecutive values (coalesced); the window reads
// fall inside the row's own max(window, 128) values, one or a few cache
// lines per warp.  Row offsets are int64.
#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 4;

template <typename T>
__global__ void __launch_bounds__(kLanes * kRows)
windowed_gather_kernel(const T* __restrict__ win, int64_t win_cols,
                       const int32_t* __restrict__ idx, int window,
                       int64_t rows, T* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.y;
  if (t >= rows) return;
  const int64_t o = t * kLanes + threadIdx.x;
  const int32_t i = idx[o];
  out[o] = (i >= 0 && i < window) ? win[t * win_cols + i] : T(0);
}

template <typename T>
int launch_windowed_gather(const void* win, int64_t win_cols, const void* idx,
                           int window, int64_t rows, void* out,
                           void* stream) {
  if (rows > 0) {
    windowed_gather_kernel<T><<<nsp::blocks_for(rows, kRows),
                                dim3(kLanes, kRows), 0,
                                nsp::as_stream(stream)>>>(
        static_cast<const T*>(win), win_cols,
        static_cast<const int32_t*>(idx), window, rows, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_windowed_gather_f32(const void* win, int64_t win_cols,
                                       const void* idx, int window,
                                       int64_t rows, void* out, void* stream) {
  return launch_windowed_gather<float>(win, win_cols, idx, window, rows, out,
                                       stream);
}

NSP_EXPORT int nsp_windowed_gather_f64(const void* win, int64_t win_cols,
                                       const void* idx, int window,
                                       int64_t rows, void* out, void* stream) {
  return launch_windowed_gather<double>(win, win_cols, idx, window, rows, out,
                                        stream);
}
