// K10: windowed gather, out[t, l] = win[t, idx[t, l]] for l < 128, and 0
// where idx[t, l] lies outside [0, window): such an index reads nothing.
//
// Replaces gather_pallas.windowed_gather (pallas_call :465).  The TPU has
// no vector gather, so its kernel builds each output by a roll-scan: one
// lane roll and select per window position, W/128 * 128 passes over the
// tile.  Hopper gathers in hardware, so each output is one read.
//
// Bound: device memory, the 4-byte indices and the outputs once each plus
// the window values the indices name.  The card moves 32-byte sectors, so
// 128 random indices into a wide window touch most of the row's sectors
// (about 81 of 128 at 1,024 f32 values): that, not the 4 bytes a value,
// is the floor of a wide window.
//
// Routes, chosen on the host from the window's span in bytes alone
// (tools/k10_variants.py measures them):
//  - Direct (below a 4 KB span): a warp per row.  A lane takes
//    out_per_lane<T>() consecutive outputs per access, 16 bytes of values
//    (turns<T>() accesses cover the row's 128): its index vectors loaded
//    first, then all its window reads issued through the read-only path
//    before any is used, then 16-byte stores.  The row's base pointer is
//    formed once; offsets in the row are int32.  A block holds kWarps
//    rows and an SM as many blocks as fit, so many independent reads are
//    in flight per SM.  Measured and left out: a persistent grid that
//    strides over the rows (slower: its last rows run on few warps),
//    staging the window in shared memory (no faster, even at one line a
//    row) and streaming hints on the indices and outputs (no faster).
//  - Thread (from a 4 KB span): a thread per output, kThreadRows rows a
//    block: the first design, kept where the warp route loses to it.
#include "common.cuh"

namespace {

constexpr int kLanes = 128;  // outputs a row
// outputs a lane takes per access: 16 bytes of values
constexpr int kOutF32 = 4;
constexpr int kOutF64 = 2;
constexpr int kWarps = 8;  // rows a block (direct route)
constexpr int kThreads = 32 * kWarps;
constexpr int kThreadRows = 4;  // rows a block (thread route)

enum Route { kDirect = 0, kThread = 1 };

template <typename T>
__host__ __device__ constexpr int out_per_lane() {
  return sizeof(T) == 4 ? kOutF32 : kOutF64;
}

template <typename T>
__host__ __device__ constexpr int turns() {  // accesses a lane per row
  return kLanes / (32 * out_per_lane<T>());
}

// N indices from p: one vector where idx is 16-byte aligned (kVec).
template <int N, bool kVec>
__device__ __forceinline__ void load_idx(const int32_t* p, int (&j)[N]) {
  if constexpr (kVec && N == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    j[0] = q.x; j[1] = q.y; j[2] = q.z; j[3] = q.w;
  } else if constexpr (kVec && N == 2) {
    const int2 q = *reinterpret_cast<const int2*>(p);
    j[0] = q.x; j[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) j[k] = p[k];
  }
}

// N outputs to p: 16-byte stores where out is 16-byte aligned (kVec).
template <int N, bool kVec>
__device__ __forceinline__ void store_out(float* p, const float (&v)[N]) {
  if constexpr (kVec && N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec && N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}

template <int N, bool kVec>
__device__ __forceinline__ void store_out(double* p, const double (&v)[N]) {
  if constexpr (kVec && N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      *reinterpret_cast<double2*>(p + k) = make_double2(v[k], v[k + 1]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}

__device__ __forceinline__ bool inside(int j, int window) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(window);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
windowed_gather_kernel(const T* __restrict__ win, int64_t win_cols,
                       const int32_t* __restrict__ idx, int window,
                       int64_t rows, T* __restrict__ out) {
  constexpr int kOut = out_per_lane<T>();
  constexpr int kStep = 32 * kOut;  // a warp's outputs per access
  const int lane = threadIdx.x & 31;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= rows) return;
  const T* row = win + t * win_cols;
  const int32_t* ip = idx + t * kLanes + lane * kOut;
  int j[turns<T>()][kOut];
#pragma unroll
  for (int p = 0; p < turns<T>(); ++p) {
    load_idx<kOut, kVec>(ip + p * kStep, j[p]);
  }
  T v[turns<T>()][kOut];
#pragma unroll
  for (int p = 0; p < turns<T>(); ++p) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int jk = j[p][k];
      v[p][k] = inside(jk, window) ? __ldg(row + jk) : T(0);
    }
  }
  T* op = out + t * kLanes + lane * kOut;
#pragma unroll
  for (int p = 0; p < turns<T>(); ++p) {
    store_out<kOut, kVec>(op + p * kStep, v[p]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kThreadRows)
windowed_gather_thread_kernel(const T* __restrict__ win, int64_t win_cols,
                              const int32_t* __restrict__ idx, int window,
                              int64_t rows, T* __restrict__ out) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kThreadRows + threadIdx.y;
  if (t >= rows) return;
  const int64_t o = t * kLanes + threadIdx.x;
  const int j = idx[o];
  out[o] = inside(j, window) ? win[t * win_cols + j] : T(0);
}

template <typename T>
int launch_windowed_gather(const void* win_p, int64_t win_cols,
                           const void* idx_p, int window, int64_t rows,
                           void* out_p, int route, void* stream) {
  if (window < 1 || window > win_cols || rows < 0 ||
      (route != kDirect && route != kThread)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const auto* win = static_cast<const T*>(win_p);
  const auto* idx = static_cast<const int32_t*>(idx_p);
  auto* out = static_cast<T*>(out_p);
  const auto s = nsp::as_stream(stream);
  if (route == kThread) {
    windowed_gather_thread_kernel<T>
        <<<nsp::blocks_for(rows, kThreadRows), dim3(kLanes, kThreadRows), 0,
           s>>>(win, win_cols, idx, window, rows, out);
  } else if (nsp::aligned16(idx) && nsp::aligned16(out)) {
    windowed_gather_kernel<T, true>
        <<<nsp::blocks_for(rows, kWarps), kThreads, 0, s>>>(
            win, win_cols, idx, window, rows, out);
  } else {
    windowed_gather_kernel<T, false>
        <<<nsp::blocks_for(rows, kWarps), kThreads, 0, s>>>(
            win, win_cols, idx, window, rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_windowed_gather_f32(const void* win, int64_t win_cols,
                                       const void* idx, int window,
                                       int64_t rows, void* out, int route,
                                       void* stream) {
  return launch_windowed_gather<float>(win, win_cols, idx, window, rows, out,
                                       route, stream);
}

NSP_EXPORT int nsp_windowed_gather_f64(const void* win, int64_t win_cols,
                                       const void* idx, int window,
                                       int64_t rows, void* out, int route,
                                       void* stream) {
  return launch_windowed_gather<double>(win, win_cols, idx, window, rows, out,
                                        route, stream);
}
