// K2: product expansion, in two modes.
//
// Run form (the v1 window numeric).  For run r covering
// [run_start[r], run_start[r+1]):
//   out[run_start[r] + i] = a_val[aidx[r]] * b_val[b_start[r] + i]  for i < live_len[r]
//                         = 0                                        otherwise
// Gap runs (window slack, padding windows) have live_len 0.
//
// Piece mode (the v2 numeric's fallback pool, the global slab layout).
// Per 1024-slot subtile i of one piece-budget class (J pieces, cuts
// non-decreasing):
//   out[i * 1024 + p] = src[boffs[i, j] * row_scale + p] * apv[i, j]
// for the last piece j with cuts[i, j] <= p, 0 if there is none.  In the
// aligned mode (row_scale 128) src is the pre-rolled bank of the 8-aligned
// B table (build_bank.cu) and boffs are bank-row codes; in the flat mode
// (row_scale 1, the TPU's unaligned mode, for tables past its bank limit)
// src is that table itself behind its zero bias and boffs are offsets.
// apv holds the per-piece A values (one K1 gather).  The subtiles land in
// the class's slice of the class-major compact buffer; gather_tiles8.cu
// restores arena order.
//
// Replaces piecewise.piecewise_expand (_make_pw_kern through
// _pw_class_call): the run form for the v1 numeric, where the TPU also
// went through build_bank, gather_tiles8, scatter_tiles and a flat_gather
// of per-piece A values because it can only move aligned (8, 128)
// slices, and a run here reads its B row straight from b_val and writes
// arena order; the piece mode keeps the TPU plan's tables, so the v2
// numeric and the global layout run the same route as the JAX package.
// The TPU's unaligned mode realigned each piece with lane rolls; the flat
// mode needs no alignment at all, only the row scale of the source index.
//
// Bound: device memory — one product written per slot (23M slots on
// R-MAT-14 in the run form, 1.03M in the v2 piece mode, 36M in the flat
// mode on R-MAT-16), B rows read once per A entry.  Design: run form, one warp per run, so the warp's B reads
// and output writes are both contiguous and the run descriptors are read
// once per warp; piece mode, one block per subtile, the J pieces staged
// in shared memory and found per slot by binary search over the cuts, the
// bank reads and output writes contiguous across the block's threads.
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

constexpr int kTile = 1024;  // slots per subtile
constexpr int kLanes = 128;  // bank row width
constexpr int kMaxJ = 128;   // piece budget of the largest class

template <typename T>
__global__ void expand_pieces_kernel(const T* __restrict__ bank,
                                     const T* __restrict__ apv,
                                     const int32_t* __restrict__ cuts,
                                     const int32_t* __restrict__ boffs,
                                     int j_budget, int row_scale,
                                     T* __restrict__ out) {
  __shared__ int32_t s_cut[kMaxJ];
  __shared__ int32_t s_boff[kMaxJ];
  __shared__ T s_av[kMaxJ];
  const int64_t sub = blockIdx.x;
  const int64_t q0 = sub * j_budget;
  for (int j = threadIdx.x; j < j_budget; j += blockDim.x) {
    s_cut[j] = cuts[q0 + j];
    s_boff[j] = boffs[q0 + j];
    s_av[j] = apv[q0 + j];
  }
  __syncthreads();
  T* o = out + sub * kTile;
  for (int p = threadIdx.x; p < kTile; p += blockDim.x) {
    int a = 0, b = j_budget;  // a = number of pieces with cut <= p
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (s_cut[mid] <= p) {
        a = mid + 1;
      } else {
        b = mid;
      }
    }
    o[p] = a > 0
               ? bank[static_cast<int64_t>(s_boff[a - 1]) * row_scale + p] *
                     s_av[a - 1]
               : T(0);
  }
}

template <typename T>
int launch_expand_pieces(const void* bank, const void* apv, const void* cuts,
                         const void* boffs, int64_t n_sub, int j_budget,
                         int row_scale, void* out, void* stream) {
  constexpr int kThreads = 256;  // 4 slots per thread
  if (j_budget <= 0 || j_budget > kMaxJ ||
      (row_scale != 1 && row_scale != kLanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_sub > 0) {
    expand_pieces_kernel<T><<<static_cast<unsigned int>(n_sub), kThreads, 0,
                               nsp::as_stream(stream)>>>(
        static_cast<const T*>(bank), static_cast<const T*>(apv),
        static_cast<const int32_t*>(cuts), static_cast<const int32_t*>(boffs),
        j_budget, row_scale, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_expand_pieces_f32(const void* bank, const void* apv,
                                     const void* cuts, const void* boffs,
                                     int64_t n_sub, int j_budget,
                                     int row_scale, void* out, void* stream) {
  return launch_expand_pieces<float>(bank, apv, cuts, boffs, n_sub, j_budget,
                                     row_scale, out, stream);
}

NSP_EXPORT int nsp_expand_pieces_f64(const void* bank, const void* apv,
                                     const void* cuts, const void* boffs,
                                     int64_t n_sub, int j_budget,
                                     int row_scale, void* out, void* stream) {
  return launch_expand_pieces<double>(bank, apv, cuts, boffs, n_sub, j_budget,
                                      row_scale, out, stream);
}

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
