// K2: product expansion, in two modes.
//
// Run form (the v1 window numeric).  For run r covering
// [run_start[r], run_start[r+1]):
//   out[run_start[r] + i] = a_val[aidx[r]] * b_val[b_start[r] + i]  for i < live_len[r]
//                         = 0                                        otherwise
// Gap runs (window slack, padding windows) have live_len 0.
//
// Piece mode (the v2 numeric's fallback pool, the global slab layout).
// Per 1024-slot compact subtile i of a piece-budget class (J pieces, cuts
// non-decreasing):
//   out[i * 1024 + p] = src[boffs[i, j] * row_scale + p] * apv[i, j]
// for the last piece j with cuts[i, j] <= p, 0 if there is none.  In the
// aligned mode (row_scale 128) src is the pre-rolled bank of the 8-aligned
// B table (build_bank.cu) and boffs are bank-row codes; in the flat mode
// (row_scale 1, the TPU's unaligned mode, for tables past its bank limit)
// src is that table itself behind its zero bias and boffs are offsets.
// apv holds the per-piece A values (one K1 gather).  One launch covers
// every class: the classes' tables are concatenated, and a class table
// (at most 8 rows: first compact subtile, J, first piece) tells each
// subtile its class.  The subtiles land in the class-major compact
// buffer; gather_tiles8.cu restores arena order.
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
// mode on R-MAT-16), B rows read once per A entry.  Design: run form, one
// warp per run, so the warp's B reads and output writes are both
// contiguous and the run descriptors are read once per warp; piece mode,
// one block per compact subtile of any class (one launch per plan, where
// a launch per class cost the host 20-35 us each), each slot's piece by a
// max-scan of the pieces' first slots (no per-slot search), 16-byte bank
// reads and output writes, contiguous across the block's threads.
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

constexpr int kTile = 1024;          // slots per subtile
constexpr int kLanes = 128;          // bank row width
constexpr int kMaxJ = 128;           // piece budget of the largest class
constexpr int kMaxClasses = 8;       // rows of the class table
// 128 threads, 8 slots a thread: on the card faster than 256 threads (4
// slots) and 64 (16), tools/k2_variants.py
constexpr int kPieceThreads = 128;
constexpr int kSlots = kTile / kPieceThreads;  // a thread's slots, 4 or more

// One launch over the compact subtiles of every class.  Block `sub` finds
// its class row (first compact subtile, J, first piece), stages its J
// pieces, and marks each piece's first slot (a piece whose next piece
// starts at the same cut covers no slot); a block-wide max-scan of the
// marks then gives every slot its piece, the last one that starts at or
// before it, with no search.  A thread writes kSlots consecutive slots,
// four at a time: one 16-byte load and store when the four share a piece
// and the source and output are aligned.
template <typename T>
__global__ void __launch_bounds__(kPieceThreads)
expand_pieces_kernel(const T* __restrict__ src, const T* __restrict__ apv,
                     const int32_t* __restrict__ cuts,
                     const int32_t* __restrict__ boffs,
                     const int32_t* __restrict__ cls, int n_cls,
                     int row_scale, bool vec, T* __restrict__ out) {
  __shared__ int32_t s_cut[kMaxJ + 1];
  __shared__ int32_t s_boff[kMaxJ];
  __shared__ T s_av[kMaxJ];
  __shared__ __align__(16) int32_t s_mark[kTile];
  __shared__ int32_t s_warp[kPieceThreads / 32];
  const int64_t sub = blockIdx.x;
  int row = 0;
  for (int r = 1; r < n_cls; ++r) {
    if (sub >= __ldg(cls + 3 * r)) row = r;
  }
  const int j_budget = min(__ldg(cls + 3 * row + 1), kMaxJ);
  const int64_t q0 = __ldg(cls + 3 * row + 2) +
                     (sub - __ldg(cls + 3 * row)) * j_budget;
  const int t = threadIdx.x;
  for (int j = t; j < j_budget; j += blockDim.x) {
    s_cut[j] = min(max(__ldg(cuts + q0 + j), 0), kTile);
    s_boff[j] = __ldg(boffs + q0 + j);
    s_av[j] = __ldg(apv + q0 + j);
  }
  if (t == 0) s_cut[j_budget] = kTile;
  const int p0 = kSlots * t;
  int4* marks = reinterpret_cast<int4*>(s_mark + p0);
#pragma unroll
  for (int g = 0; g < kSlots / 4; ++g) marks[g] = make_int4(-1, -1, -1, -1);
  __syncthreads();
  for (int j = t; j < j_budget; j += blockDim.x) {
    if (s_cut[j] < s_cut[j + 1]) s_mark[s_cut[j]] = j;
  }
  __syncthreads();

  // the max-scan: the thread's slots, then the warp, then the warps
  // before it
  int4 q[kSlots / 4];
  int run = -1;
#pragma unroll
  for (int g = 0; g < kSlots / 4; ++g) {
    q[g] = marks[g];
    run = max(run, max(max(q[g].x, q[g].y), max(q[g].z, q[g].w)));
  }
  const int lane = t & 31;
  int incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = max(incl, y);
  }
  run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = -1;
  if (lane == 31) s_warp[t >> 5] = incl;
  __syncthreads();
  for (int u = 0; u < (t >> 5); ++u) run = max(run, s_warp[u]);

  T v[kSlots];
#pragma unroll
  for (int g = 0; g < kSlots / 4; ++g) {
    int m[4];
    m[0] = run = max(run, q[g].x);
    m[1] = run = max(run, q[g].y);
    m[2] = run = max(run, q[g].z);
    m[3] = run = max(run, q[g].w);
    const int p = p0 + 4 * g;
    const int j = m[0];
    const int64_t s0 =
        static_cast<int64_t>(j >= 0 ? s_boff[j] : 0) * row_scale + p;
    T* vg = v + 4 * g;
    if (vec && j >= 0 && j == m[3] && s0 % 4 == 0) {
      T w4[4];
      nsp::load4(src + s0, w4);
      const T av = s_av[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) vg[k] = w4[k] * av;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        vg[k] = m[k] >= 0
                    ? src[static_cast<int64_t>(s_boff[m[k]]) * row_scale + p +
                          k] * s_av[m[k]]
                    : T(0);
      }
    }
  }
  T* o = out + sub * kTile + p0;
#pragma unroll
  for (int g = 0; g < kSlots / 4; ++g) {
    if (vec) {
      const T w4[4] = {v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]};
      nsp::store4(o + 4 * g, w4);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) o[4 * g + k] = v[4 * g + k];
    }
  }
}

template <typename T>
int launch_expand_pieces(const void* src, const void* apv, const void* cuts,
                         const void* boffs, const void* cls, int n_cls,
                         int64_t n_sub, int row_scale, void* out,
                         void* stream) {
  if (n_cls <= 0 || n_cls > kMaxClasses ||
      (row_scale != 1 && row_scale != kLanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_sub > 0) {
    const bool vec = nsp::aligned16(src) && nsp::aligned16(out);
    expand_pieces_kernel<T><<<static_cast<unsigned int>(n_sub), kPieceThreads,
                              0, nsp::as_stream(stream)>>>(
        static_cast<const T*>(src), static_cast<const T*>(apv),
        static_cast<const int32_t*>(cuts), static_cast<const int32_t*>(boffs),
        static_cast<const int32_t*>(cls), n_cls, row_scale, vec,
        static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define NSP_EXPAND_PIECES(SUFFIX, T)                                         \
  NSP_EXPORT int nsp_expand_pieces_##SUFFIX(                                 \
      const void* src, const void* apv, const void* cuts, const void* boffs, \
      const void* cls, int n_cls, int64_t n_sub, int row_scale, void* out,   \
      void* stream) {                                                        \
    return launch_expand_pieces<T>(src, apv, cuts, boffs, cls, n_cls, n_sub, \
                                   row_scale, out, stream);                  \
  }

NSP_EXPAND_PIECES(f32, float)
NSP_EXPAND_PIECES(f64, double)

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
