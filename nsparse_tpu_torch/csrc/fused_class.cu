// K3: fused window reduction of one width class, in two modes.
//
// Per window of W slots (one block per window), on the window's level
// pyramid P (levels laid end to end):
//   1. F0, the window's W products in fold-slot order:
//      v1: F0[i] = x[tile[i]], the products read in arena order;
//      v2: the kernel forms them: for each of the window's 1024-slot arena
//          subtiles, slot p takes bank[eboff * 128 + p] * apv from the
//          subtile's piece with cut <= p < end, and lands in its fold slot,
//          F0[tile_inv[e]] = product e (tile_inv inverts the permutation);
//   2. lv halving folds, F_k[i] = F_{k-1}[i] + F_{k-1}[i + W >> k];
//   3. per radix-8 tier of width V (only when lv == 3): gather the arena
//      [F_prev | zeros] through the tier's window-local permutation, then
//      3 halving folds (the first fold reads the gather directly);
//   4. out[i] = P[ext[entry[i]]], 0 where ext is -1.
// The semantics are window_fused._fused_reference (v1) and the v2 kernel
// body of window_fused.fused_class_apply; the fold order is the same
// pairwise order, and v2 forms each product with the one multiply v1's
// expansion makes, so v1 and v2 give the same class arena and both equal
// the plain PyTorch version bit for bit.
//
// Replaces window_fused.fused_class_apply (body _make_fused_kernel), which
// kept the pyramid in VMEM and permuted with in-register Benes networks
// (tier-1 masks in v2, tier masks, entry masks), and the per-class
// shuffle_pallas.tile_benes_apply that fed it in v1; here every
// permutation is an index table with window-local entries, which the host
// checks.  v2 keeps the TPU kernel's point: the class's products (21.9M
// slots on R-MAT-14) never reach device memory.
//
// Bound: shared-memory and device-memory traffic of the folds — about
// 2.2 W values written and read per window — plus one index read per slot
// and gather; v2 adds one bank read (the 11 MB f32 bank of R-MAT-14 stays
// in the 50 MB L2) and one tile_inv read per slot, and drops v1's product
// read.  Design: the pyramid lives in dynamic shared memory when it fits
// the block's opt-in limit (227 KB on H100: every f32 class up to
// W = 16384, f64 up to W = 8192); wider windows keep it in a per-window
// slice of a global scratch buffer, which mostly stays in the 50 MB L2.
// v2 has no buffer for the arena-order products: each product is written
// straight to its fold slot.  A subtile's pieces (at most kMaxPieces) are
// staged in static shared memory; each thread finds its slot's piece by
// binary search over their cuts.  Folds write to a level the same pass
// does not read, so one __syncthreads() per level orders them, and no
// atomics are needed.
#include "common.cuh"

namespace {

constexpr int kMaxTiers = 8;
constexpr int kThreads = 512;
constexpr int kTile = 1024;      // slots per arena subtile
constexpr int kLanes = 128;      // bank row width
constexpr int kMaxPieces = 256;  // pieces per subtile (window_fused.py)

struct TierGeom {
  int n;
  int v[kMaxTiers];            // tier arena width V
  int64_t idx_off[kMaxTiers];  // offset of the tier's indices in tier_idx
};

template <typename T>
__device__ void fold(T* pyr, int64_t src, int64_t dst, int half) {
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    pyr[dst + i] = pyr[src + i] + pyr[src + i + half];
  }
  __syncthreads();
}

// Steps 2-4 on a window whose F0 is in pyr[0, w).
template <typename T>
__device__ void reduce_window(T* pyr, T* __restrict__ out,
                              const int32_t* __restrict__ ext,
                              const int32_t* __restrict__ entry,
                              const int32_t* __restrict__ tier_idx, int w,
                              int lv, const TierGeom& tg, int64_t win) {
  const int64_t base = win * w;
  int64_t src = 0;  // offset of the current level
  int64_t dst = w;  // offset of the next level
  int width = w;
  for (int k = 0; k < lv; ++k) {
    const int half = width >> 1;
    fold(pyr, src, dst, half);
    src = dst;
    dst += half;
    width = half;
  }

  for (int t = 0; t < tg.n; ++t) {
    const int v = tg.v[t];
    const int half = v >> 1;  // == width: the arena is [current | zeros]
    const int32_t* idx = tier_idx + tg.idx_off[t] + win * v;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int32_t j0 = idx[i];
      const int32_t j1 = idx[i + half];
      const T a = j0 < half ? pyr[src + j0] : T(0);
      const T b = j1 < half ? pyr[src + j1] : T(0);
      pyr[dst + i] = a + b;
    }
    __syncthreads();
    src = dst;
    dst += half;
    width = half;
    for (int k = 0; k < 2; ++k) {
      const int h = width >> 1;
      fold(pyr, src, dst, h);
      src = dst;
      dst += h;
      width = h;
    }
  }

  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    const int32_t s = ext[base + entry[base + i]];
    out[base + i] = s >= 0 ? pyr[s] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_class_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const int32_t* __restrict__ tile,
                   const int32_t* __restrict__ ext,
                   const int32_t* __restrict__ entry,
                   const int32_t* __restrict__ tier_idx, int w, int lv,
                   TierGeom tg, T* scratch, int64_t pyr_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t win = blockIdx.x;
  T* pyr = scratch != nullptr ? scratch + win * pyr_len
                              : reinterpret_cast<T*>(smem_raw);
  const int64_t base = win * w;

  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    pyr[i] = x[base + tile[base + i]];
  }
  __syncthreads();
  reduce_window(pyr, out, ext, entry, tier_idx, w, lv, tg, win);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_class_v2_kernel(const T* __restrict__ bank, const T* __restrict__ apv,
                      const int32_t* __restrict__ etrips,
                      const int32_t* __restrict__ ecuts,
                      const int32_t* __restrict__ eboffs,
                      const int32_t* __restrict__ eends,
                      const int32_t* __restrict__ tile_inv,
                      T* __restrict__ out, const int32_t* __restrict__ ext,
                      const int32_t* __restrict__ entry,
                      const int32_t* __restrict__ tier_idx, int w, int lv,
                      TierGeom tg, T* scratch, int64_t pyr_len,
                      int subs_per_step, int j2_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int32_t s_cut[kMaxPieces];
  __shared__ int32_t s_end[kMaxPieces];
  __shared__ int32_t s_boff[kMaxPieces];
  __shared__ T s_av[kMaxPieces];
  const int64_t win = blockIdx.x;
  T* pyr = scratch != nullptr ? scratch + win * pyr_len
                              : reinterpret_cast<T*>(smem_raw);
  const int64_t base = win * w;
  const int n_sub_w = w / kTile;

  for (int t = 0; t < n_sub_w; ++t) {
    const int64_t s = win * n_sub_w + t;  // the class's arena subtile
    const int64_t region = (s / subs_per_step) * j2_cap;
    const int lo = etrips[2 * s];
    const int np = min(etrips[2 * s + 1] - lo, kMaxPieces);
    for (int j = threadIdx.x; j < np; j += blockDim.x) {
      const int64_t q = region + lo + j;
      s_cut[j] = ecuts[q];
      s_end[j] = eends[q];
      s_boff[j] = eboffs[q];
      s_av[j] = apv[q];
    }
    __syncthreads();
    const int32_t* inv = tile_inv + base + static_cast<int64_t>(t) * kTile;
    for (int p = threadIdx.x; p < kTile; p += blockDim.x) {
      int a = 0, b = np;  // a = number of pieces with cut <= p
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (s_cut[mid] <= p) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      T v = T(0);
      if (a > 0 && p < s_end[a - 1]) {
        v = bank[static_cast<int64_t>(s_boff[a - 1]) * kLanes + p] *
            s_av[a - 1];
      }
      pyr[inv[p]] = v;
    }
    __syncthreads();
  }
  reduce_window(pyr, out, ext, entry, tier_idx, w, lv, tg, win);
}

inline bool tier_geom(int64_t n_win, int n_tiers, const int* tier_v,
                      TierGeom* tg) {
  if (n_tiers < 0 || n_tiers > kMaxTiers) return false;
  *tg = TierGeom{};
  tg->n = n_tiers;
  int64_t off = 0;
  for (int t = 0; t < n_tiers; ++t) {
    tg->v[t] = tier_v[t];
    tg->idx_off[t] = off;
    off += n_win * tier_v[t];
  }
  return true;
}

// Dynamic shared memory of one block: the pyramid, unless it lives in the
// global scratch; above 48 KB the kernel must opt in.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_fused(const void* x, void* out, const void* tile, const void* ext,
                 const void* entry, const void* tier_idx, int64_t n_win,
                 int w, int lv, int n_tiers, const int* tier_v, void* scratch,
                 int64_t pyr_len, void* stream) {
  TierGeom tg;
  if (!tier_geom(n_win, n_tiers, tier_v, &tg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      scratch != nullptr ? 0 : static_cast<size_t>(pyr_len) * sizeof(T);
  const cudaError_t e = set_smem(fused_class_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_win > 0) {
    fused_class_kernel<T><<<static_cast<unsigned int>(n_win), kThreads, smem,
                            nsp::as_stream(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const int32_t*>(tile), static_cast<const int32_t*>(ext),
        static_cast<const int32_t*>(entry),
        static_cast<const int32_t*>(tier_idx), w, lv, tg,
        static_cast<T*>(scratch), pyr_len);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused_v2(const void* bank, const void* apv, const void* etrips,
                    const void* ecuts, const void* eboffs, const void* eends,
                    const void* tile_inv, void* out, const void* ext,
                    const void* entry, const void* tier_idx, int64_t n_win,
                    int w, int lv, int n_tiers, const int* tier_v,
                    void* scratch, int64_t pyr_len, int subs_per_step,
                    int j2_cap, void* stream) {
  TierGeom tg;
  if (!tier_geom(n_win, n_tiers, tier_v, &tg) || w % kTile != 0 ||
      subs_per_step <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      scratch != nullptr ? 0 : static_cast<size_t>(pyr_len) * sizeof(T);
  const cudaError_t e = set_smem(fused_class_v2_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_win > 0) {
    fused_class_v2_kernel<T><<<static_cast<unsigned int>(n_win), kThreads,
                               smem, nsp::as_stream(stream)>>>(
        static_cast<const T*>(bank), static_cast<const T*>(apv),
        static_cast<const int32_t*>(etrips),
        static_cast<const int32_t*>(ecuts),
        static_cast<const int32_t*>(eboffs),
        static_cast<const int32_t*>(eends),
        static_cast<const int32_t*>(tile_inv), static_cast<T*>(out),
        static_cast<const int32_t*>(ext), static_cast<const int32_t*>(entry),
        static_cast<const int32_t*>(tier_idx), w, lv, tg,
        static_cast<T*>(scratch), pyr_len, subs_per_step, j2_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_fused_class_f32(const void* x, void* out, const void* tile,
                                   const void* ext, const void* entry,
                                   const void* tier_idx,
                                   int64_t n_win, int w, int lv, int n_tiers,
                                   const int* tier_v, void* scratch,
                                   int64_t pyr_len, void* stream) {
  return launch_fused<float>(x, out, tile, ext, entry, tier_idx, n_win, w, lv,
                             n_tiers, tier_v, scratch, pyr_len, stream);
}

NSP_EXPORT int nsp_fused_class_f64(const void* x, void* out, const void* tile,
                                   const void* ext, const void* entry,
                                   const void* tier_idx,
                                   int64_t n_win, int w, int lv, int n_tiers,
                                   const int* tier_v, void* scratch,
                                   int64_t pyr_len, void* stream) {
  return launch_fused<double>(x, out, tile, ext, entry, tier_idx, n_win, w, lv,
                              n_tiers, tier_v, scratch, pyr_len, stream);
}

#define NSP_FUSED_V2(SUFFIX, T)                                              \
  NSP_EXPORT int nsp_fused_class_v2_##SUFFIX(                                \
      const void* bank, const void* apv, const void* etrips,                 \
      const void* ecuts, const void* eboffs, const void* eends,              \
      const void* tile_inv, void* out, const void* ext, const void* entry,   \
      const void* tier_idx, int64_t n_win, int w, int lv, int n_tiers,       \
      const int* tier_v, void* scratch, int64_t pyr_len, int subs_per_step,  \
      int j2_cap, void* stream) {                                            \
    return launch_fused_v2<T>(bank, apv, etrips, ecuts, eboffs, eends,       \
                              tile_inv, out, ext, entry, tier_idx, n_win, w, \
                              lv, n_tiers, tier_v, scratch, pyr_len,         \
                              subs_per_step, j2_cap, stream);                \
  }

NSP_FUSED_V2(f32, float)
NSP_FUSED_V2(f64, double)

// Largest dynamic shared memory a block may opt in to on the current device.
NSP_EXPORT int nsp_max_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  }
  return static_cast<int>(e);
}
