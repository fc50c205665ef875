// K3: fused window reduction of one width class (v1 form: the products
// come in arena order and are read through the class's tile permutation).
//
// Per window of W slots (one block per window), on the window's level
// pyramid P (levels laid end to end):
//   1. F0[i] = x[tile[i]], the window's W products in fold-slot order;
//   2. lv halving folds, F_k[i] = F_{k-1}[i] + F_{k-1}[i + W >> k];
//   3. per radix-8 tier of width V (only when lv == 3): gather the arena
//      [F_prev | zeros] through the tier's window-local permutation, then
//      3 halving folds (the first fold reads the gather directly);
//   4. out[i] = P[ext[entry[i]]], 0 where ext is -1.
// The semantics are window_fused._fused_reference; the fold order is the
// same pairwise order, so the result equals the plain PyTorch version bit
// for bit.
//
// Replaces window_fused.fused_class_apply (body _make_fused_kernel), which
// kept the pyramid in VMEM and permuted with in-register Benes networks
// (tier masks, entry masks), and the per-class
// shuffle_pallas.tile_benes_apply that fed it; here every permutation is a
// gather with window-local indices, which the host checks.
//
// Bound: shared-memory and device-memory traffic of the folds — about
// 2.2 W values written and read per window — plus one index read per slot
// and gather.  The tile gather reads inside the window's W products, so
// its uncoalesced loads hit lines the block reads anyway.  Design: the
// pyramid lives in dynamic shared memory when it
// fits the block's opt-in limit (227 KB on H100: every f32 class up to
// W = 16384, f64 up to W = 8192); wider windows keep it in a per-window
// slice of a global scratch buffer, which mostly stays in the 50 MB L2.
// Folds write to a level the same pass does not read, so one
// __syncthreads() per level orders them, and no atomics are needed.
#include "common.cuh"

namespace {

constexpr int kMaxTiers = 8;
constexpr int kThreads = 512;

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
int launch_fused(const void* x, void* out, const void* tile, const void* ext,
                 const void* entry, const void* tier_idx, int64_t n_win,
                 int w, int lv, int n_tiers, const int* tier_v, void* scratch,
                 int64_t pyr_len, void* stream) {
  if (n_tiers < 0 || n_tiers > kMaxTiers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TierGeom tg{};
  tg.n = n_tiers;
  int64_t off = 0;
  for (int t = 0; t < n_tiers; ++t) {
    tg.v[t] = tier_v[t];
    tg.idx_off[t] = off;
    off += n_win * tier_v[t];
  }
  const size_t smem =
      scratch != nullptr ? 0 : static_cast<size_t>(pyr_len) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_class_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
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
