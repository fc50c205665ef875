// K3: fused window reduction of one width class, in two modes.
//
// Per window of W slots, on the window's level pyramid P (levels laid end
// to end: F0, F1..F_lv, then three levels per tier):
//   1. F0, the window's W products in fold-slot order:
//      v1: F0[i] = x[tile[i]], the products read in arena order;
//      v2: the kernel forms them: slot p of arena subtile t takes
//          bank[eboff * 128 + p] * apv from the piece of t with
//          cut <= p < end, and lands in its fold slot, F0[tile_inv[e]] =
//          product e (tile_inv inverts the tile permutation);
//   2. lv halving folds, F_k[i] = F_{k-1}[i] + F_{k-1}[i + W >> k];
//   3. per radix-8 tier of width V: gather the arena [F_prev | zeros]
//      through the tier's window-local permutation, then 3 halving folds
//      (the first fold reads the gather directly);
//   4. the extraction: out[i] = P[ext[entry[i]]], 0 where ext is -1.
// The semantics are window_fused._fused_reference (v1) and the v2 kernel
// body of window_fused.fused_class_apply; the fold order is the same
// pairwise order, and v2 forms each product with the one multiply v1's
// expansion makes, so v1 and v2 give the same class arena and both equal
// the plain PyTorch version bit for bit.
//
// Replaces window_fused.fused_class_apply (body _make_fused_kernel), which
// kept the pyramid in VMEM and permuted with in-register Benes networks
// (tier-1 masks in v2, tier masks, entry masks), and the per-class
// shuffle_pallas.tile_benes_apply that fed it in v1.  v2 keeps the TPU
// kernel's point: the class's products (21.9M slots on R-MAT-14) never
// reach device memory.
//
// Bound: device memory, about 16-18 bytes a slot: the fold-slot table
// (tile or tile_inv, 4 B), the extraction table (2 B per pyramid value,
// about 2.2 per slot), the tier tables, the class arena written, and v1's
// products or v2's bank values (the 11 MB f32 bank of R-MAT-14 stays in
// the 50 MB L2).  Design:
// - Folds in registers.  A thread owns columns c of F_lv (c < W >> lv):
//   the 2^lv F0 slots c + m (W >> lv) of a column fold into F_lv[c]
//   without leaving its registers, so the folds need no barrier and no
//   shared memory.  Only F_lv, which the tier gathers read at random, is
//   stored (shared memory), and only when the class has tiers.
// - One extraction table, inverted: pyr_dst holds, per pyramid value, the
//   window-local output slot that reads it (int16, -1 = none), composed
//   from ext and entry on the host.  Each value is written straight to
//   its slot as it is formed; the block first zero-fills its windows'
//   output slots, so the slots no value reaches hold 0 (and the scattered
//   writes find their lines in L2: v2 runs slower without the fill, and
//   with 16-byte fill stores; tools/k3_variants.py).  No pyramid is
//   stored, so nothing falls back to global scratch.
// - v2 forms F0 in shared memory (the products land at scattered fold
//   slots): W values, 128 KB at W = 32768 in f32.  Each warp takes a run
//   of the window's pieces and its lanes walk a piece's slots, so bank and
//   tile_inv reads are contiguous within a piece and no slot searches for
//   its piece.
// - Wide windows on a thread-block cluster.  A window may span 2-8 blocks
//   of a cluster (csize): block r owns the F0 slots and columns c with
//   c % csize == r, so every fold stays in one block; products reach
//   their owner's F0 through distributed shared memory, and block 0 reads
//   the others' F_lv for the tiers.  The host takes csize > 1 where F0
//   would not fit one block's shared memory (f64 at W = 32768) or where
//   the class has fewer windows than the card has SMs (W = 32768 on
//   R-MAT-14: 106 windows on 132 SMs), so no class runs fewer blocks than
//   SMs.  A window that does not fit a cluster of 8 is refused (the
//   launch returns an error): there is no scratch path.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 64;
constexpr int kTile = 1024;        // slots per arena subtile
constexpr int kLanes = 128;        // bank row width
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxWidth = 32768;   // pyr_dst holds window slots as int16
constexpr int kMaxDevices = 64;

struct Geom {
  int64_t n_win;
  int w;        // window width
  int lv;       // fold levels before the tiers (0..3)
  int n_tiers;  // tier arena widths: 2 (W >> lv), then 2 (V >> 3) each
  int lg_c;     // log2 of the blocks per window (the cluster size)
  int pyr_len;  // pyramid values per window
};

template <typename T>
struct Tables {
  const T* x;                // v1: the class's products, arena order
  const int32_t* tile;       // v1: window-local product of each fold slot
  const T* bank;             // v2: the pre-rolled B bank
  const T* apv;              // v2: per-piece A values
  const int32_t* etrips;     // v2: each subtile's pieces [lo, hi)
  const int32_t* ecuts;      // v2: piece tables, per step region
  const int32_t* eboffs;
  const int32_t* eends;
  const int32_t* esub;       // v2: each piece's window-local subtile
  const int32_t* tile_inv;   // v2: fold slot of each window-local product
  int subs_per_step;
  int j2_cap;
  const int16_t* pyr_dst;    // output slot of each pyramid value, or -1
  const int32_t* tier_idx;   // per tier, per window, the gather sources
  T* out;                    // the class arena, entry order
};

__device__ __forceinline__ void window_sync(int lg_c) {
  if (lg_c) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ void emit(T* out, int d, T v) {
  if (d >= 0) out[d] = v;
}

// Steps 1, 2 and the extraction of F0..F_lv for this block's columns;
// F_lv[c] goes to lvl[c] when the class has tiers.
template <typename T, bool kExpand, int LV>
__device__ __forceinline__ void fold_columns(const Tables<T>& tb,
                                             const Geom& g, const T* f0,
                                             T* lvl, int64_t win, int rank) {
  constexpr int kN = 1 << LV;
  const int w = g.w;
  const int ncol = w >> LV;
  const int64_t base = win * w;
  const int16_t* dst = tb.pyr_dst + win * g.pyr_len;
  T* out = tb.out + base;
  const int step = blockDim.x << g.lg_c;
  for (int c = rank + (threadIdx.x << g.lg_c); c < ncol; c += step) {
    // the column's 2 kN - 1 output slots, level k from 2 kN - 2 (kN >> k)
    int d[2 * kN - 1];
#pragma unroll
    for (int k = 0; k <= LV; ++k) {
      const int pos = 2 * w - 2 * (w >> k);  // pyramid base of level k
#pragma unroll
      for (int m = 0; m < (kN >> k); ++m) {
        d[2 * kN - 2 * (kN >> k) + m] = __ldg(dst + pos + c + m * ncol);
      }
    }
    T v[kN];
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      const int f = c + m * ncol;
      if constexpr (kExpand) {
        v[m] = f0[f >> g.lg_c];
      } else {
        v[m] = __ldg(tb.x + base + __ldg(tb.tile + base + f));
      }
    }
#pragma unroll
    for (int m = 0; m < kN; ++m) emit(out, d[m], v[m]);
#pragma unroll
    for (int k = 1; k <= LV; ++k) {
#pragma unroll
      for (int m = 0; m < (kN >> k); ++m) {
        v[m] = v[m] + v[m + (kN >> k)];
        emit(out, d[2 * kN - 2 * (kN >> k) + m], v[m]);
      }
    }
    if (g.n_tiers) lvl[c] = v[0];
  }
}

// Step 3 and the extraction of the tier levels, by one block, from F_lv in
// lvl (buf: the other half of the ping-pong).
template <typename T>
__device__ __forceinline__ void run_tiers(const Tables<T>& tb, const Geom& g,
                                          T* lvl, T* buf, int64_t win) {
  const int w = g.w;
  const int16_t* dst = tb.pyr_dst + win * g.pyr_len;
  T* out = tb.out + win * w;
  int pos = 0;  // pyramid base of the tier's first level
  for (int k = 0; k <= g.lv; ++k) pos += w >> k;
  int64_t toff = 0;
  int v = 2 * (w >> g.lv);
  T* src = lvl;
  T* nxt = buf;
  for (int t = 0; t < g.n_tiers; ++t) {
    const int half = v >> 1;  // the width of F_prev: the arena's zeros
    const int nc = v >> 3;
    const int32_t* idx = tb.tier_idx + toff + win * v;
    for (int c = threadIdx.x; c < nc; c += blockDim.x) {
      int d[7];
#pragma unroll
      for (int m = 0; m < 4; ++m) d[m] = __ldg(dst + pos + c + m * nc);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        d[4 + m] = __ldg(dst + pos + half + c + m * nc);
      }
      d[6] = __ldg(dst + pos + half + (v >> 2) + c);
      T gv[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int j = __ldg(idx + c + m * nc);
        gv[m] = j < half ? src[j] : T(0);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        gv[m] = gv[m] + gv[m + 4];
        emit(out, d[m], gv[m]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        gv[m] = gv[m] + gv[m + 2];
        emit(out, d[4 + m], gv[m]);
      }
      gv[0] = gv[0] + gv[1];
      emit(out, d[6], gv[0]);
      nxt[c] = gv[0];
    }
    __syncthreads();
    T* tmp = src;
    src = nxt;
    nxt = tmp;
    pos += half + (v >> 2) + (v >> 3);
    toff += g.n_win * v;
    v = 2 * (v >> 3);
  }
}

template <typename T, bool kExpand>
__global__ void __launch_bounds__(kMaxThreads)
fused_class_kernel(const Tables<T> tb, const Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = g.w;
  const int local_w = w >> g.lg_c;  // F0 slots (and output slots) a block owns
  const int ncol = w >> g.lv;
  T* f0 = reinterpret_cast<T*>(smem_raw);
  T* lvl = f0 + (kExpand ? local_w : 0);
  T* buf = lvl + ncol;
  const int cmask = (1 << g.lg_c) - 1;
  const int rank = static_cast<int>(blockIdx.x) & cmask;
  const int64_t win = blockIdx.x >> g.lg_c;
  const int64_t base = win * w;

  // zero this block's share of the window's output slots (the extraction
  // writes only the slots that read a value) and, in v2, its F0 slots;
  // the barrier also starts every block of the cluster before any block
  // writes into another's shared memory
  for (int i = threadIdx.x; i < local_w; i += blockDim.x) {
    tb.out[base + rank * local_w + i] = T(0);
    if constexpr (kExpand) f0[i] = T(0);
  }
  window_sync(g.lg_c);

  if constexpr (kExpand) {
    // F0 from the window's pieces, which lie contiguous in their step's
    // region: a warp per piece, its lanes over the piece's slots
    const int n_sub = w / kTile;
    const int64_t s0 = win * n_sub;
    const int64_t region = (s0 / tb.subs_per_step) * tb.j2_cap;
    const int q1 = tb.etrips[2 * (s0 + n_sub - 1) + 1];
    const int lane = threadIdx.x & 31;
    const int nwarp = blockDim.x >> 5;
    for (int q = tb.etrips[2 * s0] + rank * nwarp + (threadIdx.x >> 5);
         q < q1; q += nwarp << g.lg_c) {
      const int64_t qq = region + q;
      const int cut = __ldg(tb.ecuts + qq);
      const int end = __ldg(tb.eends + qq);
      if (cut >= end) continue;
      const T av = __ldg(tb.apv + qq);
      const T* brow =
          tb.bank + static_cast<int64_t>(__ldg(tb.eboffs + qq)) * kLanes;
      const int32_t* inv = tb.tile_inv + base +
                           static_cast<int64_t>(__ldg(tb.esub + qq)) * kTile;
      for (int p = cut + lane; p < end; p += 32) {
        const int f = __ldg(inv + p);
        const T val = __ldg(brow + p) * av;
        if (g.lg_c == 0) {
          f0[f] = val;
        } else {
          *cg::this_cluster().map_shared_rank(f0 + (f >> g.lg_c), f & cmask) =
              val;
        }
      }
    }
    window_sync(g.lg_c);
  }

  switch (g.lv) {
    case 0: fold_columns<T, kExpand, 0>(tb, g, f0, lvl, win, rank); break;
    case 1: fold_columns<T, kExpand, 1>(tb, g, f0, lvl, win, rank); break;
    case 2: fold_columns<T, kExpand, 2>(tb, g, f0, lvl, win, rank); break;
    default: fold_columns<T, kExpand, 3>(tb, g, f0, lvl, win, rank); break;
  }
  if (g.n_tiers == 0) return;
  if (g.lg_c) {
    // block 0 runs the tiers: it reads the others' columns of F_lv, and
    // they stay resident until it has
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
        if (c & cmask) lvl[c] = *cluster.map_shared_rank(lvl + c, c & cmask);
      }
    }
    cluster.sync();
    if (rank) return;
  } else {
    __syncthreads();
  }
  run_tiers(tb, g, lvl, buf, win);
}

struct Device {
  int sms;
  int smem_optin;
};

// The current device's SM count and shared-memory opt-in limit, queried
// once per device.
cudaError_t device_info(Device* info) {
  static Device cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev].sms == 0) {
    Device d{};
    e = cudaDeviceGetAttribute(&d.smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return e;
    cache[dev] = d;
  }
  *info = cache[dev];
  return cudaSuccess;
}

// Checks the geometry and chooses the blocks per window (g->lg_c), the
// threads and the dynamic shared memory of a launch.
template <typename T, bool kExpand>
cudaError_t configure(Geom* g, int* threads, size_t* smem) {
  const int w = g->w;
  if (w <= 0 || w > kMaxWidth || g->lv < 0 || g->lv > 3 || g->n_tiers < 0 ||
      ((w >> g->lv) << g->lv) != w || (kExpand && w % kTile != 0)) {
    return cudaErrorInvalidValue;
  }
  const int ncol = w >> g->lv;
  int pyr = 0;
  for (int k = 0; k <= g->lv; ++k) pyr += w >> k;
  for (int t = 0, v = 2 * ncol; t < g->n_tiers; ++t, v = 2 * (v >> 3)) {
    if (v < 8 || v % 8 != 0) return cudaErrorInvalidValue;
    pyr += (v >> 1) + (v >> 2) + (v >> 3);
  }
  g->pyr_len = pyr;
  Device dev{};
  const cudaError_t e = device_info(&dev);
  if (e != cudaSuccess) return e;
  auto need = [&](int lg) {
    return (static_cast<size_t>(kExpand ? w >> lg : 0) +
            (g->n_tiers ? ncol + ncol / 4 : 0)) * sizeof(T);
  };
  int lg = 0;
  while ((2 << lg) <= kMaxCluster && (ncol >> (lg + 1)) >= 32 &&
         ((ncol >> (lg + 1)) << (lg + 1)) == ncol &&
         (need(lg) > static_cast<size_t>(dev.smem_optin) ||
          (g->n_win << lg) < dev.sms)) {
    ++lg;
  }
  if (need(lg) > static_cast<size_t>(dev.smem_optin)) {
    return cudaErrorInvalidConfiguration;  // no scratch path: refuse
  }
  g->lg_c = lg;
  *threads = std::min(kMaxThreads,
                      std::max(kMinThreads, ((ncol >> lg) + 31) / 32 * 32));
  *smem = need(lg);
  return cudaSuccess;
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once per
// kernel, device and size.
template <typename T, bool kExpand>
cudaError_t allow_smem(size_t smem) {
  static int allowed[kMaxDevices];
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev] >= static_cast<int>(smem)) return cudaSuccess;
  e = cudaFuncSetAttribute(fused_class_kernel<T, kExpand>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) allowed[dev] = static_cast<int>(smem);
  return e;
}

template <typename T, bool kExpand>
int launch_fused(const Tables<T>& tb, Geom g, void* stream) {
  int threads = 0;
  size_t smem = 0;
  cudaError_t e = configure<T, kExpand>(&g, &threads, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (g.n_win == 0) return static_cast<int>(cudaGetLastError());
  e = allow_smem<T, kExpand>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(g.n_win << g.lg_c));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = nsp::as_stream(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << g.lg_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.lg_c ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, fused_class_kernel<T, kExpand>, tb, g);
  // read (and clear) the launch's error either way, so that a refused
  // launch is not reported again by the next one
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// What launch_fused chooses for a class: blocks per window, threads,
// dynamic shared memory, and the blocks of that size an SM holds.
template <typename T, bool kExpand>
int geometry(Geom g, int* out) {
  int threads = 0;
  size_t smem = 0;
  cudaError_t e = configure<T, kExpand>(&g, &threads, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem<T, kExpand>(smem);
  int per_sm = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_class_kernel<T, kExpand>, threads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 1 << g.lg_c;
  out[1] = threads;
  out[2] = static_cast<int>(smem);
  out[3] = per_sm;
  return 0;
}

template <typename T>
int fused_v1(const void* x, const void* tile, const void* pyr_dst,
             const void* tier_idx, void* out, int64_t n_win, int w, int lv,
             int n_tiers, void* stream) {
  Tables<T> tb{};
  tb.x = static_cast<const T*>(x);
  tb.tile = static_cast<const int32_t*>(tile);
  tb.pyr_dst = static_cast<const int16_t*>(pyr_dst);
  tb.tier_idx = static_cast<const int32_t*>(tier_idx);
  tb.out = static_cast<T*>(out);
  return launch_fused<T, false>(tb, Geom{n_win, w, lv, n_tiers, 0, 0},
                                stream);
}

template <typename T>
int fused_v2(const void* bank, const void* apv, const void* etrips,
             const void* ecuts, const void* eboffs, const void* eends,
             const void* esub, const void* tile_inv, const void* pyr_dst,
             const void* tier_idx, void* out, int64_t n_win, int w, int lv,
             int n_tiers, int subs_per_step, int j2_cap, void* stream) {
  if (subs_per_step <= 0 || j2_cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tables<T> tb{};
  tb.bank = static_cast<const T*>(bank);
  tb.apv = static_cast<const T*>(apv);
  tb.etrips = static_cast<const int32_t*>(etrips);
  tb.ecuts = static_cast<const int32_t*>(ecuts);
  tb.eboffs = static_cast<const int32_t*>(eboffs);
  tb.eends = static_cast<const int32_t*>(eends);
  tb.esub = static_cast<const int32_t*>(esub);
  tb.tile_inv = static_cast<const int32_t*>(tile_inv);
  tb.subs_per_step = subs_per_step;
  tb.j2_cap = j2_cap;
  tb.pyr_dst = static_cast<const int16_t*>(pyr_dst);
  tb.tier_idx = static_cast<const int32_t*>(tier_idx);
  tb.out = static_cast<T*>(out);
  return launch_fused<T, true>(tb, Geom{n_win, w, lv, n_tiers, 0, 0}, stream);
}

}  // namespace

#define NSP_FUSED(SUFFIX, T)                                                  \
  NSP_EXPORT int nsp_fused_class_##SUFFIX(                                    \
      const void* x, const void* tile, const void* pyr_dst,                   \
      const void* tier_idx, void* out, int64_t n_win, int w, int lv,          \
      int n_tiers, void* stream) {                                            \
    return fused_v1<T>(x, tile, pyr_dst, tier_idx, out, n_win, w, lv,         \
                       n_tiers, stream);                                      \
  }                                                                           \
  NSP_EXPORT int nsp_fused_class_v2_##SUFFIX(                                 \
      const void* bank, const void* apv, const void* etrips,                  \
      const void* ecuts, const void* eboffs, const void* eends,               \
      const void* esub, const void* tile_inv, const void* pyr_dst,            \
      const void* tier_idx, void* out, int64_t n_win, int w, int lv,          \
      int n_tiers, int subs_per_step, int j2_cap, void* stream) {             \
    return fused_v2<T>(bank, apv, etrips, ecuts, eboffs, eends, esub,         \
                       tile_inv, pyr_dst, tier_idx, out, n_win, w, lv,        \
                       n_tiers, subs_per_step, j2_cap, stream);               \
  }

NSP_FUSED(f32, float)
NSP_FUSED(f64, double)

// The launch geometry of a class (expand: v2; el: bytes per value):
// out[0..3] = blocks per window, threads, dynamic shared memory bytes,
// resident blocks per SM.
NSP_EXPORT int nsp_fused_class_geom(int expand, int el, int64_t n_win, int w,
                                    int lv, int n_tiers, int* out) {
  const Geom g{n_win, w, lv, n_tiers, 0, 0};
  if (el == 4) {
    return expand ? geometry<float, true>(g, out)
                  : geometry<float, false>(g, out);
  }
  if (el == 8) {
    return expand ? geometry<double, true>(g, out)
                  : geometry<double, false>(g, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
