// One-shot SpGEMM C = A·B by per-row hash accumulation in shared memory:
// the reference's two-phase hash SpGEMM (nsparse's symbolic count, then
// numeric accumulate, rows binned by their work) rebuilt for Hopper.
//
// Replaces no TPU kernel.  The JAX package forms C in one shot by
// expanding every product, one global sort of packed (row, column) keys
// and a segmented scan (ops/spgemm.py:spgemm_plan_device and
// spgemm_numeric_sort), because the TPU has no scatter atomics; the card
// has them in shared memory, so each row of C is accumulated where it is
// made and only C leaves the SM.
//
// Bound: device memory, A and B read once and C written once (C's
// columns and values dominate); the products are read from L2 (B's rows
// are re-read once per A entry that names them).
//
// Pipeline (ops/kernels/spgemm_hash.py launches it; each entry returns
// cudaGetLastError()):
//   nsp_hash_bin      a warp per row: the row's size (symbolic: its
//                     products, capped at N; numeric: its nnz) and its
//                     route, the first whose limit (the wrapper's, passed
//                     in) is >= size, or the tail route past the last; a
//                     per-route histogram,
//                     the device-memory table space of tail rows, and
//                     (numeric) nnz(C), all int64 in `info`;
//   nsp_hash_scatter  the rows grouped by route into `perm`
//                     (warp-aggregated cursors);
//   nsp_hash_symbolic per route: the distinct columns of each row;
//   nsp_hash_numeric  per route: each row's (column, value) pairs
//                     accumulated, sorted by column, written to C;
//   nsp_hash_geom     a route's kernel on this card: resident blocks per
//                     SM, registers and spilled bytes a thread.
// Routes (kinds; hash_routes in the wrapper picks them from N and the
// value width): a partial warp of 8 lanes per row with a 64-slot table,
// a warp per row with 1,024 slots, then either a block per row with a
// dense accumulator (a bitmap of a slice of N columns, and in the
// numeric phase their values; one pass over the row's products per
// slice), or, where N is too wide for that, a block per row with a
// power-of-two table in shared memory and past the largest a block per
// row whose table lies in device memory.  Tables probe linearly from a
// multiplicative hash; a slot's key goes from empty to one column once,
// by atomicCAS.  The numeric tables sort their slots by a bitonic
// network (empty slots, key 0xffffffff, sort last); the dense route
// reads the bitmap in column order, so it needs no sort.  Sums follow
// the order of the shared-memory atomics, as the reference's do.
#include "common.cuh"

namespace {

constexpr int32_t kEmpty = -1;
constexpr unsigned kHashMul = 0x9E3779B1u;
constexpr int kScratchInts = 64;  // block reductions and scans
constexpr int kMaxBins = 16;      // the info layout, as in spgemm_hash.py
constexpr int kInfoGlobal = kMaxBins;      // device-table slots reserved
constexpr int kInfoNnz = kMaxBins + 1;     // nnz(C), numeric mode
constexpr int kInfoCursor = kMaxBins + 2;  // kMaxBins cursors follow
constexpr int kBinThreads = 256;

enum Kind { kPwarp = 0, kWarp = 1, kBlock = 2, kDense = 3, kGlobal = 4 };
constexpr int kPwarpLanes = 8, kPwarpSlots = 64;
constexpr int kWarpLanes = 32, kWarpSlots = 1024;
constexpr int kSmemMax = 232448;  // the 227 KB a block may opt in to
// The dense route's blocks: dense_route (spgemm_hash.py) sizes their shared
// memory so that two share an SM, and __launch_bounds__ holds the numeric
// kernel to the 32 registers a thread that two blocks of 1,024 threads
// leave.  The symbolic kernel takes 28 unbounded; bounded it ran 7% slower
// on an H100, so chip_smoke.py's hash_geometry checks its two blocks an SM.
constexpr int kDenseThreads = 1024;

// The largest size of each bin but the tail, ascending.
struct Limits {
  long long v[kMaxBins - 1];
};

using u64 = unsigned long long;

// The device-memory table of a tail row of `size` distinct columns at
// most: the power of two at least twice the size (load <= 1/2).
__host__ __device__ inline u64 global_slots(long long size) {
  u64 t = 2;
  while (t < 2ull * static_cast<u64>(size)) t <<= 1;
  return t;
}

__host__ __device__ constexpr int log2c(int pow2) {
  return pow2 <= 1 ? 0 : 1 + log2c(pow2 / 2);
}

__device__ __forceinline__ int log2_of(u64 pow2) {
  return 63 - __clzll(pow2);
}

__device__ __forceinline__ unsigned hash_slot(int32_t col, int shift) {
  return (static_cast<unsigned>(col) * kHashMul) >> shift;
}

// Insert `col`; 1 if it was new.  A plain read first: a slot that holds
// a column holds it for good, so only an empty slot needs the CAS.
__device__ __forceinline__ int insert_key(int32_t* keys, unsigned mask,
                                          int shift, int32_t col) {
  volatile int32_t* vk = keys;
  unsigned s = hash_slot(col, shift) & mask;
  while (true) {
    const int32_t k = vk[s];
    if (k == col) return 0;
    if (k == kEmpty) {
      const int32_t old = atomicCAS(keys + s, kEmpty, col);
      if (old == kEmpty) return 1;
      if (old == col) return 0;
    }
    s = (s + 1) & mask;
  }
}

template <typename V>
__device__ __forceinline__ void insert_add(int32_t* keys, V* vals,
                                           unsigned mask, int shift,
                                           int32_t col, V v) {
  volatile int32_t* vk = keys;
  unsigned s = hash_slot(col, shift) & mask;
  while (true) {
    const int32_t k = vk[s];
    if (k == col) break;
    if (k == kEmpty) {
      const int32_t old = atomicCAS(keys + s, kEmpty, col);
      if (old == kEmpty || old == col) break;
    }
    s = (s + 1) & mask;
  }
  atomicAdd(vals + s, v);
}

// Set bit `col` of a bitmap; 1 if it was clear.
__device__ __forceinline__ int set_bit(unsigned* bm, int32_t col) {
  const unsigned bit = 1u << (col & 31);
  unsigned* w = bm + (col >> 5);
  if (*reinterpret_cast<volatile unsigned*>(w) & bit) return 0;
  return (atomicOr(w, bit) & bit) ? 0 : 1;
}

// Every product of row `row` once: f(j, t) for A entry j and B entry t.
// `groups` groups of `lanes` lanes share the row, a group an A entry at a
// time, its lanes over the entry's B row (distinct columns, so a group's
// lanes never meet on one accumulator); where the row has fewer A
// entries than groups, several groups split one entry's B row.
template <typename F>
__device__ __forceinline__ void for_products(
    const int32_t* __restrict__ a_rpt, const int32_t* __restrict__ a_col,
    const int32_t* __restrict__ b_rpt, int row, int g, int groups, int lane,
    int lanes, F f) {
  const int j0 = a_rpt[row], j1 = a_rpt[row + 1];
  const int na = j1 - j0;
  if (na <= 0) return;
  const int per = na >= groups ? 1 : groups / na;
  const int stride = groups / per;
  if (g >= stride * per) return;
  const int first = (g % per) * lanes + lane, step = per * lanes;
  for (int j = j0 + g / per; j < j1; j += stride) {
    const int k = a_col[j];
    const int t1 = b_rpt[k + 1];
    for (int t = b_rpt[k] + first; t < t1; t += step) f(j, t);
  }
}

// Sum of v over the block; thread 0 gets it.  `scratch`: 32 ints.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      total += scratch[w];
  return total;
}

// Exclusive prefix sum of v over the block, and the block's total.
// `scratch`: 64 ints; ends with a barrier, so it may be called again.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch,
                                                    int& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? scratch[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    scratch[32 + lane] = s;
  }
  __syncthreads();
  const int before = warp ? scratch[32 + warp - 1] : 0;
  total = scratch[32 + nwarps - 1];
  __syncthreads();
  return before + x - v;
}

struct WarpSync {
  __device__ void operator()() const { __syncwarp(); }
};
struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};

// Sort n (a power of two) (key, value) pairs by key as unsigned, with
// `nthreads` threads from `tid`; `sync` orders their accesses.  I: the
// index type (32 bits for shared tables, 64 for device-memory ones).
template <typename I, typename V, typename Sync>
__device__ void bitonic_sort(int32_t* keys, V* vals, I n, unsigned tid,
                             unsigned nthreads, Sync sync) {
  unsigned* uk = reinterpret_cast<unsigned*>(keys);
  for (I k = 2; k <= n; k <<= 1) {
    for (I j = k >> 1; j > 0; j >>= 1) {
      for (I p = tid; p < n / 2; p += nthreads) {
        const I i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const I l = i | j;
        const unsigned ka = uk[i], kb = uk[l];
        if ((ka > kb) == ((i & k) == 0)) {
          uk[i] = kb;
          uk[l] = ka;
          const V va = vals[i];
          vals[i] = vals[l];
          vals[l] = va;
        }
      }
      sync();
    }
  }
}

// -- binning -----------------------------------------------------------------

__global__ void bin_kernel(const int32_t* __restrict__ a_rpt,
                           const int32_t* __restrict__ a_col,
                           const int32_t* __restrict__ b_rpt,
                           int32_t* __restrict__ row_nnz, int mode,
                           int64_t m, int64_t n,
                           const __grid_constant__ Limits limits,
                           int n_edges, int tail_global,
                           int32_t* __restrict__ size_out,
                           int32_t* __restrict__ bin,
                           long long* __restrict__ goff,
                           u64* __restrict__ info) {
  __shared__ u64 hist[kMaxBins];
  __shared__ u64 nnz_sum;
  if (threadIdx.x < kMaxBins) hist[threadIdx.x] = 0;
  if (threadIdx.x == 0) nnz_sum = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       row < m; row += warps) {
    long long size;
    if (mode == 0) {  // symbolic: the row's products, capped at N
      long long p = 0;
      for (int j = a_rpt[row] + lane; j < a_rpt[row + 1]; j += 32) {
        const int k = a_col[j];
        p += b_rpt[k + 1] - b_rpt[k];
      }
      for (int o = 16; o; o >>= 1) p += __shfl_down_sync(0xffffffffu, p, o);
      size = p < n ? p : n;
    } else {  // numeric: the row's nnz
      size = row_nnz[row];
    }
    if (lane == 0) {
      int b = -1;
      if (size > 0) {
        b = 0;
        while (b < n_edges && size > limits.v[b]) ++b;
        atomicAdd(&hist[b], 1ull);
        if (b == n_edges && tail_global)
          goff[row] = static_cast<long long>(
              atomicAdd(info + kInfoGlobal, global_slots(size)));
      }
      bin[row] = b;
      if (mode == 0) {
        size_out[row] = static_cast<int32_t>(size);
        if (b < 0) row_nnz[row] = 0;
      } else {
        atomicAdd(&nnz_sum, static_cast<u64>(size));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x <= n_edges && hist[threadIdx.x])
    atomicAdd(info + threadIdx.x, hist[threadIdx.x]);
  if (threadIdx.x == 0 && mode == 1 && nnz_sum)
    atomicAdd(info + kInfoNnz, nnz_sum);
}

__global__ void scatter_kernel(const int32_t* __restrict__ bin, int64_t m,
                               u64* __restrict__ info, int n_bins,
                               int32_t* __restrict__ perm) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int b = row < m ? bin[row] : -1;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const int leader = __ffs(peers) - 1;
  const int rank = __popc(peers & ((1u << lane) - 1));
  u64 pos = 0;
  if (lane == leader && b >= 0)
    pos = atomicAdd(info + kInfoCursor + b, static_cast<u64>(__popc(peers)));
  pos = __shfl_sync(0xffffffffu, pos, leader);
  if (b < 0) return;
  u64 start = 0;
  for (int q = 0; q < b && q < n_bins; ++q) start += info[q];
  perm[start + pos + rank] = static_cast<int32_t>(row);
}

// -- symbolic: distinct columns per row --------------------------------------

template <int kLanes, int kSlots>
__global__ void sym_group_kernel(const int32_t* __restrict__ a_rpt,
                                 const int32_t* __restrict__ a_col,
                                 const int32_t* __restrict__ b_rpt,
                                 const int32_t* __restrict__ b_col,
                                 const int32_t* __restrict__ perm,
                                 int64_t n_rows,
                                 int32_t* __restrict__ row_nnz) {
  extern __shared__ int32_t smem[];
  constexpr int kShift = 32 - log2c(kSlots);
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kLanes) + g;
  int32_t* keys = smem + g * kSlots;
  for (int s = lane; s < kSlots; s += kLanes) keys[s] = kEmpty;
  __syncwarp();
  int cnt = 0;
  int row = -1;
  if (i < n_rows) {
    row = perm[i];
    const auto f = [&](int, int t) {
      cnt += insert_key(keys, kSlots - 1, kShift, b_col[t]);
    };
    for_products(a_rpt, a_col, b_rpt, row, 0, 1, lane, kLanes, f);
  }
  for (int o = kLanes / 2; o; o >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, o, kLanes);
  if (row >= 0 && lane == 0) row_nnz[row] = cnt;
}

// A block per row: the table in shared memory (`slots`), or, kGlobal, in
// device memory at goff[row], sized by the row's capped products.
template <bool kGlobal>
__global__ void sym_block_kernel(const int32_t* __restrict__ a_rpt,
                                 const int32_t* __restrict__ a_col,
                                 const int32_t* __restrict__ b_rpt,
                                 const int32_t* __restrict__ b_col,
                                 const int32_t* __restrict__ perm,
                                 const int32_t* __restrict__ size,
                                 const long long* __restrict__ goff,
                                 int32_t* gkeys, u64 slots,
                                 int32_t* __restrict__ row_nnz) {
  extern __shared__ int32_t smem[];
  const int row = perm[blockIdx.x];
  u64 t_slots = slots;
  int32_t* keys = smem;
  int* scratch = smem + (kGlobal ? 0 : slots);
  if (kGlobal) {
    t_slots = global_slots(size[row]);
    keys = gkeys + goff[row];
  }
  for (u64 s = threadIdx.x; s < t_slots; s += blockDim.x) keys[s] = kEmpty;
  __syncthreads();
  const unsigned mask = static_cast<unsigned>(t_slots - 1);
  const int shift = 32 - log2_of(t_slots);
  int cnt = 0;
  for_products(a_rpt, a_col, b_rpt, row, threadIdx.x >> 5,
               blockDim.x >> 5, threadIdx.x & 31, 32, [&](int, int t) {
                 cnt += insert_key(keys, mask, shift, b_col[t]);
               });
  const int total = block_sum(cnt, scratch);
  if (threadIdx.x == 0) row_nnz[row] = total;
}

// The dense route, symbolic: an occupancy bitmap of `slice` columns in
// shared memory, one pass over the row's products per slice of N.
__global__ void sym_dense_kernel(const int32_t* __restrict__ a_rpt,
                                 const int32_t* __restrict__ a_col,
                                 const int32_t* __restrict__ b_rpt,
                                 const int32_t* __restrict__ b_col,
                                 const int32_t* __restrict__ perm, int64_t n,
                                 int64_t slice,
                                 int32_t* __restrict__ row_nnz) {
  extern __shared__ int32_t smem[];
  const int row = perm[blockIdx.x];
  const int64_t words = slice / 32;
  unsigned* bm = reinterpret_cast<unsigned*>(smem);
  int* scratch = smem + words;
  int total = 0;
  for (int64_t c0 = 0; c0 < n; c0 += slice) {
    for (int64_t w = threadIdx.x; w < words; w += blockDim.x) bm[w] = 0;
    __syncthreads();
    int cnt = 0;
    for_products(a_rpt, a_col, b_rpt, row, threadIdx.x >> 5,
                 blockDim.x >> 5, threadIdx.x & 31, 32, [&](int, int t) {
                   const int64_t c = b_col[t] - c0;
                   if (c >= 0 && c < slice)
                     cnt += set_bit(bm, static_cast<int32_t>(c));
                 });
    total += block_sum(cnt, scratch);
    __syncthreads();
  }
  if (threadIdx.x == 0) row_nnz[row] = total;
}

// -- numeric: accumulate, sort by column, write ------------------------------

template <typename V, int kLanes, int kSlots>
__global__ void num_group_kernel(
    const int32_t* __restrict__ a_rpt, const int32_t* __restrict__ a_col,
    const V* __restrict__ a_val, const int32_t* __restrict__ b_rpt,
    const int32_t* __restrict__ b_col, const V* __restrict__ b_val,
    const int32_t* __restrict__ perm, int64_t n_rows,
    const int32_t* __restrict__ c_rpt, int32_t* __restrict__ c_col,
    V* __restrict__ c_val) {
  extern __shared__ int32_t smem[];
  constexpr int kShift = 32 - log2c(kSlots);
  const int groups = blockDim.x / kLanes;
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * groups + g;
  int32_t* keys = smem + g * kSlots;
  V* vals = reinterpret_cast<V*>(smem + groups * kSlots) + g * kSlots;
  for (int s = lane; s < kSlots; s += kLanes) {
    keys[s] = kEmpty;
    vals[s] = V(0);
  }
  __syncwarp();
  int row = -1;
  if (i < n_rows) {
    row = perm[i];
    const auto f = [&](int j, int t) {
      insert_add(keys, vals, kSlots - 1, kShift, b_col[t],
                 a_val[j] * b_val[t]);
    };
    for_products(a_rpt, a_col, b_rpt, row, 0, 1, lane, kLanes, f);
  }
  __syncwarp();
  // every group of the warp runs the network (empty tables too), so the
  // warp's barriers are reached by all its lanes
  bitonic_sort(keys, vals, static_cast<unsigned>(kSlots), lane, kLanes,
               WarpSync());
  if (row < 0) return;
  const int base = c_rpt[row], len = c_rpt[row + 1] - base;
  for (int t = lane; t < len; t += kLanes) {
    c_col[base + t] = keys[t];
    c_val[base + t] = vals[t];
  }
}

template <typename V, bool kGlobal>
__global__ void num_block_kernel(
    const int32_t* __restrict__ a_rpt, const int32_t* __restrict__ a_col,
    const V* __restrict__ a_val, const int32_t* __restrict__ b_rpt,
    const int32_t* __restrict__ b_col, const V* __restrict__ b_val,
    const int32_t* __restrict__ perm, const long long* __restrict__ goff,
    int32_t* gkeys, V* gvals, u64 slots, const int32_t* __restrict__ c_rpt,
    int32_t* __restrict__ c_col, V* __restrict__ c_val) {
  extern __shared__ int32_t smem[];
  const int row = perm[blockIdx.x];
  const int base = c_rpt[row], len = c_rpt[row + 1] - base;
  u64 t_slots = slots;
  int32_t* keys = smem;
  V* vals = reinterpret_cast<V*>(smem + slots);
  if (kGlobal) {
    t_slots = global_slots(len);
    keys = gkeys + goff[row];
    vals = gvals + goff[row];
  }
  for (u64 s = threadIdx.x; s < t_slots; s += blockDim.x) {
    keys[s] = kEmpty;
    vals[s] = V(0);
  }
  __syncthreads();
  const unsigned mask = static_cast<unsigned>(t_slots - 1);
  const int shift = 32 - log2_of(t_slots);
  for_products(a_rpt, a_col, b_rpt, row, threadIdx.x >> 5,
               blockDim.x >> 5, threadIdx.x & 31, 32, [&](int j, int t) {
                 insert_add(keys, vals, mask, shift, b_col[t],
                            a_val[j] * b_val[t]);
               });
  __syncthreads();
  if (kGlobal)
    bitonic_sort(keys, vals, t_slots, threadIdx.x, blockDim.x, BlockSync());
  else
    bitonic_sort(keys, vals, static_cast<unsigned>(t_slots), threadIdx.x,
                 blockDim.x, BlockSync());
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    c_col[base + t] = keys[t];
    c_val[base + t] = vals[t];
  }
}

// The dense route, numeric: `slice` values and a `slice`-bit occupancy
// bitmap in shared memory, one pass over the row's products per slice of
// N; the bitmap, read in column order, places the entries sorted.
template <typename V>
__global__ void __launch_bounds__(kDenseThreads, 2) num_dense_kernel(
    const int32_t* __restrict__ a_rpt, const int32_t* __restrict__ a_col,
    const V* __restrict__ a_val, const int32_t* __restrict__ b_rpt,
    const int32_t* __restrict__ b_col, const V* __restrict__ b_val,
    const int32_t* __restrict__ perm, int64_t n, int64_t slice,
    const int32_t* __restrict__ c_rpt, int32_t* __restrict__ c_col,
    V* __restrict__ c_val) {
  extern __shared__ int32_t smem[];
  const int row = perm[blockIdx.x];
  const int64_t words = slice / 32;
  V* acc = reinterpret_cast<V*>(smem);
  unsigned* bm = reinterpret_cast<unsigned*>(acc + slice);
  int* scratch = reinterpret_cast<int*>(bm + words);
  int pos = c_rpt[row];
  for (int64_t c0 = 0; c0 < n; c0 += slice) {
    for (int64_t c = threadIdx.x; c < slice; c += blockDim.x) acc[c] = V(0);
    for (int64_t w = threadIdx.x; w < words; w += blockDim.x) bm[w] = 0;
    __syncthreads();
    for_products(a_rpt, a_col, b_rpt, row, threadIdx.x >> 5,
                 blockDim.x >> 5, threadIdx.x & 31, 32, [&](int j, int t) {
                   const int64_t c = b_col[t] - c0;
                   if (c >= 0 && c < slice) {
                     atomicAdd(acc + c, a_val[j] * b_val[t]);
                     set_bit(bm, static_cast<int32_t>(c));
                   }
                 });
    __syncthreads();
    for (int64_t w0 = 0; w0 < words; w0 += blockDim.x) {
      const int64_t w = w0 + threadIdx.x;
      unsigned bits = w < words ? bm[w] : 0u;
      int total;
      int at = pos + block_exclusive_scan(__popc(bits), scratch, total);
      while (bits) {
        const int32_t c = static_cast<int32_t>(w * 32 + __ffs(bits) - 1);
        c_col[at] = static_cast<int32_t>(c0 + c);
        c_val[at] = acc[c];
        ++at;
        bits &= bits - 1;
      }
      pos += total;
    }
    __syncthreads();  // every read of this slice's values before the next
  }
}

// -- launch geometry ---------------------------------------------------------

// Dynamic shared memory of a route, as hash_routes computes it.
int64_t smem_bytes(int kind, u64 slots, int threads, int vb) {
  const int64_t slot = 4 + vb;  // vb 0 in the symbolic phase
  const int64_t scratch = kScratchInts * 4;
  switch (kind) {
    case kPwarp: return (threads / kPwarpLanes) * kPwarpSlots * slot;
    case kWarp: return (threads / kWarpLanes) * kWarpSlots * slot;
    case kBlock: return static_cast<int64_t>(slots) * slot + scratch;
    case kDense:  // a slice of `slots` columns: values and a bitmap
      return static_cast<int64_t>(slots) * vb + slots / 8 + scratch;
    default: return scratch;
  }
}

template <typename K>
cudaError_t prepare(K kernel, int64_t smem) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

unsigned group_grid(int64_t n_rows, int threads, int lanes) {
  const int64_t per = threads / lanes;
  return static_cast<unsigned>((n_rows + per - 1) / per);
}

template <typename V>
int launch_numeric(int kind, int64_t slots, int threads, const void* a_rpt,
                   const void* a_col, const void* a_val, const void* b_rpt,
                   const void* b_col, const void* b_val, const void* perm,
                   int64_t n_rows, const void* goff, void* gkeys, void* gvals,
                   int64_t n, const void* c_rpt, void* c_col, void* c_val,
                   void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = nsp::as_stream(stream);
  const int64_t smem = smem_bytes(kind, slots, threads, sizeof(V));
  const auto ar = static_cast<const int32_t*>(a_rpt);
  const auto ac = static_cast<const int32_t*>(a_col);
  const auto av = static_cast<const V*>(a_val);
  const auto br = static_cast<const int32_t*>(b_rpt);
  const auto bc = static_cast<const int32_t*>(b_col);
  const auto bv = static_cast<const V*>(b_val);
  const auto pm = static_cast<const int32_t*>(perm);
  const auto cr = static_cast<const int32_t*>(c_rpt);
  const auto cc = static_cast<int32_t*>(c_col);
  const auto cv = static_cast<V*>(c_val);
  cudaError_t err = cudaSuccess;
  switch (kind) {
    case kPwarp: {
      auto k = num_group_kernel<V, kPwarpLanes, kPwarpSlots>;
      if ((err = prepare(k, smem)) != cudaSuccess) return static_cast<int>(err);
      k<<<group_grid(n_rows, threads, kPwarpLanes), threads, smem, st>>>(
          ar, ac, av, br, bc, bv, pm, n_rows, cr, cc, cv);
      break;
    }
    case kWarp: {
      auto k = num_group_kernel<V, kWarpLanes, kWarpSlots>;
      if ((err = prepare(k, smem)) != cudaSuccess) return static_cast<int>(err);
      k<<<group_grid(n_rows, threads, kWarpLanes), threads, smem, st>>>(
          ar, ac, av, br, bc, bv, pm, n_rows, cr, cc, cv);
      break;
    }
    case kBlock:
    case kGlobal: {
      auto k = kind == kBlock ? num_block_kernel<V, false>
                              : num_block_kernel<V, true>;
      if ((err = prepare(k, smem)) != cudaSuccess) return static_cast<int>(err);
      k<<<static_cast<unsigned>(n_rows), threads, smem, st>>>(
          ar, ac, av, br, bc, bv, pm, static_cast<const long long*>(goff),
          static_cast<int32_t*>(gkeys), static_cast<V*>(gvals),
          static_cast<u64>(slots), cr, cc, cv);
      break;
    }
    case kDense: {
      auto k = num_dense_kernel<V>;
      if ((err = prepare(k, smem)) != cudaSuccess) return static_cast<int>(err);
      k<<<static_cast<unsigned>(n_rows), threads, smem, st>>>(
          ar, ac, av, br, bc, bv, pm, n, slots, cr, cc, cv);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
const void* numeric_kernel(int kind) {
  switch (kind) {
    case kPwarp:
      return (const void*)num_group_kernel<V, kPwarpLanes, kPwarpSlots>;
    case kWarp:
      return (const void*)num_group_kernel<V, kWarpLanes, kWarpSlots>;
    case kBlock: return (const void*)num_block_kernel<V, false>;
    case kGlobal: return (const void*)num_block_kernel<V, true>;
    case kDense: return (const void*)num_dense_kernel<V>;
    default: return nullptr;
  }
}

// The kernel of a route (phase 0 symbolic, 1 numeric; vb bytes a value).
const void* route_kernel(int phase, int kind, int vb) {
  if (phase == 1) {
    return vb == 4 ? numeric_kernel<float>(kind)
                   : vb == 8 ? numeric_kernel<double>(kind) : nullptr;
  }
  switch (kind) {
    case kPwarp:
      return (const void*)sym_group_kernel<kPwarpLanes, kPwarpSlots>;
    case kWarp:
      return (const void*)sym_group_kernel<kWarpLanes, kWarpSlots>;
    case kBlock: return (const void*)sym_block_kernel<false>;
    case kGlobal: return (const void*)sym_block_kernel<true>;
    case kDense: return (const void*)sym_dense_kernel;
    default: return nullptr;
  }
}

}  // namespace

// A route's kernel as it is launched: out[0..3] = resident blocks per SM,
// registers a thread, spilled (local) bytes a thread, dynamic shared
// memory bytes a block.
NSP_EXPORT int nsp_hash_geom(int phase, int kind, int vb, int64_t slots,
                             int threads, int* out) {
  const void* k = route_kernel(phase, kind, vb);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = smem_bytes(kind, slots, threads, phase ? vb : 0);
  cudaError_t e = prepare(k, smem);
  cudaFuncAttributes fa{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = per_sm;
  out[1] = fa.numRegs;
  out[2] = static_cast<int>(fa.localSizeBytes);
  out[3] = static_cast<int>(smem);
  return 0;
}

NSP_EXPORT int nsp_hash_bin(const void* a_rpt, const void* a_col,
                            const void* b_rpt, void* row_nnz, int mode,
                            int64_t m, int64_t n, const int64_t* limits,
                            int n_limits, int tail_global, void* size,
                            void* bin, void* goff, void* info, void* stream) {
  if (m > 0) {
    if (n_limits < 1 || n_limits >= kMaxBins)
      return static_cast<int>(cudaErrorInvalidValue);
    Limits lim{};
    for (int b = 0; b < n_limits; ++b) lim.v[b] = limits[b];
    const int64_t warps_per_block = kBinThreads / 32;
    int64_t grid = (m + warps_per_block - 1) / warps_per_block;
    if (grid > 4096) grid = 4096;
    bin_kernel<<<static_cast<unsigned>(grid), kBinThreads, 0,
                 nsp::as_stream(stream)>>>(
        static_cast<const int32_t*>(a_rpt), static_cast<const int32_t*>(a_col),
        static_cast<const int32_t*>(b_rpt), static_cast<int32_t*>(row_nnz),
        mode, m, n, lim, n_limits, tail_global, static_cast<int32_t*>(size),
        static_cast<int32_t*>(bin),
        static_cast<long long*>(goff), static_cast<u64*>(info));
  }
  return static_cast<int>(cudaGetLastError());
}

NSP_EXPORT int nsp_hash_scatter(const void* bin, int64_t m, void* info,
                                int n_bins, void* perm, void* stream) {
  constexpr int kThreads = 256;
  if (m > 0) {
    scatter_kernel<<<nsp::blocks_for(m, kThreads), kThreads, 0,
                     nsp::as_stream(stream)>>>(
        static_cast<const int32_t*>(bin), m, static_cast<u64*>(info), n_bins,
        static_cast<int32_t*>(perm));
  }
  return static_cast<int>(cudaGetLastError());
}

NSP_EXPORT int nsp_hash_symbolic(int kind, int64_t slots, int threads,
                                 const void* a_rpt, const void* a_col,
                                 const void* b_rpt, const void* b_col,
                                 const void* perm, int64_t n_rows,
                                 const void* size, const void* goff,
                                 void* gkeys, int64_t n, void* row_nnz,
                                 void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = nsp::as_stream(stream);
  const int64_t smem = smem_bytes(kind, slots, threads, 0);
  const auto ar = static_cast<const int32_t*>(a_rpt);
  const auto ac = static_cast<const int32_t*>(a_col);
  const auto br = static_cast<const int32_t*>(b_rpt);
  const auto bc = static_cast<const int32_t*>(b_col);
  const auto pm = static_cast<const int32_t*>(perm);
  const auto out = static_cast<int32_t*>(row_nnz);
  cudaError_t err = cudaSuccess;
  switch (kind) {
    case kPwarp: {
      auto k = sym_group_kernel<kPwarpLanes, kPwarpSlots>;
      if ((err = prepare(k, smem)) != cudaSuccess) return static_cast<int>(err);
      k<<<group_grid(n_rows, threads, kPwarpLanes), threads, smem, st>>>(
          ar, ac, br, bc, pm, n_rows, out);
      break;
    }
    case kWarp: {
      auto k = sym_group_kernel<kWarpLanes, kWarpSlots>;
      if ((err = prepare(k, smem)) != cudaSuccess) return static_cast<int>(err);
      k<<<group_grid(n_rows, threads, kWarpLanes), threads, smem, st>>>(
          ar, ac, br, bc, pm, n_rows, out);
      break;
    }
    case kBlock:
    case kGlobal: {
      auto k = kind == kBlock ? sym_block_kernel<false>
                              : sym_block_kernel<true>;
      if ((err = prepare(k, smem)) != cudaSuccess) return static_cast<int>(err);
      k<<<static_cast<unsigned>(n_rows), threads, smem, st>>>(
          ar, ac, br, bc, pm, static_cast<const int32_t*>(size),
          static_cast<const long long*>(goff), static_cast<int32_t*>(gkeys),
          static_cast<u64>(slots), out);
      break;
    }
    case kDense: {
      auto k = sym_dense_kernel;
      if ((err = prepare(k, smem)) != cudaSuccess) return static_cast<int>(err);
      k<<<static_cast<unsigned>(n_rows), threads, smem, st>>>(
          ar, ac, br, bc, pm, n, slots, out);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#define NSP_HASH_NUMERIC(SUFFIX, T)                                           \
  NSP_EXPORT int nsp_hash_numeric_##SUFFIX(                                   \
      int kind, int64_t slots, int threads, const void* a_rpt,                \
      const void* a_col, const void* a_val, const void* b_rpt,                \
      const void* b_col, const void* b_val, const void* perm,                 \
      int64_t n_rows, const void* goff, void* gkeys, void* gvals, int64_t n,  \
      const void* c_rpt, void* c_col, void* c_val, void* stream) {            \
    return launch_numeric<T>(kind, slots, threads, a_rpt, a_col, a_val,       \
                             b_rpt, b_col, b_val, perm, n_rows, goff, gkeys,  \
                             gvals, n, c_rpt, c_col, c_val, stream);          \
  }

NSP_HASH_NUMERIC(f32, float)
NSP_HASH_NUMERIC(f64, double)
