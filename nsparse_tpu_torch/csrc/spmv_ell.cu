// K14: the ELL SpMV in one pass,
//   slot[s0 + r] = sum over w < lens[r] of vals[w, r] * x[cols[w, r]]
//                  for every row r of every width-binned slab, then
//   y[i] = slot[pos[i]] + the slots of row i's extra chunks (split rows).
//
// Replaces no TPU kernel: the JAX package's ELL SpMV
// (nsparse_tpu/ops/spmv.py:92) expands x to one value per slot through
// planned gathers (Pallas K5 and K1, or the x-shuffle's K5, K5 and K1),
// then multiplies and sums each slab with XLA, because the TPU has no
// fast gather.  On Hopper the card gathers x itself, so the expansion,
// the product array and the sums (37 launches a call on Graph500 scale
// 21, 307 MB written and read three times) become two launches.
//
// Bound: device memory.  Each stored entry's value and column are read
// once, each row's length, position and output once; x is gathered from
// L2 (it is far smaller than the slabs).  Design:
//   - slabs are width-major (W, R): lanes take consecutive rows at one w,
//     so each warp load of values and columns is one 128-byte line, read
//     with streaming loads (evict-first) so the slabs do not push x out
//     of L2; x is read through the read-only path;
//   - a lane stops at its row's length and the warp at its longest row,
//     so padded sectors are never fetched (rows are sorted by length
//     inside windows of sigma rows, so neighbouring lanes stop together);
//   - a thread per row at every width, with kUnroll loads in flight a
//     lane (rows wider than the ELL's split width, 512 by default, are
//     split into chunks on the host).  On Graph500 scale 21 (widths
//     2-512) a thread per row took 0.471 ms where w split over 2-8 warps
//     of a block, in ranges of 64, took 0.494 and ranges of 128 took
//     0.482 (tools/k14_variants.py at the time);
//   - the sums have one fixed order, without atomics: a row's terms in
//     ascending w, a split row's chunks added in the order of its
//     `split_slots`.  Every
//     product and sum is rounded on its own (no FMA contraction), so y is
//     the same bit for bit from call to call and equal to the plain
//     version (ops/kernels/spmv_ell.py), which takes the same order.
// Every slab runs in one launch: the slab table (pointers, width, rows,
// first slot and first block of each) is a kernel parameter
// passed by value, filled from a host array, so no device table is
// built per call.  Blocks take the widest slabs first.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;         // 8 warps a block
constexpr int kMaxSlabs = 32;         // ops/kernels/spmv_ell.py:MAX_SLABS
constexpr int kFields = 7;            // host table int64s a slab
constexpr int kUnroll = 8;            // loads in flight a lane
constexpr int kSplitLoads = 4;        // a split row's chunk loads a lane
constexpr unsigned kFull = 0xffffffffu;

struct Slab {
  const void* val;      // (width, rows) values
  const int32_t* col;   // (width, rows) columns
  const int32_t* len;   // (rows,) row lengths
  int64_t rows;
  int64_t slot0;        // the slab's first output slot
  int64_t block0;       // the slab's first block
  int width;
};

struct Slabs {
  Slab s[kMaxSlabs];
  int n;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_slabs_kernel(const Slabs slabs, const T* __restrict__ x,
                 T* __restrict__ out) {
  __shared__ Slab sl;
  if (threadIdx.x == 0) {
    // the block's slab; read with compile-time indices only, since a
    // kernel parameter indexed at run time would be copied to local
    // memory
    const int64_t b = blockIdx.x;
    int s = 0;
#pragma unroll
    for (int i = 1; i < kMaxSlabs; ++i)
      if (i < slabs.n && b >= slabs.s[i].block0) s = i;
#pragma unroll
    for (int i = 0; i < kMaxSlabs; ++i)
      if (i == s) sl = slabs.s[i];
  }
  __syncthreads();
  const int64_t rows = sl.rows;
  const int64_t r = (static_cast<int64_t>(blockIdx.x) - sl.block0)
                        * kThreads + threadIdx.x;
  const int n = r < rows ? min(__ldcs(sl.len + r), sl.width) : 0;
  const int n_warp = __reduce_max_sync(kFull, n);

  const T* v = static_cast<const T*>(sl.val) + r;
  const int32_t* c = sl.col + r;
  T acc = T(0);
  for (int k = 0; k < n_warp; k += kUnroll) {
    T pv[kUnroll], px[kUnroll];
    int pc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pv[u] = T(0);
      pc[u] = 0;
      if (k + u < n) {
        pv[u] = __ldcs(v + (k + u) * rows);
        pc[u] = __ldcs(c + (k + u) * rows);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      px[u] = k + u < n ? __ldg(x + pc[u]) : T(0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u < n) acc = add(acc, mul(pv[u], px[u]));
  }
  if (r < rows) out[sl.slot0 + r] = acc;
}

// y[i] = slot[pos[i]], plus, for a split row, its extra chunks' slots in
// the order of its row of split_slots (-1 pads, which trail).  Block b's
// rows hold split rows split_run[b] .. split_run[b + 1] - 1 (split_rows
// ascending; at most one a thread): each is marked in shared memory by
// its row.  A warp then takes its split rows one at a time: its lanes
// load kSplitLoads * 32 of the row's chunk sums at once and the row's
// thread adds them in order, so a hub row of hundreds of chunks waits for
// a few rounds of loads, not for one load a chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const T* __restrict__ slot, const int32_t* __restrict__ pos,
                int64_t m, const int32_t* __restrict__ split_rows,
                const int32_t* __restrict__ split_slots,
                const int32_t* __restrict__ split_run, int split_cols,
                T* __restrict__ y) {
  __shared__ int split_of[kThreads];  // the row's split entry, or -1
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t r = r0 + threadIdx.x;
  const int lane = threadIdx.x & 31;
  T v = r < m ? __ldg(slot + __ldcs(pos + r)) : T(0);
  if (split_run == nullptr) {  // no split rows: uniform in the grid
    if (r < m) y[r] = v;
    return;
  }
  const int lo = split_run[blockIdx.x], hi = split_run[blockIdx.x + 1];
  split_of[threadIdx.x] = -1;
  __syncthreads();
  if (threadIdx.x < hi - lo)
    split_of[split_rows[lo + threadIdx.x] - r0] = lo + threadIdx.x;
  __syncthreads();
  const int k = split_of[threadIdx.x];
  unsigned todo = __ballot_sync(kFull, k >= 0);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const int32_t* s = split_slots
        + static_cast<int64_t>(__shfl_sync(kFull, k, owner)) * split_cols;
    bool more = true;
    for (int c0 = 0; more && c0 < split_cols; c0 += kSplitLoads * 32) {
      int32_t t[kSplitLoads];
      T part[kSplitLoads];
#pragma unroll
      for (int u = 0; u < kSplitLoads; ++u) {
        const int c = c0 + u * 32 + lane;
        t[u] = c < split_cols ? s[c] : -1;
      }
#pragma unroll
      for (int u = 0; u < kSplitLoads; ++u)
        part[u] = t[u] >= 0 ? __ldg(slot + t[u]) : T(0);
#pragma unroll
      for (int u = 0; u < kSplitLoads; ++u) {
        const unsigned have = __ballot_sync(kFull, t[u] >= 0);
        for (int q = 0; q < 32; ++q) {
          const T pq = __shfl_sync(kFull, part[u], q);
          if (lane == owner && (have >> q & 1u)) v = add(v, pq);
        }
        more = more && have == kFull;
      }
    }
  }
  if (r < m) y[r] = v;
}

template <typename T>
int launch_slabs(const void* x, void* out, const int64_t* table, int n_slabs,
                 int64_t n_blocks, void* stream) {
  if (n_slabs < 0 || n_slabs > kMaxSlabs) return cudaErrorInvalidValue;
  Slabs slabs{};
  for (int i = 0; i < n_slabs; ++i) {
    const int64_t* f = table + kFields * i;
    slabs.s[i].val = reinterpret_cast<const void*>(f[0]);
    slabs.s[i].col = reinterpret_cast<const int32_t*>(f[1]);
    slabs.s[i].len = reinterpret_cast<const int32_t*>(f[2]);
    slabs.s[i].rows = f[3];
    slabs.s[i].width = static_cast<int>(f[4]);
    slabs.s[i].slot0 = f[5];
    slabs.s[i].block0 = f[6];
  }
  slabs.n = n_slabs;
  if (n_blocks > 0) {
    ell_slabs_kernel<T><<<static_cast<unsigned int>(n_blocks), kThreads, 0,
                          nsp::as_stream(stream)>>>(
        slabs, static_cast<const T*>(x), static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* slot, const void* pos, int64_t m,
                const void* split_rows, const void* split_slots,
                const void* split_run, int split_cols, void* y,
                void* stream) {
  if (m > 0) {
    ell_rows_kernel<T><<<nsp::blocks_for(m, kThreads), kThreads, 0,
                         nsp::as_stream(stream)>>>(
        static_cast<const T*>(slot), static_cast<const int32_t*>(pos), m,
        static_cast<const int32_t*>(split_rows),
        static_cast<const int32_t*>(split_slots),
        static_cast<const int32_t*>(split_run), split_cols,
        static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_spmv_ell_slabs_f32(const void* x, void* out,
                                      const int64_t* table, int n_slabs,
                                      int64_t n_blocks, void* stream) {
  return launch_slabs<float>(x, out, table, n_slabs, n_blocks, stream);
}

NSP_EXPORT int nsp_spmv_ell_slabs_f64(const void* x, void* out,
                                      const int64_t* table, int n_slabs,
                                      int64_t n_blocks, void* stream) {
  return launch_slabs<double>(x, out, table, n_slabs, n_blocks, stream);
}

NSP_EXPORT int nsp_spmv_ell_rows_f32(const void* slot, const void* pos,
                                     int64_t m, const void* split_rows,
                                     const void* split_slots,
                                     const void* split_run, int split_cols,
                                     void* y, void* stream) {
  return launch_rows<float>(slot, pos, m, split_rows, split_slots, split_run,
                            split_cols, y, stream);
}

NSP_EXPORT int nsp_spmv_ell_rows_f64(const void* slot, const void* pos,
                                     int64_t m, const void* split_rows,
                                     const void* split_slots,
                                     const void* split_run, int split_cols,
                                     void* y, void* stream) {
  return launch_rows<double>(slot, pos, m, split_rows, split_slots,
                             split_run, split_cols, y, stream);
}
