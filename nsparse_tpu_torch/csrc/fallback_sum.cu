// K13: the window numeric's fallback segment in one launch.
//
// Members (ops/kernels/fallback.py builds the tables): the slab's level-0
// class members, the segment's gap slots, the entries past 512 products.
//   out[dst[m]] = the slab tree sum of member m's slots (src -1: a pad,
//                 +0.0); a gap slot takes +0.0; dst -1: no write.
// The members with a slot cover the segment once, so one launch writes
// every slot of it.
//
// The slab tree (spgemm.slab_class_reduce, the sums this replaces): a
// class of width L holds its members' slots member-minor (slot t of
// member m at t * cnt + m), and halving adds pair slot t with t + L/2,
// then t + L/4, down to t + 1.  That is pairwise summation over the slots
// in bit-reversed order: leaf r is slot bitrev(r), leaves r and r + 1 pair
// first.  An entry past 512 products is a run of width-512 members (its
// chunks), and its sum a tree of its chunk sums: width their count
// rounded up to a power of two, or past 512 chunks, width-512 trees of
// 512 chunk sums and a tree of those.  The sums here are those trees, add
// for add, so the segment equals the slab route's bit for bit.
//
// Replaces the fallback stage of the window numeric: K1 into the slabs,
// one torch add per halving step of every class, the level gathers, cat,
// pad, K1 into segment order and the copy into the merge buffer (some 60
// launches a call on Graph500 scale 13); on the TPU, slab_class_reduce's
// XLA adds around shuffle_pallas.planned_shuffle.
//
// Bound: device memory.  Each slot's 4-byte source and each product are
// read once, each segment slot written once with its 4-byte slot.  The
// product reads are scattered: what bounds the kernel in practice is how
// many it keeps in flight and how many sectors they touch.  Design, by
// class width L:
//   L <= 64    a thread per member, a warp per 32 consecutive members, so
//              a warp's loads of one slot t are one coalesced read of
//              sources, and the neighbouring members' products they name
//              share sectors; the thread sums its leaves in bit-reversed
//              order, 16 loads in flight, partial sums in registers;
//   128..512   a warp per member: slot t at lane t % 32, register t / 32,
//              strides 256..32 added in registers, 16..1 by shuffles (a
//              thread per member of 128 took 9% longer on Graph500 scale
//              13 and 51% on R-MAT-14: its 8 batches in turn);
//   long       a block per entry: its warps take the chunks in turn (a
//              warp per chunk, as above) and the chunk sums meet in
//              shared memory, where warp 0 sums them.
// Each warp reads its class and first member from a table in launch
// order: the long entries' blocks first, then every warp by the first
// segment slot it writes, so that warps running together read nearby
// products and the pool's sectors are read from device memory about once
// (the warps class after class took 2.1 times as long on Graph500 scale
// 13).  The class table arrives as a host array, passed by value.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;             // spgemm.CHUNK
constexpr int kRegs = kChunk / 32;      // slots a lane holds of a chunk
constexpr int kBatch = 16;              // leaves a thread loads at once
constexpr int kMaxClasses = 12;         // widths 1..512, gaps, long entries
constexpr int kGap = -1, kLong = 0;     // the width codes of those two
constexpr int kThreadMax = 64;          // widths a thread per member
constexpr unsigned kFull = 0xffffffffu;

// Read with compile-time indices only: a kernel parameter indexed at run
// time would be copied to local memory.
struct Classes {
  int width[kMaxClasses];
  int64_t s0[kMaxClasses];   // first slot
  int64_t cnt[kMaxClasses];  // members (a class's slot stride)
  int64_t m0[kMaxClasses];   // first member
  int n;
};

__host__ __device__ constexpr int bitrev(int r, int bits) {
  int o = 0;
  for (int i = 0; i < bits; ++i) o |= ((r >> i) & 1) << (bits - 1 - i);
  return o;
}

__device__ __forceinline__ int ceil_pow2(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

template <typename T>
__device__ __forceinline__ T value(const T* __restrict__ x, int32_t j) {
  return j >= 0 ? __ldg(x + j) : T(0);
}

// Pairwise summation of v[0..n) in place: adjacent values pair first.
template <typename T, int n>
__device__ __forceinline__ T pairwise(T (&v)[n]) {
#pragma unroll
  for (int w = 1; w < n; w <<= 1) {
#pragma unroll
    for (int i = 0; i + w < n; i += 2 * w) v[i] = v[i] + v[i + w];
  }
  return v[0];
}

// One member of width 1 << LOG, a thread: slot t at s[t * stride]; its
// products are loaded only where ``live``.  Batches of 16 leaves are
// whole subtrees; part[k] holds the finished subtree of 2^k batches left
// of the current one, as a binary counter.
template <typename T, int LOG>
__device__ T member_sum(const T* __restrict__ x,
                        const int32_t* __restrict__ s, int64_t stride,
                        bool live) {
  constexpr int L = 1 << LOG;
  constexpr int B = L < kBatch ? L : kBatch;
  constexpr int NB = L / B;
  T part[4];
  T cur = T(0);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    int32_t j[B];
    T v[B];
#pragma unroll
    for (int i = 0; i < B; ++i)
      j[i] = __ldg(s + stride * bitrev(b * B + i, LOG));
#pragma unroll
    for (int i = 0; i < B; ++i) v[i] = value(x, live ? j[i] : -1);
    cur = pairwise(v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (((b >> k) & 1) == 0) {
        part[k] = cur;
        break;
      }
      cur = part[k] + cur;
    }
  }
  return cur;
}

template <typename T>
__device__ __forceinline__ T member_class(const T* __restrict__ x,
                                          const int32_t* __restrict__ s,
                                          int64_t stride, bool live, int L) {
  switch (L) {
    case 1: return member_sum<T, 0>(x, s, stride, live);
    case 2: return member_sum<T, 1>(x, s, stride, live);
    case 4: return member_sum<T, 2>(x, s, stride, live);
    case 8: return member_sum<T, 3>(x, s, stride, live);
    case 16: return member_sum<T, 4>(x, s, stride, live);
    case 32: return member_sum<T, 5>(x, s, stride, live);
    default: return member_sum<T, 6>(x, s, stride, live);
  }
}

// Halving adds over a lane's registers: slot t = 32 r + lane of a tree of
// 32 * regs slots, strides 16 regs .. 32 slots.
template <typename T>
__device__ __forceinline__ T reg_tree(T (&v)[kRegs], int regs) {
#pragma unroll
  for (int h = kRegs / 2; h >= 1; h >>= 1) {
    if (h < regs) {
#pragma unroll
      for (int r = 0; r < h; ++r) v[r] += v[r + h];
    }
  }
  return v[0];
}

// Halving adds across the warp's lanes: lane 0 ends with the tree sum of
// the ``width`` (a power of two <= 32) lanes from it.
template <typename T>
__device__ __forceinline__ T lane_tree(T v, int width) {
  for (int d = width >> 1; d >= 1; d >>= 1)
    v += __shfl_down_sync(kFull, v, d);
  return v;
}

// The tree of width L over values held as slot t = 32 r + lane.
template <typename T>
__device__ __forceinline__ T warp_tree(T (&v)[kRegs], int L) {
  if (L < 32) return lane_tree(v[0], L);
  return lane_tree(reg_tree(v, L >> 5), 32);
}

// A member's width-32 regs tree, a warp: slot t at s[t * stride]; lane 0
// holds the sum.
template <typename T>
__device__ __forceinline__ T wide_sum(const T* __restrict__ x,
                                      const int32_t* __restrict__ s,
                                      int64_t stride, int regs, int lane) {
  int32_t j[kRegs];
  T v[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r)
    j[r] = r < regs ? __ldg(s + stride * (32 * r + lane)) : -1;
#pragma unroll
  for (int r = 0; r < kRegs; ++r) v[r] = value(x, j[r]);
  return warp_tree(v, 32 * regs);
}

// The tree of width L over the n values of a block's shared array (the
// rest +0.0), a warp; lane 0 holds the sum.
template <typename T>
__device__ __forceinline__ T shared_tree(const T* a, int n, int L,
                                         int lane) {
  T v[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int t = 32 * r + lane;
    v[r] = t < n ? a[t] : T(0);
  }
  return warp_tree(v, L);
}

// A long entry of nch chunks, chunk c's slots from s + c, a block: its
// warps take the chunks in turn, the chunk sums (past 512 chunks, 512 at
// a time) meet in shared memory, and warp 0 sums them by the tree of
// their count (past 512 chunks, width-512 trees into part2, then the tree
// of those).  Lane 0 of warp 0 holds the sum.
template <typename T>
__device__ T long_entry(const T* __restrict__ x,
                        const int32_t* __restrict__ s, int64_t stride,
                        int nch, int lane, int warp, T* part1, T* part2) {
  const bool deep = nch > kChunk;
  const int groups = deep ? (nch + kChunk - 1) / kChunk : 1;
  T sum = T(0);
  for (int g = 0; g < groups; ++g) {
    const int c0 = g * kChunk;
    const int n = nch - c0 < kChunk ? nch - c0 : kChunk;
    for (int c = warp; c < n; c += kThreads / 32) {
      const T cs = wide_sum(x, s + c0 + c, stride, kRegs, lane);
      if (lane == 0) part1[c] = cs;
    }
    __syncthreads();
    if (warp == 0) {
      sum = shared_tree(part1, n, deep ? kChunk : ceil_pow2(n), lane);
      if (deep && lane == 0) part2[g] = sum;
    }
    __syncthreads();
  }
  if (deep && warp == 0)
    sum = shared_tree(part2, groups, ceil_pow2(groups), lane);
  return sum;
}

// At most 64 registers a thread: four blocks an SM.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
fallback_kernel(const T* __restrict__ x, const int32_t* __restrict__ src,
                const int32_t* __restrict__ dst,
                const int32_t* __restrict__ chunks,
                const int32_t* __restrict__ warps, int64_t n_warps,
                Classes cls, T* __restrict__ out) {
  const int64_t gw =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= n_warps) return;  // the whole warp
  const int2 d = __ldg(reinterpret_cast<const int2*>(warps) + gw);
  int L = 0;
  int64_t s0 = 0, cnt = 0, m0 = 0, s512 = 0, cnt512 = 0;
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k) {
    if (k < cls.n && k == d.x) {
      L = cls.width[k];
      s0 = cls.s0[k];
      cnt = cls.cnt[k];
      m0 = cls.m0[k];
    }
    if (k < cls.n && cls.width[k] == kChunk) {
      s512 = cls.s0[k];
      cnt512 = cls.cnt[k];
    }
  }
  if (L == kLong) {
    // the whole block: its warps' descriptors name one entry
    __shared__ T part1[kChunk], part2[kChunk];
    const int64_t e = d.y;
    const int2 ch = __ldg(reinterpret_cast<const int2*>(chunks) + e);
    const int warp = threadIdx.x >> 5;
    const T v = long_entry(x, src + s512 + ch.x, cnt512, ch.y, lane, warp,
                           part1, part2);
    if (warp == 0 && lane == 0) out[dst[m0 + e]] = v;
    return;
  }
  if (L > kThreadMax) {
    // a warp per member
    const int32_t j = __ldg(dst + m0 + d.y);
    const T v = wide_sum(x, src + s0 + d.y, cnt, L >> 5, lane);
    if (lane == 0) out[j] = v;
    return;
  }
  const int64_t m = d.y + lane;
  const int32_t j = __ldg(dst + m0 + m);
  if (L == kGap) {
    if (j >= 0) out[j] = T(0);
    return;
  }
  const T v = member_class(x, src + s0 + m, cnt, j >= 0, L);
  if (j >= 0) out[j] = v;
}

template <typename T>
int launch_fallback(const void* x, const void* src, const void* dst,
                    const void* chunks, const void* warps, int64_t n_warps,
                    const int64_t* classes, int n_cls, void* out,
                    void* stream) {
  if (n_cls < 0 || n_cls > kMaxClasses)
    return static_cast<int>(cudaErrorInvalidValue);
  Classes cls{};
  cls.n = n_cls;
  for (int c = 0; c < n_cls; ++c) {
    const int64_t w = classes[4 * c];
    if (w < kGap || w > kChunk || (w > 0 && (w & (w - 1))))
      return static_cast<int>(cudaErrorInvalidValue);
    cls.width[c] = static_cast<int>(w);
    cls.s0[c] = classes[4 * c + 1];
    cls.cnt[c] = classes[4 * c + 2];
    cls.m0[c] = classes[4 * c + 3];
  }
  if (n_warps > 0) {
    fallback_kernel<T><<<nsp::blocks_for(n_warps * 32, kThreads), kThreads,
                         0, nsp::as_stream(stream)>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(dst), static_cast<const int32_t*>(chunks),
        static_cast<const int32_t*>(warps), n_warps, cls,
        static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_fallback_sum_f32(const void* x, const void* src,
                                    const void* dst, const void* chunks,
                                    const void* warps, int64_t n_warps,
                                    const int64_t* classes, int n_cls,
                                    void* out, void* stream) {
  return launch_fallback<float>(x, src, dst, chunks, warps, n_warps, classes,
                                n_cls, out, stream);
}

NSP_EXPORT int nsp_fallback_sum_f64(const void* x, const void* src,
                                    const void* dst, const void* chunks,
                                    const void* warps, int64_t n_warps,
                                    const int64_t* classes, int n_cls,
                                    void* out, void* stream) {
  return launch_fallback<double>(x, src, dst, chunks, warps, n_warps,
                                 classes, n_cls, out, stream);
}
