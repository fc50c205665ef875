// K9: block-sparse SpGEMM tile products,
//   c[t] = sum over pairs p in [c_pair_start[t], c_pair_start[t+1]) of
//          a_blocks[pair_a[p]] @ b_blocks[pair_b[p]],
// over dense (bs, bs) row-major tiles, bs a multiple of 64.  Every C tile
// is written whole, once (a tile without pairs gives 0).
//
// Replaces spgemm_bsr.spgemm_bsr_blocks (pallas_call :354).  The TPU kernel
// walks the pairs on a sequential grid sorted by C tile and carries the C
// tile across consecutive steps in VMEM, one 256^3 MXU product per step at
// Precision.HIGHEST.  On Hopper blocks run in parallel and in no order, so
// one block owns one 64 x 64 sub-tile of one C tile (blockIdx.x the C
// tile, since gridDim.y stops at 65535; blockIdx.y the sub-tile) and loops
// over its C tile's pairs itself: no accumulator crosses blocks, no
// atomics, C written once in a fixed order (bitwise reproducible runs).
//
// Bound: operations, 2 * n_pairs * bs^3 at the non-tensor-core peak (the
// bytes, two tiles per pair and the C tiles once, take about a third of
// that time at bs 256).  First design, right and simple: per 32-wide
// k-slice the block stages a 64 x 32 slice of A (rows padded to 33, so the
// column reads of one warp hit distinct banks) and a 32 x 64 slice of B in
// shared memory with coalesced loads, then each of its 256 threads keeps a
// 4 x 4 register tile (rows ty + 16 i, columns tx + 16 j: conflict-free
// shared reads, coalesced stores) and accumulates with plain FFMA (f32) or
// DFMA (f64): no TF32.  Offsets are int64.  Tensor cores (3xTF32-split
// mma/wgmma for f32, DMMA for f64) and TMA-fed tile rings are later work.
#include "common.cuh"

namespace {

constexpr int kSub = 64;                  // C sub-tile edge of one block
constexpr int kK = 32;                    // k-slice staged per step
constexpr int kSide = 16;                 // threads per side of the block
constexpr int kThreads = kSide * kSide;   // 4 x 4 outputs each
constexpr int kReg = kSub / kSide;

template <typename T>
__global__ void __launch_bounds__(kThreads)
spgemm_bsr_kernel(const T* __restrict__ a_blocks,
                  const T* __restrict__ b_blocks,
                  const int32_t* __restrict__ pair_a,
                  const int32_t* __restrict__ pair_b,
                  const int32_t* __restrict__ c_pair_start, int bs,
                  T* __restrict__ c) {
  __shared__ T as[kSub][kK + 1];
  __shared__ T bsm[kK][kSub];
  const int64_t ct = blockIdx.x;
  const int subs = bs / kSub;
  const int r0 = (blockIdx.y / subs) * kSub;
  const int c0 = (blockIdx.y % subs) * kSub;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int64_t tile = static_cast<int64_t>(bs) * bs;

  T acc[kReg][kReg];
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
#pragma unroll
    for (int j = 0; j < kReg; ++j) acc[i][j] = T(0);
  }

  const int32_t p0 = c_pair_start[ct], p1 = c_pair_start[ct + 1];
  for (int32_t p = p0; p < p1; ++p) {
    const T* a = a_blocks + static_cast<int64_t>(pair_a[p]) * tile +
                 static_cast<int64_t>(r0) * bs;
    const T* b = b_blocks + static_cast<int64_t>(pair_b[p]) * tile + c0;
    for (int k0 = 0; k0 < bs; k0 += kK) {
      // one warp reads 32 consecutive values of a row of each slice
#pragma unroll
      for (int i = 0; i < kSub * kK / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int r = e / kK, k = e % kK;
        as[r][k] = a[static_cast<int64_t>(r) * bs + k0 + k];
      }
#pragma unroll
      for (int i = 0; i < kK * kSub / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int k = e / kSub, col = e % kSub;
        bsm[k][col] = b[static_cast<int64_t>(k0 + k) * bs + col];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kK; ++k) {
        T av[kReg], bv[kReg];
#pragma unroll
        for (int i = 0; i < kReg; ++i) av[i] = as[ty + kSide * i][k];
#pragma unroll
        for (int j = 0; j < kReg; ++j) bv[j] = bsm[k][tx + kSide * j];
#pragma unroll
        for (int i = 0; i < kReg; ++i) {
#pragma unroll
          for (int j = 0; j < kReg; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();  // the slices are read before the next ones land
    }
  }

  T* out = c + ct * tile + static_cast<int64_t>(r0) * bs + c0;
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      out[static_cast<int64_t>(ty + kSide * i) * bs + tx + kSide * j] =
          acc[i][j];
    }
  }
}

template <typename T>
int launch_spgemm_bsr(const void* a_blocks, const void* b_blocks,
                      const void* pair_a, const void* pair_b,
                      const void* c_pair_start, int64_t n_c_blocks, int bs,
                      void* c, void* stream) {
  if (bs <= 0 || bs % kSub) return static_cast<int>(cudaErrorInvalidValue);
  if (n_c_blocks > 0) {
    const int subs = bs / kSub;
    const dim3 grid(static_cast<unsigned int>(n_c_blocks),
                    static_cast<unsigned int>(subs * subs));
    spgemm_bsr_kernel<T><<<grid, kThreads, 0, nsp::as_stream(stream)>>>(
        static_cast<const T*>(a_blocks), static_cast<const T*>(b_blocks),
        static_cast<const int32_t*>(pair_a),
        static_cast<const int32_t*>(pair_b),
        static_cast<const int32_t*>(c_pair_start), bs, static_cast<T*>(c));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_spgemm_bsr_f32(const void* a_blocks, const void* b_blocks,
                                  const void* pair_a, const void* pair_b,
                                  const void* c_pair_start,
                                  int64_t n_c_blocks, int bs, void* c,
                                  void* stream) {
  return launch_spgemm_bsr<float>(a_blocks, b_blocks, pair_a, pair_b,
                                  c_pair_start, n_c_blocks, bs, c, stream);
}

NSP_EXPORT int nsp_spgemm_bsr_f64(const void* a_blocks, const void* b_blocks,
                                  const void* pair_a, const void* pair_b,
                                  const void* c_pair_start,
                                  int64_t n_c_blocks, int bs, void* c,
                                  void* stream) {
  return launch_spgemm_bsr<double>(a_blocks, b_blocks, pair_a, pair_b,
                                   c_pair_start, n_c_blocks, bs, c, stream);
}
