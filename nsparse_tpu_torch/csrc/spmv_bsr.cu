// K8: BSR SpMV over (128, 128) tiles,
//   y[br*128 + r] = sum_{k in block row br} sum_c data[k][r][c] * x[bcol[k]*128 + c],
// x read as 0 past n; every row below m is written (a block row without
// tiles gives 0).
//
// Replaces spmv_pallas.spmv_bsr_pallas (pallas_call :108).  The TPU kernel
// walks tiles on a sequential grid, keeps a block row's sums in a VMEM
// accumulator revisited across grid steps, and picks the 128-wide x row
// out of an (8, 128) block by an 8-way sublane select (TPU block shapes
// forbid (1, 128)).  On Hopper blocks run in parallel and in no order, so
// one block owns one block row and walks its tiles (block_rpt) in a loop:
// no accumulator crosses blocks, no atomics, y written once.
//
// Bound: device memory, nblocks * 128 * 128 values + block indices + x +
// y.  Design: 8 warps, 16 tile rows each; for each tile the block stages
// the 128 x values in shared memory, and lane l of a warp reads columns
// l, l+32, l+64, l+96 of its rows, so each warp load is 32 consecutive
// values (coalesced) and 64 loads a tile are in flight per warp.  Each
// lane keeps 16 partial sums in registers across the tiles (full-precision
// FFMA, no TF32), then a warp shuffle reduction sums each row.
#include "common.cuh"

namespace {

constexpr int kB = 128;                 // tile edge
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kB / kWarps;
constexpr int kColsPerLane = kB / 32;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spmv_bsr_kernel(const T* __restrict__ data, const int32_t* __restrict__ bcol,
                const int32_t* __restrict__ brpt, const T* __restrict__ x,
                int64_t n, T* __restrict__ y, int64_t m) {
  __shared__ T xs[kB];
  const int64_t br = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = T(0);

  const int32_t k0 = brpt[br], k1 = brpt[br + 1];
  for (int32_t k = k0; k < k1; ++k) {
    __syncthreads();  // the previous tile's x reads are done
    if (threadIdx.x < kB) {
      const int64_t c = static_cast<int64_t>(bcol[k]) * kB + threadIdx.x;
      xs[threadIdx.x] = c < n ? x[c] : T(0);
    }
    __syncthreads();
    T xv[kColsPerLane];
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) xv[t] = xs[lane + 32 * t];
    const T* tile = data + static_cast<int64_t>(k) * kB * kB +
                    static_cast<int64_t>(warp) * kRowsPerWarp * kB;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int t = 0; t < kColsPerLane; ++t) {
        acc[r] += tile[r * kB + lane + 32 * t] * xv[t];
      }
    }
  }

  T mine = T(0);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    T v = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == r) mine = v;
  }
  const int64_t row = br * kB + warp * kRowsPerWarp + lane;
  if (lane < kRowsPerWarp && row < m) y[row] = mine;
}

template <typename T>
int launch_spmv_bsr(const void* data, const void* bcol, const void* brpt,
                    int64_t n_block_rows, const void* x, int64_t n, void* y,
                    int64_t m, void* stream) {
  if (n_block_rows > 0) {
    spmv_bsr_kernel<T><<<static_cast<unsigned int>(n_block_rows),
                         kWarps * 32, 0, nsp::as_stream(stream)>>>(
        static_cast<const T*>(data), static_cast<const int32_t*>(bcol),
        static_cast<const int32_t*>(brpt), static_cast<const T*>(x), n,
        static_cast<T*>(y), m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_spmv_bsr_f32(const void* data, const void* bcol,
                                const void* brpt, int64_t n_block_rows,
                                const void* x, int64_t n, void* y, int64_t m,
                                void* stream) {
  return launch_spmv_bsr<float>(data, bcol, brpt, n_block_rows, x, n, y, m,
                                stream);
}

NSP_EXPORT int nsp_spmv_bsr_f64(const void* data, const void* bcol,
                                const void* brpt, int64_t n_block_rows,
                                const void* x, int64_t n, void* y, int64_t m,
                                void* stream) {
  return launch_spmv_bsr<double>(data, bcol, brpt, n_block_rows, x, n, y, m,
                                 stream);
}
