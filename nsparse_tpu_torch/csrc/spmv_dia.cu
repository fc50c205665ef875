// K7: DIA SpMV,
//   y[i] = sum_d vals[d * ld + i] * x[i + off[d]],  i < m,
// terms with i + off[d] outside [0, n) contributing 0.
//
// Replaces dia_pallas.spmv_dia_pallas (pallas_call :84).  The TPU kernel
// loads three neighbouring x blocks per row block (a sliding window) and
// forms each diagonal's shifted x with static lane and sublane rolls,
// because the TPU has no gather.  On Hopper each thread owns one row and
// reads x[i + off] directly: neighbouring rows read neighbouring x, so
// every diagonal's x reads coalesce, and the ndiag reads of one x value
// by nearby rows hit L1/L2.
//
// Bound: device memory, ndiag * m values + x + y (offsets are a few
// bytes).  Design: one pass, row-parallel, each diagonal's values read
// once and coalesced; the sum runs over the diagonals in order, one FMA
// each, so it differs from the plain version (a multiply, then an add)
// only by the FMA's single rounding.
#include "common.cuh"

namespace {

template <typename T>
__global__ void spmv_dia_kernel(const T* __restrict__ vals, int64_t ld,
                                const int32_t* __restrict__ off, int ndiag,
                                const T* __restrict__ x, int64_t n,
                                T* __restrict__ y, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  T acc = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + off[d];
    if (j >= 0 && j < n) acc += vals[d * ld + i] * x[j];
  }
  y[i] = acc;
}

template <typename T>
int launch_spmv_dia(const void* vals, int64_t ld, const void* off, int ndiag,
                    const void* x, int64_t n, void* y, int64_t m,
                    void* stream) {
  constexpr int kThreads = 256;
  if (m > 0) {
    spmv_dia_kernel<T><<<nsp::blocks_for(m, kThreads), kThreads, 0,
                         nsp::as_stream(stream)>>>(
        static_cast<const T*>(vals), ld, static_cast<const int32_t*>(off),
        ndiag, static_cast<const T*>(x), n, static_cast<T*>(y), m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_spmv_dia_f32(const void* vals, int64_t ld, const void* off,
                                int ndiag, const void* x, int64_t n, void* y,
                                int64_t m, void* stream) {
  return launch_spmv_dia<float>(vals, ld, off, ndiag, x, n, y, m, stream);
}

NSP_EXPORT int nsp_spmv_dia_f64(const void* vals, int64_t ld, const void* off,
                                int ndiag, const void* x, int64_t n, void* y,
                                int64_t m, void* stream) {
  return launch_spmv_dia<double>(vals, ld, off, ndiag, x, n, y, m, stream);
}
