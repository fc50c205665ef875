// K11: the pre-rolled B bank of the piece expansion.
//
// From b_val and the 8-aligned table map b8_idx (b8_len slots, -1 = a
// structural zero), with n = bank_rows * 128:
//   flat[j] = b_val[b8_idx[j - bias]]  for bias <= j < bias + b8_len where
//             that index lies in b_val, else 0;
//   bank[k * n + t] = flat[(t + 8k) mod n],  k < n_copies.
// Copy k is the table rolled by -8k, so bank-row code k * bank_rows + q
// names the 1024 slots from table position 128 q + 8 k - bias on.
//
// Replaces piecewise.build_bank (_bank_kernel), which rolled a
// VMEM-resident flat table into each copy with lane and sublane rolls, fed
// by a separate flat_gather of b_val through b8_gp; here one pass gathers
// b_val through b8_idx and writes every copy, so the flat table is never
// stored.  The output is the JAX array element for element.
//
// Bound: device memory — the bank written once (n_copies * n values: 11.0
// MB in f32 on R-MAT-14), b_val and b8_idx read (each copy rereads them,
// from L2).  Design: one thread per bank value, a grid row per copy, so
// writes and the b8_idx reads are coalesced and the b_val reads nearly so
// (b8_idx ascends inside each B row).  At R-MAT-14's 2.75M values the
// launch latency is of the same order as the transfer.
#include "common.cuh"

namespace {

template <typename T>
__global__ void build_bank_kernel(const T* __restrict__ b_val, int64_t n_b,
                                  const int32_t* __restrict__ b8_idx,
                                  int64_t b8_len, int64_t n, int bias,
                                  T* __restrict__ out) {
  // blockIdx.y is the copy k: no division per value
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int64_t k = blockIdx.y;
  int64_t j = t + 8 * k;
  if (j >= n) j -= n;
  const int64_t s = j - bias;
  T v = T(0);
  if (s >= 0 && s < b8_len) {
    const int32_t b = b8_idx[s];
    if (b >= 0 && b < n_b) v = b_val[b];
  }
  out[k * n + t] = v;
}

template <typename T>
int launch_build_bank(const void* b_val, int64_t n_b, const void* b8_idx,
                      int64_t b8_len, int64_t bank_rows, int bias,
                      int n_copies, void* out, void* stream) {
  constexpr int kThreads = 256;
  const int64_t n = bank_rows * 128;
  if (8 * static_cast<int64_t>(n_copies) > n || n_copies > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0 && n_copies > 0) {
    const dim3 grid(nsp::blocks_for(n, kThreads),
                    static_cast<unsigned int>(n_copies));
    build_bank_kernel<T><<<grid, kThreads, 0, nsp::as_stream(stream)>>>(
        static_cast<const T*>(b_val), n_b,
        static_cast<const int32_t*>(b8_idx), b8_len, n, bias,
        static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int nsp_build_bank_f32(const void* b_val, int64_t n_b,
                                  const void* b8_idx, int64_t b8_len,
                                  int64_t bank_rows, int bias, int n_copies,
                                  void* out, void* stream) {
  return launch_build_bank<float>(b_val, n_b, b8_idx, b8_len, bank_rows, bias,
                                  n_copies, out, stream);
}

NSP_EXPORT int nsp_build_bank_f64(const void* b_val, int64_t n_b,
                                  const void* b8_idx, int64_t b8_len,
                                  int64_t bank_rows, int bias, int n_copies,
                                  void* out, void* stream) {
  return launch_build_bank<double>(b_val, n_b, b8_idx, b8_len, bank_rows, bias,
                                   n_copies, out, stream);
}
