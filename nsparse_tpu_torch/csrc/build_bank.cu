// K11: the pre-rolled B bank of the piece expansion.
//
// From b_val and the 8-aligned table map b8_idx (b8_len slots, -1 = a
// structural zero), with n = bank_rows * 128:
//   flat[j] = b_val[b8_idx[j - bias]]  for bias <= j < bias + b8_len where
//             that index lies in b_val, else 0;
//   bank[k * n + t] = flat[(t + 8k) mod n],  k < n_copies.
// Copy k is the table rolled by -8k, so bank-row code k * bank_rows + q
// names the 1024 slots from table position 128 q + 8 k - bias on.  One
// copy is the flat table of the unaligned piece mode.
//
// Replaces piecewise.build_bank (_bank_kernel), which rolled a
// VMEM-resident flat table into each copy with lane and sublane rolls, fed
// by a separate flat_gather of b_val through b8_gp; here one pass gathers
// b_val through b8_idx and writes every copy, so the flat table is never
// stored.  The output is the JAX array element for element.
//
// Bound: device memory — the bank written once (n_copies * n values: 11.0
// MB in f32 on R-MAT-14, 3.3 us at 3.35 TB/s), b8_idx and the b_val values
// it names read once.  Design: one read per table slot.  A thread owns 4
// consecutive flat slots j (j a multiple of 4), loads their b8_idx entries
// once (one 16-byte load where b8_idx is 16-byte aligned and bias a
// multiple of 4, else 4 scalar loads) and their b_val values once, and
// writes them to every copy k at t = (j - 8k) mod n.  Since n and 8k are
// multiples of 4, the 4 slots are one aligned 16-byte vector of each copy
// (a float4, or two double2) that never straddles n, so the roll needs no
// special case.  The old design ran a thread per bank value and reread
// b8_idx and b_val for every copy (from L2), with scalar stores.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T table_value(const T* __restrict__ b_val,
                                         int64_t n_b, int32_t b) {
  return (b >= 0 && b < n_b) ? __ldg(b_val + b) : T(0);
}

template <typename T, bool kVecIdx>
__global__ void build_bank_kernel(const T* __restrict__ b_val, int64_t n_b,
                                  const int32_t* __restrict__ b8_idx,
                                  int64_t b8_len, int64_t n, int bias,
                                  int n_copies, T* __restrict__ out) {
  const int64_t j =
      4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (j >= n) return;
  const int64_t s = j - bias;
  T v[4];
  if (kVecIdx && s >= 0 && s + 4 <= b8_len) {
    const int4 b = __ldg(reinterpret_cast<const int4*>(b8_idx + s));
    v[0] = table_value(b_val, n_b, b.x);
    v[1] = table_value(b_val, n_b, b.y);
    v[2] = table_value(b_val, n_b, b.z);
    v[3] = table_value(b_val, n_b, b.w);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t su = s + u;
      v[u] = (su >= 0 && su < b8_len)
                 ? table_value(b_val, n_b, __ldg(b8_idx + su))
                 : T(0);
    }
  }
  // slot j of the table is slot (j - 8k) mod n of copy k
  T* o = out;
  int64_t t = j;
  for (int k = 0; k < n_copies; ++k) {
    nsp::store4(o + t, v);
    o += n;
    t -= 8;
    if (t < 0) t += n;
  }
}

template <typename T>
int launch_build_bank(const void* b_val, int64_t n_b, const void* b8_idx,
                      int64_t b8_len, int64_t bank_rows, int bias,
                      int n_copies, void* out, void* stream) {
  const int64_t n = bank_rows * 128;
  // the wrapper allocates out, so its copies are whole aligned vectors
  if (n_copies < 0 || 8 * static_cast<int64_t>(n_copies) > n || bias < 0 ||
      !nsp::aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0 && n_copies > 0) {
    const unsigned int grid = nsp::blocks_for(n / 4, kThreads);
    const auto s = nsp::as_stream(stream);
    const auto* bv = static_cast<const T*>(b_val);
    const auto* bi = static_cast<const int32_t*>(b8_idx);
    auto* o = static_cast<T*>(out);
    if (nsp::aligned16(b8_idx) && bias % 4 == 0) {
      build_bank_kernel<T, true><<<grid, kThreads, 0, s>>>(
          bv, n_b, bi, b8_len, n, bias, n_copies, o);
    } else {
      build_bank_kernel<T, false><<<grid, kThreads, 0, s>>>(
          bv, n_b, bi, b8_len, n, bias, n_copies, o);
    }
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
