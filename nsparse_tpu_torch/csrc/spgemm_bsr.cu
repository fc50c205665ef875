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
// one block owns one sub-tile of one C tile (a 1-D grid, the sub-tiles of
// one C tile adjacent, so that they share A and B tiles in L2) and loops
// over its C tile's pairs itself: no accumulator crosses blocks, no
// atomics, C written once in a fixed order (bitwise reproducible runs).
//
// Bound: operations on the tensor cores.  Float32 runs on TF32 tensor
// cores split three ways (3xTF32): each operand x = hi + lo with hi =
// tf32(x) and lo = tf32(x - hi) (cvt.rna), and a product is lo*hi + hi*lo
// + hi*hi, each term an mma.sync.m16n8k8 TF32 product accumulated in FP32
// registers.  The dropped lo*lo term is below 2^-21 of |a||b|, so the
// result keeps float32 accuracy, as the TPU kernel's Precision.HIGHEST
// does; a single TF32 pass keeps about three digits.  Three products per
// f32 product makes the bound 3 * 2 * pairs * bs^3 at 495 TFLOP/s (TF32).
// mma.sync reaches about 315 TFLOP/s of TF32 on an H100 (wgmma, the only
// way to the full rate, takes tf32 operands K-major only, so B would have
// to be transposed into shared memory; later work).  Float64 runs on DMMA,
// mma.sync.m16n8k8 .f64, at the 67 TFLOP/s FP64 tensor-core peak (the
// m8n8k4 shape issues at half that rate on Hopper).
//
// Design: 256 threads (8 warps, 2 along m and 4 along n) own a 128 x 128 C
// sub-tile where bs % 128 == 0 (each staged slice feeds twice the outputs
// of a 64 x 64 one), else 64 x 64.  A ring in dynamic shared memory (3
// stages of 37 KB in f32, two blocks an SM; 4 stages of 41 KB in f64, one
// block an SM), fed by 16-byte cp.async.cg copies, runs over the block's
// flattened (pair, k-slice) sequence, so the next pair's first slice is in
// flight while the current pair's last one is multiplied; one
// __syncthreads a slice.  A slice is 128 bytes of each A row and as many B
// rows (32 floats or 16 doubles).  Within an 8-deep mma step, logical k
// and k + 4 sit at physical 2k and 2k + 1 in both A and B (the same
// permutation of the sum), so a thread's A fragment is one 8-byte (f32) or
// 16-byte (f64) shared load per row.  Row strides are padded (A: 40 floats
// or 24 doubles; B: BN + 4 floats or BN + 2 doubles) so that every
// fragment load of a warp hits distinct banks.  Offsets are int64.  On an
// H100 the hi * hi pass alone takes about half the time of all three
// (tools/k9_variants.py): staging the A and B panels from L2, which each
// of a C tile's four 128 x 128 blocks reads for itself, is the other half,
// and the tensor work does not hide under it.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsM = 2, kWarpsN = 4;

template <typename T>
struct Geom;

// float32: two blocks an SM (128 registers a thread), 3 ring stages each
template <>
struct Geom<float> {
  static constexpr int kK = 32;     // k per ring stage: 128 bytes of a row
  static constexpr int kPadA = 8;   // A row stride 40: conflict-free float2
  static constexpr int kPadB = 4;   // B row stride BN + 4
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = 2;
};

// float64: one block an SM (the 64 accumulators of a thread take 128
// registers), 4 ring stages
template <>
struct Geom<double> {
  static constexpr int kK = 16;
  static constexpr int kPadA = 8;   // A row stride 24: conflict-free double2
  static constexpr int kPadB = 2;   // B row stride BN + 2
  static constexpr int kStages = 4;
  static constexpr int kMinBlocks = 1;
};

template <typename T, int kBM>
struct Tile {
  static constexpr int kK = Geom<T>::kK;
  static constexpr int kStages = Geom<T>::kStages;
  static constexpr int kSA = kK + Geom<T>::kPadA;   // A stage row stride
  static constexpr int kSB = kBM + Geom<T>::kPadB;  // B stage row stride
  static constexpr int kStageA = kBM * kSA;          // elements
  static constexpr int kStage = kStageA + kK * kSB;
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(T));
  static constexpr int kWM = kBM / kWarpsM;          // warp tile
  static constexpr int kWN = kBM / kWarpsN;
  static constexpr int kMT = kWM / 16;               // m16 x n8 mma tiles
  static constexpr int kNT = kWN / 8;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static_assert((kStageA * sizeof(T)) % 16 == 0 && (kStage * sizeof(T)) % 16 == 0,
                "stages must stay 16-byte aligned");
  static_assert((kSA * sizeof(T)) % 16 == 0 && (kSB * sizeof(T)) % 16 == 0,
                "staged rows must stay 16-byte aligned");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One ring stage: the (kBM x kK) slice of A at `a` (row stride bs) and the
// (kK x kBM) slice of B at `b`, as 16-byte copies in flight.
template <typename T, int kBM>
__device__ __forceinline__ void load_stage(T* sa, T* sb, const T* a,
                                           const T* b, int bs) {
  using G = Tile<T, kBM>;
  constexpr int kRowA = G::kK / G::kVec;   // 16-byte chunks per A row
  constexpr int kRowB = kBM / G::kVec;     // and per B row
  static_assert((kBM * kRowA) % kThreads == 0 && (G::kK * kRowB) % kThreads == 0,
                "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kBM * kRowA / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kRowA, col = (e % kRowA) * G::kVec;
    cp_async16(sa + r * G::kSA + col, a + static_cast<int64_t>(r) * bs + col);
  }
#pragma unroll
  for (int i = 0; i < G::kK * kRowB / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kRowB, col = (e % kRowB) * G::kVec;
    cp_async16(sb + r * G::kSB + col, b + static_cast<int64_t>(r) * bs + col);
  }
}

// The products of one staged slice, float32: 3xTF32.  Fragment layouts of
// m16n8k8 (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); logical k and k + 4
// read physical 2k and 2k + 1.  The three passes run one after another
// over all the warp's fragments, so that consecutive mma instructions
// write different accumulators and none waits on the one before.
template <int kBM>
__device__ __forceinline__ void stage_product(
    float (&acc)[Tile<float, kBM>::kMT][Tile<float, kBM>::kNT][4],
    const float* sa, const float* sb, int wm0, int wn0, int g, int t) {
  using G = Tile<float, kBM>;
#pragma unroll
  for (int kk = 0; kk < G::kK; kk += 8) {
    uint32_t bh[G::kNT][2], bl[G::kNT][2];
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      const float* p = sb + (kk + 2 * t) * G::kSB + wn0 + 8 * j + g;
      split_tf32(p[0], bh[j][0], bl[j][0]);
      split_tf32(p[G::kSB], bh[j][1], bl[j][1]);
    }
    uint32_t ah[G::kMT][4], al[G::kMT][4];
#pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
      const float* p = sa + (wm0 + 16 * i + g) * G::kSA + kk + 2 * t;
      const float2 r0 = *reinterpret_cast<const float2*>(p);
      const float2 r8 = *reinterpret_cast<const float2*>(p + 8 * G::kSA);
      split_tf32(r0.x, ah[i][0], al[i][0]);
      split_tf32(r8.x, ah[i][1], al[i][1]);
      split_tf32(r0.y, ah[i][2], al[i][2]);
      split_tf32(r8.y, ah[i][3], al[i][3]);
    }
    // the small terms first, then hi * hi
#pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
    }
#pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
    }
#pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }
}

// The products of one staged slice, float64: DMMA m16n8k8, the same
// fragment layouts as above.
template <int kBM>
__device__ __forceinline__ void stage_product(
    double (&acc)[Tile<double, kBM>::kMT][Tile<double, kBM>::kNT][4],
    const double* sa, const double* sb, int wm0, int wn0, int g, int t) {
  using G = Tile<double, kBM>;
#pragma unroll
  for (int kk = 0; kk < G::kK; kk += 8) {
    double b[G::kNT][2];
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      const double* p = sb + (kk + 2 * t) * G::kSB + wn0 + 8 * j + g;
      b[j][0] = p[0];
      b[j][1] = p[G::kSB];
    }
#pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
      const double* p = sa + (wm0 + 16 * i + g) * G::kSA + kk + 2 * t;
      const double2 r0 = *reinterpret_cast<const double2*>(p);
      const double2 r8 = *reinterpret_cast<const double2*>(p + 8 * G::kSA);
      const double a[4] = {r0.x, r8.x, r0.y, r8.y};
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) mma_f64(acc[i][j], a, b[j]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(double* p, double x, double y) {
  *reinterpret_cast<double2*>(p) = make_double2(x, y);
}

template <typename T, int kBM>
__global__ void __launch_bounds__(kThreads, Geom<T>::kMinBlocks)
spgemm_bsr_kernel(const T* __restrict__ a_blocks,
                  const T* __restrict__ b_blocks,
                  const int32_t* __restrict__ pair_a,
                  const int32_t* __restrict__ pair_b,
                  const int32_t* __restrict__ c_pair_start, int bs,
                  T* __restrict__ c) {
  using G = Tile<T, kBM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int subs = bs / kBM;
  const int64_t ct = blockIdx.x / (subs * subs);
  const int sub = static_cast<int>(blockIdx.x % (subs * subs));
  const int r0 = (sub / subs) * kBM, c0 = (sub % subs) * kBM;
  const int64_t tile = static_cast<int64_t>(bs) * bs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm0 = (warp / kWarpsN) * G::kWM, wn0 = (warp % kWarpsN) * G::kWN;

  T acc[G::kMT][G::kNT][4];
#pragma unroll
  for (int i = 0; i < G::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = T(0);
    }
  }

  // the flattened (pair, k-slice) sequence of this C tile
  const int32_t p0 = c_pair_start[ct];
  const int ksteps = bs / G::kK;
  const int steps = (c_pair_start[ct + 1] - p0) * ksteps;
  auto issue = [&](int s) {
    const int32_t p = p0 + s / ksteps;
    const int k0 = (s % ksteps) * G::kK;
    T* st = smem + (s % G::kStages) * G::kStage;
    load_stage<T, kBM>(
        st, st + G::kStageA,
        a_blocks + __ldg(pair_a + p) * tile + static_cast<int64_t>(r0) * bs +
            k0,
        b_blocks + __ldg(pair_b + p) * tile + static_cast<int64_t>(k0) * bs +
            c0,
        bs);
  };

#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<G::kStages - 2>();  // slice s has landed (this thread's)
    __syncthreads();  // ... every thread's, and slice s - 1 is consumed
    if (s + G::kStages - 1 < steps) issue(s + G::kStages - 1);
    cp_async_commit();  // an empty group at the end keeps the count
    const T* st = smem + (s % G::kStages) * G::kStage;
    stage_product<kBM>(acc, st, st + G::kStageA, wm0, wn0, g, t);
  }

  // C fragment: c0, c1 at (g, 2t, 2t + 1), c2, c3 at (g + 8, ...)
  T* out = c + ct * tile + static_cast<int64_t>(r0 + wm0) * bs + c0 + wn0;
#pragma unroll
  for (int i = 0; i < G::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      T* o = out + static_cast<int64_t>(16 * i + g) * bs + 8 * j + 2 * t;
      store2(o, acc[i][j][0], acc[i][j][1]);
      store2(o + 8 * static_cast<int64_t>(bs), acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <typename T, int kBM>
int launch_tiles(const T* a_blocks, const T* b_blocks, const int32_t* pair_a,
                 const int32_t* pair_b, const int32_t* c_pair_start,
                 int64_t n_c_blocks, int bs, T* c, cudaStream_t stream) {
  using G = Tile<T, kBM>;
  const int64_t subs = bs / kBM;
  const int64_t blocks = n_c_blocks * subs * subs;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = spgemm_bsr_kernel<T, kBM>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, G::kSmem, stream>>>(
      a_blocks, b_blocks, pair_a, pair_b, c_pair_start, bs, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spgemm_bsr(const void* a_blocks, const void* b_blocks,
                      const void* pair_a, const void* pair_b,
                      const void* c_pair_start, int64_t n_c_blocks, int bs,
                      void* c, void* stream) {
  // 16-byte copies: bs a multiple of 64 keeps every row aligned when the
  // tiles start aligned
  if (bs <= 0 || bs % 64 || n_c_blocks < 0 || !nsp::aligned16(a_blocks) ||
      !nsp::aligned16(b_blocks) || !nsp::aligned16(c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_c_blocks == 0) return static_cast<int>(cudaGetLastError());
  const auto* a = static_cast<const T*>(a_blocks);
  const auto* b = static_cast<const T*>(b_blocks);
  const auto* pa = static_cast<const int32_t*>(pair_a);
  const auto* pb = static_cast<const int32_t*>(pair_b);
  const auto* st = static_cast<const int32_t*>(c_pair_start);
  auto* cv = static_cast<T*>(c);
  const auto s = nsp::as_stream(stream);
  return bs % 128 == 0
             ? launch_tiles<T, 128>(a, b, pa, pb, st, n_c_blocks, bs, cv, s)
             : launch_tiles<T, 64>(a, b, pa, pb, st, n_c_blocks, bs, cv, s);
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
