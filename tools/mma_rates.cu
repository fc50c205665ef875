// The mma.sync shapes K9 can use on Hopper: each fragment layout held
// against a host product, and each shape's issue rate (TFLOP/s with 32
// warps an SM, 8 independent accumulators a warp).
//
//   mkdir -p nsparse_tpu_torch/_build && nvcc -gencode \
//     arch=compute_90a,code=sm_90a -std=c++17 -O3 -o \
//     nsparse_tpu_torch/_build/mma_rates tools/mma_rates.cu && \
//     nsparse_tpu_torch/_build/mma_rates
//
// Layouts (g = lane / 4, t = lane % 4): tf32 m16n8k8 and f64 m16n8k8 take
// A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and B (t, g), (t + 4, g);
// D (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  Exits 1 when a
// layout disagrees.
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
#include <vector>

#define CK(x) do { cudaError_t err_ = (x); if (err_ != cudaSuccess) { \
  printf("CUDA error %s at %d\n", cudaGetErrorString(err_), __LINE__); exit(1);} } while (0)

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r; asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x)); return r;
}

// A (M x K) row-major, B (K x N) row-major, D (M x N) row-major; one warp.
__global__ void lay_tf32(const float* A, const float* B, float* D) {
  const int l = threadIdx.x, g = l >> 2, t = l & 3; const int K = 8, N = 8;
  unsigned a0 = tf32(A[g * K + t]), a1 = tf32(A[(g + 8) * K + t]),
           a2 = tf32(A[g * K + t + 4]), a3 = tf32(A[(g + 8) * K + t + 4]);
  unsigned b0 = tf32(B[t * N + g]), b1 = tf32(B[(t + 4) * N + g]);
  float c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
    "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
    : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
    : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  D[g * N + 2 * t] = c0; D[g * N + 2 * t + 1] = c1;
  D[(g + 8) * N + 2 * t] = c2; D[(g + 8) * N + 2 * t + 1] = c3;
}

__global__ void lay_m8n8k4(const double* A, const double* B, double* D) {
  const int l = threadIdx.x, g = l >> 2, t = l & 3; const int K = 4, N = 8;
  double a = A[g * K + t], b = B[t * N + g], c0 = 0, c1 = 0;
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
    "{%0,%1}, {%2}, {%3}, {%0,%1};\n" : "+d"(c0), "+d"(c1) : "d"(a), "d"(b));
  D[g * N + 2 * t] = c0; D[g * N + 2 * t + 1] = c1;
}

__global__ void lay_m16n8k4(const double* A, const double* B, double* D) {
  const int l = threadIdx.x, g = l >> 2, t = l & 3; const int K = 4, N = 8;
  double a0 = A[g * K + t], a1 = A[(g + 8) * K + t], b = B[t * N + g];
  double c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
    "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
    : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3) : "d"(a0), "d"(a1), "d"(b));
  D[g * N + 2 * t] = c0; D[g * N + 2 * t + 1] = c1;
  D[(g + 8) * N + 2 * t] = c2; D[(g + 8) * N + 2 * t + 1] = c3;
}

__global__ void lay_m16n8k8(const double* A, const double* B, double* D) {
  const int l = threadIdx.x, g = l >> 2, t = l & 3; const int K = 8, N = 8;
  double a0 = A[g * K + t], a1 = A[(g + 8) * K + t], a2 = A[g * K + t + 4],
         a3 = A[(g + 8) * K + t + 4];
  double b0 = B[t * N + g], b1 = B[(t + 4) * N + g];
  double c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
    "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
    : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
    : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
  D[g * N + 2 * t] = c0; D[g * N + 2 * t + 1] = c1;
  D[(g + 8) * N + 2 * t] = c2; D[(g + 8) * N + 2 * t + 1] = c3;
}

__global__ void lay_m16n8k16(const double* A, const double* B, double* D) {
  const int l = threadIdx.x, g = l >> 2, t = l & 3; const int K = 16, N = 8;
  double a[8], b[4];
  for (int j = 0; j < 4; ++j) {
    a[2 * j] = A[g * K + t + 4 * j]; a[2 * j + 1] = A[(g + 8) * K + t + 4 * j];
    b[j] = B[(t + 4 * j) * N + g];
  }
  double c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
    "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
    "{%0,%1,%2,%3};\n"
    : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
    : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
      "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  D[g * N + 2 * t] = c0; D[g * N + 2 * t + 1] = c1;
  D[(g + 8) * N + 2 * t] = c2; D[(g + 8) * N + 2 * t + 1] = c3;
}

constexpr int kIt = 4096, kAcc = 8;

__global__ void rate_tf32(float* out) {
  unsigned a = tf32(threadIdx.x * 1e-3f), b = tf32(1.0f + threadIdx.x);
  float c[kAcc][4] = {};
  for (int i = 0; i < kIt; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};\n"
        : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
        : "r"(a), "r"(b));
  float s = 0; for (int j = 0; j < kAcc; ++j) s += c[j][0] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kShape>  // 0: m8n8k4, 1: m16n8k4, 2: m16n8k8, 3: m16n8k16
__global__ void rate_f64(double* out) {
  double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x;
  double c[kAcc][4] = {};
  for (int i = 0; i < kIt; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      if (kShape == 0)
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
          "{%0,%1}, {%2}, {%3}, {%0,%1};\n" : "+d"(c[j][0]), "+d"(c[j][1])
          : "d"(a), "d"(b));
      else if (kShape == 1)
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
          "{%0,%1,%2,%3}, {%4,%4}, {%5}, {%0,%1,%2,%3};\n"
          : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]), "+d"(c[j][3])
          : "d"(a), "d"(b));
      else if (kShape == 2)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
          "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};\n"
          : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]), "+d"(c[j][3])
          : "d"(a), "d"(b));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
          "{%0,%1,%2,%3}, {%4,%4,%4,%4,%4,%4,%4,%4}, {%5,%5,%5,%5}, "
          "{%0,%1,%2,%3};\n"
          : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]), "+d"(c[j][3])
          : "d"(a), "d"(b));
    }
  double s = 0; for (int j = 0; j < kAcc; ++j) s += c[j][0] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename T, typename K>
bool check(const char* name, K kern, int M, int N, int Kd) {
  std::vector<T> A(M * Kd), B(Kd * N), D(M * N), R(M * N, 0);
  for (int i = 0; i < M * Kd; ++i) A[i] = (T)((i * 7) % 13 - 6);
  for (int i = 0; i < Kd * N; ++i) B[i] = (T)((i * 5) % 11 - 5);
  for (int m = 0; m < M; ++m) for (int n = 0; n < N; ++n)
    for (int k = 0; k < Kd; ++k) R[m * N + n] += A[m * Kd + k] * B[k * N + n];
  T *a, *b, *d;
  CK(cudaMalloc(&a, A.size() * sizeof(T))); CK(cudaMalloc(&b, B.size() * sizeof(T)));
  CK(cudaMalloc(&d, D.size() * sizeof(T)));
  CK(cudaMemcpy(a, A.data(), A.size() * sizeof(T), cudaMemcpyHostToDevice));
  CK(cudaMemcpy(b, B.data(), B.size() * sizeof(T), cudaMemcpyHostToDevice));
  kern<<<1, 32>>>(a, b, d);
  CK(cudaGetLastError()); CK(cudaDeviceSynchronize());
  CK(cudaMemcpy(D.data(), d, D.size() * sizeof(T), cudaMemcpyDeviceToHost));
  int bad = 0; for (int i = 0; i < M * N; ++i) bad += D[i] != R[i];
  printf("layout %s: %s (%d of %d wrong)\n", name, bad ? "FAIL" : "pass", bad, M * N);
  cudaFree(a); cudaFree(b); cudaFree(d);
  return !bad;
}

template <typename T, typename K>
void rate(const char* name, K kern, double flop_per_mma) {
  int sms; CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  const int blocks = sms * 4, threads = 256;
  T* o; CK(cudaMalloc(&o, blocks * threads * sizeof(T)));
  kern<<<blocks, threads>>>(o); CK(cudaDeviceSynchronize());
  cudaEvent_t s, e; cudaEventCreate(&s); cudaEventCreate(&e);
  cudaEventRecord(s); kern<<<blocks, threads>>>(o); cudaEventRecord(e);
  CK(cudaEventSynchronize(e)); float ms; cudaEventElapsedTime(&ms, s, e);
  double mmas = double(blocks) * threads / 32 * kIt * kAcc;
  printf("rate %s: %.1f TFLOP/s (%.3f ms)\n", name, mmas * flop_per_mma / ms / 1e9, ms);
  cudaFree(o);
}

int main() {
  bool ok = check<float>("tf32 m16n8k8", lay_tf32, 16, 8, 8);
  ok &= check<double>("f64 m8n8k4", lay_m8n8k4, 8, 8, 4);
  ok &= check<double>("f64 m16n8k4", lay_m16n8k4, 16, 8, 4);
  ok &= check<double>("f64 m16n8k8", lay_m16n8k8, 16, 8, 8);
  ok &= check<double>("f64 m16n8k16", lay_m16n8k16, 16, 8, 16);
  rate<float>("tf32 m16n8k8", rate_tf32, 2.0 * 16 * 8 * 8);
  rate<double>("f64 m8n8k4", rate_f64<0>, 2.0 * 8 * 8 * 4);
  rate<double>("f64 m16n8k4", rate_f64<1>, 2.0 * 16 * 8 * 4);
  rate<double>("f64 m16n8k8", rate_f64<2>, 2.0 * 16 * 8 * 8);
  rate<double>("f64 m16n8k16", rate_f64<3>, 2.0 * 16 * 8 * 16);
  return ok ? 0 : 1;
}
