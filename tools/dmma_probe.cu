// Probe of the f64 tensor-core (DMMA) shapes of mma.sync on sm_90: for each
// of m8n8k4, m16n8k4, m16n8k8 and m16n8k16, one warp's product against the
// host (the fragment maps that csrc/dmma.cuh relies on) and the peak rate on
// registers (132 x 8 blocks of 8 warps, 8 independent accumulators a warp).
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a \
//        -o dmma_probe tools/dmma_probe.cu && ./dmma_probe
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <vector>

template <int S> struct Sh;
template <> struct Sh<0> { static constexpr int M = 8, K = 4, NA = 1, NB = 1, NC = 2; };
template <> struct Sh<1> { static constexpr int M = 16, K = 4, NA = 2, NB = 1, NC = 4; };
template <> struct Sh<2> { static constexpr int M = 16, K = 8, NA = 4, NB = 2, NC = 4; };
template <> struct Sh<3> { static constexpr int M = 16, K = 16, NA = 8, NB = 4, NC = 4; };

template <int S> __device__ __forceinline__ void mma(double* c, const double* a, const double* b);
template <> __device__ __forceinline__ void mma<0>(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n" : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<1>(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
    : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<2>(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
    : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <> __device__ __forceinline__ void mma<3>(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
    : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
    : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
      "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
// assumed maps: A a_r (row g + 8 (r % 2) [m16] or g [m8], col t + 4 (r / 2));
// B b_r (row t + 4 r, col g); C c_r (row g + 8 (r / 2), col 2 t + r % 2)
template <int S> __global__ void check(const double* A, const double* B, double* C) {
  using T = Sh<S>;
  int l = threadIdx.x, g = l >> 2, t = l & 3;
  double a[8], b[4], c[4] = {0, 0, 0, 0};
  for (int r = 0; r < T::NA; ++r) {
    int row = T::M == 8 ? g : g + 8 * (r % 2), col = t + 4 * (T::M == 8 ? r : r / 2);
    a[r] = A[row * T::K + col];
  }
  for (int r = 0; r < T::NB; ++r) b[r] = B[(t + 4 * r) * 8 + g];
  mma<S>(c, a, b);
  for (int r = 0; r < T::NC; ++r) C[(g + 8 * (r / 2)) * 8 + 2 * t + r % 2] = c[r];
}
constexpr int kAcc = 8;
template <int S> __global__ void peak(double* out, int iters) {
  using T = Sh<S>;
  double a[8], b[4], c[kAcc][4];
  for (int r = 0; r < 8; ++r) a[r] = 1e-3 * (threadIdx.x + r);
  for (int r = 0; r < 4; ++r) b[r] = 1e-3 * (threadIdx.x - r);
  for (int u = 0; u < kAcc; ++u) for (int r = 0; r < 4; ++r) c[u][r] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int u = 0; u < kAcc; ++u) mma<S>(c[u], a, b);
  double s = 0; for (int u = 0; u < kAcc; ++u) for (int r = 0; r < 4; ++r) s += c[u][r];
  if (s == 12345.678) out[0] = s;
}
template <int S> void run(const char* name) {
  using T = Sh<S>;
  std::vector<double> A(T::M * T::K), B(T::K * 8), C(T::M * 8);
  for (size_t i = 0; i < A.size(); ++i) A[i] = std::sin(1.0 + i);
  for (size_t i = 0; i < B.size(); ++i) B[i] = std::cos(2.0 + i);
  double *dA, *dB, *dC; cudaMalloc(&dA, 8 * A.size()); cudaMalloc(&dB, 8 * B.size()); cudaMalloc(&dC, 8 * 16 * 8);
  cudaMemcpy(dA, A.data(), 8 * A.size(), cudaMemcpyHostToDevice); cudaMemcpy(dB, B.data(), 8 * B.size(), cudaMemcpyHostToDevice);
  check<S><<<1, 32>>>(dA, dB, dC);
  cudaMemcpy(C.data(), dC, 8 * C.size(), cudaMemcpyDeviceToHost);
  double err = 0;
  for (int m = 0; m < T::M; ++m) for (int n = 0; n < 8; ++n) {
    double s = 0; for (int k = 0; k < T::K; ++k) s += A[m * T::K + k] * B[k * 8 + n];
    err = std::fmax(err, std::fabs(s - C[m * 8 + n]));
  }
  int iters = 20000, blocks = 132 * 8, threads = 256;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  peak<S><<<blocks, threads>>>(dC, 10);
  cudaEventRecord(e0); peak<S><<<blocks, threads>>>(dC, iters); cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double flops = 2.0 * T::M * 8 * T::K * kAcc * (double)iters * blocks * (threads / 32);
  printf("%-10s fragment map err %.3e  peak %.2f TFLOP/s (%s)\n", name, err, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(dA); cudaFree(dB); cudaFree(dC);
}
int main() { run<0>("m8n8k4"); run<1>("m16n8k4"); run<2>("m16n8k8"); run<3>("m16n8k16"); run<0>("m8n8k4"); return 0; }
