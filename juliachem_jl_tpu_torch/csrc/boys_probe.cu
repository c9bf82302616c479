// Kernel K3: the device Boys function of K1 (boys.cuh) on a vector of
// arguments, F[i, m] = F_m(T[i]) for m = 0..mmax.
//
// Replaces nothing on the SCF path: it exposes the device function that K1
// inlines (in place of juliachem_jl_tpu/ops/boys.py::boys, :61-98) so that
// it can be held against the plain torch version in isolation.  One thread
// per argument; bound by the 128-term series, as in K1.
//
// Also home of jc_error_string, which the ctypes wrapper uses to report the
// CUDA error code any entry point returns.

#include <cuda_runtime.h>

#include "boys.cuh"

namespace {

template <int M>
__global__ void boys_probe_kernel(const double* __restrict__ T, long long n,
                                  double* __restrict__ F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double f[M + 1];
  jc::boys<M>(T[i], f);
#pragma unroll
  for (int m = 0; m <= M; ++m) F[i * (M + 1) + m] = f[m];
}

template <int M>
int launch(const double* T, long long n, double* F, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    boys_probe_kernel<M><<<(unsigned)blocks, threads, 0, stream>>>(T, n, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jc_boys_probe(const double* T, long long n, int mmax,
                             double* F, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mmax) {
    case 0: return launch<0>(T, n, F, s);
    case 1: return launch<1>(T, n, F, s);
    case 2: return launch<2>(T, n, F, s);
    case 3: return launch<3>(T, n, F, s);
    case 4: return launch<4>(T, n, F, s);
    case 5: return launch<5>(T, n, F, s);
    case 6: return launch<6>(T, n, F, s);
    case 7: return launch<7>(T, n, F, s);
    case 8: return launch<8>(T, n, F, s);
    case 9: return launch<9>(T, n, F, s);
    case 10: return launch<10>(T, n, F, s);
    case 11: return launch<11>(T, n, F, s);
    case 12: return launch<12>(T, n, F, s);
    case 13: return launch<13>(T, n, F, s);
    case 14: return launch<14>(T, n, F, s);
    case 15: return launch<15>(T, n, F, s);
    case 16: return launch<16>(T, n, F, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* jc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
