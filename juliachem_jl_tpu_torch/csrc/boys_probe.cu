// Kernel K3: the device Boys function (boys.cuh) on a vector of arguments,
// F[i, m] = F_m(T[i]) for m = 0..mmax, in its dividing form;
// jc_boys_probe_recip runs the form K1, K4 and K5 inline (boys<M, true>:
// reciprocals, no divides).
//
// Replaces nothing on the SCF path: it exposes the device function that
// K1 and K4/K5 inline (in place of juliachem_jl_tpu/ops/boys.py::boys,
// :61-98) so that each can be held against the plain torch version in
// isolation.  One thread per argument; bound by the 128-term series.
//
// Also home of jc_error_string, which the ctypes wrapper uses to report the
// CUDA error code any entry point returns.

#include <cuda_runtime.h>

#include "boys.cuh"

namespace {

template <int M, bool kRecip>
__global__ void boys_probe_kernel(const double* __restrict__ T, long long n,
                                  double* __restrict__ F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double f[M + 1];
  jc::boys<M, kRecip>(T[i], f);
#pragma unroll
  for (int m = 0; m <= M; ++m) F[i * (M + 1) + m] = f[m];
}

template <int M, bool kRecip>
int launch(const double* T, long long n, double* F, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    boys_probe_kernel<M, kRecip><<<(unsigned)blocks, threads, 0, stream>>>(
        T, n, F);
  return (int)cudaGetLastError();
}

template <bool kRecip>
int dispatch(const double* T, long long n, int mmax, double* F,
             cudaStream_t s) {
  switch (mmax) {
    case 0: return launch<0, kRecip>(T, n, F, s);
    case 1: return launch<1, kRecip>(T, n, F, s);
    case 2: return launch<2, kRecip>(T, n, F, s);
    case 3: return launch<3, kRecip>(T, n, F, s);
    case 4: return launch<4, kRecip>(T, n, F, s);
    case 5: return launch<5, kRecip>(T, n, F, s);
    case 6: return launch<6, kRecip>(T, n, F, s);
    case 7: return launch<7, kRecip>(T, n, F, s);
    case 8: return launch<8, kRecip>(T, n, F, s);
    case 9: return launch<9, kRecip>(T, n, F, s);
    case 10: return launch<10, kRecip>(T, n, F, s);
    case 11: return launch<11, kRecip>(T, n, F, s);
    case 12: return launch<12, kRecip>(T, n, F, s);
    case 13: return launch<13, kRecip>(T, n, F, s);
    case 14: return launch<14, kRecip>(T, n, F, s);
    case 15: return launch<15, kRecip>(T, n, F, s);
    case 16: return launch<16, kRecip>(T, n, F, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int jc_boys_probe(const double* T, long long n, int mmax,
                             double* F, void* stream) {
  return dispatch<false>(T, n, mmax, F, (cudaStream_t)stream);
}

extern "C" int jc_boys_probe_recip(const double* T, long long n, int mmax,
                                   double* F, void* stream) {
  return dispatch<true>(T, n, mmax, F, (cudaStream_t)stream);
}

extern "C" const char* jc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
