// Launches of kernel K11 (device code and design in eri3c_grad.cuh), and
// the C entry points of one class: the eri3c_grad_*.cu units instantiate
// the classes in groups, so nvcc builds them in parallel.  Each function
// returns the CUDA error of its launch (0 on success).
#pragma once

#include <algorithm>

#include "eri3c_grad.cuh"
#include "oei_grad_launch.cuh"

namespace jc {

template <int LA, int LP, int LQ, bool kMetric>
int eri3c_grad_launch(const double* aprim, const double* apair,
                      const int* ameta, long long na, const double* pprim,
                      const double* ppair, const int* pmeta, long long np,
                      const double* gam, long long s_a, long long s_p,
                      double weight, double* grad, int natom,
                      cudaStream_t stream) {
  if (natom <= 0) return (int)cudaErrorInvalidValue;
  if (na <= 0 || np <= 0) return 0;
  const size_t bytes = sizeof(double) * grad_acc_doubles(natom);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        eri3c_grad_kernel<LA, LP, LQ, kMetric>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = na * np;
  const long long blocks = std::min(
      (total + kEri3gThreads - 1) / kEri3gThreads, kGradMaxBlocks);
  eri3c_grad_kernel<LA, LP, LQ, kMetric>
      <<<(unsigned)blocks, kEri3gThreads, bytes, stream>>>(
          aprim, apair, ameta, na, pprim, ppair, pmeta, np, gam, s_a, s_p,
          weight, grad, natom);
  return (int)cudaGetLastError();
}

}  // namespace jc

#define JC_ERI3C_GRAD_ARGS                                                   \
  const double *aprim, const double *apair, const int *ameta, long long na,  \
      const double *pprim, const double *ppair, const int *pmeta,            \
      long long np, const double *gam, long long s_a, long long s_p,         \
      double weight, double *grad, int natom, void *stream

// the C entry point of one 3-center class (lA | lp lq),
// jc_eri3c_grad_c<lA><lp><lq>
#define JC_ERI3C_GRAD_CLASS(LA, LP, LQ)                                      \
  extern "C" int jc_eri3c_grad_c##LA##LP##LQ(JC_ERI3C_GRAD_ARGS) {           \
    return jc::eri3c_grad_launch<LA, LP, LQ, false>(                         \
        aprim, apair, ameta, na, pprim, ppair, pmeta, np, gam, s_a, s_p,     \
        weight, grad, natom, (cudaStream_t)stream);                          \
  }

// the C entry point of one metric class (lA | lB), lA <= lB,
// jc_metric_grad_c<lA><lB>
#define JC_METRIC_GRAD_CLASS(LA, LB)                                         \
  extern "C" int jc_metric_grad_c##LA##LB(JC_ERI3C_GRAD_ARGS) {              \
    return jc::eri3c_grad_launch<LA, LB, 0, true>(                           \
        aprim, apair, ameta, na, pprim, ppair, pmeta, np, gam, s_a, s_p,     \
        weight, grad, natom, (cudaStream_t)stream);                          \
  }

// the 15 primary pair classes (lp <= lq) for one aux class
#define JC_ERI3C_GRAD_PAIRS(LA)                                              \
  JC_ERI3C_GRAD_CLASS(LA, 0, 0) JC_ERI3C_GRAD_CLASS(LA, 0, 1)                \
  JC_ERI3C_GRAD_CLASS(LA, 0, 2) JC_ERI3C_GRAD_CLASS(LA, 0, 3)                \
  JC_ERI3C_GRAD_CLASS(LA, 0, 4) JC_ERI3C_GRAD_CLASS(LA, 1, 1)                \
  JC_ERI3C_GRAD_CLASS(LA, 1, 2) JC_ERI3C_GRAD_CLASS(LA, 1, 3)                \
  JC_ERI3C_GRAD_CLASS(LA, 1, 4) JC_ERI3C_GRAD_CLASS(LA, 2, 2)                \
  JC_ERI3C_GRAD_CLASS(LA, 2, 3) JC_ERI3C_GRAD_CLASS(LA, 2, 4)                \
  JC_ERI3C_GRAD_CLASS(LA, 3, 3) JC_ERI3C_GRAD_CLASS(LA, 3, 4)                \
  JC_ERI3C_GRAD_CLASS(LA, 4, 4)
