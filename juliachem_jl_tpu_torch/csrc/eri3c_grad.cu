// Kernel K11 entry point: dispatch one class to its instance
// (eri3c_grad_lq*.cu, eri3c_grad_metric.cu; design in eri3c_grad.cuh).
// metric 0: the 3-center class (la | lp lq), lp <= lq; metric 1: the
// 2-center class (la | lp), la <= lp (lq 0).  jc_eri3c_grad adds the
// class's share of the two-electron DF gradient to grad [natom][3] (f64)
// and returns the CUDA error of the launch (0 on success).

#include <cuda_runtime.h>

#define JC_ERI3C_GRAD_ARGS                                                   \
  const double *aprim, const double *apair, const int *ameta, long long na,  \
      const double *pprim, const double *ppair, const int *pmeta,            \
      long long np, const double *gam, long long s_a, long long s_p,         \
      double weight, double *grad, int natom, void *stream
#define JC_ERI3C_GRAD_PASS                                                   \
  aprim, apair, ameta, na, pprim, ppair, pmeta, np, gam, s_a, s_p, weight,   \
      grad, natom, stream

#define JC_PAIRS(M, LA)                                                      \
  M(LA, 0, 0) M(LA, 0, 1) M(LA, 0, 2) M(LA, 0, 3) M(LA, 0, 4) M(LA, 1, 1)    \
  M(LA, 1, 2) M(LA, 1, 3) M(LA, 1, 4) M(LA, 2, 2) M(LA, 2, 3) M(LA, 2, 4)    \
  M(LA, 3, 3) M(LA, 3, 4) M(LA, 4, 4)
#define JC_3C(M) JC_PAIRS(M, 0) JC_PAIRS(M, 1) JC_PAIRS(M, 2) JC_PAIRS(M, 3) \
  JC_PAIRS(M, 4)
#define JC_2C(M)                                                             \
  M(0, 0) M(0, 1) M(0, 2) M(0, 3) M(0, 4) M(1, 1) M(1, 2) M(1, 3) M(1, 4)    \
  M(2, 2) M(2, 3) M(2, 4) M(3, 3) M(3, 4) M(4, 4)

#define JC_3C_DECL(LA, LP, LQ)                                               \
  extern "C" int jc_eri3c_grad_c##LA##LP##LQ(JC_ERI3C_GRAD_ARGS);
#define JC_2C_DECL(LA, LB)                                                   \
  extern "C" int jc_metric_grad_c##LA##LB(JC_ERI3C_GRAD_ARGS);
JC_3C(JC_3C_DECL)
JC_2C(JC_2C_DECL)

#define JC_3C_CALL(LA, LP, LQ)                                               \
  if (la == LA && lp == LP && lq == LQ)                                      \
    return jc_eri3c_grad_c##LA##LP##LQ(JC_ERI3C_GRAD_PASS);
#define JC_2C_CALL(LA, LB)                                                   \
  if (la == LA && lp == LB) return jc_metric_grad_c##LA##LB(JC_ERI3C_GRAD_PASS);

extern "C" int jc_eri3c_grad(int la, int lp, int lq, int metric,
                             JC_ERI3C_GRAD_ARGS) {
  if (metric) {
    if (lq != 0) return (int)cudaErrorInvalidValue;
    JC_2C(JC_2C_CALL)
  } else {
    JC_3C(JC_3C_CALL)
  }
  return (int)cudaErrorInvalidValue;
}
