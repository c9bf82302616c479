// Kernel K10 entry point: dispatch one (la, lb) class, la <= lb, to its
// instance (oei_grad_l*.cu; design in oei_grad.cuh), with ``group`` lanes
// a shell pair.  jc_stv_grad adds the class's share of the one-electron
// gradient to grad [natom][3] (f64) and returns the CUDA error of the
// launch (0 on success).

#include <cuda_runtime.h>

#define JC_STV_GRAD_CLASSES(M)                                               \
  M(0, 0) M(0, 1) M(0, 2) M(0, 3) M(0, 4) M(1, 1) M(1, 2) M(1, 3) M(1, 4)    \
  M(2, 2) M(2, 3) M(2, 4) M(3, 3) M(3, 4) M(4, 4)

#define JC_STV_GRAD_DECL(LA, LB)                                             \
  extern "C" int jc_stv_grad_c##LA##LB(                                      \
      int group, const double* prim, const double* pair, const int* meta,    \
      long long n, const double* atoms, int natom, const double* D,          \
      const double* W, long long nbf, double* grad, void* stream);

JC_STV_GRAD_CLASSES(JC_STV_GRAD_DECL)

#define JC_STV_GRAD_CALL(LA, LB)                                             \
  if (la == LA && lb == LB)                                                  \
    return jc_stv_grad_c##LA##LB(group, prim, pair, meta, n, atoms, natom,   \
                                 D, W, nbf, grad, stream);

extern "C" int jc_stv_grad(int la, int lb, int group, const double* prim,
                           const double* pair, const int* meta, long long n,
                           const double* atoms, int natom, const double* D,
                           const double* W, long long nbf, double* grad,
                           void* stream) {
  JC_STV_GRAD_CLASSES(JC_STV_GRAD_CALL)
  return (int)cudaErrorInvalidValue;
}
