// Kernel K9 entry points: dispatch one (la, lb) class, la <= lb, to its
// instance (oei_l*.cu; design in oei.cuh), with ``group`` lanes a shell
// pair.  jc_stv writes the class's elements of S, T and V (row-major nbf x
// nbf, f64) and returns the CUDA error of the launch (0 on success).

#include <cuda_runtime.h>

#define JC_STV_CLASSES(M)                                                    \
  M(0, 0) M(0, 1) M(0, 2) M(0, 3) M(0, 4) M(1, 1) M(1, 2) M(1, 3) M(1, 4)    \
  M(2, 2) M(2, 3) M(2, 4) M(3, 3) M(3, 4) M(4, 4)

#define JC_STV_DECL(LA, LB)                                                  \
  extern "C" int jc_stv_c##LA##LB(int group, const double* prim,             \
                                  const double* pair, const int* meta,       \
                                  long long n, const double* atoms,          \
                                  int natom, double* S, double* T,           \
                                  double* V, long long nbf, void* stream);

JC_STV_CLASSES(JC_STV_DECL)

#define JC_STV_CALL(LA, LB)                                                  \
  if (la == LA && lb == LB)                                                  \
    return jc_stv_c##LA##LB(group, prim, pair, meta, n, atoms, natom, S, T,  \
                            V, nbf, stream);

extern "C" int jc_stv(int la, int lb, int group, const double* prim,
                      const double* pair, const int* meta, long long n,
                      const double* atoms, int natom, double* S, double* T,
                      double* V, long long nbf, void* stream) {
  JC_STV_CLASSES(JC_STV_CALL)
  return (int)cudaErrorInvalidValue;
}
