// Kernel K1 entry point: dispatch one (la, lb | lq) class to the translation
// unit of its aux angular momentum (eri3c_lq<lq>.cu; design in eri3c.cuh).
// Returns the CUDA error of the launch (0 on success).

#include <cuda_runtime.h>

#define JC_ERI3C_DECL(LQ)                                                    \
  extern "C" int jc_eri3c_lq##LQ(                                            \
      int la, int lb, const double* pair, long long n, int Ka, int Kb,      \
      const double* aux, const long long* qrow, int nq, int Kq,              \
      const long long* cols, const long long* cols_t,                        \
      const unsigned char* mirror, double* out, long long ld, void* stream);

JC_ERI3C_DECL(0)
JC_ERI3C_DECL(1)
JC_ERI3C_DECL(2)
JC_ERI3C_DECL(3)
JC_ERI3C_DECL(4)

extern "C" int jc_eri3c(int la, int lb, int lq, const double* pair,
                        long long n, int Ka, int Kb, const double* aux,
                        const long long* qrow, int nq, int Kq,
                        const long long* cols, const long long* cols_t,
                        const unsigned char* mirror, double* out, long long ld,
                        void* stream) {
  switch (lq) {
    case 0: return jc_eri3c_lq0(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream);
    case 1: return jc_eri3c_lq1(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream);
    case 2: return jc_eri3c_lq2(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream);
    case 3: return jc_eri3c_lq3(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream);
    case 4: return jc_eri3c_lq4(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream);
  }
  return (int)cudaErrorInvalidValue;
}
