// Kernel K1 entry points: dispatch one (la, lb | lq) class to the translation
// unit of its aux angular momentum and output type (eri3c_lq<lq>.cu for a
// double output, eri3c_f32_lq<lq>.cu for float; design in eri3c.cuh).
// Return the CUDA error of the launch (0 on success).

#include <cuda_runtime.h>

#define JC_ERI3C_DECL(NAME, TOUT)                                            \
  extern "C" int NAME(                                                       \
      int la, int lb, const double* pair, long long n, int Ka, int Kb,      \
      const double* aux, const long long* qrow, int nq, int Kq,              \
      const long long* cols, const long long* cols_t,                        \
      const unsigned char* mirror, TOUT* out, long long ld, void* stream);

JC_ERI3C_DECL(jc_eri3c_lq0, double)
JC_ERI3C_DECL(jc_eri3c_lq1, double)
JC_ERI3C_DECL(jc_eri3c_lq2, double)
JC_ERI3C_DECL(jc_eri3c_lq3, double)
JC_ERI3C_DECL(jc_eri3c_lq4, double)
JC_ERI3C_DECL(jc_eri3c_f32_lq0, float)
JC_ERI3C_DECL(jc_eri3c_f32_lq1, float)
JC_ERI3C_DECL(jc_eri3c_f32_lq2, float)
JC_ERI3C_DECL(jc_eri3c_f32_lq3, float)
JC_ERI3C_DECL(jc_eri3c_f32_lq4, float)

#define JC_ERI3C_DISPATCH(PREFIX)                                            \
  switch (lq) {                                                              \
    case 0: return PREFIX##0(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream); \
    case 1: return PREFIX##1(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream); \
    case 2: return PREFIX##2(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream); \
    case 3: return PREFIX##3(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream); \
    case 4: return PREFIX##4(la, lb, pair, n, Ka, Kb, aux, qrow, nq, Kq, cols, cols_t, mirror, out, ld, stream); \
  }                                                                          \
  return (int)cudaErrorInvalidValue;

extern "C" int jc_eri3c(int la, int lb, int lq, const double* pair,
                        long long n, int Ka, int Kb, const double* aux,
                        const long long* qrow, int nq, int Kq,
                        const long long* cols, const long long* cols_t,
                        const unsigned char* mirror, double* out, long long ld,
                        void* stream) {
  JC_ERI3C_DISPATCH(jc_eri3c_lq)
}

extern "C" int jc_eri3c_f32(int la, int lb, int lq, const double* pair,
                            long long n, int Ka, int Kb, const double* aux,
                            const long long* qrow, int nq, int Kq,
                            const long long* cols, const long long* cols_t,
                            const unsigned char* mirror, float* out,
                            long long ld, void* stream) {
  JC_ERI3C_DISPATCH(jc_eri3c_f32_lq)
}
