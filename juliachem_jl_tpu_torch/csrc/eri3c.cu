// Kernel K1 entry points: dispatch one (la, lb | lq) class to the translation
// unit of its aux angular momentum (eri3c_lq<lq>.cu; design in eri3c.cuh).
// jc_eri3c writes double, or float when f32 is nonzero; it returns the CUDA
// error of the launch (0 on success).  jc_eri3c_geometry reports a class's
// route and launch geometry (eri3c.cuh eri3c_geometry).

#include <cuda_runtime.h>

#define JC_ERI3C_DECL(LQ)                                                    \
  extern "C" int jc_eri3c_lq##LQ(                                            \
      int la, int lb, const double* pair, const int* meta, long long n,      \
      int Ka, int Kb, const double* aux, const int* auxk,                    \
      const long long* qrow, const double* ecd, int nq, int Kq,              \
      const long long* cols, const long long* cols_t,                        \
      const unsigned char* mirror, void* out, int f32, long long ld,         \
      void* stream);                                                         \
  extern "C" int jc_eri3c_geometry_lq##LQ(int la, int lb, int Ka, int Kb,    \
                                          int Kq, long long* out);

JC_ERI3C_DECL(0)
JC_ERI3C_DECL(1)
JC_ERI3C_DECL(2)
JC_ERI3C_DECL(3)
JC_ERI3C_DECL(4)

#define JC_ERI3C_ARGS                                                        \
  la, lb, pair, meta, n, Ka, Kb, aux, auxk, qrow, ecd, nq, Kq, cols, cols_t, \
      mirror, out, f32, ld, stream

extern "C" int jc_eri3c(int la, int lb, int lq, const double* pair,
                        const int* meta, long long n, int Ka, int Kb,
                        const double* aux, const int* auxk,
                        const long long* qrow, const double* ecd, int nq,
                        int Kq, const long long* cols, const long long* cols_t,
                        const unsigned char* mirror, void* out, int f32,
                        long long ld, void* stream) {
  switch (lq) {
    case 0: return jc_eri3c_lq0(JC_ERI3C_ARGS);
    case 1: return jc_eri3c_lq1(JC_ERI3C_ARGS);
    case 2: return jc_eri3c_lq2(JC_ERI3C_ARGS);
    case 3: return jc_eri3c_lq3(JC_ERI3C_ARGS);
    case 4: return jc_eri3c_lq4(JC_ERI3C_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int jc_eri3c_geometry(int la, int lb, int lq, int Ka, int Kb,
                                 int Kq, long long* out) {
  switch (lq) {
    case 0: return jc_eri3c_geometry_lq0(la, lb, Ka, Kb, Kq, out);
    case 1: return jc_eri3c_geometry_lq1(la, lb, Ka, Kb, Kq, out);
    case 2: return jc_eri3c_geometry_lq2(la, lb, Ka, Kb, Kq, out);
    case 3: return jc_eri3c_geometry_lq3(la, lb, Ka, Kb, Kq, out);
    case 4: return jc_eri3c_geometry_lq4(la, lb, Ka, Kb, Kq, out);
  }
  return (int)cudaErrorInvalidValue;
}
