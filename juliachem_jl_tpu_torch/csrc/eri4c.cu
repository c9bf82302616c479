// Entry points of kernels K4 (jc_eri4c), K5 (jc_eri4c_jk) and K6
// (jc_digest_jk): dispatch one (la lb | lc ld) class to the translation
// unit of its bra class (eri4c_b<la><lb>.cu; design in eri4c.cuh).
// Returns the CUDA error of the launch (0 on success); a class that is not
// instantiated returns cudaErrorInvalidValue.
#include "eri4c_launch.cuh"

#define JC_ERI4C_DECL(LA, LB)                                                \
  extern "C" int jc_eri4c_b##LA##LB(int lc, int ld, JC_ERI4C_ARGS);          \
  extern "C" int jc_eri4c_jk_b##LA##LB(int lc, int ld, JC_ERI4C_JK_ARGS);    \
  extern "C" int jc_digest_jk_b##LA##LB(int lc, int ld, JC_DIGEST_JK_ARGS);

JC_ERI4C_DECL(0, 0)
JC_ERI4C_DECL(0, 1)
JC_ERI4C_DECL(0, 2)
JC_ERI4C_DECL(1, 1)
JC_ERI4C_DECL(1, 2)
JC_ERI4C_DECL(2, 2)

#define JC_ERI4C_SWITCH(FN, ...)                                             \
  switch (la * 10 + lb) {                                                    \
    case 0: return FN##_b00(lc, ld, __VA_ARGS__);                            \
    case 1: return FN##_b01(lc, ld, __VA_ARGS__);                            \
    case 2: return FN##_b02(lc, ld, __VA_ARGS__);                            \
    case 11: return FN##_b11(lc, ld, __VA_ARGS__);                           \
    case 12: return FN##_b12(lc, ld, __VA_ARGS__);                           \
    case 22: return FN##_b22(lc, ld, __VA_ARGS__);                           \
  }                                                                          \
  return (int)cudaErrorInvalidValue;

extern "C" int jc_eri4c(int la, int lb, int lc, int ld, JC_ERI4C_ARGS) {
  JC_ERI4C_SWITCH(jc_eri4c, pb, Ka, Kb, mb, pk, Kc, Kd, mk, sel_bra, sel_ket,
                  n, out, stream)
}

extern "C" int jc_eri4c_jk(int la, int lb, int lc, int ld, JC_ERI4C_JK_ARGS) {
  JC_ERI4C_SWITCH(jc_eri4c_jk, pb, Ka, Kb, mb, pk, Kc, Kd, mk, sel_bra,
                  sel_ket, weight, cum, n_bra, same_block, n, D, nbf, JK,
                  stream)
}

extern "C" int jc_digest_jk(int la, int lb, int lc, int ld,
                            JC_DIGEST_JK_ARGS) {
  JC_ERI4C_SWITCH(jc_digest_jk, mb, mk, sel_bra, sel_ket, weight, n, I, D,
                  nbf, JK, stream)
}
