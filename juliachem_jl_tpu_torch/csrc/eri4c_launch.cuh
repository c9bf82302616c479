// Launches of kernels K4, K5 and K6 (device code and design in eri4c.cuh),
// and the C entry points of one bra class: eri4c_b<la><lb>.cu instantiates
// them for every ket class (lc, ld) that the i <= j walk over the pair
// classes (0,0) (0,1) (0,2) (0,3) (1,1) (1,2) (1,3) (2,2) (2,3) (3,3)
// reaches from its bra class, so nvcc builds the bra classes in parallel.
// Each function returns the CUDA error of its launch (0 on success).
#pragma once

#include "eri4c.cuh"

namespace jc {

// Warps per block: up to kEri4cMaxWarps while a block stays under ~100 KB of
// shared memory, at least one (a class of up to 227 KB a warp: (ff|ff)
// needs 214 KiB in K4/K5, 83 KiB in K6); one warp per quartet.
inline int eri4c_warps(size_t warp_bytes) {
  int w = (int)((100 * 1024) / (warp_bytes > 0 ? warp_bytes : 1));
  return w < 1 ? 1 : (w > kEri4cMaxWarps ? kEri4cMaxWarps : w);
}

template <typename Kern>
inline cudaError_t eri4c_prepare(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// primitive quartets per R round: at most one per lane
inline int eri4c_round(int Kab, int Kcd) {
  const int n = Kab * Kcd;
  return n < 32 ? n : 32;
}

template <int LA, int LB, int LC, int LD>
int eri4c_launch(const double* pb, int Ka, int Kb, const int* mb,
                 const double* pk, int Kc, int Kd, const int* mk,
                 const long long* sel_bra, const long long* sel_ket,
                 long long n, double* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int RS = eri4c_round(Ka * Kb, Kc * Kd);
  const size_t wb = sizeof(double) *
                    Eri4cSmem<LA, LB, LC, LD>(Ka * Kb, Kc * Kd, RS).total;
  const int W = eri4c_warps(wb);
  auto kern = eri4c_kernel<LA, LB, LC, LD>;
  cudaError_t err = eri4c_prepare(kern, W * wb);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + W - 1) / W;
  kern<<<(unsigned)blocks, 32 * W, W * wb, stream>>>(
      pb, Ka, Kb, mb, pk, Kc, Kd, mk,
      reinterpret_cast<const int64_t*>(sel_bra),
      reinterpret_cast<const int64_t*>(sel_ket), n, RS, out);
  return (int)cudaGetLastError();
}

template <int LA, int LB, int LC, int LD>
int eri4c_jk_launch(const double* pb, int Ka, int Kb, const int* mb,
                    const double* pk, int Kc, int Kd, const int* mk,
                    const long long* sel_bra, const long long* sel_ket,
                    const double* weight, const long long* cum,
                    long long n_bra, int same_block, long long n,
                    long long t0, const double* D, long long nbf, double* JK,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  const int RS = eri4c_round(Ka * Kb, Kc * Kd);
  const size_t wb = sizeof(double) *
                    Eri4cSmem<LA, LB, LC, LD>(Ka * Kb, Kc * Kd, RS).total;
  const int W = eri4c_warps(wb);
  auto kern = eri4c_jk_kernel<LA, LB, LC, LD>;
  cudaError_t err = eri4c_prepare(kern, W * wb);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + W - 1) / W;
  kern<<<(unsigned)blocks, 32 * W, W * wb, stream>>>(
      pb, Ka, Kb, mb, pk, Kc, Kd, mk,
      reinterpret_cast<const int64_t*>(sel_bra),
      reinterpret_cast<const int64_t*>(sel_ket), weight,
      reinterpret_cast<const int64_t*>(cum), n_bra, same_block, n, t0, RS, D,
      nbf, JK);
  return (int)cudaGetLastError();
}

template <int LA, int LB, int LC, int LD>
int digest_jk_launch(const int* mb, const int* mk, const long long* sel_bra,
                     const long long* sel_ket, const double* weight,
                     long long n, const double* I, const double* D,
                     long long nbf, double* JK, cudaStream_t stream) {
  if (n <= 0) return 0;
  const size_t wb = sizeof(double) * DigestSmem<LA, LB, LC, LD>().total;
  const int W = eri4c_warps(wb);
  auto kern = digest_jk_kernel<LA, LB, LC, LD>;
  cudaError_t err = eri4c_prepare(kern, W * wb);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + W - 1) / W;
  kern<<<(unsigned)blocks, 32 * W, W * wb, stream>>>(
      mb, mk, reinterpret_cast<const int64_t*>(sel_bra),
      reinterpret_cast<const int64_t*>(sel_ket), weight, n, I, D, nbf, JK);
  return (int)cudaGetLastError();
}

}  // namespace jc

#define JC_ERI4C_ARGS                                                        \
  const double *pb, int Ka, int Kb, const int *mb, const double *pk, int Kc, \
      int Kd, const int *mk, const long long *sel_bra,                       \
      const long long *sel_ket, long long n, double *out, void *stream
#define JC_ERI4C_JK_ARGS                                                     \
  const double *pb, int Ka, int Kb, const int *mb, const double *pk, int Kc, \
      int Kd, const int *mk, const long long *sel_bra,                       \
      const long long *sel_ket, const double *weight, const long long *cum,  \
      long long n_bra, int same_block, long long n, long long t0,            \
      const double *D, long long nbf, double *JK, void *stream
#define JC_DIGEST_JK_ARGS                                                    \
  const int *mb, const int *mk, const long long *sel_bra,                    \
      const long long *sel_ket, const double *weight, long long n,           \
      const double *I, const double *D, long long nbf, double *JK,           \
      void *stream

#define JC_ERI4C_KET(LA, LB, LC, LD)                                         \
  if (lc == LC && ld == LD) {                                                \
    if (which == 0)                                                          \
      return jc::eri4c_launch<LA, LB, LC, LD>(                               \
          pb, Ka, Kb, mb, pk, Kc, Kd, mk, sel_bra, sel_ket, n, out,          \
          (cudaStream_t)stream);                                             \
    return jc::eri4c_jk_launch<LA, LB, LC, LD>(                              \
        pb, Ka, Kb, mb, pk, Kc, Kd, mk, sel_bra, sel_ket, weight, cum,       \
        n_bra, same_block, n, t0, D, nbf, JK, (cudaStream_t)stream);         \
  }
#define JC_DIGEST_KET(LA, LB, LC, LD)                                        \
  if (lc == LC && ld == LD)                                                  \
    return jc::digest_jk_launch<LA, LB, LC, LD>(                             \
        mb, mk, sel_bra, sel_ket, weight, n, I, D, nbf, JK,                  \
        (cudaStream_t)stream);

// jc_eri4c_b<LA><LB> (K4), jc_eri4c_jk_b<LA><LB> (K5) and
// jc_digest_jk_b<LA><LB> (K6) over the ket classes KETS(X) of one bra class;
// a ket class it lacks returns cudaErrorInvalidValue.
#define JC_ERI4C_BRA(LA, LB, KETS)                                           \
  static int jc_eri4c_any_b##LA##LB(                                         \
      int which, int lc, int ld, const double* pb, int Ka, int Kb,           \
      const int* mb, const double* pk, int Kc, int Kd, const int* mk,        \
      const long long* sel_bra, const long long* sel_ket,                    \
      const double* weight, const long long* cum, long long n_bra,           \
      int same_block, long long n, long long t0, const double* D,            \
      long long nbf, double* JK, double* out, void* stream) {                \
    KETS(JC_ERI4C_KET, LA, LB)                                               \
    return (int)cudaErrorInvalidValue;                                       \
  }                                                                          \
  extern "C" int jc_eri4c_b##LA##LB(int lc, int ld, JC_ERI4C_ARGS) {         \
    return jc_eri4c_any_b##LA##LB(0, lc, ld, pb, Ka, Kb, mb, pk, Kc, Kd, mk, \
                                  sel_bra, sel_ket, nullptr, nullptr, 0, 0,  \
                                  n, 0, nullptr, 0, nullptr, out, stream);   \
  }                                                                          \
  extern "C" int jc_eri4c_jk_b##LA##LB(int lc, int ld, JC_ERI4C_JK_ARGS) {   \
    return jc_eri4c_any_b##LA##LB(1, lc, ld, pb, Ka, Kb, mb, pk, Kc, Kd, mk, \
                                  sel_bra, sel_ket, weight, cum, n_bra,      \
                                  same_block, n, t0, D, nbf, JK, nullptr,    \
                                  stream);                                   \
  }                                                                          \
  extern "C" int jc_digest_jk_b##LA##LB(int lc, int ld, JC_DIGEST_JK_ARGS) { \
    KETS(JC_DIGEST_KET, LA, LB)                                              \
    return (int)cudaErrorInvalidValue;                                       \
  }

// ket classes at or after each bra class in the pair-class order
#define JC_KETS_FROM_00(M, LA, LB) M(LA, LB, 0, 0) JC_KETS_FROM_01(M, LA, LB)
#define JC_KETS_FROM_01(M, LA, LB) M(LA, LB, 0, 1) JC_KETS_FROM_02(M, LA, LB)
#define JC_KETS_FROM_02(M, LA, LB) M(LA, LB, 0, 2) JC_KETS_FROM_03(M, LA, LB)
#define JC_KETS_FROM_03(M, LA, LB) M(LA, LB, 0, 3) JC_KETS_FROM_11(M, LA, LB)
#define JC_KETS_FROM_11(M, LA, LB) M(LA, LB, 1, 1) JC_KETS_FROM_12(M, LA, LB)
#define JC_KETS_FROM_12(M, LA, LB) M(LA, LB, 1, 2) JC_KETS_FROM_13(M, LA, LB)
#define JC_KETS_FROM_13(M, LA, LB) M(LA, LB, 1, 3) JC_KETS_FROM_22(M, LA, LB)
#define JC_KETS_FROM_22(M, LA, LB) M(LA, LB, 2, 2) JC_KETS_FROM_23(M, LA, LB)
#define JC_KETS_FROM_23(M, LA, LB) M(LA, LB, 2, 3) JC_KETS_FROM_33(M, LA, LB)
#define JC_KETS_FROM_33(M, LA, LB) M(LA, LB, 3, 3)
