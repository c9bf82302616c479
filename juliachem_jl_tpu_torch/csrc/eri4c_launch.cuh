// Launches of kernels K4, K5 and K6 (device code and design in eri4c.cuh),
// and the C entry points of one bra class: eri4c_b<la><lb>.cu instantiates
// them for every ket class (lc, ld) that the i <= j walk over the pair
// classes (0,0) (0,1) .. (0,4) (1,1) .. (1,4) (2,2) .. (4,4) reaches from
// its bra class, so nvcc builds the bra classes in parallel.
// K4/K5 instantiate only the route of their class pair (lane, block or
// warp: JC_ERI4C_LANE_MASK_B<i>, JC_ERI4C_BLOCK_MASK_B<i>), K6 the route
// of its class pair (lane, block or warp: DigestClass::kLane, kBlock from
// JC_DIGEST_BLOCK_MASK_B<i>).  Each function
// returns the CUDA error of its launch (0 on success).
#pragma once

#include "eri4c.cuh"

namespace jc {

template <typename Kern>
inline cudaError_t eri4c_prepare(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// K4/K5's warp route: the dynamic shared memory of a block and, for a
// class pair in tiles, the whole of the SM's unified memory as shared
// memory, so that two warps of the largest slices (kEri4cWarpCap) share an
// SM; the other class pairs leave the split to the CUDA runtime.
template <typename Kern>
inline cudaError_t eri4c_prepare_warp(Kern kern, const Eri4cGeometry& g,
                                      int ncd) {
  if (g.CT < ncd) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return eri4c_prepare(kern, g.W * g.warp_bytes);
}

// K4/K5's block route: the dynamic shared memory of a block and the whole
// of the SM's unified memory as shared memory.
template <typename Kern>
inline cudaError_t eri4c_prepare_block(Kern kern, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return eri4c_prepare(kern, bytes);
}

inline unsigned lane_blocks(long long n) {
  return (unsigned)((n + kEri4cLaneBlock - 1) / kEri4cLaneBlock);
}

// K4 and K5 launch the route of their class (Eri4cClass::kLane, kBlock):
// the lane route one quartet a thread, 128 a block, no shared memory; the
// block route one quartet a block of Eri4cBlockClass::kThreads threads
// (eri4c_block_geometry: tiles and rounds; a launch takes fewer than 2^31
// quartets); the warp route one quartet a warp, W warps a block
// (eri4c_geometry).
template <int LA, int LB, int LC, int LD>
int eri4c_launch(const double* pb, int Ka, int Kb, const int* mb,
                 const double* pk, int Kc, int Kd, const int* mk,
                 const long long* sel_bra, const long long* sel_ket,
                 long long n, double* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t* sb = reinterpret_cast<const int64_t*>(sel_bra);
  const int64_t* sk = reinterpret_cast<const int64_t*>(sel_ket);
  if constexpr (Eri4cClass<LA, LB, LC, LD>::kLane) {
    eri4c_lane_kernel<LA, LB, LC, LD><<<lane_blocks(n), kEri4cLaneBlock, 0,
                                        stream>>>(pb, Ka, Kb, mb, pk, Kc, Kd,
                                                  mk, sb, sk, n, out);
  } else if constexpr (Eri4cClass<LA, LB, LC, LD>::kBlock) {
    if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const Eri4cBlockGeometry g =
        eri4c_block_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd, false);
    auto kern = eri4c_block_kernel<LA, LB, LC, LD>;
    cudaError_t err = eri4c_prepare_block(kern, g.bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)n, Eri4cBlockClass<LA, LB, LC, LD>::kThreads,
           g.bytes, stream>>>(
        pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb, sk, g.CT, g.AT, g.RB, g.RK, out);
  } else {
    const Eri4cGeometry g = eri4c_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd);
    auto kern = eri4c_kernel<LA, LB, LC, LD>;
    cudaError_t err =
        eri4c_prepare_warp(kern, g, Eri4cClass<LA, LB, LC, LD>::NCD);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)((n + g.W - 1) / g.W), 32 * g.W, g.W * g.warp_bytes,
           stream>>>(pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb, sk, n, g.CT, g.RS,
                     out);
  }
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
  const int64_t* sb = reinterpret_cast<const int64_t*>(sel_bra);
  const int64_t* sk = reinterpret_cast<const int64_t*>(sel_ket);
  const int64_t* cm = reinterpret_cast<const int64_t*>(cum);
  if constexpr (Eri4cClass<LA, LB, LC, LD>::kLane) {
    eri4c_jk_lane_kernel<LA, LB, LC, LD><<<lane_blocks(n), kEri4cLaneBlock, 0,
                                           stream>>>(
        pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb, sk, weight, cm, n_bra, same_block,
        n, t0, D, nbf, JK);
  } else if constexpr (Eri4cClass<LA, LB, LC, LD>::kBlock) {
    if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const Eri4cBlockGeometry g =
        eri4c_block_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd, true);
    auto kern = eri4c_jk_block_kernel<LA, LB, LC, LD>;
    cudaError_t err = eri4c_prepare_block(kern, g.bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)n, Eri4cBlockClass<LA, LB, LC, LD>::kThreads,
           g.bytes, stream>>>(
        pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb, sk, weight, cm, n_bra, same_block,
        t0, g.CT, g.AT, g.RB, g.RK, D, nbf, JK);
  } else {
    const Eri4cGeometry g = eri4c_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd);
    auto kern = eri4c_jk_kernel<LA, LB, LC, LD>;
    cudaError_t err =
        eri4c_prepare_warp(kern, g, Eri4cClass<LA, LB, LC, LD>::NCD);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)((n + g.W - 1) / g.W), 32 * g.W, g.W * g.warp_bytes,
           stream>>>(pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb, sk, weight, cm,
                     n_bra, same_block, n, t0, g.CT, g.RS, D, nbf, JK);
  }
  return (int)cudaGetLastError();
}

// K5's launch geometry for one class pair, for the smoke and the tools:
// out = {lane route (1), warp route (0) or block route (2), CT, RS
// (primitive quartets a round), warps a block, bytes of shared memory a
// warp (the block route: a block), blocks an SM holds, AT, RB, RK (bra and
// ket primitive pairs a round)}; nothing is launched.
template <int LA, int LB, int LC, int LD>
int eri4c_geometry_query(int Ka, int Kb, int Kc, int Kd, long long* out) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  int blocks = 0;
  cudaError_t err;
  if constexpr (C::kLane) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, eri4c_jk_lane_kernel<LA, LB, LC, LD>, kEri4cLaneBlock, 0);
    const long long v[9] = {1, C::NCD, 0, kEri4cLaneBlock / 32, 0, blocks,
                            C::NAB, Ka * Kb, Kc * Kd};
    for (int i = 0; i < 9; ++i) out[i] = v[i];
  } else if constexpr (C::kBlock) {
    const Eri4cBlockGeometry g =
        eri4c_block_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd, true);
    auto kern = eri4c_jk_block_kernel<LA, LB, LC, LD>;
    err = eri4c_prepare_block(kern, g.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, Eri4cBlockClass<LA, LB, LC, LD>::kThreads,
          g.bytes);
    const long long v[9] = {2, g.CT, (long long)g.RB * g.RK,
                            Eri4cBlockClass<LA, LB, LC, LD>::kThreads / 32,
                            (long long)g.bytes, blocks, g.AT, g.RB, g.RK};
    for (int i = 0; i < 9; ++i) out[i] = v[i];
  } else {
    const Eri4cGeometry g = eri4c_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd);
    auto kern = eri4c_jk_kernel<LA, LB, LC, LD>;
    err = eri4c_prepare_warp(kern, g, C::NCD);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, 32 * g.W, g.W * g.warp_bytes);
    const long long v[9] = {0, g.CT, g.RS, g.W, (long long)g.warp_bytes,
                            blocks, C::NAB, Ka * Kb, Kc * Kd};
    for (int i = 0; i < 9; ++i) out[i] = v[i];
  }
  return (int)err;
}

// K6 launches the route of its class pair (DigestClass::kLane, kBlock):
// the lane route one block a thread, kDigestLaneBlock threads a block; the
// block route one block a CTA of kDigestBlockThreads threads (its shared
// memory, a ring of slabs, above the 48 KB default; a launch takes fewer
// than 2^31 blocks); the warp route one block a warp, warps a block from
// the footprint.
template <int LA, int LB, int LC, int LD>
struct DigestLaunch {
  using G = DigestClass<LA, LB, LC, LD>;
  static auto kern() {
    if constexpr (G::kLane) return digest_jk_lane_kernel<LA, LB, LC, LD>;
    else return digest_jk_warp_kernel<LA, LB, LC, LD>;
  }
  static int warps() {
    return G::kBlock  ? kDigestBlockThreads / 32
           : G::kLane ? kDigestLaneBlock / 32
                      : eri4c_warps(G::warp_bytes());
  }
  // dynamic shared memory a CTA
  static size_t bytes() {
    return G::kBlock ? G::warp_bytes() : warps() * G::warp_bytes();
  }
};

template <int LA, int LB, int LC, int LD>
int digest_jk_launch(const int* mb, const int* mk, const long long* sel_bra,
                     const long long* sel_ket, const double* weight,
                     long long n, const double* I, const double* D,
                     long long nbf, double* JK, cudaStream_t stream) {
  if (n <= 0) return 0;
  using L = DigestLaunch<LA, LB, LC, LD>;
  const int64_t* sb = reinterpret_cast<const int64_t*>(sel_bra);
  const int64_t* sk = reinterpret_cast<const int64_t*>(sel_ket);
  const size_t bytes = L::bytes();
  if constexpr (L::G::kBlock) {
    if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    auto kern = digest_jk_block_kernel<LA, LB, LC, LD>;
    cudaError_t err = eri4c_prepare(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)n, kDigestBlockThreads, bytes, stream>>>(
        mb, mk, sb, sk, weight, I, D, nbf, JK);
  } else {
    auto kern = L::kern();
    const int W = L::warps();
    cudaError_t err = eri4c_prepare(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    const long long per = L::G::kLane ? kDigestLaneBlock : W;
    kern<<<(unsigned)((n + per - 1) / per), 32 * W, bytes, stream>>>(
        mb, mk, sb, sk, weight, n, I, D, nbf, JK);
  }
  return (int)cudaGetLastError();
}

// K6's launch geometry for one class pair, as built, for the smoke and the
// tools: out = {lane route (1), warp route (0) or block route (2), warps
// a block, bytes of shared memory a warp (the block route: a CTA), blocks
// an SM holds (CUDA's occupancy calculator)}; nothing is launched.
template <int LA, int LB, int LC, int LD>
int digest_geometry_query(long long* out) {
  using L = DigestLaunch<LA, LB, LC, LD>;
  const int W = L::warps();
  const size_t bytes = L::bytes();
  int blocks = 0;
  cudaError_t err;
  if constexpr (L::G::kBlock) {
    auto kern = digest_jk_block_kernel<LA, LB, LC, LD>;
    err = eri4c_prepare(kern, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, kDigestBlockThreads, bytes);
  } else {
    auto kern = L::kern();
    err = eri4c_prepare(kern, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                          32 * W, bytes);
  }
  const long long v[4] = {L::G::kLane ? 1 : L::G::kBlock ? 2 : 0, W,
                          (long long)L::G::warp_bytes(), blocks};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return (int)err;
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
#define JC_GEOMETRY_KET(LA, LB, LC, LD)                                      \
  if (lc == LC && ld == LD)                                                  \
    return jc::eri4c_geometry_query<LA, LB, LC, LD>(Ka, Kb, Kc, Kd, out);
#define JC_DIGEST_KET(LA, LB, LC, LD)                                        \
  if (lc == LC && ld == LD)                                                  \
    return jc::digest_jk_launch<LA, LB, LC, LD>(                             \
        mb, mk, sel_bra, sel_ket, weight, n, I, D, nbf, JK,                  \
        (cudaStream_t)stream);
#define JC_DIGEST_GEOMETRY_KET(LA, LB, LC, LD)                               \
  if (lc == LC && ld == LD)                                                  \
    return jc::digest_geometry_query<LA, LB, LC, LD>(out);

// jc_eri4c_b<LA><LB> (K4), jc_eri4c_jk_b<LA><LB> (K5),
// jc_digest_jk_b<LA><LB> (K6), jc_eri4c_geometry_b<LA><LB> (K5's
// geometry) and jc_digest_jk_geometry_b<LA><LB> (K6's) over the ket
// classes KETS(X) of one bra class; a ket class it
// lacks returns cudaErrorInvalidValue.
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
  }                                                                          \
  extern "C" int jc_eri4c_geometry_b##LA##LB(int lc, int ld, int Ka, int Kb, \
                                             int Kc, int Kd, long long* out) { \
    KETS(JC_GEOMETRY_KET, LA, LB)                                            \
    return (int)cudaErrorInvalidValue;                                       \
  }                                                                          \
  extern "C" int jc_digest_jk_geometry_b##LA##LB(int lc, int ld,             \
                                                 long long* out) {           \
    KETS(JC_DIGEST_GEOMETRY_KET, LA, LB)                                     \
    return (int)cudaErrorInvalidValue;                                       \
  }

// ket classes at or after each bra class in the pair-class order
#define JC_KETS_FROM_00(M, LA, LB) M(LA, LB, 0, 0) JC_KETS_FROM_01(M, LA, LB)
#define JC_KETS_FROM_01(M, LA, LB) M(LA, LB, 0, 1) JC_KETS_FROM_02(M, LA, LB)
#define JC_KETS_FROM_02(M, LA, LB) M(LA, LB, 0, 2) JC_KETS_FROM_03(M, LA, LB)
#define JC_KETS_FROM_03(M, LA, LB) M(LA, LB, 0, 3) JC_KETS_FROM_04(M, LA, LB)
#define JC_KETS_FROM_04(M, LA, LB) M(LA, LB, 0, 4) JC_KETS_FROM_11(M, LA, LB)
#define JC_KETS_FROM_11(M, LA, LB) M(LA, LB, 1, 1) JC_KETS_FROM_12(M, LA, LB)
#define JC_KETS_FROM_12(M, LA, LB) M(LA, LB, 1, 2) JC_KETS_FROM_13(M, LA, LB)
#define JC_KETS_FROM_13(M, LA, LB) M(LA, LB, 1, 3) JC_KETS_FROM_14(M, LA, LB)
#define JC_KETS_FROM_14(M, LA, LB) M(LA, LB, 1, 4) JC_KETS_FROM_22(M, LA, LB)
#define JC_KETS_FROM_22(M, LA, LB) M(LA, LB, 2, 2) JC_KETS_FROM_23(M, LA, LB)
#define JC_KETS_FROM_23(M, LA, LB) M(LA, LB, 2, 3) JC_KETS_FROM_24(M, LA, LB)
#define JC_KETS_FROM_24(M, LA, LB) M(LA, LB, 2, 4) JC_KETS_FROM_33(M, LA, LB)
#define JC_KETS_FROM_33(M, LA, LB) M(LA, LB, 3, 3) JC_KETS_FROM_34(M, LA, LB)
#define JC_KETS_FROM_34(M, LA, LB) M(LA, LB, 3, 4) JC_KETS_FROM_44(M, LA, LB)
#define JC_KETS_FROM_44(M, LA, LB) M(LA, LB, 4, 4)
