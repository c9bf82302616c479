// Launches of kernel K1 (device code and design in eri3c.cuh), and the C
// entry points of one aux angular momentum: eri3c_lq<lq>.cu instantiates
// them for every bra class, so nvcc builds the aux momenta in parallel.
// Each class instantiates only its route (lane or block:
// JC_ERI3C_LANE_MASK_B<i>).  Each function returns the CUDA
// error of its launch (0 on success).
#pragma once

#include "eri3c.cuh"

namespace jc {

// the block route's dynamic shared memory above the 48 KB default
template <int LA, int LB, int LQ>
inline cudaError_t eri3c_block_prepare(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(eri3c_block_kernel<LA, LB, LQ>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// K1 launches the route of its class (Eri3cClass::kLane): the lane route
// 128 threads a block, four warps of 32 pairs x one aux shell each, no
// shared memory; the block route one block of Eri3cClass::kThreads
// threads (128, or kEri3cT1Threads for the T1 body) per (pair, aux tile),
// QT = eri3c_tile.
template <int LA, int LB, int LQ>
int eri3c_launch(const double* pair, const int* meta, long long n, int Ka,
                 int Kb, const double* aux, const int* auxk,
                 const long long* qrow, const double* ecd, int nq, int Kq,
                 const long long* cols, const long long* cols_t,
                 const unsigned char* mirror, void* out, int f32,
                 long long ld, cudaStream_t stream) {
  if (n <= 0 || nq <= 0) return 0;
  const int64_t* qr = reinterpret_cast<const int64_t*>(qrow);
  const int64_t* cs = reinterpret_cast<const int64_t*>(cols);
  const int64_t* ct = reinterpret_cast<const int64_t*>(cols_t);
  const uint8_t* mi = reinterpret_cast<const uint8_t*>(mirror);
  if constexpr (Eri3cClass<LA, LB, LQ>::kLane) {
    const long long warps = (n + 31) / 32 * nq;
    const long long blocks = (warps + kEri3cThreads / 32 - 1) / (kEri3cThreads / 32);
    if (warps >= (1LL << 32)) return (int)cudaErrorInvalidConfiguration;
    eri3c_lane_kernel<LA, LB, LQ><<<(unsigned)blocks, kEri3cThreads, 0,
                                    stream>>>(pair, Ka, Kb, meta, n, aux, auxk,
                                              qr, nq, Kq, cs, ct, mi, out, f32,
                                              ld);
  } else {
    const int QT = eri3c_tile<LA, LB, LQ>(Ka * Kb, Kq);
    const size_t bytes = eri3c_block_bytes<LA, LB, LQ>(Ka * Kb, Kq, QT);
    const cudaError_t err = eri3c_block_prepare<LA, LB, LQ>(bytes);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = n * ((nq + QT - 1) / QT);
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
    eri3c_block_kernel<LA, LB, LQ><<<(unsigned)blocks,
                                     Eri3cClass<LA, LB, LQ>::kThreads, bytes,
                                     stream>>>(pair, Ka, Kb, meta, aux, auxk,
                                               qr, ecd, nq, Kq, QT, cs, ct, mi,
                                               out, f32, ld);
  }
  return (int)cudaGetLastError();
}

// The geometry of a class as eri3c_launch takes it: out = route (0 lane, 1
// block, 2 block with the T1 body), QT, threads, shared-memory bytes a
// block, blocks an SM (CUDA's occupancy calculator).
template <int LA, int LB, int LQ>
int eri3c_geometry(int Ka, int Kb, int Kq, long long* out) {
  using K = Eri3cClass<LA, LB, LQ>;
  int blocks = 0;
  cudaError_t err;
  if constexpr (K::kLane) {
    out[0] = 0;
    out[1] = 1;
    out[3] = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, eri3c_lane_kernel<LA, LB, LQ>, kEri3cThreads, 0);
  } else {
    const int QT = eri3c_tile<LA, LB, LQ>(Ka * Kb, Kq);
    const size_t bytes = eri3c_block_bytes<LA, LB, LQ>(Ka * Kb, Kq, QT);
    out[0] = K::kT1 ? 2 : 1;
    out[1] = QT;
    out[3] = (long long)bytes;
    err = eri3c_block_prepare<LA, LB, LQ>(bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, eri3c_block_kernel<LA, LB, LQ>, K::kThreads, bytes);
  }
  out[2] = K::kThreads;
  out[4] = blocks;
  return (int)err;
}

}  // namespace jc

// One translation unit per aux angular momentum LQ, so nvcc builds the
// classes in parallel: JC_ERI3C_LQ(LQ) defines jc_eri3c_lq<LQ>(la, lb, ...)
// (writing double, or float when f32) and jc_eri3c_geometry_lq<LQ>.
#define JC_ERI3C_CASE(LA, LB, LQ)                                            \
  if (la == LA && lb == LB)                                                  \
    return jc::eri3c_launch<LA, LB, LQ>(pair, meta, n, Ka, Kb, aux, auxk,    \
                                        qrow, ecd, nq, Kq, cols, cols_t,     \
                                        mirror, out, f32, ld,                \
                                        (cudaStream_t)stream);

#define JC_ERI3C_GEOMETRY_CASE(LA, LB, LQ)                                   \
  if (la == LA && lb == LB) return jc::eri3c_geometry<LA, LB, LQ>(Ka, Kb, Kq, out);

#define JC_ERI3C_CASES(M, LQ)                                                \
  M(0, 0, LQ)                                                                \
  M(0, 1, LQ)                                                                \
  M(0, 2, LQ)                                                                \
  M(1, 1, LQ)                                                                \
  M(1, 2, LQ)                                                                \
  M(2, 2, LQ)                                                                \
  M(0, 3, LQ)                                                                \
  M(1, 3, LQ)                                                                \
  M(2, 3, LQ)                                                                \
  M(3, 3, LQ)                                                                \
  M(0, 4, LQ)                                                                \
  M(1, 4, LQ)                                                                \
  M(2, 4, LQ)                                                                \
  M(3, 4, LQ)                                                                \
  M(4, 4, LQ)

#define JC_ERI3C_LQ(LQ)                                                      \
  extern "C" int jc_eri3c_lq##LQ(                                            \
      int la, int lb, const double* pair, const int* meta, long long n,      \
      int Ka, int Kb, const double* aux, const int* auxk,                    \
      const long long* qrow, const double* ecd, int nq, int Kq,              \
      const long long* cols, const long long* cols_t,                        \
      const unsigned char* mirror, void* out, int f32, long long ld,         \
      void* stream) {                                                        \
    JC_ERI3C_CASES(JC_ERI3C_CASE, LQ)                                        \
    return (int)cudaErrorInvalidValue;                                       \
  }                                                                          \
  extern "C" int jc_eri3c_geometry_lq##LQ(int la, int lb, int Ka, int Kb,    \
                                          int Kq, long long* out) {          \
    JC_ERI3C_CASES(JC_ERI3C_GEOMETRY_CASE, LQ)                               \
    return (int)cudaErrorInvalidValue;                                       \
  }

