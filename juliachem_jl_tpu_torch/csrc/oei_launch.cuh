// Launches of kernel K9 (device code and design in oei.cuh), and the C
// entry points of one class (la, lb): the oei_*.cu units instantiate the
// classes in groups of about equal build time (the highest alone), so
// nvcc builds them in parallel.  Each function returns the CUDA error of
// its launch (0 on success).
#pragma once

#include "oei.cuh"

namespace jc {

// the groups' shared memory above the 48 KB default, sized for the
// smallest group (the most groups a block)
template <int LA, int LB>
inline cudaError_t stv_prepare() {
  constexpr size_t bytes = stv_smem_bytes<LA, LB>(kStvMinGroup);
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(stv_kernel<LA, LB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline bool stv_group_ok(int G) {
  return G >= kStvMinGroup && G <= 32 && (G & (G - 1)) == 0;
}

// kStvThreads threads a block, kStvThreads / G shell pairs a block
template <int LA, int LB>
int stv_launch(int G, const double* prim, const double* pair, const int* meta,
               long long n, const double* atoms, int natom, double* S,
               double* T, double* V, long long nbf, cudaStream_t stream) {
  if (!stv_group_ok(G)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const cudaError_t err = stv_prepare<LA, LB>();
  if (err != cudaSuccess) return (int)err;
  const long long per = kStvThreads / G, blocks = (n + per - 1) / per;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  stv_kernel<LA, LB><<<(unsigned)blocks, kStvThreads,
                       stv_smem_bytes<LA, LB>(G), stream>>>(
      prim, pair, meta, n, atoms, natom, S, T, V, nbf, G);
  return (int)cudaGetLastError();
}

}  // namespace jc

// the C entry point of one class, jc_stv_c<la><lb>
#define JC_STV_CLASS(LA, LB)                                                 \
  extern "C" int jc_stv_c##LA##LB(int group, const double* prim,             \
                                  const double* pair, const int* meta,       \
                                  long long n, const double* atoms,          \
                                  int natom, double* S, double* T,           \
                                  double* V, long long nbf, void* stream) {  \
    return jc::stv_launch<LA, LB>(group, prim, pair, meta, n, atoms, natom,  \
                                  S, T, V, nbf, (cudaStream_t)stream);       \
  }
