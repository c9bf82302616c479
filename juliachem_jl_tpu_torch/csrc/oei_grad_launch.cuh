// Launches of kernel K10 (device code and design in oei_grad.cuh), and the
// C entry points of one class (la, lb): the oei_grad_*.cu units
// instantiate the classes in groups, so nvcc builds them in parallel.
// Each function returns the CUDA error of its launch (0 on success).
#pragma once

#include <algorithm>

#include "oei_grad.cuh"

namespace jc {

// blocks of a launch at most: each walks its pairs grid-stride and flushes
// its [natom][3] accumulator once
constexpr long long kGradMaxBlocks = 2048;

template <int LA, int LB>
int stv_grad_launch(int G, const double* prim, const double* pair,
                    const int* meta, long long n, const double* atoms,
                    int natom, const double* D, const double* W,
                    long long nbf, double* grad, cudaStream_t stream) {
  if (G < kStvMinGroup || G > 32 || (G & (G - 1)) != 0 || natom <= 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const size_t bytes = stvg_smem_bytes<LA, LB>(G, natom);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stv_grad_kernel<LA, LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long per = StvgClass<LA, LB>::NTH / G;
  const long long blocks = std::min((n + per - 1) / per, kGradMaxBlocks);
  stv_grad_kernel<LA, LB><<<(unsigned)blocks, StvgClass<LA, LB>::NTH, bytes,
                            stream>>>(prim, pair, meta, n, atoms, natom, D, W,
                                      nbf, G, grad);
  return (int)cudaGetLastError();
}

}  // namespace jc

// the C entry point of one class, jc_stv_grad_c<la><lb>
#define JC_STV_GRAD_CLASS(LA, LB)                                            \
  extern "C" int jc_stv_grad_c##LA##LB(                                      \
      int group, const double* prim, const double* pair, const int* meta,    \
      long long n, const double* atoms, int natom, const double* D,          \
      const double* W, long long nbf, double* grad, void* stream) {          \
    return jc::stv_grad_launch<LA, LB>(group, prim, pair, meta, n, atoms,    \
                                       natom, D, W, nbf, grad,               \
                                       (cudaStream_t)stream);                \
  }
