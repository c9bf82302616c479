// C entry of the block candidate (stv_block.cuh) for the f and g classes,
// built by tools/stv_candidates.py.  Returns the CUDA error of the launch.
#include "stv_block.cuh"

namespace {

template <int LA, int LB>
int launch(const double* prim, const double* pair, const int* meta,
           long long n, const double* atoms, int natom, double* S, double* T,
           double* V, long long nbf) {
  constexpr size_t bytes = jc::StvBlockSmem<LA, LB>::bytes;
  if (n <= 0) return 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jc::stv_block_kernel<LA, LB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  jc::stv_block_kernel<LA, LB><<<(unsigned)n, jc::kStvBlockThreads, bytes>>>(
      prim, pair, meta, n, atoms, natom, S, T, V, nbf);
  return (int)cudaGetLastError();
}

}  // namespace

#define JC_CASE(LA, LB)                                                      \
  if (la == LA && lb == LB)                                                  \
    return launch<LA, LB>(prim, pair, meta, n, atoms, natom, S, T, V, nbf);

extern "C" int jc_stv_block(int la, int lb, const double* prim,
                            const double* pair, const int* meta, long long n,
                            const double* atoms, int natom, double* S,
                            double* T, double* V, long long nbf) {
  JC_CASE(0, 3) JC_CASE(0, 4) JC_CASE(1, 3) JC_CASE(1, 4) JC_CASE(2, 3)
  JC_CASE(2, 4) JC_CASE(3, 3) JC_CASE(3, 4) JC_CASE(4, 4)
  return (int)cudaErrorInvalidValue;
}
