// C entry of the thread-a-pair candidate: K9's body (csrc/oei.cuh) at G =
// 1, kStvThreadPairs threads and shell pairs a block, for the s, p and d
// classes; built by tools/stv_candidates.py.  Returns the CUDA error of
// the launch.
#include "oei.cuh"

namespace {

constexpr int kStvThreadPairs = 32;

template <int LA, int LB>
int launch(const double* prim, const double* pair, const int* meta,
           long long n, const double* atoms, int natom, double* S, double* T,
           double* V, long long nbf) {
  constexpr int NT = kStvThreadPairs;
  constexpr size_t bytes = jc::stv_smem_bytes<LA, LB, NT>(1);
  if (n <= 0) return 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jc::stv_kernel<LA, LB, NT, 1>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  jc::stv_kernel<LA, LB, NT, 1><<<(unsigned)((n + NT - 1) / NT), NT, bytes>>>(
      prim, pair, meta, n, atoms, natom, S, T, V, nbf, 1);
  return (int)cudaGetLastError();
}

}  // namespace

#define JC_CASE(LA, LB)                                                      \
  if (la == LA && lb == LB)                                                  \
    return launch<LA, LB>(prim, pair, meta, n, atoms, natom, S, T, V, nbf);

extern "C" int jc_stv_thread(int la, int lb, const double* prim,
                             const double* pair, const int* meta, long long n,
                             const double* atoms, int natom, double* S,
                             double* T, double* V, long long nbf) {
  JC_CASE(0, 0) JC_CASE(0, 1) JC_CASE(0, 2) JC_CASE(1, 1) JC_CASE(1, 2)
  JC_CASE(2, 2)
  return (int)cudaErrorInvalidValue;
}
