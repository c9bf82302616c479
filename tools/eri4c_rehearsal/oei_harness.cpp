// g++ rehearsal of K9 (csrc/oei.cuh) on the CPU: the device code compiled
// as C++20 against shim/cuda_runtime.h, each launch emulated block by block
// with one std::thread per CUDA thread and the grid and block of
// oei_launch.cuh.  rh_stv takes the arguments of jc_stv without the
// stream.  Every class to (gg), at any group size the launch takes.  Built and held against the plain torch version by
// tools/oei_rehearsal.py.
#include <memory>
#include <thread>
#include <vector>

#include "oei.cuh"

thread_local dim3 threadIdx, blockIdx, blockDim;
thread_local WarpCtx* tl_warp;
thread_local std::barrier<>* tl_block;

namespace jc {
// the dynamic shared memory of the block that runs
alignas(16) double sm[1 << 15];
}

namespace {

template <class F>
void run_grid(long long blocks, int threads, F body) {
  for (long long b = 0; b < blocks; ++b) {
    const int nw = threads / 32;
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<WarpCtx> warps(nw);
    for (int w = 0; w < nw; ++w) {
      bars.emplace_back(new std::barrier<>(32));
      warps[w].bar = bars.back().get();
    }
    std::barrier<> block(threads);
    std::vector<std::thread> th;
    for (int t = 0; t < threads; ++t)
      th.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = (unsigned)b;
        blockDim.x = threads;
        tl_warp = &warps[t / 32];
        tl_block = &block;
        body();
      });
    for (auto& x : th) x.join();
  }
}

template <int LA, int LB>
int stv(int G, const double* prim, const double* pair, const int* meta,
        long long n, const double* atoms, int natom, double* S, double* T,
        double* V, long long nbf) {
  using namespace jc;
  if (G < kStvMinGroup || G > 32 || (G & (G - 1))) return 3;
  if (n <= 0) return 0;
  if (stv_smem_bytes<LA, LB>(G) > sizeof(sm)) return 1;
  const long long per = kStvThreads / G;
  run_grid((n + per - 1) / per, kStvThreads, [&] {
    stv_kernel<LA, LB>(prim, pair, meta, n, atoms, natom, S, T, V, nbf, G);
  });
  return 0;
}

}  // namespace

#define RH_CASE(LA, LB)                                                      \
  if (la == LA && lb == LB)                                                  \
    return stv<LA, LB>(group, prim, pair, meta, n, atoms, natom, S, T, V,    \
                       nbf);

extern "C" int rh_stv(int la, int lb, int group, const double* prim,
                      const double* pair, const int* meta, long long n,
                      const double* atoms, int natom, double* S, double* T,
                      double* V, long long nbf) {
  RH_CASE(0, 0) RH_CASE(0, 1) RH_CASE(0, 2) RH_CASE(0, 3) RH_CASE(0, 4)
  RH_CASE(1, 1) RH_CASE(1, 2) RH_CASE(1, 3) RH_CASE(1, 4)
  RH_CASE(2, 2) RH_CASE(2, 3) RH_CASE(2, 4)
  RH_CASE(3, 3) RH_CASE(3, 4)
  RH_CASE(4, 4)
  return 2;
}
