// g++ rehearsal of the K9 candidates (stv_block.cuh; K9's body at G = 1) on
// the CPU: the device code compiled as C++20 against
// tools/eri4c_rehearsal/shim/cuda_runtime.h, each launch emulated block by
// block with one std::thread per CUDA thread and the grid and block of
// stv_block.cu and stv_thread.cu.  rh_stv_block and rh_stv_thread take the
// arguments of their C entries.  Built by tools/stv_candidates.py
// --rehearse.
#include <memory>
#include <thread>
#include <vector>

#include "stv_block.cuh"

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
int block(const double* prim, const double* pair, const int* meta,
          long long n, const double* atoms, int natom, double* S, double* T,
          double* V, long long nbf) {
  using namespace jc;
  if (StvBlockSmem<LA, LB>::bytes > sizeof(sm)) return 1;
  run_grid(n, kStvBlockThreads, [&] {
    stv_block_kernel<LA, LB>(prim, pair, meta, n, atoms, natom, S, T, V, nbf);
  });
  return 0;
}

template <int LA, int LB>
int thread(const double* prim, const double* pair, const int* meta,
           long long n, const double* atoms, int natom, double* S, double* T,
           double* V, long long nbf) {
  using namespace jc;
  constexpr int NT = 32;
  if (stv_smem_bytes<LA, LB, NT>(1) > sizeof(sm)) return 1;
  run_grid((n + NT - 1) / NT, NT, [&] {
    stv_kernel<LA, LB, NT, 1>(prim, pair, meta, n, atoms, natom, S, T, V, nbf,
                              1);
  });
  return 0;
}

}  // namespace

#define RH_CASE(F, LA, LB)                                                   \
  if (la == LA && lb == LB)                                                  \
    return F<LA, LB>(prim, pair, meta, n, atoms, natom, S, T, V, nbf);

extern "C" int rh_stv_block(int la, int lb, const double* prim,
                            const double* pair, const int* meta, long long n,
                            const double* atoms, int natom, double* S,
                            double* T, double* V, long long nbf) {
  RH_CASE(block, 0, 3) RH_CASE(block, 0, 4) RH_CASE(block, 1, 3)
  RH_CASE(block, 1, 4) RH_CASE(block, 2, 3) RH_CASE(block, 2, 4)
  RH_CASE(block, 3, 3) RH_CASE(block, 3, 4) RH_CASE(block, 4, 4)
  return 2;
}

extern "C" int rh_stv_thread(int la, int lb, const double* prim,
                             const double* pair, const int* meta, long long n,
                             const double* atoms, int natom, double* S,
                             double* T, double* V, long long nbf) {
  RH_CASE(thread, 0, 0) RH_CASE(thread, 0, 1) RH_CASE(thread, 0, 2)
  RH_CASE(thread, 1, 1) RH_CASE(thread, 1, 2) RH_CASE(thread, 2, 2)
  return 2;
}
