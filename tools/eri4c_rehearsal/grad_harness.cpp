// g++ rehearsal of K10 (csrc/oei_grad.cuh) and K11 (csrc/eri3c_grad.cuh)
// on the CPU: the device code compiled as C++20 against
// shim/cuda_runtime.h, each launch emulated block by block with one
// std::thread per CUDA thread and the block of oei_grad_launch.cuh and
// eri3c_grad_launch.cuh; ``blocks`` caps the grid, so a small cap walks
// the grid-stride loops many times.  rh_stv_grad and rh_eri3c_grad take
// the arguments of jc_stv_grad and jc_eri3c_grad without the stream, and
// the cap.  Built and held against the plain torch versions by
// tools/grad_rehearsal.py.
#include <memory>
#include <thread>
#include <vector>

#include "eri3c_grad.cuh"

thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local WarpCtx* tl_warp;
thread_local std::barrier<>* tl_block;

namespace jc {
// the dynamic shared memory of the block that runs (K10's name, K11's)
alignas(16) double sm[1 << 15];
alignas(16) double acc[1 << 13];
}  // namespace jc

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

template <class F>
void run(long long blocks, int threads, F body) {
  run_grid(blocks, threads, [&] {
    gridDim.x = (unsigned)blocks;
    body();
  });
}

template <int LA, int LB>
int stv_grad(int G, const double* prim, const double* pair, const int* meta,
             long long n, const double* atoms, int natom, const double* D,
             const double* W, long long nbf, double* grad, long long cap) {
  using namespace jc;
  if (G < kStvMinGroup || G > 32 || (G & (G - 1))) return 3;
  if (n <= 0) return 0;
  if (stvg_smem_bytes<LA, LB>(G, natom) > sizeof(sm)) return 1;
  const long long per = StvgClass<LA, LB>::NTH / G;
  run(std::min((n + per - 1) / per, cap), StvgClass<LA, LB>::NTH, [&] {
    stv_grad_kernel<LA, LB>(prim, pair, meta, n, atoms, natom, D, W, nbf, G,
                            grad);
  });
  return 0;
}

template <int LA, int LP, int LQ, bool M>
int eri3c_grad(const double* aprim, const double* apair, const int* ameta,
               long long na, const double* pprim, const double* ppair,
               const int* pmeta, long long np, const double* gam,
               long long s_a, long long s_p, double weight, double* grad,
               int natom, long long cap) {
  using namespace jc;
  if (na <= 0 || np <= 0) return 0;
  if (3 * natom > (int)(sizeof(acc) / sizeof(double))) return 1;
  const long long total = na * np;
  run(std::min((total + kEri3gThreads - 1) / kEri3gThreads, cap),
      kEri3gThreads, [&] {
        eri3c_grad_kernel<LA, LP, LQ, M>(aprim, apair, ameta, na, pprim, ppair,
                                         pmeta, np, gam, s_a, s_p, weight,
                                         grad, natom);
      });
  return 0;
}

}  // namespace

#define RH_STV(LA, LB)                                                       \
  if (la == LA && lb == LB)                                                  \
    return stv_grad<LA, LB>(group, prim, pair, meta, n, atoms, natom, D, W,  \
                            nbf, grad, cap);

extern "C" int rh_stv_grad(int la, int lb, int group, const double* prim,
                           const double* pair, const int* meta, long long n,
                           const double* atoms, int natom, const double* D,
                           const double* W, long long nbf, double* grad,
                           long long cap) {
  RH_STV(0, 0) RH_STV(0, 1) RH_STV(0, 2) RH_STV(0, 3) RH_STV(0, 4)
  RH_STV(1, 1) RH_STV(1, 2) RH_STV(1, 3) RH_STV(1, 4)
  RH_STV(2, 2) RH_STV(2, 3) RH_STV(2, 4)
  RH_STV(3, 3) RH_STV(3, 4)
  RH_STV(4, 4)
  return 2;
}

#define RH_ARGS                                                              \
  aprim, apair, ameta, na, pprim, ppair, pmeta, np, gam, s_a, s_p, weight,   \
      grad, natom, cap
#define RH_3C(LA, LP, LQ)                                                    \
  if (la == LA && lp == LP && lq == LQ)                                      \
    return eri3c_grad<LA, LP, LQ, false>(RH_ARGS);
#define RH_PAIRS(LA)                                                         \
  RH_3C(LA, 0, 0) RH_3C(LA, 0, 1) RH_3C(LA, 0, 2) RH_3C(LA, 0, 3)            \
  RH_3C(LA, 0, 4) RH_3C(LA, 1, 1) RH_3C(LA, 1, 2) RH_3C(LA, 1, 3)            \
  RH_3C(LA, 1, 4) RH_3C(LA, 2, 2) RH_3C(LA, 2, 3) RH_3C(LA, 2, 4)            \
  RH_3C(LA, 3, 3) RH_3C(LA, 3, 4) RH_3C(LA, 4, 4)
#define RH_2C(LA, LB)                                                        \
  if (la == LA && lp == LB) return eri3c_grad<LA, LB, 0, true>(RH_ARGS);

extern "C" int rh_eri3c_grad(int la, int lp, int lq, int metric,
                             const double* aprim, const double* apair,
                             const int* ameta, long long na,
                             const double* pprim, const double* ppair,
                             const int* pmeta, long long np,
                             const double* gam, long long s_a, long long s_p,
                             double weight, double* grad, int natom,
                             long long cap) {
  if (metric) {
    RH_2C(0, 0) RH_2C(0, 1) RH_2C(0, 2) RH_2C(0, 3) RH_2C(0, 4)
    RH_2C(1, 1) RH_2C(1, 2) RH_2C(1, 3) RH_2C(1, 4)
    RH_2C(2, 2) RH_2C(2, 3) RH_2C(2, 4)
    RH_2C(3, 3) RH_2C(3, 4)
    RH_2C(4, 4)
  } else {
    RH_PAIRS(0) RH_PAIRS(1) RH_PAIRS(2) RH_PAIRS(3) RH_PAIRS(4)
  }
  return 2;
}
