// g++ rehearsal of K1 (csrc/eri3c.cuh) on the CPU: the device code compiled
// as C++20 against shim/cuda_runtime.h, each launch emulated block by block
// with one std::thread per CUDA thread and the grid, block size and shared
// memory of eri3c_launch.cuh (the route of each class from
// -DJC_ERI3C_LANE_MASK_B<i>, the block route's body from
// -DJC_ERI3C_T1_MASK_B<i>, its aux tile from eri3c_tile).
// rh_eri3c takes the arguments of jc_eri3c without the
// stream; rh_eri3c_tile returns a block-route class's tile (0 on the lane
// route).  Classes to (dd|g) and the metric's (0,3), (0,4) bras, and with
// -DRH_WITH_F the f pairs.  Built and held against the plain torch version
// by tools/eri3c_rehearsal.py.
#include <memory>
#include <thread>
#include <vector>

#include "eri3c.cuh"

thread_local dim3 threadIdx, blockIdx, blockDim;
thread_local WarpCtx* tl_warp;
thread_local std::barrier<>* tl_block;

namespace jc {
// the dynamic shared memory of the block that runs
alignas(16) double sm[1 << 17];
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

template <int LA, int LB, int LQ>
int eri3c(const double* pair, const int* meta, long long n, int Ka, int Kb,
          const double* aux, const int* auxk, const int64_t* qrow,
          const double* ecd, int nq, int Kq, const int64_t* cols,
          const int64_t* cols_t, const uint8_t* mirror, void* out, int f32,
          long long ld) {
  using namespace jc;
  if (n <= 0 || nq <= 0) return 0;
  if constexpr (Eri3cClass<LA, LB, LQ>::kLane) {
    const long long warps = (n + 31) / 32 * nq;
    run_grid((warps + 3) / 4, kEri3cThreads, [&] {
      eri3c_lane_kernel<LA, LB, LQ>(pair, Ka, Kb, meta, n, aux, auxk, qrow,
                                    nq, Kq, cols, cols_t, mirror, out, f32,
                                    ld);
    });
  } else {
    const int QT = eri3c_tile<LA, LB, LQ>(Ka * Kb, Kq);
    const size_t bytes = eri3c_block_bytes<LA, LB, LQ>(Ka * Kb, Kq, QT);
    if (bytes > sizeof(sm) || bytes > 232448) return 1;
    run_grid(n * ((nq + QT - 1) / QT), Eri3cClass<LA, LB, LQ>::kThreads, [&] {
      eri3c_block_kernel<LA, LB, LQ>(pair, Ka, Kb, meta, aux, auxk, qrow, ecd,
                                     nq, Kq, QT, cols, cols_t, mirror, out,
                                     f32, ld);
    });
  }
  return 0;
}

template <int LA, int LB, int LQ>
int tile(int Ka, int Kb, int Kq) {
  using namespace jc;
  if constexpr (Eri3cClass<LA, LB, LQ>::kLane) return 0;
  else return eri3c_tile<LA, LB, LQ>(Ka * Kb, Kq);
}

}  // namespace

#define RH_BRAS(M, LQ) \
  M(0, 0, LQ) \
  M(0, 1, LQ) \
  M(0, 2, LQ) \
  M(1, 1, LQ) \
  M(1, 2, LQ) \
  M(2, 2, LQ) \
  M(0, 3, LQ) \
  M(0, 4, LQ)

#ifdef RH_WITH_F
#define RH_F_BRAS(M, LQ) \
  M(1, 3, LQ) \
  M(2, 3, LQ) \
  M(3, 3, LQ)
#else
#define RH_F_BRAS(M, LQ)
#endif

#ifdef RH_WITH_G
#define RH_G_BRAS(M, LQ) \
  M(1, 4, LQ) \
  M(2, 4, LQ) \
  M(3, 4, LQ) \
  M(4, 4, LQ)
#else
#define RH_G_BRAS(M, LQ)
#endif

#define RH_CLASSES(M) \
  RH_BRAS(M, 0) RH_BRAS(M, 1) RH_BRAS(M, 2) RH_BRAS(M, 3) RH_BRAS(M, 4) \
  RH_F_BRAS(M, 0) RH_F_BRAS(M, 1) RH_F_BRAS(M, 2) RH_F_BRAS(M, 3) \
  RH_F_BRAS(M, 4) RH_G_BRAS(M, 0) RH_G_BRAS(M, 1) RH_G_BRAS(M, 2) \
  RH_G_BRAS(M, 3) RH_G_BRAS(M, 4)

#define RH_K1(LA, LB, LQ)                                                     \
  if (la == LA && lb == LB && lq == LQ)                                       \
    return eri3c<LA, LB, LQ>(pair, meta, n, Ka, Kb, aux, auxk,                \
                             (const int64_t*)qrow, ecd, nq, Kq,               \
                             (const int64_t*)cols, (const int64_t*)cols_t,    \
                             mirror, out, f32, ld);
#define RH_TILE(LA, LB, LQ) \
  if (la == LA && lb == LB && lq == LQ) return tile<LA, LB, LQ>(Ka, Kb, Kq);

// the route mask of K1's bra class i (bit lq: the class on the lane route)
extern "C" unsigned long long rh_lane_mask(int i) {
  return jc::kEri3cLaneMasks[i];
}

extern "C" int rh_eri3c(int la, int lb, int lq, const double* pair,
                        const int* meta, long long n, int Ka, int Kb,
                        const double* aux, const int* auxk,
                        const long long* qrow, const double* ecd, int nq,
                        int Kq, const long long* cols, const long long* cols_t,
                        const unsigned char* mirror, void* out, int f32,
                        long long ld) {
  RH_CLASSES(RH_K1)
  return 2;
}

extern "C" int rh_eri3c_tile(int la, int lb, int lq, int Ka, int Kb, int Kq) {
  RH_CLASSES(RH_TILE)
  return -1;
}
