// g++ rehearsal of K4/K5/K6 (csrc/eri4c.cuh) on the CPU: the device code
// compiled as C++20 against shim/cuda_runtime.h, each launch emulated block
// by block with one std::thread per CUDA thread and the grid, block size
// and shared memory of eri4c_launch.cuh (the route of each class pair from
// -DJC_ERI4C_LANE_MASK_B<i> and -DJC_ERI4C_BLOCK_MASK_B<i>, the warp
// route's geometry from eri4c_geometry, the block route's from
// eri4c_block_geometry, its block held to the card's 227 KB).
// The C entry points take the arguments of jc_eri4c / jc_eri4c_jk /
// jc_digest_jk without the stream.  Classes up to (dd|dd), with
// -DRH_WITH_F the f class pairs, to (ff|ff), and with -DRH_WITH_G the g
// class pairs, to (gg|gg).  Built and held
// against the plain torch versions by tools/eri4c_rehearsal.py.
#include <memory>
#include <thread>
#include <vector>

#include "eri4c.cuh"

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

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <int LA, int LB, int LC, int LD>
int eri4c(const double* pb, int Ka, int Kb, const int* mb, const double* pk,
          int Kc, int Kd, const int* mk, const int64_t* sb, const int64_t* sk,
          long long n, double* out) {
  using namespace jc;
  if (n <= 0) return 0;
  if constexpr (Eri4cClass<LA, LB, LC, LD>::kLane) {
    run_grid(cdiv(n, kEri4cLaneBlock), kEri4cLaneBlock, [&] {
      eri4c_lane_kernel<LA, LB, LC, LD>(pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb,
                                        sk, n, out);
    });
  } else if constexpr (Eri4cClass<LA, LB, LC, LD>::kBlock) {
    const Eri4cBlockGeometry g =
        eri4c_block_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd, false);
    if (g.bytes > sizeof(sm) || g.bytes > 232448) return 1;
    run_grid(n, Eri4cBlockClass<LA, LB, LC, LD>::kThreads, [&] {
      eri4c_block_kernel<LA, LB, LC, LD>(pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb,
                                         sk, g.CT, g.AT, g.RB, g.RK, out);
    });
  } else {
    const Eri4cGeometry g = eri4c_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd);
    if (g.W * g.warp_bytes > sizeof(sm)) return 1;
    run_grid(cdiv(n, g.W), 32 * g.W, [&] {
      eri4c_kernel<LA, LB, LC, LD>(pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb, sk, n,
                                   g.CT, g.RS, out);
    });
  }
  return 0;
}

template <int LA, int LB, int LC, int LD>
int eri4c_jk(const double* pb, int Ka, int Kb, const int* mb,
             const double* pk, int Kc, int Kd, const int* mk,
             const int64_t* sb, const int64_t* sk, const double* weight,
             const int64_t* cum, long long n_bra, int same_block, long long n,
             long long t0, const double* D, long long nbf, double* JK) {
  using namespace jc;
  if (n <= 0) return 0;
  if constexpr (Eri4cClass<LA, LB, LC, LD>::kLane) {
    run_grid(cdiv(n, kEri4cLaneBlock), kEri4cLaneBlock, [&] {
      eri4c_jk_lane_kernel<LA, LB, LC, LD>(pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb,
                                           sk, weight, cum, n_bra, same_block,
                                           n, t0, D, nbf, JK);
    });
  } else if constexpr (Eri4cClass<LA, LB, LC, LD>::kBlock) {
    const Eri4cBlockGeometry g =
        eri4c_block_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd, true);
    if (g.bytes > sizeof(sm) || g.bytes > 232448) return 1;
    run_grid(n, Eri4cBlockClass<LA, LB, LC, LD>::kThreads, [&] {
      eri4c_jk_block_kernel<LA, LB, LC, LD>(pb, Ka, Kb, mb, pk, Kc, Kd, mk,
                                            sb, sk, weight, cum, n_bra,
                                            same_block, t0, g.CT, g.AT, g.RB,
                                            g.RK, D, nbf, JK);
    });
  } else {
    const Eri4cGeometry g = eri4c_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd);
    if (g.W * g.warp_bytes > sizeof(sm)) return 1;
    run_grid(cdiv(n, g.W), 32 * g.W, [&] {
      eri4c_jk_kernel<LA, LB, LC, LD>(pb, Ka, Kb, mb, pk, Kc, Kd, mk, sb, sk,
                                      weight, cum, n_bra, same_block, n, t0,
                                      g.CT, g.RS, D, nbf, JK);
    });
  }
  return 0;
}

// K6 on the route of its class pair (DigestClass::kLane, kBlock): the
// lane route's blocks of kDigestLaneBlock threads, the block route's one
// block a CTA of kDigestBlockThreads (its ring held to the card's 227 KB),
// the warp route's warps of one block each, warps a block from the
// footprint
template <int LA, int LB, int LC, int LD>
int digest_jk(const int* mb, const int* mk, const int64_t* sb,
              const int64_t* sk, const double* weight, long long n,
              const double* I, const double* D, long long nbf, double* JK) {
  using namespace jc;
  using G = DigestClass<LA, LB, LC, LD>;
  if (n <= 0) return 0;
  if constexpr (G::kLane) {
    if ((kDigestLaneBlock / 32) * G::warp_bytes() > sizeof(sm)) return 1;
    run_grid(cdiv(n, kDigestLaneBlock), kDigestLaneBlock, [&] {
      digest_jk_lane_kernel<LA, LB, LC, LD>(mb, mk, sb, sk, weight, n, I, D,
                                            nbf, JK);
    });
  } else if constexpr (G::kBlock) {
    if (G::warp_bytes() > sizeof(sm) || G::warp_bytes() > 232448) return 1;
    run_grid(n, kDigestBlockThreads, [&] {
      digest_jk_block_kernel<LA, LB, LC, LD>(mb, mk, sb, sk, weight, I, D,
                                             nbf, JK);
    });
  } else {
    const int W = eri4c_warps(G::warp_bytes());
    if (W * G::warp_bytes() > sizeof(sm)) return 1;
    run_grid(cdiv(n, W), 32 * W, [&] {
      digest_jk_warp_kernel<LA, LB, LC, LD>(mb, mk, sb, sk, weight, n, I, D,
                                            nbf, JK);
    });
  }
  return 0;
}

}  // namespace

#define RH_CLASSES(M) \
  M(0, 0, 0, 0) \
  M(0, 0, 0, 1) \
  M(0, 0, 0, 2) \
  M(0, 0, 1, 1) \
  M(0, 0, 1, 2) \
  M(0, 0, 2, 2) \
  M(0, 1, 0, 1) \
  M(0, 1, 0, 2) \
  M(0, 1, 1, 1) \
  M(0, 1, 1, 2) \
  M(0, 1, 2, 2) \
  M(0, 2, 0, 2) \
  M(0, 2, 1, 1) \
  M(0, 2, 1, 2) \
  M(0, 2, 2, 2) \
  M(1, 1, 1, 1) \
  M(1, 1, 1, 2) \
  M(1, 1, 2, 2) \
  M(1, 2, 1, 2) \
  M(1, 2, 2, 2) \
  M(2, 2, 2, 2)

// the 34 class pairs with an f shell, built with -DRH_WITH_F
#ifdef RH_WITH_F
#define RH_F_CLASSES(M) \
  M(0, 0, 0, 3) \
  M(0, 0, 1, 3) \
  M(0, 0, 2, 3) \
  M(0, 0, 3, 3) \
  M(0, 1, 0, 3) \
  M(0, 1, 1, 3) \
  M(0, 1, 2, 3) \
  M(0, 1, 3, 3) \
  M(0, 2, 0, 3) \
  M(0, 2, 1, 3) \
  M(0, 2, 2, 3) \
  M(0, 2, 3, 3) \
  M(0, 3, 0, 3) \
  M(0, 3, 1, 1) \
  M(0, 3, 1, 2) \
  M(0, 3, 1, 3) \
  M(0, 3, 2, 2) \
  M(0, 3, 2, 3) \
  M(0, 3, 3, 3) \
  M(1, 1, 1, 3) \
  M(1, 1, 2, 3) \
  M(1, 1, 3, 3) \
  M(1, 2, 1, 3) \
  M(1, 2, 2, 3) \
  M(1, 2, 3, 3) \
  M(1, 3, 1, 3) \
  M(1, 3, 2, 2) \
  M(1, 3, 2, 3) \
  M(1, 3, 3, 3) \
  M(2, 2, 2, 3) \
  M(2, 2, 3, 3) \
  M(2, 3, 2, 3) \
  M(2, 3, 3, 3) \
  M(3, 3, 3, 3)
#else
#define RH_F_CLASSES(M)
#endif

// the 65 class pairs with a g shell, built with -DRH_WITH_G
#ifdef RH_WITH_G
#define RH_G_CLASSES(M) \
  M(0, 0, 0, 4) \
  M(0, 0, 1, 4) \
  M(0, 0, 2, 4) \
  M(0, 0, 3, 4) \
  M(0, 0, 4, 4) \
  M(0, 1, 0, 4) \
  M(0, 1, 1, 4) \
  M(0, 1, 2, 4) \
  M(0, 1, 3, 4) \
  M(0, 1, 4, 4) \
  M(0, 2, 0, 4) \
  M(0, 2, 1, 4) \
  M(0, 2, 2, 4) \
  M(0, 2, 3, 4) \
  M(0, 2, 4, 4) \
  M(0, 3, 0, 4) \
  M(0, 3, 1, 4) \
  M(0, 3, 2, 4) \
  M(0, 3, 3, 4) \
  M(0, 3, 4, 4) \
  M(0, 4, 0, 4) \
  M(0, 4, 1, 1) \
  M(0, 4, 1, 2) \
  M(0, 4, 1, 3) \
  M(0, 4, 1, 4) \
  M(0, 4, 2, 2) \
  M(0, 4, 2, 3) \
  M(0, 4, 2, 4) \
  M(0, 4, 3, 3) \
  M(0, 4, 3, 4) \
  M(0, 4, 4, 4) \
  M(1, 1, 1, 4) \
  M(1, 1, 2, 4) \
  M(1, 1, 3, 4) \
  M(1, 1, 4, 4) \
  M(1, 2, 1, 4) \
  M(1, 2, 2, 4) \
  M(1, 2, 3, 4) \
  M(1, 2, 4, 4) \
  M(1, 3, 1, 4) \
  M(1, 3, 2, 4) \
  M(1, 3, 3, 4) \
  M(1, 3, 4, 4) \
  M(1, 4, 1, 4) \
  M(1, 4, 2, 2) \
  M(1, 4, 2, 3) \
  M(1, 4, 2, 4) \
  M(1, 4, 3, 3) \
  M(1, 4, 3, 4) \
  M(1, 4, 4, 4) \
  M(2, 2, 2, 4) \
  M(2, 2, 3, 4) \
  M(2, 2, 4, 4) \
  M(2, 3, 2, 4) \
  M(2, 3, 3, 4) \
  M(2, 3, 4, 4) \
  M(2, 4, 2, 4) \
  M(2, 4, 3, 3) \
  M(2, 4, 3, 4) \
  M(2, 4, 4, 4) \
  M(3, 3, 3, 4) \
  M(3, 3, 4, 4) \
  M(3, 4, 3, 4) \
  M(3, 4, 4, 4) \
  M(4, 4, 4, 4) 
#else
#define RH_G_CLASSES(M)
#endif

#define RH_K4(LA, LB, LC, LD)                                                 \
  if (la == LA && lb == LB && lc == LC && ld == LD)                           \
    return eri4c<LA, LB, LC, LD>(pb, Ka, Kb, mb, pk, Kc, Kd, mk,              \
                                 (const int64_t*)sel_bra,                     \
                                 (const int64_t*)sel_ket, n, out);
#define RH_K5(LA, LB, LC, LD)                                                 \
  if (la == LA && lb == LB && lc == LC && ld == LD)                           \
    return eri4c_jk<LA, LB, LC, LD>(                                          \
        pb, Ka, Kb, mb, pk, Kc, Kd, mk, (const int64_t*)sel_bra,              \
        (const int64_t*)sel_ket, weight, (const int64_t*)cum, n_bra,          \
        same_block, n, t0, D, nbf, JK);
#define RH_K6(LA, LB, LC, LD)                                                 \
  if (la == LA && lb == LB && lc == LC && ld == LD)                           \
    return digest_jk<LA, LB, LC, LD>(mb, mk, (const int64_t*)sel_bra,         \
                                     (const int64_t*)sel_ket, weight, n, I,   \
                                     D, nbf, JK);

// the route mask of bra pair class i (bit j: ket pair class j on the lane
// route), and of the block route
extern "C" unsigned long long rh_lane_mask(int i) {
  return jc::kEri4cLaneMasks[i];
}
extern "C" unsigned long long rh_block_mask(int i) {
  return jc::kEri4cBlockMasks[i];
}

// K5's block-route geometry of a class pair: {CT, AT, bytes, RB, RK},
// zeros off the block route
#define RH_BLOCK_GEO(LA, LB, LC, LD)                                          \
  if (la == LA && lb == LB && lc == LC && ld == LD) {                         \
    if constexpr (jc::Eri4cClass<LA, LB, LC, LD>::kBlock) {                   \
      const jc::Eri4cBlockGeometry g =                                        \
          jc::eri4c_block_geometry<LA, LB, LC, LD>(Ka, Kb, Kc, Kd, true);     \
      out[0] = g.CT;                                                          \
      out[1] = g.AT;                                                          \
      out[2] = (long long)g.bytes;                                            \
      out[3] = g.RB;                                                          \
      out[4] = g.RK;                                                          \
    }                                                                         \
    return 0;                                                                 \
  }

// K6's route of a class pair as built: lane (1), block (2) or warp (0)
#define RH_K6_ROUTE(LA, LB, LC, LD)                                           \
  if (la == LA && lb == LB && lc == LC && ld == LD)                           \
    return jc::DigestClass<LA, LB, LC, LD>::kLane    ? 1                      \
           : jc::DigestClass<LA, LB, LC, LD>::kBlock ? 2                      \
                                                     : 0;

extern "C" int rh_digest_lane(int la, int lb, int lc, int ld) {
  RH_CLASSES(RH_K6_ROUTE)
  RH_F_CLASSES(RH_K6_ROUTE)
  RH_G_CLASSES(RH_K6_ROUTE)
  return 2;
}

extern "C" int rh_block_geometry(int la, int lb, int lc, int ld, int Ka,
                                 int Kb, int Kc, int Kd, long long* out) {
  out[0] = out[1] = out[2] = out[3] = out[4] = 0;
  RH_CLASSES(RH_BLOCK_GEO)
  RH_F_CLASSES(RH_BLOCK_GEO)
  RH_G_CLASSES(RH_BLOCK_GEO)
  return 2;
}

extern "C" int rh_eri4c(int la, int lb, int lc, int ld, const double* pb,
                        int Ka, int Kb, const int* mb, const double* pk,
                        int Kc, int Kd, const int* mk,
                        const long long* sel_bra, const long long* sel_ket,
                        long long n, double* out) {
  RH_CLASSES(RH_K4)
  RH_F_CLASSES(RH_K4)
  RH_G_CLASSES(RH_K4)
  return 2;
}

extern "C" int rh_eri4c_jk(int la, int lb, int lc, int ld, const double* pb,
                           int Ka, int Kb, const int* mb, const double* pk,
                           int Kc, int Kd, const int* mk,
                           const long long* sel_bra, const long long* sel_ket,
                           const double* weight, const long long* cum,
                           long long n_bra, int same_block, long long n,
                           long long t0, const double* D, long long nbf,
                           double* JK) {
  RH_CLASSES(RH_K5)
  RH_F_CLASSES(RH_K5)
  RH_G_CLASSES(RH_K5)
  return 2;
}

extern "C" int rh_digest_jk(int la, int lb, int lc, int ld, const int* mb,
                            const int* mk, const long long* sel_bra,
                            const long long* sel_ket, const double* weight,
                            long long n, const double* I, const double* D,
                            long long nbf, double* JK) {
  RH_CLASSES(RH_K6)
  RH_F_CLASSES(RH_K6)
  RH_G_CLASSES(RH_K6)
  return 2;
}
