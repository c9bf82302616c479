// Kernels K4 (eri4c), K5 (eri4c_jk) and K6 (digest_jk): 4-center
// electron-repulsion integrals of one (la lb | lc ld) class, McMurchie-
// Davidson, and their six-image J/K digestion.  Device code only; the
// launches are in eri4c_launch.cuh.
//
// K4 replaces juliachem_jl_tpu/ops/eri.py::_eri_kernel_body / _eri_kernel
// (:44-85): (ab|cd) blocks [N, nab*ncd] for explicit (sel_bra, sel_ket)
// lists.  It serves the Schwarz diagonal (ops/schwarz.py:19), the in-core
// ERI fill (ops/fock.py:409-428), the full ERI tensor and the SAD atoms.
// K5 replaces ops/fock.py::_fused_digest_direct (:322-340) with the
// gather-sum ops/segsum.py::_reduce_into (:93-100) in list mode, and
// ops/fock_stream.py::_stream_scan_factory / _stream_digest (:92-166) in
// staircase mode: the ERI block of each quartet digested at once.
// K6 replaces ops/fock.py::_digest_incore (:343-362) + _reduce_into: the same
// digestion over cached blocks (the function of _make_digest_body, :158-189).
//
// Math, per quartet with bra primitive pairs k and ket primitive pairs l:
//   (ab|cd) = sum_{k,l} sum_{h,g} Eab[k][ab][h] (-1)^|g| R_kl[h+g] Ecd[l][cd][g]
// and, with the symmetry weight w of the quartet, into non-symmetric
// workspaces that the caller symmetrises (J + J^T, K + K^T):
//   J[a,b] += 2w sum_cd I D[c,d]     J[c,d] += 2w sum_ab I D[a,b]
//   K[a,c] += w sum_bd I D[b,d]      K[a,d] += w sum_bc I D[b,c]
//   K[b,c] += w sum_ad I D[a,d]      K[b,d] += w sum_ac I D[a,c]
//
// What bounds it on the card: per live primitive quartet the Boys series
// (128 dependent steps on the scalar FP64 pipe) and the R recursion, then
// small products per quartet; the J/K targets of many quartets collide.
// Most quartets of a real basis are low classes (L = la+lb+lc+ld <= 3: 82 %
// of benzene_2_water's in 6-311++G(2d,2p)) whose blocks hold at most 27
// integrals and which have few live primitive quartets (1 for every
// diffuse and polarisation shell).  So three routes, chosen per class
// pair at compile time (Eri4cClass::kLane, kBlock, from
// -DJC_ERI4C_LANE_MASK_B<i> and -DJC_ERI4C_BLOCK_MASK_B<i>, which
// ops/kernels.py passes from its route table):
//
// * lane route (the class pairs to L = 6 but (pd|pd)): one quartet per
//   lane, nothing in shared memory.  Each lane decodes its quartet, loops
//   over its live primitive pairs, keeps the E tables, the Boys values, R
//   and the block in registers (every index a compile-time constant:
//   static_for), and digests from registers.  32 quartets are in flight per warp where one
//   ran before, and no phase waits on __syncwarp.
// * warp route (the higher classes): one quartet per warp in shared
//   memory; the lanes build the E tables and Hermite expansions, the Boys
//   + R rounds run over its live primitive quartets (up to 32 a round), and
//   the products and the digestion share the lanes.  (Two quartets a warp,
//   to fill the rounds, made (pd|pd) 1.62x slower on the H100: the larger
//   slice halves the warps an SM, and T1 and I bind it, not the round.)
//   Where the quartet's slice would pass kEri4cWarpCap (the f
//   classes with an (ff) ket: (ff|ff) needed 214 KiB, one warp an SM), T1
//   and I are built one tile of ket components cd at a time: each tile's
//   block is written out (K4) or its share of every J/K output summed in
//   shared memory (K5), so that two warps share an SM.  One round's R
//   serves every tile; more rounds are recomputed per tile.  (The g
//   bras, whose expansion alone would pass the cap, left this route for
//   the block route, and with them its bra tiles.)
// * block route (56 of the 65 class pairs with a g shell): one quartet a
//   block of 4 or 8 warps, both products on the f64 tensor cores, in
//   tiles of ket and bra components and, where a contraction is long, in
//   rounds of primitive pairs, so that a block stays within its cap
//   whatever the contraction (the block route section below).  What
//   bound the warp route there:
//   latency.  One quartet a warp and 2 warps an SM (its slice capped at
//   110 KiB), every element of T1 and I a chain of dependent FMAs on one
//   lane behind runtime index arithmetic, Boys and R of a quartet with one
//   live primitive quartet (most g quartets) on one lane while 31 wait:
//   (gg|gg) took 138.2 ms for 1024 quartets against 0.447 ms of bound
//   (~130 clock cycles an FMA).  The block route keeps one quartet's R in
//   shared memory, built level by level by the whole block, and runs T1 =
//   M Ecd (M gathered from R as the fragments load) and I = Eab^T T1 as
//   m16n8k4 DMMA products over tiles of ket and bra components, the live
//   primitive pairs stacked on both GEMM dimensions: (gg|gg) 3.54 ms,
//   8.5 TFLOP/s (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).  What
//   binds it now: 170-230 registers hold one block of 8 warps an SM, so
//   the barriers between its phases (tables, Boys, the R levels, each
//   tile) and each k-step's gather behind its DMMA are not hidden, ~20-30
//   us a quartet; that fixed cost binds the low g class pairs with
//   millions of quartets (the lane route keeps those of L <= 6).  Where
//   the bra is tiled its expansion is rebuilt for each (ket tile, bra
//   tile): 40 % of K4's (gg|gg) and 22 % of K5's, nearly all of the
//   expansions' cost over the g class pairs (timed by building them twice);
//   where the bra is one tile its expansion costs < 1 %, so a block that
//   kept it over a run of one bra row's quartets would gain nothing.
//
// The Boys series multiplies by compile-time reciprocals (boys<L, true>):
// no f64 divide in its 128 steps.  j_ab's targets are the same for every
// quartet of one bra row, and in staircase mode consecutive quartets share
// their row (the row of t is the r with cum[r-1] <= t < cum[r]); so on the
// lane route the lanes of a warp that share a row sum their j_ab (a
// segmented warp scan over shuffles) before one lane adds each element.
// The other five images keep one atomic per element: their targets differ
// from quartet to quartet.  Only the primitives with
// nonzero coefficients are visited: the wrapper packs them first in each
// shell and passes their counts (meta), so the contraction padding of a
// class (K = 6 for a core s shell) costs nothing.  Sums into J/K are f64
// atomicAdd (native on sm_90), so J/K change in the last bits from run to
// run.
//
// K6 digests cached blocks on three routes (the K6 section below): a
// block a thread for the small blocks of K4/K5's lane class pairs (a
// warp's 32 blocks, contiguous in I, staged by 16-byte cp.async copies,
// K5's lane_digest, the targets that lanes share summed before their
// atomics; the in-core batches are bra-row-major,
// ops/schwarz.py::screened_quartets), a block a CTA for the large g blocks
// (read once through shared memory in slabs of one a, by a ring of
// cp.async stages, each slab digested as it lands), and a block a warp
// for the rest.  DMMA for the warp route's products (the d/f class
// pairs), one persistent launch over all classes and the warp route's
// slices sized by the live primitive counts are later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "boys.cuh"
#include "dmma.cuh"
#include "mcmurchie.cuh"

#ifndef JC_ERI4C_LANE_MASK_B14
#error "build with -DJC_ERI4C_LANE_MASK_B0 .. _B14 (ops/kernels.py's table)"
#endif
#ifndef JC_ERI4C_BLOCK_MASK_B14
#error "build with -DJC_ERI4C_BLOCK_MASK_B0 .. _B14 (ops/kernels.py's table)"
#endif
#ifndef JC_ERI4C_BLOCK4_MASK_B14
#error "build with -DJC_ERI4C_BLOCK4_MASK_B0 .. _B14 (ops/kernels.py's table)"
#endif
#ifndef JC_DIGEST_LANE_MAX_N
#error "build with -DJC_DIGEST_LANE_MAX_N (ops/kernels.py passes K6's table)"
#endif
// the block route's warps a block, bytes of shared memory a block before
// its tiles shrink, and the same of its 4-warp blocks
#if !defined(JC_ERI4C_BLOCK_WARPS) || !defined(JC_ERI4C_BLOCK_CAP) || \
    !defined(JC_ERI4C_BLOCK4_CAP)
#error "build with -DJC_ERI4C_BLOCK_WARPS, _CAP, 4_CAP (ops/kernels.py)"
#endif

namespace jc {

// pair table rows [n][2Ka+2Kb+6] = aexp | acoef | bexp | bcoef | A | B, the
// primitives of nonzero coefficient first; meta rows [n][kMeta]:
constexpr int kMeta = 5;  // off_a, off_b, nonzero prims of a, of b, ish == jsh
constexpr int kEri4cMaxWarps = 4;
constexpr int kEri4cLaneBlock = 128;  // threads (= quartets) of a lane-route block
// bytes one quartet's slice may take before the warp route tiles its kets:
// two such warps fit an SM's 228 KB (the rehearsal builds with a small cap
// so that every warp-route class runs in tiles)
#ifndef JC_ERI4C_WARP_CAP
#define JC_ERI4C_WARP_CAP (110 * 1024)
#endif
constexpr size_t kEri4cWarpCap = JC_ERI4C_WARP_CAP;
constexpr unsigned kFullMask = 0xffffffffu;

// Index of pair class (a, b), a <= b <= 4, in the order (0,0) (0,1) ..
// (0,4) (1,1) .. (1,4) (2,2) .. (4,4) (ops/eri.py::PAIR_CLASSES).  The
// route table JC_ERI4C_LANE_MASK_B<i> is the mask of bra pair class i,
// whose bit j is the class pair (bra i | ket j), j >= i, on the lane
// route (one macro a bra: nvcc splits a -D value at its commas).
__host__ __device__ constexpr int pair_class(int a, int b) {
  return a * 5 - a * (a - 1) / 2 + (b - a);
}
constexpr unsigned kEri4cLaneMasks[15] = {
    JC_ERI4C_LANE_MASK_B0, JC_ERI4C_LANE_MASK_B1, JC_ERI4C_LANE_MASK_B2,
    JC_ERI4C_LANE_MASK_B3, JC_ERI4C_LANE_MASK_B4, JC_ERI4C_LANE_MASK_B5,
    JC_ERI4C_LANE_MASK_B6, JC_ERI4C_LANE_MASK_B7, JC_ERI4C_LANE_MASK_B8,
    JC_ERI4C_LANE_MASK_B9, JC_ERI4C_LANE_MASK_B10, JC_ERI4C_LANE_MASK_B11,
    JC_ERI4C_LANE_MASK_B12, JC_ERI4C_LANE_MASK_B13, JC_ERI4C_LANE_MASK_B14};
// the block route, in the same form: bit j of JC_ERI4C_BLOCK_MASK_B<i> is
// the class pair (bra i | ket j) on the block route
constexpr unsigned kEri4cBlockMasks[15] = {
    JC_ERI4C_BLOCK_MASK_B0, JC_ERI4C_BLOCK_MASK_B1, JC_ERI4C_BLOCK_MASK_B2,
    JC_ERI4C_BLOCK_MASK_B3, JC_ERI4C_BLOCK_MASK_B4, JC_ERI4C_BLOCK_MASK_B5,
    JC_ERI4C_BLOCK_MASK_B6, JC_ERI4C_BLOCK_MASK_B7, JC_ERI4C_BLOCK_MASK_B8,
    JC_ERI4C_BLOCK_MASK_B9, JC_ERI4C_BLOCK_MASK_B10, JC_ERI4C_BLOCK_MASK_B11,
    JC_ERI4C_BLOCK_MASK_B12, JC_ERI4C_BLOCK_MASK_B13, JC_ERI4C_BLOCK_MASK_B14};
// ... and the block route's class pairs that run 4 warps a block
constexpr unsigned kEri4cBlock4Masks[15] = {
    JC_ERI4C_BLOCK4_MASK_B0, JC_ERI4C_BLOCK4_MASK_B1, JC_ERI4C_BLOCK4_MASK_B2,
    JC_ERI4C_BLOCK4_MASK_B3, JC_ERI4C_BLOCK4_MASK_B4, JC_ERI4C_BLOCK4_MASK_B5,
    JC_ERI4C_BLOCK4_MASK_B6, JC_ERI4C_BLOCK4_MASK_B7, JC_ERI4C_BLOCK4_MASK_B8,
    JC_ERI4C_BLOCK4_MASK_B9, JC_ERI4C_BLOCK4_MASK_B10,
    JC_ERI4C_BLOCK4_MASK_B11, JC_ERI4C_BLOCK4_MASK_B12,
    JC_ERI4C_BLOCK4_MASK_B13, JC_ERI4C_BLOCK4_MASK_B14};

template <int LA, int LB, int LC, int LD>
struct Eri4cClass {
  static constexpr int NA = ncart(LA), NB = ncart(LB);
  static constexpr int NC = ncart(LC), ND = ncart(LD);
  static constexpr int NAB = NA * NB, NCD = NC * ND;
  static constexpr int LBRA = LA + LB, LKET = LC + LD, L = LBRA + LKET;
  static constexpr int NHB = nherm(LBRA), NHK = nherm(LKET), NH = nherm(L);
  static constexpr int NEB = (LA + 1) * (LB + 1) * (LBRA + 1);
  static constexpr int NEK = (LC + 1) * (LD + 1) * (LKET + 1);
  // D blocks of the digestion: D_cd, D_ab, D_bd, D_bc, D_ad, D_ac
  static constexpr int NDG = NC * ND + NA * NB + NB * ND + NB * NC + NA * ND + NA * NC;
  // J/K outputs of one quartet: j_ab, j_cd, k_ac, k_ad, k_bc, k_bd
  static constexpr int NOUT = NAB + NCD + NA * NC + NA * ND + NB * NC + NB * ND;
  // the route: one quartet per lane, one per block (kBlock), or one per
  // warp (neither)
  static constexpr bool kLane =
      (kEri4cLaneMasks[pair_class(LA, LB)] >> pair_class(LC, LD)) & 1;
  static constexpr bool kBlock =
      !kLane &&
      ((kEri4cBlockMasks[pair_class(LA, LB)] >> pair_class(LC, LD)) & 1);
  static constexpr bool kBlock4 =
      kBlock &&
      ((kEri4cBlock4Masks[pair_class(LA, LB)] >> pair_class(LC, LD)) & 1);
};

// ---------------------------------------------------------------- helpers

// compile-time forms of the index arithmetic of mcmurchie.cuh
__host__ __device__ constexpr int tri_root(int c) {  // d with c in row d
  int d = 0;
  while ((d + 1) * (d + 2) / 2 <= c) ++d;
  return d;
}
__host__ __device__ constexpr int cart_x(int l, int c) { return l - tri_root(c); }
__host__ __device__ constexpr int cart_y(int l, int c) {
  return tri_root(c) - (c - tri_root(c) * (tri_root(c) + 1) / 2);
}
__host__ __device__ constexpr int cart_z(int l, int c) {
  return l - cart_x(l, c) - cart_y(l, c);
}
__host__ __device__ constexpr int herm_order(int h) {
  int s = 0;
  while (nherm(s) <= h) ++s;
  return s;
}
__host__ __device__ constexpr int herm_t(int h) {
  return herm_order(h) - tri_root(h - nherm(herm_order(h) - 1));
}
__host__ __device__ constexpr int herm_u(int h) {
  const int r = h - nherm(herm_order(h) - 1), d = tri_root(r);
  return d - (r - d * (d + 1) / 2);
}
__host__ __device__ constexpr int herm_v(int h) {
  return herm_order(h) - herm_t(h) - herm_u(h);
}
__host__ __device__ constexpr double cdfact(int n) {  // (2n-1)!!
  double out = 1.0;
  for (int k = 2 * n - 1; k > 0; k -= 2) out *= k;
  return out;
}
__host__ __device__ constexpr double csqrt(double x) {  // x >= 1
  double r = x;
  for (int i = 0; i < 64; ++i) r = 0.5 * (r + x / r);
  return r;
}
__host__ __device__ constexpr double caxial(int l, int c) {
  return csqrt(cdfact(l) / (cdfact(cart_x(l, c)) * cdfact(cart_y(l, c)) *
                            cdfact(cart_z(l, c))));
}

// ------------------------------------------------------------- lane route

// Per-dimension E[i][j][t] of one primitive pair in registers (the
// recurrences of hermite_E, the terms that are zero left out); E00 is
// E[0][0][0] (the Gaussian prefactor and coefficients on one dimension, 1
// on the others).
template <int L1, int L2>
__device__ __forceinline__ void herm_E_lane(double oo2p, double PA, double PB,
                                            double E00, double* E) {
  constexpr int NT = L1 + L2 + 1;
  E[0] = E00;
  // E[i][j][t] from E[i'][j'][.] = E[i-1][0] (j == 0) or E[i][j-1]
  auto step = [&](auto i_, auto j_, auto t_, double X) {
    constexpr int i = decltype(i_)::value, j = decltype(j_)::value;
    constexpr int t = decltype(t_)::value;
    constexpr int ip = j == 0 ? i - 1 : i, jp = j == 0 ? 0 : j - 1;
    constexpr int src = (ip * (L2 + 1) + jp) * NT, top = ip + jp;
    double v;
    if constexpr (t >= 1) {
      v = oo2p * E[src + t - 1];
      if constexpr (t <= top) v += X * E[src + t];
    } else {
      v = X * E[src + t];
    }
    if constexpr (t + 1 <= top) v += (t + 1) * E[src + t + 1];
    E[(i * (L2 + 1) + j) * NT + t] = v;
  };
  static_for<L1>([&](auto i0) {
    constexpr int i = decltype(i0)::value + 1;
    static_for<i + 1>([&](auto t) {
      step(std::integral_constant<int, i>{}, std::integral_constant<int, 0>{},
           t, PA);
    });
  });
  static_for<L2>([&](auto j0) {
    constexpr int j = decltype(j0)::value + 1;
    static_for<L1 + 1>([&](auto i) {
      static_for<decltype(i)::value + j + 1>([&](auto t) {
        step(i, std::integral_constant<int, j>{}, t, PB);
      });
    });
  });
}

// One primitive pair of a shell pair row: exponent sum p, centre P, and
// its three E tables (contraction coefficients on the x table).
template <int L1, int L2>
struct LanePair {
  static constexpr int NT = L1 + L2 + 1, NE = (L1 + 1) * (L2 + 1) * NT;
  double p, P[3], E[3][NE];
  __device__ __forceinline__ void build(const double* row, int K1, int K2,
                                        int i, int j, double AB2) {
    const double* cA = row + 2 * K1 + 2 * K2;
    const double* cB = cA + 3;
    const double a = row[i], b = row[2 * K1 + j];
    p = a + b;
    const double rp = 1.0 / p, oo2p = 0.5 * rp;
    const double pre =
        exp(-(a * b * rp) * AB2) * row[K1 + i] * row[2 * K1 + K2 + j];
    static_for<3>([&](auto d_) {
      constexpr int d = decltype(d_)::value;
      P[d] = (a * cA[d] + b * cB[d]) * rp;
      herm_E_lane<L1, L2>(oo2p, P[d] - cA[d], P[d] - cB[d], d == 0 ? pre : 1.0,
                          E[d]);
    });
  }
  // E[d][i][j][t]
  __device__ __forceinline__ double e(int d, int i, int j, int t) const {
    return E[d][(i * (L2 + 1) + j) * NT + t];
  }
};

__device__ __forceinline__ double dist2(const double* A, const double* B) {
  const double x = A[0] - B[0], y = A[1] - B[1], z = A[2] - B[2];
  return x * x + y * y + z * z;
}

// I[ab][cd] += sum_h Eab[ab][h] V[h] for one cd of one primitive quartet,
// V[h] = sum_g (-1)^|g| Ecd[cd][g] R[h+g] over the bra Hermite indices h
// (a function of its own per cd, force-inlined: as one body, the
// accumulation of a large class outgrows what the compiler inlines)
template <int LA, int LB, int LC, int LD, int CD>
__device__ __forceinline__ void lane_accumulate_cd(const LanePair<LA, LB>& bp,
                                                   const LanePair<LC, LD>& kp,
                                                   const double* R,
                                                   double* I) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NB = C::NB, ND = C::ND, NAB = C::NAB, NCD = C::NCD;
  constexpr int NHB = C::NHB;
  constexpr int ci = CD / ND, di = CD % ND;
  constexpr int cx = cart_x(LC, ci), cy = cart_y(LC, ci), cz = cart_z(LC, ci);
  constexpr int dx = cart_x(LD, di), dy = cart_y(LD, di), dz = cart_z(LD, di);
  double V[NHB];
  static_for<NHB>([&](auto h_) {
    constexpr int h = decltype(h_)::value;
    constexpr int t = herm_t(h), u = herm_u(h), v = herm_v(h);
    double acc = -0.0;
    static_for<cx + dx + 1>([&](auto t2_) {
      constexpr int t2 = decltype(t2_)::value;
      static_for<cy + dy + 1>([&](auto u2_) {
        constexpr int u2 = decltype(u2_)::value;
        static_for<cz + dz + 1>([&](auto v2_) {
          constexpr int v2 = decltype(v2_)::value;
          const double e = kp.e(0, cx, dx, t2) * kp.e(1, cy, dy, u2) *
                           kp.e(2, cz, dz, v2) *
                           R[hidx(t + t2, u + u2, v + v2)];
          if constexpr ((t2 + u2 + v2) & 1) acc -= e;
          else acc += e;
        });
      });
    });
    V[h] = acc;
  });
  static_for<NAB>([&](auto ab_) {
    constexpr int ab = decltype(ab_)::value;
    constexpr int ai = ab / NB, bi = ab % NB;
    constexpr int ax = cart_x(LA, ai), ay = cart_y(LA, ai);
    constexpr int az = cart_z(LA, ai), bx = cart_x(LB, bi);
    constexpr int by = cart_y(LB, bi), bz = cart_z(LB, bi);
    double acc = -0.0;
    static_for<ax + bx + 1>([&](auto t_) {
      constexpr int t = decltype(t_)::value;
      static_for<ay + by + 1>([&](auto u_) {
        constexpr int u = decltype(u_)::value;
        static_for<az + bz + 1>([&](auto v_) {
          constexpr int v = decltype(v_)::value;
          acc += bp.e(0, ax, bx, t) * bp.e(1, ay, by, u) *
                 bp.e(2, az, bz, v) * V[hidx(t, u, v)];
        });
      });
    });
    I[ab * NCD + CD] += acc;
  });
}

template <int LA, int LB, int LC, int LD, int... CD>
__device__ __forceinline__ void lane_accumulate(
    const LanePair<LA, LB>& bp, const LanePair<LC, LD>& kp, const double* R,
    double* I, std::integer_sequence<int, CD...>) {
  (lane_accumulate_cd<LA, LB, LC, LD, CD>(bp, kp, R, I), ...);
}

// The (ab|cd) block of one quartet into I[NAB*NCD] (row-major, registers),
// by one lane: rb, rk its pair rows, mb, mk their meta rows.
template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ void lane_block(const double* rb, int Ka, int Kb,
                                           const int* mb, const double* rk,
                                           int Kc, int Kd, const int* mk,
                                           double* I) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NB = C::NB, ND = C::ND, NAB = C::NAB, NCD = C::NCD;
  constexpr int NH = C::NH, L = C::L;
  static_for<NAB * NCD>([&](auto e) { I[decltype(e)::value] = 0.0; });
  const double AB2 = dist2(rb + 2 * Ka + 2 * Kb, rb + 2 * Ka + 2 * Kb + 3);
  const double CD2 = dist2(rk + 2 * Kc + 2 * Kd, rk + 2 * Kc + 2 * Kd + 3);
  const int ka = mb[2], kb = mb[3], kc = mk[2], kd = mk[3];
  for (int i = 0; i < ka; ++i)
    for (int j = 0; j < kb; ++j) {
      LanePair<LA, LB> bp;
      bp.build(rb, Ka, Kb, i, j, AB2);
      for (int k = 0; k < kc; ++k)
        for (int l = 0; l < kd; ++l) {
          LanePair<LC, LD> kp;
          kp.build(rk, Kc, Kd, k, l, CD2);
          const double X = bp.P[0] - kp.P[0], Y = bp.P[1] - kp.P[1];
          const double Z = bp.P[2] - kp.P[2];
          const double psum = bp.p + kp.p, alpha = bp.p * kp.p / psum;
          const double T = alpha * (X * X + Y * Y + Z * Z);
          const double pref = kTwoPiPow2_5 / (bp.p * kp.p * sqrt(psum));
          double R[NH];
          {
            double F[L + 1];
            boys<L, true>(T, F);
            static_for<L + 1>([&](auto m) { F[decltype(m)::value] *= pref; });
            hermite_R_lane<L>(alpha, X, Y, Z, F, R);
          }
          lane_accumulate(bp, kp, R, I,
                          std::make_integer_sequence<int, NCD>{});
        }
    }
  // axial normalisation of the Cartesian components
  static_for<NAB * NCD>([&](auto e_) {
    constexpr int e = decltype(e_)::value, ab = e / NCD, cd = e % NCD;
    constexpr double f = caxial(LA, ab / NB) * caxial(LB, ab % NB) *
                         caxial(LC, cd / ND) * caxial(LD, cd % ND);
    if constexpr (f != 1.0) I[e] *= f;
  });
}

// One K image of a lane's block: K[p,q] += w sum_{i,j} I(.) D[i, j] with
// (p, q | i, j) = (a, c | b, d), (a, d | b, c), (b, c | a, d), (b, d | a, c)
// for IMG = 0 .. 3 (a function of its own per image, force-inlined); with
// out, the sums w sum(.) go to out[pq] in place of the atomics.
template <int LA, int LB, int LC, int LD, int IMG>
__device__ __forceinline__ void lane_image(const double* I, double w,
                                           int64_t oa, int64_t ob, int64_t oc,
                                           int64_t od,
                                           const double* __restrict__ D,
                                           int64_t nbf, double* K,
                                           double* out = nullptr) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NA = C::NA, NB = C::NB, NC = C::NC, ND = C::ND;
  constexpr int NP = IMG < 2 ? NA : NB, NQ = IMG % 2 ? ND : NC;
  constexpr int NI = IMG < 2 ? NB : NA, NJ = IMG % 2 ? NC : ND;
  const int64_t op = IMG < 2 ? oa : ob, oq = IMG % 2 ? od : oc;
  const int64_t oi = IMG < 2 ? ob : oa, oj = IMG % 2 ? oc : od;
  double Dij[NI * NJ];
  static_for<NI * NJ>([&](auto x) {
    constexpr int e = decltype(x)::value;
    Dij[e] = D[(oi + e / NJ) * nbf + oj + e % NJ];
  });
  static_for<NP * NQ>([&](auto x) {
    constexpr int pq = decltype(x)::value, p = pq / NQ, q = pq % NQ;
    double s = -0.0;
    static_for<NI * NJ>([&](auto y) {
      constexpr int ij = decltype(y)::value, i = ij / NJ, j = ij % NJ;
      // (a, b, c, d) of this term
      constexpr int a = IMG < 2 ? p : i, b = IMG < 2 ? i : p;
      constexpr int c = IMG % 2 ? j : q, d = IMG % 2 ? q : j;
      s += I[(a * NB + b) * C::NCD + c * ND + d] * Dij[ij];
    });
    if (out) out[pq] = w * s;
    else atomicAdd(K + (op + p) * nbf + oq + q, w * s);
  });
}

// Six-image digestion of one lane's block I (weight w) from registers:
// the five images whose targets differ from lane to lane go to J/K by
// f64 atomics, j_ab (times 2w) is returned in jab for the run sums.  With
// kc, k_ac and k_bc (whose targets K[a, c], K[b, c] lanes of one bra row
// and one ket shell c share) are returned there too, k_ac then k_bc; with
// kd, k_ad and k_bd (targets shared by the lanes of one bra row and one
// ket shell d), k_ad then k_bd.
template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ void lane_digest(const double* I, double w,
                                            const int* mb, const int* mk,
                                            const double* __restrict__ D,
                                            int64_t nbf, double* J, double* K,
                                            double* jab,
                                            double* kc = nullptr,
                                            double* kd = nullptr) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NB = C::NB, ND = C::ND, NCD = C::NCD;
  const int64_t oa = mb[0], ob = mb[1], oc = mk[0], od = mk[1];
  {  // j_ab = 2w sum_cd I D_cd; j_cd = 2w sum_ab I D_ab
    double Dcd[C::NCD], Dab[C::NAB];
    static_for<NCD>([&](auto x) {
      constexpr int cd = decltype(x)::value;
      Dcd[cd] = D[(oc + cd / ND) * nbf + od + cd % ND];
    });
    static_for<C::NAB>([&](auto x) {
      constexpr int ab = decltype(x)::value;
      Dab[ab] = D[(oa + ab / NB) * nbf + ob + ab % NB];
    });
    static_for<C::NAB>([&](auto x) {
      constexpr int ab = decltype(x)::value;
      double s = -0.0;
      static_for<NCD>([&](auto y) {
        s += I[ab * NCD + decltype(y)::value] * Dcd[decltype(y)::value];
      });
      jab[ab] = w * (2.0 * s);
    });
    static_for<NCD>([&](auto x) {
      constexpr int cd = decltype(x)::value;
      double s = -0.0;
      static_for<C::NAB>([&](auto y) {
        s += I[decltype(y)::value * NCD + cd] * Dab[decltype(y)::value];
      });
      atomicAdd(J + (oc + cd / ND) * nbf + od + cd % ND, w * (2.0 * s));
    });
  }
  lane_image<LA, LB, LC, LD, 0>(I, w, oa, ob, oc, od, D, nbf, K, kc);
  lane_image<LA, LB, LC, LD, 1>(I, w, oa, ob, oc, od, D, nbf, K, kd);
  lane_image<LA, LB, LC, LD, 2>(I, w, oa, ob, oc, od, D, nbf, K,
                                kc ? kc + C::NA * C::NC : nullptr);
  lane_image<LA, LB, LC, LD, 3>(I, w, oa, ob, oc, od, D, nbf, K,
                                kd ? kd + C::NA * C::ND : nullptr);
}

// Sums v[0..N) over the runs of equal key in the warp (a segmented
// inclusive scan over shuffles, the runs being maximal stretches of lanes
// with one key); returns whether this lane is the last of its run, which
// then holds the run's sum.  Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ bool run_sums(double* v, int64_t key, int lane) {
  const int64_t prev = __shfl_up_sync(kFullMask, key, 1);
  const int64_t next = __shfl_down_sync(kFullMask, key, 1);
  int head = lane == 0 || prev != key;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int head_o = __shfl_up_sync(kFullMask, head, off);
    static_for<N>([&](auto i) {
      const double o = __shfl_up_sync(kFullMask, v[decltype(i)::value], off);
      if (lane >= off && !head) v[decltype(i)::value] += o;
    });
    if (lane >= off) head |= head_o;
  }
  return lane == 31 || next != key;
}

// Sums v[0..N) over the lanes of the warp with one key, wherever they lie
// (__match_any_sync), into the group's first lane; returns whether this
// lane is that one.  Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ bool group_sums(double* v, int64_t key, int lane) {
  const unsigned grp =
      __match_any_sync(kFullMask, (unsigned long long)key);
  const int first = __ffs(grp) - 1;
  unsigned rest = grp & (grp - 1);  // the group but its first lane
  while (__any_sync(kFullMask, rest != 0)) {
    const int m = rest ? __ffs(rest) - 1 : lane;
    static_for<N>([&](auto i) {
      const double o = __shfl_sync(kFullMask, v[decltype(i)::value], m);
      if (rest && lane == first) v[decltype(i)::value] += o;
    });
    rest &= rest - 1;
  }
  return lane == first;
}

// ------------------------------------------------------------- warp route

// Shared memory of one warp of the warp route (one quartet), in doubles,
// for ket tiles of CT components cd.  Kab, Kcd: padded primitive-pair
// counts of the class (sizes); RS: primitive quartets per R round.
// Regions whose lifetimes do not meet share space.  With one tile (CT =
// NCD): the E tables (steps 1-3a) lie where the R round (step 3b) goes,
// and the block I (step 4 on), the D blocks and the output sums of the
// digestion lie over Ecd and the R round.  With several tiles the ket E
// tables, the D blocks and the output sums live through every tile, and
// each tile's I lies over its Ecd; the bra E tables lie where the R round
// goes.
template <int LA, int LB, int LC, int LD>
struct Eri4cSmem {
  using C = Eri4cClass<LA, LB, LC, LD>;
  int CT, Pb, Pk, Eab, T1, Ecd, I, Eb, Ek, R, Dg, Acc, total;
  __host__ __device__ Eri4cSmem(int Kab, int Kcd, int RS, int CT_)
      : CT(CT_) {
    const int eb = Kab * 3 * C::NEB, ek = Kcd * 3 * C::NEK;
    const int ecd = Kcd * CT * C::NHK, i = C::NAB * CT, r = RS * C::NH;
    Pb = 0;                              // [Kab][4]: p, Px, Py, Pz
    Pk = Pb + 4 * Kab;                   // [Kcd][4]: q, Qx, Qy, Qz
    Eab = Pk + 4 * Kcd;                  // [Kab][NAB][NHB]
    T1 = Eab + Kab * C::NAB * C::NHB;    // [Kab][NHB][CT]
    Ecd = T1 + Kab * C::NHB * CT;        // [Kcd][CT][NHK]  step 3
    I = Ecd;                             // [NAB][CT]       step 4 on
    if (CT >= C::NCD) {
      Eb = Ecd + (ecd > i ? ecd : i);    // [Kab][3][NEB]   steps 1-2
      Ek = Eb + eb;                      // [Kcd][3][NEK]   steps 1-3a
      R = Eb;                            // [RS][NH]        step 3b
      Dg = I + i;                        // [NDG]           digestion
      Acc = Dg + C::NDG;                 // [NOUT]          digestion
      total = Ek + ek;
      if (R + r > total) total = R + r;
      if (Acc + C::NOUT > total) total = Acc + C::NOUT;
    } else {
      Ek = Ecd + (ecd > i ? ecd : i);
      Dg = Ek + ek;
      Acc = Dg + C::NDG;
      Eb = Acc + C::NOUT;
      R = Eb;
      total = Eb + (eb > r ? eb : r);
    }
  }
};

// Launch geometry of the warp route: ket tile (CT: NCD, or the widest tile
// that keeps the warp's slice within kEri4cWarpCap, so that two warps
// share an SM; one component where none does), primitive quartets a round
// (RS), warps a block (W, eri4c_warps) and bytes of shared memory a warp.
struct Eri4cGeometry {
  int CT, RS, W;
  size_t warp_bytes;
};

// Warps a block: up to kEri4cMaxWarps while a block stays under ~100 KB of
// shared memory, at least one (K4/K5's warp route and K6)
__host__ __device__ inline int eri4c_warps(size_t warp_bytes) {
  const int w = (int)((100 * 1024) / (warp_bytes > 0 ? warp_bytes : 1));
  return w < 1 ? 1 : (w > kEri4cMaxWarps ? kEri4cMaxWarps : w);
}

template <int LA, int LB, int LC, int LD>
__host__ __device__ Eri4cGeometry eri4c_geometry(int Ka, int Kb, int Kc,
                                                 int Kd) {
  constexpr int NCD = Eri4cClass<LA, LB, LC, LD>::NCD;
  const int Kab = Ka * Kb, Kcd = Kc * Kd, n = Kab * Kcd;
  Eri4cGeometry g;
  g.RS = n < 32 ? n : 32;
  auto bytes = [&](int CT) {
    return sizeof(double) *
           (size_t)Eri4cSmem<LA, LB, LC, LD>(Kab, Kcd, g.RS, CT).total;
  };
  g.CT = NCD;
  for (int nt = 2; g.CT > 1 && bytes(g.CT) > kEri4cWarpCap; ++nt)
    g.CT = (NCD + nt - 1) / nt;
  g.warp_bytes = bytes(g.CT);
  g.W = eri4c_warps(g.warp_bytes);
  return g;
}

// Product centre and per-dimension E table of primitive pair k = i*kb + j
// (real primitives i of the first shell, j of the second), dimension d,
// into slot s of sE and sP.
template <int L1, int L2>
__device__ __forceinline__ void pair_prim(const double* row, int K1, int K2,
                                          int kb, int k, int d, double* sE,
                                          double* sP, int s) {
  constexpr int NE = (L1 + 1) * (L2 + 1) * (L1 + L2 + 1);
  const int i = k / kb, j = k % kb;
  const double a = row[i], b = row[2 * K1 + j];
  const double* cA = row + 2 * K1 + 2 * K2;
  const double* cB = cA + 3;
  const double p = a + b, mu = a * b / p;
  const double Pd = (a * cA[d] + b * cB[d]) / p;
  if (d == 0) sP[4 * s] = p;
  sP[4 * s + 1 + d] = Pd;
  hermite_E<L1, L2>(p, mu, Pd - cA[d], Pd - cB[d], cA[d] - cB[d],
                    sE + (s * 3 + d) * NE);
}

// Element e = (k, ab, h) of the Hermite expansion with axial norms and the
// contraction coefficients folded in.
template <int L1, int L2>
__device__ __forceinline__ double pair_expansion(const double* row, int K1,
                                                 int K2, int kb,
                                                 const double* sE, int e) {
  constexpr int N2 = ncart(L2), N12 = ncart(L1) * N2, NH = nherm(L1 + L2);
  constexpr int NT = L1 + L2 + 1, NE = (L1 + 1) * (L2 + 1) * NT;
  const int k = e / (N12 * NH), ab = (e / NH) % N12, h = e % NH;
  int ax, ay, az, bx, by, bz, t, u, v;
  cart_comp(L1, ab / N2, ax, ay, az);
  cart_comp(L2, ab % N2, bx, by, bz);
  herm_triple(h, t, u, v);
  const double* Ek = sE + k * 3 * NE;
  auto at = [](int i, int j, int tt) { return (i * (L2 + 1) + j) * NT + tt; };
  const double val = Ek[at(ax, bx, t)] * Ek[NE + at(ay, by, u)] *
                     Ek[2 * NE + at(az, bz, v)];
  const double cc = row[K1 + k / kb] * row[2 * K1 + K2 + k % kb];
  return val * (axial(L1, ax, ay, az) * axial(L2, bx, by, bz)) * cc;
}

// Quartet t of a class pair: list mode (sel_bra, sel_ket, weight) or, when
// cum is given, staircase mode: bra r = first index with cum[r] > t, ket
// c = t - cum[r-1], weight from the ish == jsh flags and r == c within one
// block (ops/fock_stream.py:108-118).
__device__ __forceinline__ void decode_quartet(
    int64_t t, const int64_t* sel_bra, const int64_t* sel_ket,
    const double* weight, const int64_t* cum, int64_t n_bra, int same_block,
    const int* mb, const int* mk, int64_t& r, int64_t& c, double& w) {
  if (cum == nullptr) {
    r = sel_bra[t];
    c = sel_ket[t];
    w = weight == nullptr ? 1.0 : weight[t];
    return;
  }
  int64_t lo = 0, hi = n_bra;  // upper bound of t in cum[0..n_bra)
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (cum[mid] <= t) lo = mid + 1;
    else hi = mid;
  }
  r = lo;
  c = t - (r > 0 ? cum[r - 1] : 0);
  w = (mb[r * kMeta + 4] ? 0.5 : 1.0) * (mk[c * kMeta + 4] ? 0.5 : 1.0);
  if (same_block && r == c) w *= 0.5;
}

// The (ab|cd) block of one quartet, computed by the 32 lanes of one warp
// one tile at a time: rb, rk its pair rows, mb, mk their meta rows.  For
// each ket tile of components cd0 .. cd0 + ct - 1 the tile's block lies in
// w[lay.I] ([NAB][ct], row-major) when emit(0, NAB, cd0, ct) is called,
// which reads it (every lane calls it).  kTiles: lay.CT < NCD; without
// tiles every index divides by compile-time constants (a division by a
// runtime ct costs ~12 % of the class's time).
template <int LA, int LB, int LC, int LD, bool kTiles, class Emit>
__device__ void eri4c_warp(const double* rb, int Ka, int Kb, const int* mb,
                           const double* rk, int Kc, int Kd, const int* mk,
                           int RS, double* w,
                           const Eri4cSmem<LA, LB, LC, LD>& lay, int lane,
                           Emit&& emit) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NAB = C::NAB, NCD = C::NCD, NHB = C::NHB, NHK = C::NHK;
  constexpr int NH = C::NH, L = C::L, LKET = C::LKET;
  const int CT = kTiles ? lay.CT : NCD;
  double* sEb = w + lay.Eb;
  double* sEk = w + lay.Ek;
  double* sPb = w + lay.Pb;
  double* sPk = w + lay.Pk;
  double* sEab = w + lay.Eab;
  double* sEcd = w + lay.Ecd;
  double* sR = w + lay.R;
  double* sT1 = w + lay.T1;
  double* sI = w + lay.I;
  const int kb = mb[3], kd = mk[3];
  const int K2b = mb[2] * kb, K2k = mk[2] * kd;

  // 1. product centres and per-dimension E tables of the real primitive
  //    pairs, bra then ket
  for (int e = lane; e < 3 * (K2b + K2k); e += 32) {
    if (e < 3 * K2b) {
      pair_prim<LA, LB>(rb, Ka, Kb, kb, e / 3, e % 3, sEb, sPb, e / 3);
    } else {
      const int k = (e - 3 * K2b) / 3;
      pair_prim<LC, LD>(rk, Kc, Kd, kd, k, (e - 3 * K2b) % 3, sEk, sPk, k);
    }
  }
  __syncwarp();
  // 2. the bra Hermite expansions
  for (int e = lane; e < K2b * NAB * NHB; e += 32)
    sEab[e] = pair_expansion<LA, LB>(rb, Ka, Kb, kb, sEb, e);
  __syncwarp();
  // the primitive quartets f = k*K2k + l; in one round their R serves
  // every tile
  const int nprim = K2b * K2k;
  for (int cd0 = 0; cd0 < NCD; cd0 += CT) {
    const int ct = !kTiles ? NCD : NCD - cd0 < CT ? NCD - cd0 : CT;
    // 3a. the tile's ket expansions Ecd[l][cdt][g]; T1 = 0
    for (int e = lane; e < K2k * ct * NHK; e += 32) {
      const int l = e / (ct * NHK), cdt = (e / NHK) % ct, g = e % NHK;
      sEcd[e] = pair_expansion<LC, LD>(rk, Kc, Kd, kd, sEk,
                                       (l * NCD + cd0 + cdt) * NHK + g);
    }
    for (int e = lane; e < K2b * NHB * ct; e += 32) sT1[e] = 0.0;
    __syncwarp();
    // 3b. in rounds of RS primitive quartets: Boys + R by one lane each,
    //     then T1[k][h][cdt] += sum_g (-1)^|g| R_kl[h+g] Ecd[l][cdt][g]
    for (int f0 = 0; f0 < nprim; f0 += RS) {
      const int nr = min(RS, nprim - f0);
      if (lane < nr && (cd0 == 0 || nprim > RS)) {
        const int k = (f0 + lane) / K2k, l = (f0 + lane) % K2k;
        const double p = sPb[4 * k], q = sPk[4 * l];
        const double X = sPb[4 * k + 1] - sPk[4 * l + 1];
        const double Y = sPb[4 * k + 2] - sPk[4 * l + 2];
        const double Z = sPb[4 * k + 3] - sPk[4 * l + 3];
        const double psum = p + q, alpha = p * q / psum;
        const double T = alpha * (X * X + Y * Y + Z * Z);
        const double pref = kTwoPiPow2_5 / (p * q * sqrt(psum));
        double F[L + 1];
        boys<L, true>(T, F);
        for (int m = 0; m <= L; ++m) F[m] *= pref;
        hermite_R<L>(alpha, X, Y, Z, F, sR + lane * NH);
      }
      __syncwarp();
      for (int s = 0; s < nr; ++s) {
        const int k = (f0 + s) / K2k, l = (f0 + s) % K2k;
        const double* Rs = sR + s * NH;
        const double* El = sEcd + l * ct * NHK;
        double* Tk = sT1 + k * NHB * ct;
        for (int e = lane; e < NHB * ct; e += 32) {
          const int h = e / ct, cdt = e % ct;
          int t, u, v;
          herm_triple(h, t, u, v);
          const double* Ec = El + cdt * NHK;
          double acc = 0.0;
          for (int s2 = 0, g = 0; s2 <= LKET; ++s2)
            for (int d = 0; d <= s2; ++d)
              for (int u2 = d; u2 >= 0; --u2, ++g) {
                const int t2 = s2 - d, v2 = d - u2;
                const double m = Rs[herm_index(t + t2, u + u2, v + v2)];
                acc += ((s2 & 1) ? -m : m) * Ec[g];
              }
          Tk[e] += acc;
        }
      }
      __syncwarp();
    }
    // 4. I[ab][cdt] = sum_k sum_h Eab[k][ab][h] T1[k][h][cdt]
    for (int e = lane; e < NAB * ct; e += 32) {
      const int ab = e / ct, cdt = e % ct;
      double acc = 0.0;
      for (int k = 0; k < K2b; ++k) {
        const double* Ek = sEab + (k * NAB + ab) * NHB;
        const double* Tk = sT1 + k * NHB * ct + cdt;
        for (int h = 0; h < NHB; ++h) acc += Ek[h] * Tk[h * ct];
      }
      sI[e] = acc;
    }
    __syncwarp();
    emit(0, NAB, cd0, ct);
    __syncwarp();
  }
}

// Element e of the six D blocks of one quartet (D_cd, D_ab, D_bd, D_bc,
// D_ad, D_ac, row-major each).
template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ double dg_element(int e, int64_t oa, int64_t ob,
                                             int64_t oc, int64_t od,
                                             const double* __restrict__ D,
                                             int64_t nbf) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NA = C::NA, NB = C::NB, NC = C::NC, ND = C::ND;
  int x = e;
  int64_t r0, c0;
  int n2;
  if (x < NC * ND) { r0 = oc; c0 = od; n2 = ND; }
  else if ((x -= NC * ND) < NA * NB) { r0 = oa; c0 = ob; n2 = NB; }
  else if ((x -= NA * NB) < NB * ND) { r0 = ob; c0 = od; n2 = ND; }
  else if ((x -= NB * ND) < NB * NC) { r0 = ob; c0 = oc; n2 = NC; }
  else if ((x -= NB * NC) < NA * ND) { r0 = oa; c0 = od; n2 = ND; }
  else { x -= NA * ND; r0 = oa; c0 = oc; n2 = NC; }
  return D[(r0 + x / n2) * nbf + c0 + x % n2];
}

// Output element e of the six images of one quartet's block sI against its
// D blocks sDg: the sum (times 2 for J) and, in dst, where it goes.
template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ double jk_element(const double* sI,
                                             const double* sDg, int e,
                                             int64_t oa, int64_t ob,
                                             int64_t oc, int64_t od,
                                             int64_t nbf, double* J,
                                             double* K, double*& dst) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NA = C::NA, NB = C::NB, NC = C::NC, ND = C::ND;
  constexpr int NAB = C::NAB, NCD = C::NCD;
  const double* Dcd = sDg;
  const double* Dab = Dcd + NC * ND;
  const double* Dbd = Dab + NA * NB;
  const double* Dbc = Dbd + NB * ND;
  const double* Dad = Dbc + NB * NC;
  const double* Dac = Dad + NA * ND;
  int x = e;
  double s = 0.0;
  if (x < NAB) {                                   // j_ab
    for (int cd = 0; cd < NCD; ++cd) s += sI[x * NCD + cd] * Dcd[cd];
    dst = J + (oa + x / NB) * nbf + ob + x % NB;
    s *= 2.0;
  } else if ((x -= NAB) < NCD) {                   // j_cd
    for (int ab = 0; ab < NAB; ++ab) s += sI[ab * NCD + x] * Dab[ab];
    dst = J + (oc + x / ND) * nbf + od + x % ND;
    s *= 2.0;
  } else if ((x -= NCD) < NA * NC) {               // k_ac
    const int a = x / NC, c = x % NC;
    for (int b = 0; b < NB; ++b)
      for (int d = 0; d < ND; ++d)
        s += sI[(a * NB + b) * NCD + c * ND + d] * Dbd[b * ND + d];
    dst = K + (oa + a) * nbf + oc + c;
  } else if ((x -= NA * NC) < NA * ND) {           // k_ad
    const int a = x / ND, d = x % ND;
    for (int b = 0; b < NB; ++b)
      for (int c = 0; c < NC; ++c)
        s += sI[(a * NB + b) * NCD + c * ND + d] * Dbc[b * NC + c];
    dst = K + (oa + a) * nbf + od + d;
  } else if ((x -= NA * ND) < NB * NC) {           // k_bc
    const int b = x / NC, c = x % NC;
    for (int a = 0; a < NA; ++a)
      for (int d = 0; d < ND; ++d)
        s += sI[(a * NB + b) * NCD + c * ND + d] * Dad[a * ND + d];
    dst = K + (ob + b) * nbf + oc + c;
  } else {                                         // k_bd
    x -= NB * NC;
    const int b = x / ND, d = x % ND;
    for (int a = 0; a < NA; ++a)
      for (int c = 0; c < NC; ++c)
        s += sI[(a * NB + b) * NCD + c * ND + d] * Dac[a * NC + c];
    dst = K + (ob + b) * nbf + od + d;
  }
  return s;
}

// Output x of the six images of one quartet (j_ab, j_cd, k_ac, k_ad, k_bc,
// k_bd, as jk_element) summed over one tile: sI the tile's block [at][ct]
// of components ab0 .. ab0 + at - 1 and cd0 .. cd0 + ct - 1, sDg the
// quartet's D blocks.  J outputs carry their factor 2.
template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ double jk_partial(const double* sI,
                                             const double* sDg, int x,
                                             int ab0, int at, int cd0,
                                             int ct) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NA = C::NA, NB = C::NB, NC = C::NC, ND = C::ND;
  constexpr int NAB = C::NAB, NCD = C::NCD;
  const double* Dcd = sDg;
  const double* Dab = Dcd + NC * ND;
  const double* Dbd = Dab + NA * NB;
  const double* Dbc = Dbd + NB * ND;
  const double* Dad = Dbc + NB * NC;
  const double* Dac = Dad + NA * ND;
  const int ab1 = ab0 + at, cd1 = cd0 + ct;
  // the tile's i = r*N2 + j (r < N1) of one r: j in [lo, hi); of one j: r
  // in [lo, hi) (cd = c*ND + d against [cd0, cd1), ab = a*NB + b against
  // [ab0, ab1))
  auto j_run = [](int r, int N2, int i0, int i1, int& lo, int& hi) {
    lo = i0 - r * N2 > 0 ? i0 - r * N2 : 0;
    hi = i1 - r * N2 < N2 ? i1 - r * N2 : N2;
  };
  auto r_run = [](int j, int N1, int N2, int i0, int i1, int& lo,
                  int& hi) {
    lo = i0 > j ? (i0 - j + N2 - 1) / N2 : 0;
    hi = i1 > j ? (i1 - j + N2 - 1) / N2 : 0;
    if (hi > N1) hi = N1;
  };
  // element (a, b, c, d) of the tile's block
  auto at_ = [&](int a, int b, int c, int d) {
    return sI[(a * NB + b - ab0) * ct + c * ND + d - cd0];
  };
  double s = 0.0;
  if (x < NAB) {                                   // j_ab
    if (x < ab0 || x >= ab1) return 0.0;
    for (int t = 0; t < ct; ++t) s += sI[(x - ab0) * ct + t] * Dcd[cd0 + t];
    return 2.0 * s;
  }
  if ((x -= NAB) < NCD) {                          // j_cd
    if (x < cd0 || x >= cd1) return 0.0;
    for (int ab = ab0; ab < ab1; ++ab)
      s += sI[(ab - ab0) * ct + x - cd0] * Dab[ab];
    return 2.0 * s;
  }
  int lo, hi, alo, ahi;
  if ((x -= NCD) < NA * NC) {                      // k_ac
    const int a = x / NC, c = x % NC;
    j_run(c, ND, cd0, cd1, lo, hi);
    j_run(a, NB, ab0, ab1, alo, ahi);
    for (int d = lo; d < hi; ++d)
      for (int b = alo; b < ahi; ++b) s += at_(a, b, c, d) * Dbd[b * ND + d];
  } else if ((x -= NA * NC) < NA * ND) {           // k_ad
    const int a = x / ND, d = x % ND;
    r_run(d, NC, ND, cd0, cd1, lo, hi);
    j_run(a, NB, ab0, ab1, alo, ahi);
    for (int c = lo; c < hi; ++c)
      for (int b = alo; b < ahi; ++b) s += at_(a, b, c, d) * Dbc[b * NC + c];
  } else if ((x -= NA * ND) < NB * NC) {           // k_bc
    const int b = x / NC, c = x % NC;
    j_run(c, ND, cd0, cd1, lo, hi);
    r_run(b, NA, NB, ab0, ab1, alo, ahi);
    for (int d = lo; d < hi; ++d)
      for (int a = alo; a < ahi; ++a) s += at_(a, b, c, d) * Dad[a * ND + d];
  } else {                                         // k_bd
    x -= NB * NC;
    const int b = x / ND, d = x % ND;
    r_run(d, NC, ND, cd0, cd1, lo, hi);
    r_run(b, NA, NB, ab0, ab1, alo, ahi);
    for (int c = lo; c < hi; ++c)
      for (int a = alo; a < ahi; ++a) s += at_(a, b, c, d) * Dac[a * NC + c];
  }
  return s;
}

// Where output x of one quartet (the order of jk_partial) goes.
template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ double* jk_target(int x, int64_t oa, int64_t ob,
                                             int64_t oc, int64_t od,
                                             int64_t nbf, double* J,
                                             double* K) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NA = C::NA, NB = C::NB, NC = C::NC, ND = C::ND;
  if (x < C::NAB) return J + (oa + x / NB) * nbf + ob + x % NB;
  if ((x -= C::NAB) < C::NCD) return J + (oc + x / ND) * nbf + od + x % ND;
  if ((x -= C::NCD) < NA * NC) return K + (oa + x / NC) * nbf + oc + x % NC;
  if ((x -= NA * NC) < NA * ND) return K + (oa + x / ND) * nbf + od + x % ND;
  if ((x -= NA * ND) < NB * NC) return K + (ob + x / NC) * nbf + oc + x % NC;
  x -= NB * NC;
  return K + (ob + x / ND) * nbf + od + x % ND;
}

// The warp route's digestion, in three steps.  digest_begin, at the first
// tile: the quartet's D blocks into w[lay.Dg], the output sums w[lay.Acc]
// = 0 (every lane calls it, then __syncwarp).  digest_tile: each tile's
// share of every output, by the lane that owns the output (the same lane
// every tile).  digest_end: the sums to J/K with the weight, one f64
// atomic an element.
template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ void digest_begin(
    const Eri4cSmem<LA, LB, LC, LD>& lay, double* w, const int* mb,
    const int* mk, const double* __restrict__ D, int64_t nbf, int lane) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  for (int e = lane; e < C::NDG; e += 32)
    w[lay.Dg + e] =
        dg_element<LA, LB, LC, LD>(e, mb[0], mb[1], mk[0], mk[1], D, nbf);
  for (int e = lane; e < C::NOUT; e += 32) w[lay.Acc + e] = 0.0;
}

template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ void digest_tile(
    const Eri4cSmem<LA, LB, LC, LD>& lay, double* w, int ab0, int at,
    int cd0, int ct, int lane) {
  for (int e = lane; e < Eri4cClass<LA, LB, LC, LD>::NOUT; e += 32)
    w[lay.Acc + e] += jk_partial<LA, LB, LC, LD>(w + lay.I, w + lay.Dg, e,
                                                 ab0, at, cd0, ct);
}

template <int LA, int LB, int LC, int LD>
__device__ void digest_end(const Eri4cSmem<LA, LB, LC, LD>& lay,
                           const double* w, double wt, const int* mb,
                           const int* mk, int64_t nbf, double* JK, int lane) {
  for (int e = lane; e < Eri4cClass<LA, LB, LC, LD>::NOUT; e += 32)
    atomicAdd(jk_target<LA, LB, LC, LD>(e, mb[0], mb[1], mk[0], mk[1], nbf,
                                        JK, JK + nbf * nbf),
              wt * w[lay.Acc + e]);
}

// ------------------------------------------------------------ block route

// One quartet a block of Eri4cBlockClass::kThreads threads (8 warps, or 4
// for the class pairs of the 4-warp masks), both products on the f64
// tensor cores (dmma.cuh, mma.sync m16n8k4).  Per quartet, with K2b,
// K2k its live bra and ket primitive pairs:
//   R_kl          Boys + the Hermite recursion of each live primitive
//                 quartet (k, l), once, kept for every tile;
//   T1 = M Ecd    T1[(k,h)][cd] = sum_{(l,g)} M[(k,h)][(l,g)] Ecd[(l,g)][cd],
//                 M[(k,h)][(l,g)] = (-1)^|g| R_kl[h+g] gathered from R as
//                 the fragments are loaded (never stored), the primitive
//                 pairs stacked on both GEMM dimensions;
//   I = Eab^T T1  I[ab][cd] = sum_{(k,h)} Eab[(k,h)][ab] T1[(k,h)][cd];
// both in tiles of CT ket and AT bra components, and in rounds of at most
// RB live bra and RK live ket primitive pairs (Eri4cBlockSmem), so that
// the shared memory of a block does not grow with the contraction: a
// round's R, E tables and expansions are those of its pairs, and each
// round adds its share of every tile (K4 writes the first round's tiles
// and adds the others', K5 digests each).  Where the bra is one tile its
// expansion is built once a round, else once a (ket tile, bra tile).

constexpr int kEri4cBlockThreads = 32 * JC_ERI4C_BLOCK_WARPS;
constexpr size_t kEri4cBlockCap = JC_ERI4C_BLOCK_CAP;
constexpr size_t kEri4cBlock4Cap = JC_ERI4C_BLOCK4_CAP;
// widest tile of ket or bra components (64, not varied on the card)
constexpr int kEri4cBlockTile = 64;

__host__ __device__ constexpr int pad_to(int x, int m) {
  return (x + m - 1) / m * m;
}

// A warp's unit of each product: one m16 fragment by FN n8 fragments.
// Product 1 takes two, so that each gathered M fragment feeds two DMMAs;
// product 2 one where its n side is a tile of 32 components or fewer, so
// that a 32 x 32 tile still gives each of 8 warps a unit.
template <int LA, int LB, int LC, int LD>
struct Eri4cBlockClass {
  using C = Eri4cClass<LA, LB, LC, LD>;
  // threads a block and its shared-memory cap: 4 warps within
  // kEri4cBlock4Cap (two blocks an SM where the tiles allow) for the
  // class pairs of the 4-warp masks, else kEri4cBlockThreads within
  // kEri4cBlockCap
  static constexpr int kThreads = C::kBlock4 ? 128 : kEri4cBlockThreads;
  static constexpr size_t kCap =
      C::kBlock4 ? kEri4cBlock4Cap : kEri4cBlockCap;
  // product 1: the bra Hermite rows (k, h) on the fragments' 16-row side
  // where the bra has 16 Hermite indices or more, else the ket components
  static constexpr bool kP1Rows = C::NHB >= 16;
  static constexpr int FN1 = 2;
  // product 2: the wider of ab and cd on the 16-row side
  static constexpr bool kP2AbRows = C::NAB >= C::NCD;
  static constexpr int W2 = kP2AbRows ? C::NCD : C::NAB;
  static constexpr int FN2 = W2 > 32 && kEri4cBlockTile > 32 ? 2 : 1;
};

// Shared memory of one block-route block, in doubles, for rounds of RB
// bra and RK ket primitive pairs, tiles of CT ket and AT bra components,
// and (jk) K5's D blocks and output sums.  The operands are k-major with row
// strides of (a multiple of 16) + 4 doubles (dmma.cuh: no bank
// conflicts); a fragment unit may read up to 28 doubles past a row's
// columns (its results there are dropped), so 32 doubles close the
// layout.  The Boys values and the R recursion's odd levels lie at first
// where the tiles go.
template <int LA, int LB, int LC, int LD>
struct Eri4cBlockSmem {
  using C = Eri4cClass<LA, LB, LC, LD>;
  int CT, AT, RB, RK, ldE, ldA, ldT, Pb, Pk, Cb, Ck, Eb, Ek, R, X1, X2, T1,
      Dg, Acc, Ax, Tab, total;
  __host__ __device__ Eri4cBlockSmem(int RB_, int RK_, int CT_, int AT_,
                                     bool jk)
      : CT(CT_), AT(AT_), RB(RB_), RK(RK_) {
    const int Kab = RB, Kcd = RK, nprim = Kab * Kcd;
    const int K4b = pad_to(Kab * C::NHB, 4), K4k = pad_to(Kcd * C::NHK, 4);
    ldE = pad_to(CT, 16) + 4;
    ldA = pad_to(AT, 16) + 4;
    ldT = ldE;
    Pb = 4;                            // [0, 4): the quartet (r, c, weight)
    Pk = Pb + 4 * Kab;                 // [Kab][4], [Kcd][4]: p, Px, Py, Pz
    Cb = Pk + 4 * Kcd;                 // [Kab], [Kcd]: contraction products
    Ck = Cb + Kab;
    Eb = Ck + Kcd;                     // [Kab][3][NEB] per-dimension E
    Ek = Eb + 3 * Kab * C::NEB;        // [Kcd][3][NEK]
    R = Ek + 3 * Kcd * C::NEK;         // [Kab Kcd][NH]
    X1 = R + nprim * C::NH;            // Ecd tile [K4k][ldE]; I tile [AT][CT]
    const int x1 = K4k * ldE > AT * CT ? K4k * ldE : AT * CT;
    X2 = X1 + x1;                      // Eab tile [K4b][ldA]
    T1 = X2 + K4b * ldA;               // T1 tile [K4b][ldT]
    int end = T1 + K4b * ldT;
    // from X1 before the first tile: R's odd levels [nprim][nherm(L-1)],
    // the Boys values [nprim][L+1] and X, Y, Z [nprim][4]
    const int scratch = nprim * (nherm(C::L - 1) + C::L + 5);
    if (X1 + scratch > end) end = X1 + scratch;
    Dg = end;                          // [NDG] K5's D blocks
    Acc = Dg + (jk ? C::NDG : 0);      // [NOUT] K5's output sums
    Ax = Acc + (jk ? C::NOUT : 0);     // [NAB + NCD] axial factors
    Tab = Ax + C::NAB + C::NCD;        // ints: Hermite triples [NH], the ab
                                       // and cd E offsets [NAB + NCD],
                                       // product 1's k index [2 K4k]
    total = Tab + (C::NH + C::NAB + C::NCD + 2 * K4k + 1) / 2 + 32;
  }
};

struct Eri4cBlockGeometry {
  int CT, AT, RB, RK;
  size_t bytes;
};

// Tiles and rounds of the block route: every primitive pair of the class
// (Ka Kb, Kc Kd) in one round, CT = NCD and AT = NAB up to
// kEri4cBlockTile, the wider tile shrunk by 16 (not below 8) while the
// block would pass its cap (Eri4cBlockClass::kCap); where tiles of 8 still
// pass it, the larger round halves and the tiles start again from their
// widest.  One pair a round and tiles of 8 take at most 129 KiB (K5 at
// (gg|gg)), so a class of any contraction fits the card's 227 KB.
template <int LA, int LB, int LC, int LD>
__host__ __device__ Eri4cBlockGeometry eri4c_block_geometry(int Ka, int Kb,
                                                            int Kc, int Kd,
                                                            bool jk) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr size_t cap = Eri4cBlockClass<LA, LB, LC, LD>::kCap;
  Eri4cBlockGeometry g;
  g.RB = Ka * Kb;
  g.RK = Kc * Kd;
  auto bytes = [&] {
    return sizeof(double) *
           (size_t)Eri4cBlockSmem<LA, LB, LC, LD>(g.RB, g.RK, g.CT, g.AT,
                                                  jk).total;
  };
  for (;;) {
    g.CT = C::NCD < kEri4cBlockTile ? C::NCD : kEri4cBlockTile;
    g.AT = C::NAB < kEri4cBlockTile ? C::NAB : kEri4cBlockTile;
    while (bytes() > cap && (g.CT > 8 || g.AT > 8)) {
      int& t = g.CT >= g.AT ? g.CT : g.AT;
      t = t - 16 >= 8 ? t - 16 : 8;
    }
    if (bytes() <= cap || (g.RB == 1 && g.RK == 1)) break;
    int& r = g.RB >= g.RK ? g.RB : g.RK;
    r = (r + 1) / 2;
  }
  g.bytes = bytes();
  return g;
}

// Boys of one primitive product (exponents p, q, centres P - Q = (X, Y,
// Z)), for the block routes of K4/K5 and K1, a thread each: G[n] =
// (-2 alpha)^n F_n(T) pref (n = 0..L), the one entry of level n of the R
// recursion that it does not derive, and X, Y, Z into Q[1..3].
template <int L>
__device__ __forceinline__ void block_boys(double p, double q, double X,
                                           double Y, double Z, double* G,
                                           double* Q) {
  const double psum = p + q, alpha = p * q / psum;
  const double T = alpha * (X * X + Y * Y + Z * Z);
  const double pref = kTwoPiPow2_5 / (p * q * sqrt(psum));
  double F[L + 1];
  boys<L, true>(T, F);
  double pw = 1.0;
  for (int m = 0; m <= L; ++m) {
    G[m] = pw * (F[m] * pref);
    pw = pw * (-2.0 * alpha);
  }
  Q[1] = X;
  Q[2] = Y;
  Q[3] = Z;
}

// R of nprim primitive products by hermite_R's downward recursion, by the
// NT threads of a block, one level n = L .. 0 at a time and one barrier a
// level: the nherm(L - n) entries of level n from level n + 1, the even
// levels in sR ([nprim][nherm(L)]), the odd ones in sRs ([nprim][nherm(L -
// 1)]), so that level 0 lands in sR.  sG [nprim][L + 1] and sQ [nprim][4]
// from block_boys, htab the Hermite triples (t | u << 8 | v << 16).
template <int L, int NT>
__device__ __forceinline__ void block_r_levels(double* sR, double* sRs,
                                               const double* sG,
                                               const double* sQ,
                                               const int* htab, int nprim,
                                               int tid) {
  constexpr int NH = nherm(L), NHS = nherm(L - 1);
  for (int n = L; n >= 0; --n) {
    const bool even = (n & 1) == 0;
    double* dst = even ? sR : sRs;
    const double* src = even ? sRs : sR;
    const int sd = even ? NH : NHS, ss = even ? NHS : NH;
    const int nl = nherm(L - n);
    for (int it = tid; it < nprim * nl; it += NT) {
      const int f = it / nl, h = it - f * nl;
      double val;
      if (h == 0) {
        val = sG[f * (L + 1) + n];
      } else {
        const int p = htab[h];
        const int t = p & 255, u = (p >> 8) & 255, v = p >> 16;
        const double* Rs = src + f * ss;
        if (t > 0) {
          const double hi = Rs[herm_index(t - 1, u, v)];
          val = t >= 2 ? (t - 1) * Rs[herm_index(t - 2, u, v)] +
                             sQ[4 * f + 1] * hi
                       : sQ[4 * f + 1] * hi;
        } else if (u > 0) {
          const double hi = Rs[herm_index(t, u - 1, v)];
          val = u >= 2 ? (u - 1) * Rs[herm_index(t, u - 2, v)] +
                             sQ[4 * f + 2] * hi
                       : sQ[4 * f + 2] * hi;
        } else {
          const double hi = Rs[herm_index(t, u, v - 1)];
          val = v >= 2 ? (v - 1) * Rs[herm_index(t, u, v - 2)] +
                             sQ[4 * f + 3] * hi
                       : sQ[4 * f + 3] * hi;
        }
      }
      dst[f * sd + h] = val;
    }
    __syncthreads();
  }
}

// An operand in shared memory, k-major: X[k][i] at s[k * ld + i].
struct SmemOperand {
  const double* s;
  int ld;
  struct Idx {
    int i;
  };
  __device__ __forceinline__ Idx at(int i) const { return {i}; }
  __device__ __forceinline__ double get(const Idx& x, int k) const {
    return s[k * ld + x.i];
  }
};

// Product 1's M, gathered from R: index i = (k, h) (k = i / NHB, h = i %
// NHB), k-index kk = (l, g): (-1)^|g| R_kl[h + g], R_kl at R + (k K2k +
// l) NH.  tab[2 kk] = l NH; tab[2 kk + 1]: g's order s, u + v and v (bits
// 0-7, 8-15, 16-23), its sign (bit 24), and whether kk is past the live
// (l, g) (bit 25: zero).  Rows i past the live ones are zero.
template <int NHB, int NH>
struct MGather {
  const double* R;
  const int* htab;
  const int* tab;
  int K2k, rows;
  struct Idx {
    int base, s, d, v;
    double scale;
  };
  __device__ __forceinline__ Idx at(int i) const {
    const int k = i / NHB, p = htab[i - k * NHB];
    const int t = p & 255, u = (p >> 8) & 255, v = p >> 16;
    const bool ok = i < rows;
    return {ok ? k * K2k * NH : 0, t + u + v, u + v, v, ok ? 1.0 : 0.0};
  }
  __device__ __forceinline__ double get(const Idx& x, int kk) const {
    const int off = tab[2 * kk], p = tab[2 * kk + 1];
    const int s = x.s + (p & 255), d = x.d + ((p >> 8) & 255);
    const int v = x.v + ((p >> 16) & 255);
    double m =
        R[x.base + off + s * (s + 1) * (s + 2) / 6 + d * (d + 1) / 2 + v];
    if (p >> 25) m = 0.0;
    else if ((p >> 24) & 1) m = -m;
    return m * x.scale;
  }
};

// One warp's unit of C[m][n] = sum_k A(k, m) B(k, n): the FM x FN
// fragments (16 FM rows, 8 FN columns) from (m0, n0), over k < K4 (a
// multiple of 4, both operands zero past the live k); store(m, n, value)
// for every element of the unit (past the caller's M and N too: store
// drops those).
template <int FM, int FN, class OA, class OB, class Store>
__device__ __forceinline__ void mma_unit(const OA& A, const OB& B, int m0,
                                         int n0, int K4, int lane,
                                         Store&& store) {
  const int g = lane >> 2, t = lane & 3;
  typename OA::Idx ia[FM][2];
  typename OB::Idx ib[FN];
#pragma unroll
  for (int u = 0; u < FM; ++u) {
    ia[u][0] = A.at(m0 + 16 * u + g);
    ia[u][1] = A.at(m0 + 16 * u + 8 + g);
  }
#pragma unroll
  for (int v = 0; v < FN; ++v) ib[v] = B.at(n0 + 8 * v + g);
  DmmaTile<FM, FN> acc;
  acc.zero();
  // unrolled so that the loads (and M's gathers) of the next k-steps
  // are in flight while a step's DMMAs wait on the accumulators
#pragma unroll 4
  for (int k0 = 0; k0 < K4; k0 += 4) {
    typename DmmaTile<FM, FN>::AFrag a;
    double b[FN];
#pragma unroll
    for (int u = 0; u < FM; ++u) {
      a.v[u][0] = A.get(ia[u][0], k0 + t);
      a.v[u][1] = A.get(ia[u][1], k0 + t);
    }
#pragma unroll
    for (int v = 0; v < FN; ++v) b[v] = B.get(ib[v], k0 + t);
    acc.step_ab(a, b);
  }
#pragma unroll
  for (int u = 0; u < FM; ++u)
#pragma unroll
    for (int v = 0; v < FN; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(m0 + DmmaTile<FM, FN>::row(u, e, lane),
              n0 + DmmaTile<FM, FN>::col(v, e, lane), acc.c[u][v][e]);
}

// C[m][n] = sum_k A(k, m) B(k, n) for m < M, n < N, k < K4 on the NT / 32
// warps of a block: a warp's unit is FM x FN fragments (mma_unit), warp w
// takes the units w, w + NW, ...
template <int NT, int FM, int FN, class OA, class OB, class Store>
__device__ __forceinline__ void block_mma(const OA& A, const OB& B, int M,
                                          int N, int K4, int warp, int lane,
                                          Store&& store) {
  constexpr int NW = NT / 32;
  const int um = (M + 16 * FM - 1) / (16 * FM);
  const int un = (N + 8 * FN - 1) / (8 * FN);
  for (int unit = warp; unit < um * un; unit += NW)
    mma_unit<FM, FN>(A, B, (unit / un) * 16 * FM, (unit % un) * 8 * FN, K4,
                     lane, store);
}

// The (ab|cd) block of one quartet by the threads of one block, round by
// round and tile by tile: rb, rk its pair rows, mb, mk their meta rows, sm
// the block's shared memory (lay).  For each round of live primitive
// pairs (bra pairs b0 .. b0 + nb - 1, ket pairs k0 .. k0 + nk - 1), each
// ket tile of components cd0 .. cd0 + ct - 1 and, inside it, each bra tile
// of components ab0 .. ab0 + at - 1, the round's share of the tile's block
// lies in sm[lay.X1] ([at][ct], row-major) when emit(ab0, at, cd0, ct,
// first) is called, which reads it (every thread calls it); first: the
// first round.
template <int LA, int LB, int LC, int LD, class Emit>
__device__ void eri4c_block(const double* rb, int Ka, int Kb, const int* mb,
                            const double* rk, int Kc, int Kd, const int* mk,
                            double* sm,
                            const Eri4cBlockSmem<LA, LB, LC, LD>& lay,
                            Emit&& emit) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  using BC = Eri4cBlockClass<LA, LB, LC, LD>;
  constexpr int NB = C::NB, ND = C::ND, NAB = C::NAB, NCD = C::NCD;
  constexpr int NHB = C::NHB, NHK = C::NHK, NH = C::NH, L = C::L;
  constexpr int NEB = C::NEB, NEK = C::NEK, NHS = nherm(L - 1);
  constexpr int NT = BC::kThreads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kb = mb[3], kd = mk[3];
  const int K2b = mb[2] * kb, K2k = mk[2] * kd;
  const int CT = lay.CT, AT = lay.AT;
  double* sPb = sm + lay.Pb;
  double* sPk = sm + lay.Pk;
  double* sCb = sm + lay.Cb;
  double* sCk = sm + lay.Ck;
  double* sEb = sm + lay.Eb;
  double* sEk = sm + lay.Ek;
  double* sR = sm + lay.R;
  double* sEcd = sm + lay.X1;
  double* sI = sm + lay.X1;
  double* sEab = sm + lay.X2;
  double* sT1 = sm + lay.T1;
  double* sAx = sm + lay.Ax;
  int* htab = reinterpret_cast<int*>(sm + lay.Tab);
  int* eoff = htab + NH;  // [NAB] then [NCD]
  int* gtab = eoff + NAB + NCD;

  // 0. tables of every round: Hermite triples, and each component's
  //    offsets into the per-dimension E tables and its axial norms
  for (int e = tid; e < NH; e += NT) {
    int t, u, v;
    herm_triple(e, t, u, v);
    htab[e] = t | (u << 8) | (v << 16);
  }
  for (int e = tid; e < NAB + NCD; e += NT) {
    const bool bra = e < NAB;
    const int l1 = bra ? LA : LC, l2 = bra ? LB : LD, n2 = bra ? NB : ND;
    const int x = bra ? e : e - NAB, nt = l1 + l2 + 1;
    int ax, ay, az, bx, by, bz;
    cart_comp(l1, x / n2, ax, ay, az);
    cart_comp(l2, x % n2, bx, by, bz);
    eoff[e] = ((ax * (l2 + 1) + bx) * nt) |
              (((ay * (l2 + 1) + by) * nt) << 8) |
              (((az * (l2 + 1) + bz) * nt) << 16);
    sAx[e] = axial(l1, ax, ay, az) * axial(l2, bx, by, bz);
  }
  // the rounds stay a loop (one iteration for a contraction that fits)
#pragma unroll 1
  for (int b0 = 0; b0 < K2b; b0 += lay.RB)
#pragma unroll 1
    for (int k0 = 0; k0 < K2k; k0 += lay.RK) {
      const int nb = K2b - b0 < lay.RB ? K2b - b0 : lay.RB;
      const int nk = K2k - k0 < lay.RK ? K2k - k0 : lay.RK;
      const int nprim = nb * nk;
      const int Mb = nb * NHB, Mk = nk * NHK;  // live Hermite rows
      const int K4b = pad_to(Mb, 4), K4k = pad_to(Mk, 4);
      const bool first = b0 == 0 && k0 == 0;
      // 1. the round's pairs (local k = b - b0, l = c - k0): product 1's k
      //    index, product centres, per-dimension E tables and contraction
      //    products
      for (int e = tid; e < K4k; e += NT) {
        if (e < Mk) {
          const int l = e / NHK;
          int t, u, v;
          herm_triple(e - l * NHK, t, u, v);
          const int s = t + u + v;
          gtab[2 * e] = l * NH;
          gtab[2 * e + 1] = s | ((u + v) << 8) | (v << 16) | ((s & 1) << 24);
        } else {
          gtab[2 * e] = 0;
          gtab[2 * e + 1] = 1 << 25;
        }
      }
      for (int e = tid; e < 3 * (nb + nk); e += NT) {
        if (e < 3 * nb) {
          pair_prim<LA, LB>(rb, Ka, Kb, kb, b0 + e / 3, e % 3, sEb, sPb,
                            e / 3);
        } else {
          const int l = (e - 3 * nb) / 3;
          pair_prim<LC, LD>(rk, Kc, Kd, kd, k0 + l, (e - 3 * nb) % 3, sEk,
                            sPk, l);
        }
      }
      for (int e = tid; e < nb + nk; e += NT) {
        if (e < nb) {
          const int b = b0 + e;
          sCb[e] = rb[Ka + b / kb] * rb[2 * Ka + Kb + b % kb];
        } else {
          const int c = k0 + e - nb;
          sCk[e - nb] = rk[Kc + c / kd] * rk[2 * Kc + Kd + c % kd];
        }
      }
      __syncthreads();
      // 2. Boys per primitive quartet f = k nk + l of the round, a thread
      //    each: G[n] = (-2 alpha)^n F_n(T) pref, the one entry of level n
      //    of the recursion that it does not derive, and X, Y, Z
      double* sRs = sm + lay.X1;           // R's odd levels [nprim][NHS]
      double* sG = sRs + nprim * NHS;      // [nprim][L + 1]
      double* sQ = sG + nprim * (L + 1);   // [nprim][4]
      for (int f = tid; f < nprim; f += NT) {
        const int k = f / nk, l = f - k * nk;
        block_boys<L>(sPb[4 * k], sPk[4 * l], sPb[4 * k + 1] - sPk[4 * l + 1],
                      sPb[4 * k + 2] - sPk[4 * l + 2],
                      sPb[4 * k + 3] - sPk[4 * l + 3], sG + f * (L + 1),
                      sQ + 4 * f);
      }
      __syncthreads();
      // 3. R level by level over the round's primitive quartets
      block_r_levels<L, NT>(sR, sRs, sG, sQ, htab, nprim, tid);
      // 4. the tiles.  A tile's expansion Eab[(k,h)][j] (Ecd[(l,g)][j]): the
      //    three per-dimension E factors, the axial norms and the
      //    contraction product of component j, zero past the live rows
      auto build_eab = [&](int ab0, int at) {
        for (int e = tid; e < K4b * at; e += NT) {
          const int kk = e / at, j = e - kk * at;
          double val = 0.0;
          if (kk < Mb) {
            const int k = kk / NHB, p = htab[kk - k * NHB], o = eoff[ab0 + j];
            const double* E = sEb + k * 3 * NEB;
            val = E[(o & 255) + (p & 255)] *
                  E[NEB + ((o >> 8) & 255) + ((p >> 8) & 255)] *
                  E[2 * NEB + (o >> 16) + (p >> 16)] * sAx[ab0 + j] * sCb[k];
          }
          sEab[kk * lay.ldA + j] = val;
        }
      };
      auto build_ecd = [&](int cd0, int ct) {
        for (int e = tid; e < K4k * ct; e += NT) {
          const int kk = e / ct, j = e - kk * ct;
          double val = 0.0;
          if (kk < Mk) {
            const int l = kk / NHK, p = htab[kk - l * NHK];
            const int o = eoff[NAB + cd0 + j];
            const double* E = sEk + l * 3 * NEK;
            val = E[(o & 255) + (p & 255)] *
                  E[NEK + ((o >> 8) & 255) + ((p >> 8) & 255)] *
                  E[2 * NEK + (o >> 16) + (p >> 16)] * sAx[NAB + cd0 + j] *
                  sCk[l];
          }
          sEcd[kk * lay.ldE + j] = val;
        }
      };
      const bool bra_tiles = AT < NAB;
      if (!bra_tiles) build_eab(0, NAB);
      const MGather<NHB, NH> Mg{sR, htab, gtab, nk, Mb};
      for (int cd0 = 0; cd0 < NCD; cd0 += CT) {
        const int ct = NCD - cd0 < CT ? NCD - cd0 : CT;
        build_ecd(cd0, ct);
        __syncthreads();
        // T1[(k,h)][cdt] = sum_{(l,g)} M[(k,h)][(l,g)] Ecd[(l,g)][cdt]
        const SmemOperand Ecd{sEcd, lay.ldE};
        if constexpr (BC::kP1Rows)
          block_mma<NT, 1, BC::FN1>(
              Mg, Ecd, Mb, ct, K4k, warp, lane, [&](int m, int n, double x) {
                if (m < K4b && n < ct) sT1[m * lay.ldT + n] = x;
              });
        else
          block_mma<NT, 1, BC::FN1>(
              Ecd, Mg, ct, Mb, K4k, warp, lane, [&](int m, int n, double x) {
                if (m < ct && n < K4b) sT1[n * lay.ldT + m] = x;
              });
        __syncthreads();
        for (int ab0 = 0; ab0 < NAB; ab0 += AT) {
          const int at = NAB - ab0 < AT ? NAB - ab0 : AT;
          if (bra_tiles) {
            build_eab(ab0, at);
            __syncthreads();
          }
          // I[abt][cdt] = sum_{(k,h)} Eab[(k,h)][abt] T1[(k,h)][cdt] into
          // sI, over the ket tile's Ecd (read by product 1 before the
          // barrier)
          const SmemOperand Eab{sEab, lay.ldA}, T1{sT1, lay.ldT};
          if constexpr (BC::kP2AbRows)
            block_mma<NT, 1, BC::FN2>(
                Eab, T1, at, ct, K4b, warp, lane,
                [&](int m, int n, double x) {
                  if (m < at && n < ct) sI[m * ct + n] = x;
                });
          else
            block_mma<NT, 1, BC::FN2>(
                T1, Eab, ct, at, K4b, warp, lane,
                [&](int m, int n, double x) {
                  if (m < ct && n < at) sI[n * ct + m] = x;
                });
          __syncthreads();
          emit(ab0, at, cd0, ct, first);
          __syncthreads();
        }
      }
    }
}

// ---------------------------------------------------------------- kernels

// K4, lane route: out[q][ab*NCD + cd] = (ab|cd) of quartet (sel_bra[q],
// sel_ket[q]), one quartet per thread.
template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(kEri4cLaneBlock)
eri4c_lane_kernel(const double* __restrict__ pb, int Ka, int Kb,
                  const int* __restrict__ mb, const double* __restrict__ pk,
                  int Kc, int Kd, const int* __restrict__ mk,
                  const int64_t* __restrict__ sel_bra,
                  const int64_t* __restrict__ sel_ket, int64_t n,
                  double* __restrict__ out) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int64_t r = sel_bra[q], c = sel_ket[q];
  double I[C::NAB * C::NCD];
  lane_block<LA, LB, LC, LD>(pb + r * (2 * Ka + 2 * Kb + 6), Ka, Kb,
                             mb + r * kMeta, pk + c * (2 * Kc + 2 * Kd + 6),
                             Kc, Kd, mk + c * kMeta, I);
  double* o = out + q * (C::NAB * C::NCD);
  static_for<C::NAB * C::NCD>([&](auto e) {
    o[decltype(e)::value] = I[decltype(e)::value];
  });
}

// K5, lane route: quartet t0 + t of thread t, digested into JK at once (list
// or staircase mode); a launch covers the n quartets t0 .. t0 + n - 1, so a
// split of one class pair's quartets over ranks is a set of launches with
// disjoint ranges.
template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(kEri4cLaneBlock)
eri4c_jk_lane_kernel(const double* __restrict__ pb, int Ka, int Kb,
                     const int* __restrict__ mb,
                     const double* __restrict__ pk, int Kc, int Kd,
                     const int* __restrict__ mk,
                     const int64_t* __restrict__ sel_bra,
                     const int64_t* __restrict__ sel_ket,
                     const double* __restrict__ weight,
                     const int64_t* __restrict__ cum, int64_t n_bra,
                     int same_block, int64_t n, int64_t t0,
                     const double* __restrict__ D, int64_t nbf, double* JK) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NAB = C::NAB;
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  double jab[NAB];
  int64_t r = -1 - lane;  // a key of its own past the last quartet
  if (t < n) {
    int64_t c;
    double wt;
    decode_quartet(t0 + t, sel_bra, sel_ket, weight, cum, n_bra, same_block,
                   mb, mk, r, c, wt);
    double I[C::NAB * C::NCD];
    lane_block<LA, LB, LC, LD>(pb + r * (2 * Ka + 2 * Kb + 6), Ka, Kb,
                               mb + r * kMeta, pk + c * (2 * Kc + 2 * Kd + 6),
                               Kc, Kd, mk + c * kMeta, I);
    lane_digest<LA, LB, LC, LD>(I, wt, mb + r * kMeta, mk + c * kMeta, D, nbf,
                                JK, JK + nbf * nbf, jab);
  } else {
    static_for<NAB>([&](auto e) { jab[decltype(e)::value] = 0.0; });
  }
  // j_ab: one sum per run of lanes with one bra row, one atomic an element
  if (run_sums<NAB>(jab, r, lane) && t < n) {
    const int64_t oa = mb[r * kMeta], ob = mb[r * kMeta + 1];
    static_for<NAB>([&](auto e) {
      constexpr int ab = decltype(e)::value;
      atomicAdd(JK + (oa + ab / C::NB) * nbf + ob + ab % C::NB, jab[ab]);
    });
  }
}

// K4, warp route: the block of quartet q of a warp, written out tile by
// tile.
template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(32 * kEri4cMaxWarps, 4)
eri4c_kernel(const double* __restrict__ pb, int Ka, int Kb,
             const int* __restrict__ mb, const double* __restrict__ pk,
             int Kc, int Kd, const int* __restrict__ mk,
             const int64_t* __restrict__ sel_bra,
             const int64_t* __restrict__ sel_ket, int64_t n, int CT, int RS,
             double* __restrict__ out) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NAB = C::NAB, NCD = C::NCD;
  extern __shared__ double sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= n) return;  // the whole warp
  const Eri4cSmem<LA, LB, LC, LD> lay(Ka * Kb, Kc * Kd, RS, CT);
  double* w = sm + (int64_t)warp * lay.total;
  const int64_t r = sel_bra[q], c = sel_ket[q];
  auto emit = [&](int ab0, int at, int cd0, int ct) {
    for (int e = lane; e < at * ct; e += 32)
      out[q * (NAB * NCD) + (ab0 + e / ct) * NCD + cd0 + e % ct] =
          w[lay.I + e];
  };
  const double* rb = pb + r * (2 * Ka + 2 * Kb + 6);
  const double* rk = pk + c * (2 * Kc + 2 * Kd + 6);
  if (CT < NCD)
    eri4c_warp<LA, LB, LC, LD, true>(rb, Ka, Kb, mb + r * kMeta, rk, Kc, Kd,
                                     mk + c * kMeta, RS, w, lay, lane, emit);
  else
    eri4c_warp<LA, LB, LC, LD, false>(rb, Ka, Kb, mb + r * kMeta, rk, Kc, Kd,
                                      mk + c * kMeta, RS, w, lay, lane, emit);
}

// K5, warp route: quartet t0 + q of warp q, digested into JK.
template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(32 * kEri4cMaxWarps, 4)
eri4c_jk_kernel(const double* __restrict__ pb, int Ka, int Kb,
                const int* __restrict__ mb, const double* __restrict__ pk,
                int Kc, int Kd, const int* __restrict__ mk,
                const int64_t* __restrict__ sel_bra,
                const int64_t* __restrict__ sel_ket,
                const double* __restrict__ weight,
                const int64_t* __restrict__ cum, int64_t n_bra,
                int same_block, int64_t n, int64_t t0, int CT, int RS,
                const double* __restrict__ D, int64_t nbf, double* JK) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  extern __shared__ double sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= n) return;  // the whole warp: nothing to add
  const Eri4cSmem<LA, LB, LC, LD> lay(Ka * Kb, Kc * Kd, RS, CT);
  double* w = sm + (int64_t)warp * lay.total;
  int64_t r, c;
  double wt;
  decode_quartet(t0 + q, sel_bra, sel_ket, weight, cum, n_bra, same_block,
                 mb, mk, r, c, wt);
  const int* mr = mb + r * kMeta;
  const int* mc = mk + c * kMeta;
  auto emit = [&](int ab0, int at, int cd0, int ct) {
    if (ab0 == 0 && cd0 == 0) {
      digest_begin(lay, w, mr, mc, D, nbf, lane);
      __syncwarp();
    }
    digest_tile(lay, w, ab0, at, cd0, ct, lane);
  };
  const double* rb = pb + r * (2 * Ka + 2 * Kb + 6);
  const double* rk = pk + c * (2 * Kc + 2 * Kd + 6);
  if (CT < C::NCD)
    eri4c_warp<LA, LB, LC, LD, true>(rb, Ka, Kb, mr, rk, Kc, Kd, mc, RS, w,
                                     lay, lane, emit);
  else
    eri4c_warp<LA, LB, LC, LD, false>(rb, Ka, Kb, mr, rk, Kc, Kd, mc, RS, w,
                                      lay, lane, emit);
  digest_end(lay, w, wt, mr, mc, nbf, JK, lane);
}

// K5's share of one block-route tile [ab0, ab0 + at) x [cd0, cd0 + ct) of
// the block sI, into the output sums sAcc (the order of jk_partial), by the
// block's threads: only the outputs that the tile reaches, each once (j_ab
// of its ab, j_cd of its cd; k_ac, k_ad, k_bc, k_bd of the a and b its ab
// hold and the c and d its cd hold), so that a (gg|gg) tile of 32 x 32
// visits ~390 of the 1350 outputs.
template <int LA, int LB, int LC, int LD>
__device__ __forceinline__ void block_digest_tile(const double* sI,
                                                  const double* sDg,
                                                  double* sAcc, int ab0,
                                                  int at, int cd0, int ct) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NA = C::NA, NB = C::NB, NC = C::NC, ND = C::ND;
  constexpr int NAB = C::NAB, NCD = C::NCD;
  const int a0 = ab0 / NB, a1 = (ab0 + at - 1) / NB;
  const int c0 = cd0 / ND, c1 = (cd0 + ct - 1) / ND;
  // b (d) over a whole row where the tile spans two rows a (c)
  const int b0 = a1 > a0 ? 0 : ab0 % NB;
  const int b1 = a1 > a0 ? NB - 1 : (ab0 + at - 1) % NB;
  const int d0 = c1 > c0 ? 0 : cd0 % ND;
  const int d1 = c1 > c0 ? ND - 1 : (cd0 + ct - 1) % ND;
  const int na = a1 - a0 + 1, nb = b1 - b0 + 1, nc = c1 - c0 + 1;
  const int nd = d1 - d0 + 1;
  const int n0 = at, n1 = n0 + ct, n2 = n1 + na * nc, n3 = n2 + na * nd;
  const int n4 = n3 + nb * nc, n5 = n4 + nb * nd;
  for (int e = threadIdx.x; e < n5;
       e += Eri4cBlockClass<LA, LB, LC, LD>::kThreads) {
    int x;
    if (e < n0) {
      x = ab0 + e;
    } else if (e < n1) {
      x = NAB + cd0 + e - n0;
    } else if (e < n2) {
      const int i = e - n1, a = a0 + i / nc, c = c0 + i % nc;
      x = NAB + NCD + a * NC + c;
    } else if (e < n3) {
      const int i = e - n2, a = a0 + i / nd, d = d0 + i % nd;
      x = NAB + NCD + NA * NC + a * ND + d;
    } else if (e < n4) {
      const int i = e - n3, b = b0 + i / nc, c = c0 + i % nc;
      x = NAB + NCD + NA * NC + NA * ND + b * NC + c;
    } else {
      const int i = e - n4, b = b0 + i / nd, d = d0 + i % nd;
      x = NAB + NCD + NA * NC + NA * ND + NB * NC + b * ND + d;
    }
    sAcc[x] += jk_partial<LA, LB, LC, LD>(sI, sDg, x, ab0, at, cd0, ct);
  }
}

// K4, block route: the block of quartet q of a block, written out tile by
// tile (each tile's rows of cd contiguous), the first round's tiles
// written and the others' added.
template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(Eri4cBlockClass<LA, LB, LC, LD>::kThreads,
                                  1)
eri4c_block_kernel(const double* __restrict__ pb, int Ka, int Kb,
                   const int* __restrict__ mb, const double* __restrict__ pk,
                   int Kc, int Kd, const int* __restrict__ mk,
                   const int64_t* __restrict__ sel_bra,
                   const int64_t* __restrict__ sel_ket, int CT, int AT,
                   int RB, int RK, double* __restrict__ out) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NAB = C::NAB, NCD = C::NCD;
  extern __shared__ double sm[];
  const int64_t q = blockIdx.x;
  const Eri4cBlockSmem<LA, LB, LC, LD> lay(RB, RK, CT, AT, false);
  const int64_t r = sel_bra[q], c = sel_ket[q];
  double* o = out + q * (NAB * NCD);
  const double* sI = sm + lay.X1;
  // a thread writes the same elements of a tile in every round
  auto emit = [&](int ab0, int at, int cd0, int ct, bool first) {
    for (int e = threadIdx.x; e < at * ct;
         e += Eri4cBlockClass<LA, LB, LC, LD>::kThreads) {
      double* x = o + (ab0 + e / ct) * NCD + cd0 + e % ct;
      *x = first ? sI[e] : *x + sI[e];
    }
  };
  eri4c_block<LA, LB, LC, LD>(pb + r * (2 * Ka + 2 * Kb + 6), Ka, Kb,
                              mb + r * kMeta, pk + c * (2 * Kc + 2 * Kd + 6),
                              Kc, Kd, mk + c * kMeta, sm, lay, emit);
}

// K5, block route: quartet t0 + q of block q (decoded once by thread 0),
// each tile's share of its six J/K outputs, round by round, summed in
// shared memory by the block's threads (block_digest_tile), one f64
// atomic an output at the end.
template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(Eri4cBlockClass<LA, LB, LC, LD>::kThreads,
                                  1)
eri4c_jk_block_kernel(const double* __restrict__ pb, int Ka, int Kb,
                      const int* __restrict__ mb,
                      const double* __restrict__ pk, int Kc, int Kd,
                      const int* __restrict__ mk,
                      const int64_t* __restrict__ sel_bra,
                      const int64_t* __restrict__ sel_ket,
                      const double* __restrict__ weight,
                      const int64_t* __restrict__ cum, int64_t n_bra,
                      int same_block, int64_t t0, int CT, int AT, int RB,
                      int RK, const double* __restrict__ D, int64_t nbf,
                      double* JK) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NT = Eri4cBlockClass<LA, LB, LC, LD>::kThreads;
  extern __shared__ double sm[];
  const int tid = threadIdx.x;
  const Eri4cBlockSmem<LA, LB, LC, LD> lay(RB, RK, CT, AT, true);
  int64_t* sq = reinterpret_cast<int64_t*>(sm);  // r, c, then the weight
  if (tid == 0) {
    int64_t r, c;
    double wt;
    decode_quartet(t0 + blockIdx.x, sel_bra, sel_ket, weight, cum, n_bra,
                   same_block, mb, mk, r, c, wt);
    sq[0] = r;
    sq[1] = c;
    sm[2] = wt;
  }
  __syncthreads();
  const int64_t r = sq[0], c = sq[1];
  const double wt = sm[2];
  const int* mr = mb + r * kMeta;
  const int* mc = mk + c * kMeta;
  double* sDg = sm + lay.Dg;
  double* sAcc = sm + lay.Acc;
  for (int e = tid; e < C::NDG; e += NT)
    sDg[e] = dg_element<LA, LB, LC, LD>(e, mr[0], mr[1], mc[0], mc[1], D,
                                        nbf);
  for (int e = tid; e < C::NOUT; e += NT) sAcc[e] = 0.0;
  const double* sI = sm + lay.X1;
  auto emit = [&](int ab0, int at, int cd0, int ct, bool) {
    block_digest_tile<LA, LB, LC, LD>(sI, sDg, sAcc, ab0, at, cd0, ct);
  };
  eri4c_block<LA, LB, LC, LD>(pb + r * (2 * Ka + 2 * Kb + 6), Ka, Kb, mr,
                              pk + c * (2 * Kc + 2 * Kd + 6), Kc, Kd, mc, sm,
                              lay, emit);
  for (int e = tid; e < C::NOUT; e += NT)
    atomicAdd(jk_target<LA, LB, LC, LD>(e, mr[0], mr[1], mc[0], mc[1], nbf,
                                        JK, JK + nbf * nbf),
              wt * sAcc[e]);
}

// ------------------------------------------------------------------- K6

// Copies cnt doubles from src (8-byte aligned) to dst (16-byte aligned) by
// thread t's share (of NTH threads: a warp's lanes, or a block's threads)
// of 16-byte cp.async copies (one 8-byte copy first when src is not
// 16-byte aligned), and returns where src[0] lands (dst or dst + 1;
// dst holds cnt + 2 doubles): the copies read src in whole sectors.  The
// caller commits and waits.
template <int NTH = 32>
__device__ __forceinline__ const double* stage_doubles(double* dst,
                                                       const double* src,
                                                       int64_t cnt, int t) {
  const int off = (int)((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
  if (off && t == 0 && cnt > 0) cp_async8(dst + 1, src, true);
  const double* s2 = src + off;
  double* d2 = dst + 2 * off;
  const int64_t m = cnt - off;
  for (int64_t p = 2 * t; p < m; p += 2 * NTH)
    cp_async16(d2 + p, s2 + p, p + 1 < m ? 16 : 8);
  return dst + off;
}

// K6's routes, each class pair's fixed at compile time by DigestClass
// (kLane, kBlock; ops/kernels.py's digest_route mirrors it), chosen class
// by class from the card's times at the full in-core size:
// * lane route, for the class pairs of K4/K5's lane route
//   (Eri4cClass::kLane) whose blocks hold at most JC_DIGEST_LANE_MAX_N
//   integrals: one cached block a thread, kDigestLaneBlock threads a block;
//   a warp's 32 blocks, contiguous in I, are staged in its shared memory
//   (16-byte cp.async copies: whole sectors), each lane then reading its
//   own block there.  j_ab is summed over the
//   lanes of one bra row, k_ac, k_bc over those of one bra row and ket
//   shell c (run_sums: a row's kets come sorted by their first shell), and
//   k_ad, k_bd over those of one bra row and ket shell d, wherever they lie
//   (group_sums), before their atomics;
// * block route, for the large g blocks of JC_DIGEST_BLOCK_MASK_B<i>: one
//   cached block a CTA of kDigestBlockThreads threads, streamed through
//   shared memory once in slabs of one a (NB NCD doubles, contiguous in
//   I) by a ring of kDigestBlockStages slabs of 16-byte cp.async copies,
//   each slab digested as it lands (digest_jk_block_kernel).  What bound
//   the warp route there: bytes.  A block past the stage cap (405 KB at
//   (gg|gg)) was read where it lies by one warp, each of its 6 images
//   walking the block at its own stride, five of them one 32-byte sector
//   per 8-byte value (~20x the block's bytes), with one warp a block in
//   flight: (gg|gg) 3.234 ms against 0.132 of bound (NVIDIA H100 80GB
//   HBM3, 700 W; PERF.md §6).  Now each block is read once, in whole
//   sectors, and the digestion (6 FMAs a value, no reuse) runs from
//   shared memory;
// * warp route, for the rest: one block a warp, as many warps as blocks,
//   the block and its D blocks staged in the warp's shared memory and
//   digested at once (its outputs spread over the lanes, so that the
//   atomics of one block's contiguous outputs share sectors), one atomic
//   an output.  Block and D blocks take at most kDigestWarpCap (85 KB at
//   (ff|ff)): a larger block takes the block route.
constexpr int kDigestLaneBlock = 128;
constexpr size_t kDigestWarpCap = 110 * 1024;
// the block route's CTA (8 warps) and the slabs in flight in its ring
constexpr int kDigestBlockThreads = 256;
constexpr int kDigestBlockStages = 2;
#ifndef JC_DIGEST_BLOCK_MASK_B14
#error "build with -DJC_DIGEST_BLOCK_MASK_B0 .. _B14 (ops/kernels.py's table)"
#endif
// K6's block route, in the form of K4/K5's masks: bit j of
// JC_DIGEST_BLOCK_MASK_B<i> is the class pair (bra i | ket j) on it
constexpr unsigned kDigestBlockMasks[15] = {
    JC_DIGEST_BLOCK_MASK_B0, JC_DIGEST_BLOCK_MASK_B1, JC_DIGEST_BLOCK_MASK_B2,
    JC_DIGEST_BLOCK_MASK_B3, JC_DIGEST_BLOCK_MASK_B4, JC_DIGEST_BLOCK_MASK_B5,
    JC_DIGEST_BLOCK_MASK_B6, JC_DIGEST_BLOCK_MASK_B7, JC_DIGEST_BLOCK_MASK_B8,
    JC_DIGEST_BLOCK_MASK_B9, JC_DIGEST_BLOCK_MASK_B10,
    JC_DIGEST_BLOCK_MASK_B11, JC_DIGEST_BLOCK_MASK_B12,
    JC_DIGEST_BLOCK_MASK_B13, JC_DIGEST_BLOCK_MASK_B14};

template <int LA, int LB, int LC, int LD>
struct DigestClass {
  using C = Eri4cClass<LA, LB, LC, LD>;
  static constexpr int N = C::NAB * C::NCD;  // doubles of one block
  // the lane route: K4/K5's lane class pairs whose blocks hold at most
  // JC_DIGEST_LANE_MAX_N integrals
  static constexpr bool kLane = C::kLane && N <= JC_DIGEST_LANE_MAX_N;
  // the block route: the class pairs of the block masks (off the lane
  // route)
  static constexpr bool kBlock =
      !kLane &&
      ((kDigestBlockMasks[pair_class(LA, LB)] >> pair_class(LC, LD)) & 1);
  // lane route: doubles a warp stages (its 32 blocks and one to realign)
  static constexpr int kWarpStage = 32 * N + 2;
  // warp route: a warp's block and D blocks, and whether they fit its
  // stage (the route takes only those that do)
  static constexpr int kWarpDoubles = N + C::NDG;
  static constexpr bool kStage =
      sizeof(double) * (size_t)kWarpDoubles <= kDigestWarpCap;
  // block route: one slab (one a: NB NCD doubles) and its stage in the
  // ring (two more to realign, even: each stage 16-byte aligned); the
  // ring, then the D blocks and the slab's partial sums of k_ac, j_ab
  // ([NB][NC] each) and k_ad ([NB][ND])
  static constexpr int kSlab = C::NB * C::NCD;
  static constexpr int kSlabStage = (kSlab + 3) / 2 * 2;
  static constexpr int kBlockDoubles =
      kDigestBlockStages * kSlabStage + C::NDG + 2 * C::NB * C::NC +
      C::NB * C::ND;
  // bytes of dynamic shared memory a warp takes on the lane and warp
  // routes, a CTA on the block route
  static constexpr size_t warp_bytes() {
    return sizeof(double) *
           (kLane ? kWarpStage : kBlock ? kBlockDoubles : kWarpDoubles);
  }
};

// K6, lane route: cached block q of thread q, weight[q], digested into JK
// (K5's lane_digest); j_ab summed over the runs of one bra row in the
// warp (run_sums) before one lane adds it.
template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(kDigestLaneBlock)
digest_jk_lane_kernel(const int* __restrict__ mb, const int* __restrict__ mk,
                      const int64_t* __restrict__ sel_bra,
                      const int64_t* __restrict__ sel_ket,
                      const double* __restrict__ weight, int64_t n,
                      const double* __restrict__ I,
                      const double* __restrict__ D, int64_t nbf, double* JK) {
  using G = DigestClass<LA, LB, LC, LD>;
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NAB = C::NAB, N = G::N;
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t q0 = q - lane;
  if (q0 >= n) return;  // the whole warp
  extern __shared__ double sm[];
  double* dst = sm + (int64_t)(threadIdx.x >> 5) * G::kWarpStage;
  const int64_t nq = n - q0 < 32 ? n - q0 : 32;
  const double* Iq = stage_doubles(dst, I + q0 * N, nq * N, lane) + lane * N;
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  constexpr int NA = C::NA, NB = C::NB, NC = C::NC, ND = C::ND;
  constexpr int NKC = (NA + NB) * NC, NKD = (NA + NB) * ND;
  double jab[NAB], kc[NKC], kd[NKD];
  // keys of a lane's own past the last block: its bra row, its bra row
  // with its ket's first shell (the AO offset c), and with its second (d)
  int64_t r = -1 - lane, rc = -1 - lane, rd = -1 - lane, c = 0;
  if (q < n) {
    r = sel_bra[q];
    c = sel_ket[q];
    rc = (r << 24) | mk[c * kMeta];
    rd = (r << 24) | mk[c * kMeta + 1];
    lane_digest<LA, LB, LC, LD>(Iq, weight[q], mb + r * kMeta,
                                mk + c * kMeta, D, nbf, JK, JK + nbf * nbf,
                                jab, kc, kd);
  } else {
    static_for<NAB>([&](auto e) { jab[decltype(e)::value] = 0.0; });
    static_for<NKC>([&](auto e) { kc[decltype(e)::value] = 0.0; });
    static_for<NKD>([&](auto e) { kd[decltype(e)::value] = 0.0; });
  }
  // j_ab: one sum per run of lanes with one bra row; k_ac, k_bc: one per
  // run with one bra row and one ket shell c; one atomic an element
  double* K = JK + nbf * nbf;
  if (run_sums<NAB>(jab, r, lane) && q < n) {
    const int64_t oa = mb[r * kMeta], ob = mb[r * kMeta + 1];
    static_for<NAB>([&](auto e) {
      constexpr int ab = decltype(e)::value;
      atomicAdd(JK + (oa + ab / NB) * nbf + ob + ab % NB, jab[ab]);
    });
  }
  if (run_sums<NKC>(kc, rc, lane) && q < n) {
    const int64_t oa = mb[r * kMeta], ob = mb[r * kMeta + 1];
    const int64_t oc = mk[c * kMeta];
    static_for<NKC>([&](auto e) {
      constexpr int x = decltype(e)::value;
      constexpr int p = x / NC, cc = x % NC;   // p < NA: a, else b = p - NA
      atomicAdd(K + (p < NA ? oa + p : ob + p - NA) * nbf + oc + cc, kc[x]);
    });
  }
  // k_ad, k_bd: the lanes of one bra row and one ket shell d are not
  // adjacent (a row's kets come sorted by their first shell), so they are
  // summed by key into the group's first lane, one atomic an element
  if (group_sums<NKD>(kd, rd, lane) && q < n) {
    const int64_t oa = mb[r * kMeta], ob = mb[r * kMeta + 1];
    const int64_t od = mk[c * kMeta + 1];
    static_for<NKD>([&](auto e) {
      constexpr int x = decltype(e)::value;
      constexpr int p = x / ND, dd = x % ND;   // p < NA: a, else b = p - NA
      atomicAdd(K + (p < NA ? oa + p : ob + p - NA) * nbf + od + dd, kd[x]);
    });
  }
}

// K6, warp route: cached block q of warp q, copied into the warp's shared
// memory with its D blocks and digested at once (jk_element, one f64
// atomic an output).
template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(32 * kEri4cMaxWarps)
digest_jk_warp_kernel(const int* __restrict__ mb, const int* __restrict__ mk,
                      const int64_t* __restrict__ sel_bra,
                      const int64_t* __restrict__ sel_ket,
                      const double* __restrict__ weight, int64_t n,
                      const double* __restrict__ I,
                      const double* __restrict__ D, int64_t nbf, double* JK) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  using G = DigestClass<LA, LB, LC, LD>;
  static_assert(G::kStage, "a block past the warp's stage takes the block "
                           "route (ops/kernels.py DIGEST_BLOCK)");
  constexpr int N = C::NAB * C::NCD;
  extern __shared__ double sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= n) return;
  double* sI = sm + (int64_t)warp * G::kWarpDoubles;
  double* sDg = sI + N;
  const double* Iq = I + q * N;
  const int64_t r = sel_bra[q], c = sel_ket[q];
  const int64_t oa = mb[r * kMeta], ob = mb[r * kMeta + 1];
  const int64_t oc = mk[c * kMeta], od = mk[c * kMeta + 1];
  for (int e = lane; e < N; e += 32) sI[e] = Iq[e];
  for (int e = lane; e < C::NDG; e += 32)
    sDg[e] = dg_element<LA, LB, LC, LD>(e, oa, ob, oc, od, D, nbf);
  __syncwarp();
  const double w = weight[q];
  for (int e = lane; e < C::NOUT; e += 32) {
    double* dst;
    const double s = jk_element<LA, LB, LC, LD>(sI, sDg, e, oa, ob, oc, od,
                                                nbf, JK, JK + nbf * nbf, dst);
    atomicAdd(dst, w * s);
  }
}


// K6, block route: cached block q of CTA q, streamed through shared
// memory in slabs of one a (S[b][c][d] = I[a b][c d]), digested slab by
// slab as the ring brings them (the next slabs' copies in flight).  Per
// slab, every thread's owners (fixed across slabs):
//   (b, c), over d: k_bc[b][c] += S Dad[a][d] (a register sum across
//                   slabs); the slab's k_ac share S Dbd[b][d] and j_ab
//                   share S Dcd[c][d] into Xac[b][c], Xab[b][c];
//   (b, d), over c: k_bd[b][d] += S Dac[a][c] (registers); the slab's k_ad
//                   share S Dbc[b][c] into Xad[b][d];
//   (c d),  over b: j_cd[c d] += S Dab[a][b] (registers);
// then k_ac[a][.], k_ad[a][.] and j_ab[a][.], complete with the slab, are
// summed from X over b (c) and added to J/K; k_bc, k_bd and j_cd at the
// end.  One f64 atomic an output, times the weight (2 w for J), as the
// warp route.  A thread's loads: its own row of the slab (odd NC, ND:
// no bank conflicts) and D values its warp shares.
template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(kDigestBlockThreads)
digest_jk_block_kernel(const int* __restrict__ mb, const int* __restrict__ mk,
                       const int64_t* __restrict__ sel_bra,
                       const int64_t* __restrict__ sel_ket,
                       const double* __restrict__ weight,
                       const double* __restrict__ I,
                       const double* __restrict__ D, int64_t nbf,
                       double* JK) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  using G = DigestClass<LA, LB, LC, LD>;
  constexpr int NA = C::NA, NB = C::NB, NC = C::NC, ND = C::ND;
  constexpr int NCD = C::NCD, N = G::N, S = G::kSlab;
  constexpr int NT = kDigestBlockThreads, ST = kDigestBlockStages;
  constexpr int OBC = (NB * NC + NT - 1) / NT, OBD = (NB * ND + NT - 1) / NT;
  constexpr int OCD = (NCD + NT - 1) / NT;
  extern __shared__ double sm[];
  double* sDg = sm + ST * G::kSlabStage;
  double* sXac = sDg + C::NDG;
  double* sXab = sXac + NB * NC;
  double* sXad = sXab + NB * NC;
  const double* Dcd = sDg;
  const double* Dab = Dcd + NC * ND;
  const double* Dbd = Dab + NA * NB;
  const double* Dbc = Dbd + NB * ND;
  const double* Dad = Dbc + NB * NC;
  const double* Dac = Dad + NA * ND;
  const int tid = threadIdx.x;
  const int64_t q = blockIdx.x;
  const int64_t r = sel_bra[q], c = sel_ket[q];
  const int64_t oa = mb[r * kMeta], ob = mb[r * kMeta + 1];
  const int64_t oc = mk[c * kMeta], od = mk[c * kMeta + 1];
  const double* Iq = I + q * N;
  double* J = JK;
  double* K = JK + nbf * nbf;
  // where slab a lands in its stage
  auto slab = [&](int a) -> const double* {
    const int off = (int)((reinterpret_cast<uintptr_t>(Iq + a * S) >> 3) & 1);
    return sm + (a % ST) * G::kSlabStage + off;
  };
  // the first ST - 1 slabs in flight (one group each, empty past NA)
#pragma unroll
  for (int a = 0; a < ST - 1; ++a) {
    if (a < NA)
      stage_doubles<NT>(sm + a * G::kSlabStage, Iq + a * S, S, tid);
    cp_async_commit();
  }
  for (int e = tid; e < C::NDG; e += NT)
    sDg[e] = dg_element<LA, LB, LC, LD>(e, oa, ob, oc, od, D, nbf);
  double kbc[OBC], kbd[OBD], jcd[OCD];
#pragma unroll
  for (int o = 0; o < OBC; ++o) kbc[o] = 0.0;
#pragma unroll
  for (int o = 0; o < OBD; ++o) kbd[o] = 0.0;
#pragma unroll
  for (int o = 0; o < OCD; ++o) jcd[o] = 0.0;
  const double w = weight[q];
#pragma unroll 1
  for (int a = 0; a < NA; ++a) {
    // slab a + ST - 1 into the stage that slab a - 1 left (read before the
    // barrier that ended its digestion)
    if (a + ST - 1 < NA)
      stage_doubles<NT>(sm + ((a + ST - 1) % ST) * G::kSlabStage,
                        Iq + (a + ST - 1) * S, S, tid);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();
    const double* Sa = slab(a);
#pragma unroll
    for (int o = 0; o < OBC; ++o) {
      const int e = tid + o * NT;
      if (e < NB * NC) {
        const int b = e / NC, cc = e - b * NC;
        const double* row = Sa + e * ND;
        double xbc = 0.0, xac = 0.0, xab = 0.0;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const double v = row[d];
          xbc += v * Dad[a * ND + d];
          xac += v * Dbd[b * ND + d];
          xab += v * Dcd[cc * ND + d];
        }
        kbc[o] += xbc;
        sXac[e] = xac;
        sXab[e] = xab;
      }
    }
#pragma unroll
    for (int o = 0; o < OBD; ++o) {
      const int e = tid + o * NT;
      if (e < NB * ND) {
        const int b = e / ND, d = e - b * ND;
        const double* col = Sa + b * NCD + d;
        double xbd = 0.0, xad = 0.0;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const double v = col[cc * ND];
          xbd += v * Dac[a * NC + cc];
          xad += v * Dbc[b * NC + cc];
        }
        kbd[o] += xbd;
        sXad[e] = xad;
      }
    }
#pragma unroll
    for (int o = 0; o < OCD; ++o) {
      const int e = tid + o * NT;
      if (e < NCD) {
        double x = 0.0;
#pragma unroll
        for (int b = 0; b < NB; ++b) x += Sa[b * NCD + e] * Dab[a * NB + b];
        jcd[o] += x;
      }
    }
    __syncthreads();
    // k_ac[a][c], k_ad[a][d], j_ab[a][b]: complete with this slab
    for (int e = tid; e < NC + ND + NB; e += NT) {
      double s = 0.0;
      double* dst;
      if (e < NC) {
        for (int b = 0; b < NB; ++b) s += sXac[b * NC + e];
        dst = K + (oa + a) * nbf + oc + e;
      } else if (e < NC + ND) {
        const int d = e - NC;
        for (int b = 0; b < NB; ++b) s += sXad[b * ND + d];
        dst = K + (oa + a) * nbf + od + d;
      } else {
        const int b = e - NC - ND;
        for (int cc = 0; cc < NC; ++cc) s += sXab[b * NC + cc];
        s *= 2.0;
        dst = J + (oa + a) * nbf + ob + b;
      }
      atomicAdd(dst, w * s);
    }
  }
#pragma unroll
  for (int o = 0; o < OBC; ++o) {
    const int e = tid + o * NT;
    if (e < NB * NC)
      atomicAdd(K + (ob + e / NC) * nbf + oc + e % NC, w * kbc[o]);
  }
#pragma unroll
  for (int o = 0; o < OBD; ++o) {
    const int e = tid + o * NT;
    if (e < NB * ND)
      atomicAdd(K + (ob + e / ND) * nbf + od + e % ND, w * kbd[o]);
  }
#pragma unroll
  for (int o = 0; o < OCD; ++o) {
    const int e = tid + o * NT;
    if (e < NCD)
      atomicAdd(J + (oc + e / ND) * nbf + od + e % ND, 2.0 * w * jcd[o]);
  }
}

}  // namespace jc
