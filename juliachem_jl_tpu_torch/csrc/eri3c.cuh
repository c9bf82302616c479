// Kernel K1: 3-center integrals (Q | ab) of one (la, lb | lq) class,
// McMurchie-Davidson, written straight into the device-resident B.
//
// Replaces juliachem_jl_tpu/ops/eri3c.py::_threecenter_compute_kernel
// (:125-189) with its inlined Boys function (ops/boys.py:61-98) and Hermite
// E / R recurrences (ops/mcmurchie.py:58-192), plus the host scatter
// (_scatter_block_host, :192-208).  Math, per live primitive pair k of the
// bra and live primitive r of the aux shell (aux partner: the unit shell,
// exponent 0, at the aux centre):
//   out[ab, c] = sum_{k,h} Eab[k,ab,h] T1[k,h,c],
//   T1[k,h,c]  = sum_{r,g} (-1)^|g| R[k,r](h+g) Ecd[r,c,g].
//
// What bounds it on the card: per live primitive product the Boys series
// (128 dependent steps on the scalar FP64 pipe) and the R recursion, then
// per (pair, aux shell) the two contractions; the stores into B (one
// write per target, ld apart between aux rows).  Most (pair, aux shell)
// products of a real build are low classes ((ss|.), (sp|.), (sd|.),
// (pp|.): 95 % of w32's in 6-31+G* / cc-pVTZ-JKFIT) whose blocks hold at
// most a few dozen integrals, and most bra shells of a class have fewer
// primitives than its largest contraction.  So:
//
// * only live primitives are visited: the wrapper packs each shell's
//   primitives of nonzero coefficient first and passes their counts (the
//   pair table's meta of ops/eri.py::pair_table, the aux table's kq), so
//   the padding of a class to its largest contraction (K = 6 for a core s
//   shell) costs nothing;
// * two routes, chosen per class at compile time (Eri3cClass::kLane, from
//   -DJC_ERI3C_LANE_MASK_B<i>, which ops/kernels.py passes from its route
//   table):
//   - lane route (the low classes): one (bra pair, aux shell) per thread,
//     nothing in shared memory.  The lanes of a warp take 32 consecutive
//     bra pairs against one aux shell; each keeps the E tables, the Boys
//     values, R and its block in registers (every index a compile-time
//     constant: static_for) and stores from registers.  The aux expansion
//     (PA = 0: only every other t is nonzero, known at compile time) is
//     built in registers once per aux primitive.
//   - block route (the rest): one block per (bra pair, tile of QT aux
//     shells of the class).  Eab is built once per block in shared memory
//     as a K x M matrix (K = live primitive pairs x Hermite indices, M =
//     the bra's components); the R tensors of every (primitive pair, aux
//     shell, aux primitive) of the tile, then T1 as a K x N matrix (N = QT
//     aux shells x their components) from the aux expansion table that the
//     wrapper built once per build (ops/eri3c.py::aux_table: coefficient,
//     axial norms and (-1)^|g| folded in), and out = Eab^T T1 on the f64
//     tensor cores (mma.sync m16n8k4, dmma.cuh).  QT is the largest of 8,
//     4, 2, 1 whose shared memory stays within kEri3cBlockCap, so that two
//     blocks share an SM.  Where Eab of one primitive pair would pass
//     kEri3cATileCap (the (fg) and (gg) bras: 157 and 328 KB; the block
//     may hold 227 KB), A is built one tile of 16 FMT components ab at a
//     time, each tile's product run and stored before the next; B = T1
//     is built once per block.  That body keeps one item's R and one T1
//     row (k, qi, h) a thread; for the g classes of kEri3cT1Masks
//     (JC_ERI3C_T1_MASK_B<i>, ops/kernels.py's ERI3C_T1, chosen from the
//     card's times) the block's body is K4/K5's block machinery instead
//     (eri3c_block_t1: 8 warps, R level by level across the block, T1 on
//     DMMA with M gathered from R, its aux tile within kEri3cT1Cap).
// * the Boys series multiplies by compile-time reciprocals (boys<L, true>,
//   boys.cuh): no f64 divide in its 128 steps;
// * stores: the wrapper sorts each class's bra pairs by their first output
//   column, and neighbouring threads store neighbouring columns of one aux
//   row (lane route: neighbouring pairs, each lane its block row by row;
//   block route: eight components ab a row segment of a DMMA fragment).
//   The stores bind the lane route at w32 (an f32 B builds 1.3x faster),
//   so the pairs are not sorted by their primitive counts first, though
//   that would make a warp's lanes loop alike: it scattered the stores and
//   was 11 % slower.  Every (aux row,
//   column) target belongs to exactly one (pair, aux function), so
//   outputs are plain stores: no atomics, deterministic.
//
// The output is double, or float for an f32 B (df_b_dtype "f32",
// juliachem_jl_tpu/ops/eri3c.py:264-270), chosen at run time by the flag
// f32: one instance computes both in f64 and rounds once at the store, so
// the f32 output is the f64 output rounded to f32, bit for bit.
//
// Device code only (the launches are in eri3c_launch.cuh, so this header
// compiles with g++ for tools/eri3c_rehearsal.py); static_for, the
// compile-time index functions, LanePair, hermite_R_lane and pair_prim are
// K4/K5's, from eri4c.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma.cuh"
#include "eri4c.cuh"

#ifndef JC_ERI3C_LANE_MASK_B14
#error "build with -DJC_ERI3C_LANE_MASK_B0 .. _B14 (ops/kernels.py's table)"
#endif
#ifndef JC_ERI3C_T1_MASK_B14
#error "build with -DJC_ERI3C_T1_MASK_B0 .. _B14 (ops/kernels.py's table)"
#endif

namespace jc {

constexpr int kEri3cThreads = 128;
// shared memory of one block-route block before its aux tile shrinks: two
// such blocks fit an SM's 228 KB
constexpr size_t kEri3cBlockCap = 100 * 1024;

// the block route's A (the bra expansion, [K4][16 FM + 4]) of one live
// primitive pair is built whole up to this size (to the (ff) bras, 78 KB),
// else in tiles of at most kEri3cATile bytes a primitive pair
constexpr int kEri3cATileCap = 80 * 1024;
constexpr int kEri3cATile = 48 * 1024;

// Index of K1's bra class (la, lb) in the order (0,0) (0,1) (0,2) (1,1)
// (1,2) (2,2) (0,3) (1,3) (2,3) (3,3) (0,4) (1,4) (2,4) (3,4) (4,4)
// (ops/kernels.py::ERI3C_BRAS): the route table JC_ERI3C_LANE_MASK_B<i>
// is the mask of bra class i, whose bit lq is the class (la lb | lq) on the
// lane route.
__host__ __device__ constexpr int eri3c_bra(int la, int lb) {
  return lb <= 2 ? la * 3 - la * (la - 1) / 2 + (lb - la) : (lb == 3 ? 6 + la : 10 + la);
}
constexpr unsigned kEri3cLaneMasks[15] = {
    JC_ERI3C_LANE_MASK_B0, JC_ERI3C_LANE_MASK_B1, JC_ERI3C_LANE_MASK_B2,
    JC_ERI3C_LANE_MASK_B3, JC_ERI3C_LANE_MASK_B4, JC_ERI3C_LANE_MASK_B5,
    JC_ERI3C_LANE_MASK_B6, JC_ERI3C_LANE_MASK_B7, JC_ERI3C_LANE_MASK_B8,
    JC_ERI3C_LANE_MASK_B9, JC_ERI3C_LANE_MASK_B10, JC_ERI3C_LANE_MASK_B11,
    JC_ERI3C_LANE_MASK_B12, JC_ERI3C_LANE_MASK_B13, JC_ERI3C_LANE_MASK_B14};
// the block route's classes whose R is built across the block and whose
// T1 runs on DMMA (the T1 body below), in the same form: bit lq of
// JC_ERI3C_T1_MASK_B<i>
constexpr unsigned kEri3cT1Masks[15] = {
    JC_ERI3C_T1_MASK_B0, JC_ERI3C_T1_MASK_B1, JC_ERI3C_T1_MASK_B2,
    JC_ERI3C_T1_MASK_B3, JC_ERI3C_T1_MASK_B4, JC_ERI3C_T1_MASK_B5,
    JC_ERI3C_T1_MASK_B6, JC_ERI3C_T1_MASK_B7, JC_ERI3C_T1_MASK_B8,
    JC_ERI3C_T1_MASK_B9, JC_ERI3C_T1_MASK_B10, JC_ERI3C_T1_MASK_B11,
    JC_ERI3C_T1_MASK_B12, JC_ERI3C_T1_MASK_B13, JC_ERI3C_T1_MASK_B14};
// threads of a T1-body block (8 warps), and the shared memory of one
// before its aux tile shrinks (one such block an SM)
constexpr int kEri3cT1Threads = 256;
constexpr size_t kEri3cT1Cap = 110 * 1024;

// m16 fragments over ab of one A tile of the block route: all FM where the
// A of one primitive pair fits kEri3cATileCap, else the most within
// kEri3cATile (at least one)
__host__ __device__ constexpr int eri3c_ftile(int FM, int NHB) {
  const int k4 = (NHB + 3) / 4 * 4;
  if (8 * k4 * (16 * FM + 4) <= kEri3cATileCap) return FM;
  int f = FM;
  while (f > 1 && 8 * k4 * (16 * f + 4) > kEri3cATile) --f;
  return f;
}

template <int LA, int LB, int LQ>
struct Eri3cClass {
  static constexpr int NB = ncart(LB), NAB = ncart(LA) * NB, NCQ = ncart(LQ);
  static constexpr int LP = LA + LB, L = LP + LQ;
  static constexpr int NHB = nherm(LP), NHQ = nherm(LQ), NH = nherm(L);
  static constexpr int NE = (LA + 1) * (LB + 1) * (LP + 1);
  static constexpr int FM = (NAB + 15) / 16;  // m16 fragments over ab
  // block route: m16 fragments of one A tile, and the tiles
  static constexpr int FMT = eri3c_ftile(FM, NHB);
  static constexpr int NTILE = (FM + FMT - 1) / FMT;
  // the route: one (pair, aux shell) per thread, or a block per (pair,
  // aux tile) whose product runs on DMMA
  static constexpr bool kLane = (kEri3cLaneMasks[eri3c_bra(LA, LB)] >> LQ) & 1;
  // block route: R across the block and T1 on DMMA (kT1), or R and T1 a
  // thread an item; the threads of a block
  static constexpr bool kT1 =
      !kLane && ((kEri3cT1Masks[eri3c_bra(LA, LB)] >> LQ) & 1);
  static constexpr int kThreads = kT1 ? kEri3cT1Threads : kEri3cThreads;
};

// one store into B: double, or rounded once to float
__device__ __forceinline__ void eri3c_store(void* out, int f32, int64_t o,
                                            double v) {
  if (f32) static_cast<float*>(out)[o] = (float)v;
  else static_cast<double*>(out)[o] = v;
}

// ------------------------------------------------------------- lane route

// 1-D Hermite expansion E[i][t] (i, t <= LQ, row stride LQ + 1) of an aux
// primitive of exponent q against the unit shell at its own centre: PA =
// PB = 0, so E[i][t] = E[i-1][t-1] / 2q + (t+1) E[i-1][t+1], zero unless i
// - t is even (those entries are never read); the same on all three axes.
template <int LQ>
__device__ __forceinline__ void aux_E_lane(double oo2q, double* E) {
  constexpr int S = LQ + 1;
  E[0] = 1.0;
  static_for<LQ>([&](auto i0) {
    constexpr int i = decltype(i0)::value + 1;
    static_for<i + 1>([&](auto t_) {
      constexpr int t = decltype(t_)::value;
      if constexpr (((i - t) & 1) == 0) {
        double v;
        if constexpr (t >= 1) {
          v = oo2q * E[(i - 1) * S + t - 1];
          if constexpr (t + 1 <= i - 1) v += (t + 1) * E[(i - 1) * S + t + 1];
        } else {
          v = (t + 1) * E[(i - 1) * S + t + 1];
        }
        E[i * S + t] = v;
      }
    });
  });
}

// I[ab][C] += sum_h Eab[ab][h] V[h] for aux component C of one primitive
// product, V[h] = sum_g (-1)^|g| Ecd[C][g] R[h+g] over the nonzero g (t2 =
// cx, cx - 2, ..., so (-1)^|g| = (-1)^LQ) (a function of its own per C,
// force-inlined, as lane_accumulate_cd of eri4c.cuh)
template <int LA, int LB, int LQ, int C>
__device__ __forceinline__ void eri3c_lane_c(const LanePair<LA, LB>& bp,
                                             const double* E1, const double* R,
                                             double* I) {
  using K = Eri3cClass<LA, LB, LQ>;
  constexpr int NB = K::NB, NAB = K::NAB, NCQ = K::NCQ, NHB = K::NHB;
  constexpr int S = LQ + 1;
  constexpr int cx = cart_x(LQ, C), cy = cart_y(LQ, C), cz = cart_z(LQ, C);
  double V[NHB];
  static_for<NHB>([&](auto h_) {
    constexpr int h = decltype(h_)::value;
    constexpr int t = herm_t(h), u = herm_u(h), v = herm_v(h);
    double acc = -0.0;
    static_for<cx / 2 + 1>([&](auto a_) {
      constexpr int t2 = cx - 2 * decltype(a_)::value;
      static_for<cy / 2 + 1>([&](auto b_) {
        constexpr int u2 = cy - 2 * decltype(b_)::value;
        static_for<cz / 2 + 1>([&](auto c_) {
          constexpr int v2 = cz - 2 * decltype(c_)::value;
          acc += E1[cx * S + t2] * E1[cy * S + u2] * E1[cz * S + v2] *
                 R[hidx(t + t2, u + u2, v + v2)];
        });
      });
    });
    V[h] = (LQ & 1) ? -acc : acc;
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
    I[ab * NCQ + C] += acc;
  });
}

template <int LA, int LB, int LQ, int... C>
__device__ __forceinline__ void eri3c_lane_accumulate(
    const LanePair<LA, LB>& bp, const double* E1, const double* R, double* I,
    std::integer_sequence<int, C...>) {
  (eri3c_lane_c<LA, LB, LQ, C>(bp, E1, R, I), ...);
}

// pair: [n][2Ka+2Kb+6] = aexp | acoef | bexp | bcoef | A | B, meta [n][kMeta]
// (eri4c.cuh); aux: [nq][2Kq+3] = qexp | qcoef | Q, auxk [nq] live
// primitives (both nonzero-coefficient first); out[(qrow[q] + c) * ld +
// cols[p*NAB + ab]] (and cols_t when mirror[p]).  Warp w takes the bra
// pairs 32 (w / nq) .. + 31 (one a lane) against aux shell w % nq.
template <int LA, int LB, int LQ>
__global__ void __launch_bounds__(kEri3cThreads)
eri3c_lane_kernel(const double* __restrict__ pair, int Ka, int Kb,
                  const int* __restrict__ meta, int64_t n,
                  const double* __restrict__ aux, const int* __restrict__ auxk,
                  const int64_t* __restrict__ qrow, int nq, int Kq,
                  const int64_t* __restrict__ cols,
                  const int64_t* __restrict__ cols_t,
                  const uint8_t* __restrict__ mirror, void* __restrict__ out,
                  int f32, int64_t ld) {
  using K = Eri3cClass<LA, LB, LQ>;
  constexpr int NB = K::NB, NAB = K::NAB, NCQ = K::NCQ, NH = K::NH;
  constexpr int L = K::L, S = LQ + 1;
  // 32-bit division (eri3c_launch keeps the warps below 2^32)
  const unsigned w = blockIdx.x * (kEri3cThreads / 32) + threadIdx.x / 32;
  const int64_t q = w % (unsigned)nq;
  const int64_t p = (int64_t)(w / (unsigned)nq) * 32 + (threadIdx.x & 31);
  if (p >= n) return;
  const double* rb = pair + p * (2 * Ka + 2 * Kb + 6);
  const int* mb = meta + p * kMeta;
  const double* qa = aux + q * (2 * Kq + 3);
  double I[NAB * NCQ];
  static_for<NAB * NCQ>([&](auto e) { I[decltype(e)::value] = 0.0; });
  const double AB2 = dist2(rb + 2 * Ka + 2 * Kb, rb + 2 * Ka + 2 * Kb + 3);
  const double Qx = qa[2 * Kq], Qy = qa[2 * Kq + 1], Qz = qa[2 * Kq + 2];
  const int ka = mb[2], kb = mb[3], kq = auxk[q];
  for (int r = 0; r < kq; ++r) {
    const double qe = qa[r], qc = qa[Kq + r];
    double E1[S * S];
    aux_E_lane<LQ>(0.5 / qe, E1);
    for (int i = 0; i < ka; ++i)
      for (int j = 0; j < kb; ++j) {
        LanePair<LA, LB> bp;
        bp.build(rb, Ka, Kb, i, j, AB2);
        const double X = bp.P[0] - Qx, Y = bp.P[1] - Qy, Z = bp.P[2] - Qz;
        const double psum = bp.p + qe, alpha = bp.p * qe / psum;
        const double T = alpha * (X * X + Y * Y + Z * Z);
        const double pref = kTwoPiPow2_5 / (bp.p * qe * sqrt(psum)) * qc;
        double R[NH];
        {
          double F[L + 1];
          boys<L, true>(T, F);
          static_for<L + 1>([&](auto m) { F[decltype(m)::value] *= pref; });
          hermite_R_lane<L>(alpha, X, Y, Z, F, R);
        }
        eri3c_lane_accumulate<LA, LB, LQ>(
            bp, E1, R, I, std::make_integer_sequence<int, NCQ>{});
      }
  }
  const int64_t row0 = qrow[q];
  const bool mir = mirror[p];
  const int64_t* cp = cols + p * NAB;
  const int64_t* ct = cols_t + p * NAB;
  static_for<NAB * NCQ>([&](auto e_) {
    constexpr int e = decltype(e_)::value, ab = e / NCQ, c = e % NCQ;
    constexpr double f = caxial(LA, ab / NB) * caxial(LB, ab % NB) *
                         caxial(LQ, c);
    if constexpr (f != 1.0) I[e] *= f;
  });
  // row by row: the block's columns of one aux row, then their mirror
  // (8 % faster at w32 than (ab, c) order with each mirror store beside
  // its direct one)
  static_for<NCQ>([&](auto c_) {
    constexpr int c = decltype(c_)::value;
    const int64_t o = (row0 + c) * ld;
    static_for<NAB>([&](auto ab) {
      eri3c_store(out, f32, o + cp[decltype(ab)::value],
                  I[decltype(ab)::value * NCQ + c]);
    });
    if (mir)
      static_for<NAB>([&](auto ab) {
        eri3c_store(out, f32, o + ct[decltype(ab)::value],
                    I[decltype(ab)::value * NCQ + c]);
      });
  });
}

// ------------------------------------------------------------ block route

// Shared memory of one block-route block, in doubles, for K2 = Ka Kb
// primitive pairs (the class's padded count: a size), Kq aux primitives
// and a tile of QT aux shells.  A = one tile of Eab as [K4][lda] (K4: K2
// NHB rounded up to the k-step of 4, rows kk = k NHB + h, columns the
// tile's 16 FMT components ab), B = T1 as
// [K4][ldb] (columns n = qi NCQ + c), the columns padded to whole DMMA
// fragments (16 a row of A, 8 of B) and each row by 4 more doubles, so
// that a fragment's loads hit distinct banks (dmma.cuh).
template <int LA, int LB, int LQ>
struct Eri3cSmem {
  using K = Eri3cClass<LA, LB, LQ>;
  int K4, lda, Np, ldb, P, E, A, R, B, total;
  __host__ __device__ Eri3cSmem(int K2, int Kq, int QT) {
    K4 = (K2 * K::NHB + 3) / 4 * 4;
    lda = 16 * K::FMT + 4;
    Np = (QT * K::NCQ + 7) / 8 * 8;
    ldb = Np + 4;
    P = 0;                             // [K2][4]: p, Px, Py, Pz
    E = P + 4 * K2;                    // [K2][3][NE] bra E tables
    A = E + 3 * K2 * K::NE;            // [K4][lda]
    R = A + K4 * lda;                  // [K2][QT][Kq][NH]
    B = R + K2 * QT * Kq * K::NH;      // [K4][ldb]
    total = B + K4 * ldb;
  }
};

// Shared memory of one T1-body block (Eri3cClass::kT1), in doubles: A
// and B = T1 as in Eri3cSmem; the nprim = K2 QT Kq primitive products
// (bra pair k, aux shell qi, aux primitive r) of the tile, each with its R
// [NH]; the aux expansion of each aux shell of the tile as T1's B operand
// Ec [K4q][ldE] (rows kk = r NHQ + g, columns c); and the Hermite triples
// and product 1's k index (ints).  R's odd levels, the Boys values and X,
// Y, Z lie at first where T1 goes, A where R and Ec were.
template <int LA, int LB, int LQ>
struct Eri3cT1Smem {
  using K = Eri3cClass<LA, LB, LQ>;
  int K4, lda, Np, ldb, K4q, ldE, nprim, P, E, B, R, Ec, A, Tab, total;
  __host__ __device__ Eri3cT1Smem(int K2, int Kq, int QT) {
    K4 = (K2 * K::NHB + 3) / 4 * 4;
    lda = 16 * K::FMT + 4;
    Np = (QT * K::NCQ + 7) / 8 * 8;
    ldb = Np + 4;
    K4q = (Kq * K::NHQ + 3) / 4 * 4;
    ldE = (K::NCQ + 15) / 16 * 16 + 4;
    nprim = K2 * QT * Kq;
    P = 0;                             // [K2][4]: p, Px, Py, Pz
    E = P + 4 * K2;                    // [K2][3][NE] bra E tables
    B = E + 3 * K2 * K::NE;            // [K4][ldb]; at first R's odd
                                       // levels, G [L + 1] and X, Y, Z [4]
    const int scratch = nprim * (nherm(K::L - 1) + K::L + 5);
    R = B + (K4 * ldb > scratch ? K4 * ldb : scratch);  // [nprim][NH]
    Ec = R + nprim * K::NH;            // [QT][K4q][ldE]
    A = R;                             // [K4][lda], once T1 is built
    int end = Ec + QT * K4q * ldE;
    if (A + K4 * lda > end) end = A + K4 * lda;
    Tab = end;                         // ints: Hermite triples [NH],
                                       // product 1's k index [2 K4q]
    total = Tab + (K::NH + 2 * K4q + 1) / 2;
  }
};

// bytes of shared memory of one block-route block of QT aux shells
template <int LA, int LB, int LQ>
__host__ __device__ inline size_t eri3c_block_bytes(int K2, int Kq, int QT) {
  if constexpr (Eri3cClass<LA, LB, LQ>::kT1)
    return sizeof(double) * (size_t)Eri3cT1Smem<LA, LB, LQ>(K2, Kq, QT).total;
  else
    return sizeof(double) * (size_t)Eri3cSmem<LA, LB, LQ>(K2, Kq, QT).total;
}

// aux shells a block-route block: the largest of 8, 4, 2, 1 whose shared
// memory stays within kEri3cBlockCap (kEri3cT1Cap for the T1 body; 1 past
// it)
template <int LA, int LB, int LQ>
__host__ __device__ inline int eri3c_tile(int K2, int Kq) {
  constexpr size_t cap =
      Eri3cClass<LA, LB, LQ>::kT1 ? kEri3cT1Cap : kEri3cBlockCap;
  int qt = 8;
  while (qt > 1 && eri3c_block_bytes<LA, LB, LQ>(K2, Kq, qt) > cap) qt /= 2;
  return qt;
}

// A[kk][j] = Eab[k][ab0 + j][h] of A tile TILE (components ab0 .. ab0 + 16
// FMT - 1) with axial norms and contraction folded in, one row kk = k NHB
// + h a thread of NT (the components at compile time); zero past the live
// rows KL (to K4) and the components (to lda).  sE: the bra E tables of the
// live primitive pairs, rb the pair's row, kb its live b primitives.
template <int LA, int LB, int LQ, int TILE, int NT>
__device__ __forceinline__ void eri3c_build_a(double* sA, int lda,
                                              const double* sE,
                                              const double* rb, int Ka,
                                              int Kb, int kb, int KL, int K4,
                                              int tid) {
  using K = Eri3cClass<LA, LB, LQ>;
  constexpr int NAB = K::NAB, NHB = K::NHB, NE = K::NE;
  constexpr int AB0 = 16 * K::FMT * TILE;
  constexpr int ABN = NAB - AB0 < 16 * K::FMT ? NAB - AB0 : 16 * K::FMT;
  for (int kk = tid; kk < KL; kk += NT) {
    const int k = kk / NHB;
    int t, u, v;
    herm_triple(kk % NHB, t, u, v);
    const double* Ek = sE + k * 3 * NE;
    const double cc = rb[Ka + k / kb] * rb[2 * Ka + Kb + k % kb];
    double* arow = sA + kk * lda;
    static_for<ABN>([&](auto j_) {
      constexpr int j = decltype(j_)::value, ab = AB0 + j;
      constexpr int ai = ab / K::NB, bi = ab % K::NB;
      constexpr int ax = cart_x(LA, ai), ay = cart_y(LA, ai), az = cart_z(LA, ai);
      constexpr int bx = cart_x(LB, bi), by = cart_y(LB, bi), bz = cart_z(LB, bi);
      constexpr int NT1 = LA + LB + 1;
      constexpr double f = caxial(LA, ai) * caxial(LB, bi);
      arow[j] = Ek[(ax * (LB + 1) + bx) * NT1 + t] *
                Ek[NE + (ay * (LB + 1) + by) * NT1 + u] *
                Ek[2 * NE + (az * (LB + 1) + bz) * NT1 + v] * f * cc;
    });
    for (int j = ABN; j < lda; ++j) arow[j] = 0.0;
  }
  for (int e = KL * lda + tid; e < K4 * lda; e += NT) sA[e] = 0.0;
}

// The block route's body of the classes off the T1 body: R of each item
// on one thread, T1 one (k, qi, h) a thread.  ecd: [nq][Kq][NCQ][NHQ] aux
// expansion (ops/eri3c.py::aux_table).  Block b takes bra pair b / nqt
// against aux shells q0 .. q0 + QT - 1, q0 = (b % nqt) QT.
template <int LA, int LB, int LQ>
__device__ __forceinline__ void eri3c_block_thread(
    const double* __restrict__ pair, int Ka, int Kb,
    const int* __restrict__ meta, const double* __restrict__ aux,
    const int* __restrict__ auxk, const int64_t* __restrict__ qrow,
    const double* __restrict__ ecd, int nq, int Kq, int QT,
    const int64_t* __restrict__ cols, const int64_t* __restrict__ cols_t,
    const uint8_t* __restrict__ mirror, void* __restrict__ out, int f32,
    int64_t ld) {
  using K = Eri3cClass<LA, LB, LQ>;
  constexpr int NAB = K::NAB, NCQ = K::NCQ, NHB = K::NHB, NHQ = K::NHQ;
  constexpr int NH = K::NH, L = K::L;
  extern __shared__ double sm[];
  const Eri3cSmem<LA, LB, LQ> lay(Ka * Kb, Kq, QT);
  const int lda = lay.lda, ldb = lay.ldb;
  double* sP = sm + lay.P;
  double* sE = sm + lay.E;
  double* sA = sm + lay.A;
  double* sR = sm + lay.R;
  double* sB = sm + lay.B;
  const int nqt = (nq + QT - 1) / QT;
  const int64_t p = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x % nqt) * QT;
  const double* rb = pair + p * (2 * Ka + 2 * Kb + 6);
  const int* mb = meta + p * kMeta;
  const int kb = mb[3], k2 = mb[2] * kb;
  const int KL = k2 * NHB, K4 = (KL + 3) / 4 * 4;
  const int tid = threadIdx.x;
  constexpr int NT = kEri3cThreads;

  // 1. product centres and E tables of the live bra primitive pairs
  for (int e = tid; e < 3 * k2; e += NT)
    pair_prim<LA, LB>(rb, Ka, Kb, kb, e / 3, e % 3, sE, sP, e / 3);
  __syncthreads();
  // 2. A tile 0 (eri3c_build_a), the others after the product of the one
  //    before (step 5)
  auto build_a = [&](auto tile_) {
    eri3c_build_a<LA, LB, LQ, decltype(tile_)::value, NT>(
        sA, lda, sE, rb, Ka, Kb, kb, KL, K4, tid);
  };
  build_a(std::integral_constant<int, 0>{});
  // 3. R of every (live primitive pair k, aux shell qi of the tile, live
  //    aux primitive r), one item a thread: item (k QT + qi) Kq + r; the
  //    recursion at compile-time indices (hermite_R_lane) into shared memory
  for (int it = tid; it < k2 * QT * Kq; it += NT) {
    const int r = it % Kq, qi = (it / Kq) % QT, k = it / (Kq * QT);
    const int q = q0 + qi;
    if (q >= nq || r >= auxk[q]) continue;
    const double* qa = aux + (int64_t)q * (2 * Kq + 3);
    const double qe = qa[r], pe = sP[4 * k];
    const double X = sP[4 * k + 1] - qa[2 * Kq];
    const double Y = sP[4 * k + 2] - qa[2 * Kq + 1];
    const double Z = sP[4 * k + 3] - qa[2 * Kq + 2];
    const double psum = pe + qe, alpha = pe * qe / psum;
    const double T = alpha * (X * X + Y * Y + Z * Z);
    const double pref = kTwoPiPow2_5 / (pe * qe * sqrt(psum));
    double F[L + 1];
    boys<L, true>(T, F);
    static_for<L + 1>([&](auto m) { F[decltype(m)::value] *= pref; });
    hermite_R_lane<L>(alpha, X, Y, Z, F, sR + it * NH);
  }
  __syncthreads();
  // 4. B[kk][qi, c] = T1[k][h][qi, c] = sum_r sum_g R[k, qi, r](h + g)
  //    Ecd[q][r][c][g] over the nonzero g (t2 = cx, cx - 2, ...), one
  //    (k, qi, h) a thread (c and g at compile time); zero past the live
  //    rows, the tile's aux shells and its columns
  for (int it = tid; it < k2 * QT * NHB; it += NT) {
    const int h = it % NHB, qi = (it / NHB) % QT, k = it / (NHB * QT);
    const int q = q0 + qi;
    double acc[NCQ];
    static_for<NCQ>([&](auto c) { acc[decltype(c)::value] = 0.0; });
    if (q < nq) {
      int t, u, v;
      herm_triple(h, t, u, v);
      const int kq = auxk[q];
      for (int r = 0; r < kq; ++r) {
        const double* Rk = sR + ((k * QT + qi) * Kq + r) * NH;
        const double* Ec = ecd + ((int64_t)q * Kq + r) * NCQ * NHQ;
        static_for<NCQ>([&](auto c_) {
          constexpr int c = decltype(c_)::value;
          constexpr int cx = cart_x(LQ, c), cy = cart_y(LQ, c), cz = cart_z(LQ, c);
          static_for<cx / 2 + 1>([&](auto a_) {
            constexpr int t2 = cx - 2 * decltype(a_)::value;
            static_for<cy / 2 + 1>([&](auto b_) {
              constexpr int u2 = cy - 2 * decltype(b_)::value;
              static_for<cz / 2 + 1>([&](auto d_) {
                constexpr int v2 = cz - 2 * decltype(d_)::value;
                acc[c] += Rk[hidx(t + t2, u + u2, v + v2)] *
                          Ec[c * NHQ + hidx(t2, u2, v2)];
              });
            });
          });
        });
      }
    }
    double* brow = sB + (k * NHB + h) * ldb + qi * NCQ;
    static_for<NCQ>([&](auto c) { brow[decltype(c)::value] = acc[decltype(c)::value]; });
  }
  for (int kk = tid; kk < KL; kk += NT)
    for (int nn = QT * NCQ; nn < ldb; ++nn) sB[kk * ldb + nn] = 0.0;
  for (int e = KL * ldb + tid; e < K4 * ldb; e += NT) sB[e] = 0.0;
  __syncthreads();
  // 5. per A tile: out[ab][qi, c] = sum_kk A[kk][ab] B[kk][qi, c] on DMMA,
  //    stored into B: warp w takes the n8 fragments w, w + 4, ... of every
  //    m16 row of the tile; then the next tile of A
  const uint8_t mir = mirror[p];
  const int64_t* cp = cols + p * NAB;
  const int64_t* ct = cols_t + p * NAB;
  const int nout = QT * NCQ;
  const int warp = tid >> 5, lane = tid & 31;
  static_for<K::NTILE>([&](auto tile_) {
    constexpr int tile = decltype(tile_)::value, F0 = tile * K::FMT;
    constexpr int FT = K::FM - F0 < K::FMT ? K::FM - F0 : K::FMT;
    if constexpr (tile > 0) {
      __syncthreads();  // the product of the tile before has read A
      build_a(tile_);
      __syncthreads();
    }
    for (int fv = warp; fv < lay.Np / 8; fv += NT / 32) {
      DmmaTile<FT, 1> acc;
      acc.zero();
      for (int k0 = 0; k0 < K4; k0 += 4)
        acc.step(sA + k0 * lda, lda, sB + k0 * ldb + fv * 8, ldb, lane);
#pragma unroll
      for (int fu = 0; fu < FT; ++fu)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ab = 16 * F0 + DmmaTile<FT, 1>::row(fu, e, lane);
          const int nn = fv * 8 + DmmaTile<FT, 1>::col(0, e, lane);
          const int qi = nn / NCQ, q = q0 + qi;
          if (ab < NAB && nn < nout && q < nq) {
            const int64_t o = (qrow[q] + nn % NCQ) * ld;
            eri3c_store(out, f32, o + cp[ab], acc.c[fu][0][e]);
            if (mir) eri3c_store(out, f32, o + ct[ab], acc.c[fu][0][e]);
          }
        }
    }
  });
}


// The T1 body of the block route (Eri3cClass::kT1: the g classes of
// kEri3cT1Masks), K4/K5's block machinery (eri4c.cuh) in K1's block: per
// (bra pair p, tile of QT aux shells), with the nprim = k2 QT Kq primitive
// products f = (k QT + qi) Kq + r (live bra pair k, aux shell qi, aux
// primitive r; zero where qi is past the class or r past the shell's live
// primitives):
//   Boys        a thread a product (block_boys);
//   R           level by level across the block (block_r_levels);
//   T1          per aux shell qi, T1[(k,h)][c] = sum_{(r,g)} M[(k,h)][(r,g)]
//               Ec[(r,g)][c] on DMMA, M = R_{k,qi,r}[h + g] gathered from R
//               as the fragments load (MGather; the sign (-1)^|g| is in
//               the aux expansion), Ec the shell's aux expansion (ecd)
//               staged in shared memory; the (qi, fragment unit) jobs
//               spread over the warps;
//   out         per A tile, out[ab][(qi,c)] = sum_{(k,h)} A[(k,h)][ab]
//               T1[(k,h)][(qi,c)] on DMMA (block_mma, a unit a warp), A
//               built once per tile (eri3c_build_a), stored as the thread
//               body stores.
// What it removes: the thread body ran each product's Boys and L <= 12 R
// in one thread's registers (at QT <= 8 and Kq = 1, 8 of 128 threads
// worked while the rest waited at the barrier) and T1 one (k, qi, h) a
// thread in scalar FMAs, and its product gave each warp whole columns of
// n8 fragments (2 of 4 warps busy at QT = 1).
template <int LA, int LB, int LQ>
__device__ __forceinline__ void eri3c_block_t1(
    const double* __restrict__ pair, int Ka, int Kb,
    const int* __restrict__ meta, const double* __restrict__ aux,
    const int* __restrict__ auxk, const int64_t* __restrict__ qrow,
    const double* __restrict__ ecd, int nq, int Kq, int QT,
    const int64_t* __restrict__ cols, const int64_t* __restrict__ cols_t,
    const uint8_t* __restrict__ mirror, void* __restrict__ out, int f32,
    int64_t ld) {
  using K = Eri3cClass<LA, LB, LQ>;
  constexpr int NAB = K::NAB, NCQ = K::NCQ, NHB = K::NHB, NHQ = K::NHQ;
  constexpr int NH = K::NH, L = K::L, NT = K::kThreads, NW = NT / 32;
  constexpr int FN1 = NCQ > 8 ? 2 : 1;  // T1's n8 fragments a unit
  static_assert(NHB >= 16, "the T1 body puts the bra Hermite rows on m16");
  extern __shared__ double sm[];
  const Eri3cT1Smem<LA, LB, LQ> lay(Ka * Kb, Kq, QT);
  const int lda = lay.lda, ldb = lay.ldb, K4q = lay.K4q, ldE = lay.ldE;
  double* sP = sm + lay.P;
  double* sE = sm + lay.E;
  double* sB = sm + lay.B;
  double* sR = sm + lay.R;
  double* sEc = sm + lay.Ec;
  double* sA = sm + lay.A;
  int* htab = reinterpret_cast<int*>(sm + lay.Tab);
  int* gtab = htab + NH;
  const int nqt = (nq + QT - 1) / QT;
  const int64_t p = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x % nqt) * QT;
  const double* rb = pair + p * (2 * Ka + 2 * Kb + 6);
  const int* mb = meta + p * kMeta;
  const int kb = mb[3], k2 = mb[2] * kb;
  const int KL = k2 * NHB, K4 = (KL + 3) / 4 * 4;
  const int nprim = k2 * QT * Kq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 0. the Hermite triples; product 1's k index kk = (r, g): r's offset
  //    in a shell's R and g's order, u + v and v (MGather's table, no
  //    sign: the aux expansion holds it), zero past the Kq NHQ rows
  for (int e = tid; e < NH; e += NT) {
    int t, u, v;
    herm_triple(e, t, u, v);
    htab[e] = t | (u << 8) | (v << 16);
  }
  for (int e = tid; e < K4q; e += NT) {
    if (e < Kq * NHQ) {
      const int r = e / NHQ;
      int t, u, v;
      herm_triple(e - r * NHQ, t, u, v);
      gtab[2 * e] = r * NH;
      gtab[2 * e + 1] = (t + u + v) | ((u + v) << 8) | (v << 16);
    } else {
      gtab[2 * e] = 0;
      gtab[2 * e + 1] = 1 << 25;
    }
  }
  // 1. product centres and E tables of the live bra primitive pairs; each
  //    aux shell's expansion Ec[qi][kk][c] (zero past the class's shells,
  //    the rows and the components)
  for (int e = tid; e < 3 * k2; e += NT)
    pair_prim<LA, LB>(rb, Ka, Kb, kb, e / 3, e % 3, sE, sP, e / 3);
  for (int e = tid; e < QT * K4q * ldE; e += NT) {
    const int qi = e / (K4q * ldE), x = e - qi * K4q * ldE;
    const int kk = x / ldE, c = x - kk * ldE, q = q0 + qi;
    double val = 0.0;
    if (q < nq && kk < Kq * NHQ && c < NCQ) {
      const int r = kk / NHQ;
      val = ecd[(((int64_t)q * Kq + r) * NCQ + c) * NHQ + kk - r * NHQ];
    }
    sEc[e] = val;
  }
  __syncthreads();
  // 2. Boys per product f, a thread each (G and X, Y, Z where T1 goes)
  double* sRs = sB;                       // R's odd levels
  double* sG = sRs + nprim * nherm(L - 1);  // [nprim][L + 1]
  double* sQ = sG + nprim * (L + 1);        // [nprim][4]
  for (int f = tid; f < nprim; f += NT) {
    const int r = f % Kq, qi = (f / Kq) % QT, k = f / (Kq * QT);
    const int q = q0 + qi;
    if (q < nq && r < auxk[q]) {
      const double* qa = aux + (int64_t)q * (2 * Kq + 3);
      block_boys<L>(sP[4 * k], qa[r], sP[4 * k + 1] - qa[2 * Kq],
                    sP[4 * k + 2] - qa[2 * Kq + 1],
                    sP[4 * k + 3] - qa[2 * Kq + 2], sG + f * (L + 1),
                    sQ + 4 * f);
    } else {
      for (int m = 0; m <= L; ++m) sG[f * (L + 1) + m] = 0.0;
      sQ[4 * f + 1] = sQ[4 * f + 2] = sQ[4 * f + 3] = 0.0;
    }
  }
  __syncthreads();
  // 3. R level by level across the block (its last barrier ends the step)
  block_r_levels<L, NT>(sR, sRs, sG, sQ, htab, nprim, tid);
  // 4. T1 of each aux shell qi into B's columns qi NCQ .. + NCQ - 1, rows
  //    to K4 (zero past the live KL: MGather's rows); B's columns past the
  //    tile's zeroed
  {
    const int um = (K4 + 15) / 16, un = (NCQ + 8 * FN1 - 1) / (8 * FN1);
    for (int job = warp; job < QT * um * un; job += NW) {
      const int qi = job / (um * un), u = job - qi * um * un;
      const MGather<NHB, NH> Mg{sR + qi * Kq * NH, htab, gtab, QT * Kq, KL};
      const SmemOperand Ec{sEc + qi * K4q * ldE, ldE};
      mma_unit<1, FN1>(Mg, Ec, (u / un) * 16, (u % un) * 8 * FN1, K4q, lane,
                       [&](int m, int n, double x) {
                         if (m < K4 && n < NCQ)
                           sB[m * ldb + qi * NCQ + n] = x;
                       });
    }
    const int w = ldb - QT * NCQ;
    for (int e = tid; e < K4 * w; e += NT)
      sB[(e / w) * ldb + QT * NCQ + e % w] = 0.0;
  }
  __syncthreads();
  // 5. per A tile (A over R and Ec, which T1 has read): out[ab][qi, c] on
  //    DMMA, a unit of one m16 by one n8 fragment a warp, stored into B
  const uint8_t mir = mirror[p];
  const int64_t* cp = cols + p * NAB;
  const int64_t* ct = cols_t + p * NAB;
  const int nout = QT * NCQ;
  static_for<K::NTILE>([&](auto tile_) {
    constexpr int tile = decltype(tile_)::value, AB0 = 16 * K::FMT * tile;
    constexpr int ABN = NAB - AB0 < 16 * K::FMT ? NAB - AB0 : 16 * K::FMT;
    if constexpr (tile > 0) __syncthreads();  // the tile before is read
    eri3c_build_a<LA, LB, LQ, tile, NT>(sA, lda, sE, rb, Ka, Kb, kb, KL, K4,
                                        tid);
    __syncthreads();
    block_mma<NT, 1, 1>(
        SmemOperand{sA, lda}, SmemOperand{sB, ldb}, ABN, nout, K4, warp,
        lane, [&](int m, int nn, double x) {
          const int qi = nn / NCQ, q = q0 + qi;
          if (m < ABN && nn < nout && q < nq) {
            const int64_t o = (qrow[q] + nn % NCQ) * ld;
            eri3c_store(out, f32, o + cp[AB0 + m], x);
            if (mir) eri3c_store(out, f32, o + ct[AB0 + m], x);
          }
        });
  });
}

// K1, block route: one block of Eri3cClass::kThreads threads per (bra pair,
// tile of QT aux shells), the body of the class (kT1: eri3c_block_t1,
// else eri3c_block_thread).
template <int LA, int LB, int LQ>
__global__ void __launch_bounds__(Eri3cClass<LA, LB, LQ>::kThreads)
eri3c_block_kernel(const double* __restrict__ pair, int Ka, int Kb,
                   const int* __restrict__ meta,
                   const double* __restrict__ aux, const int* __restrict__ auxk,
                   const int64_t* __restrict__ qrow,
                   const double* __restrict__ ecd, int nq, int Kq, int QT,
                   const int64_t* __restrict__ cols,
                   const int64_t* __restrict__ cols_t,
                   const uint8_t* __restrict__ mirror, void* __restrict__ out,
                   int f32, int64_t ld) {
  if constexpr (Eri3cClass<LA, LB, LQ>::kT1)
    eri3c_block_t1<LA, LB, LQ>(pair, Ka, Kb, meta, aux, auxk, qrow, ecd, nq,
                               Kq, QT, cols, cols_t, mirror, out, f32, ld);
  else
    eri3c_block_thread<LA, LB, LQ>(pair, Ka, Kb, meta, aux, auxk, qrow, ecd,
                                   nq, Kq, QT, cols, cols_t, mirror, out, f32,
                                   ld);
}

}  // namespace jc
