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
// What bounds it on the card: per primitive quartet a serial Boys series
// (128 dependent multiply-divides) and R recursion, then two small products
// per quartet; the work per quartet spans two orders of magnitude across
// classes, and the J/K targets of many quartets collide.  Design, simple
// and right first: one warp per quartet, several independent warps per
// block, each with its own slice of shared memory.  The lanes build the E
// tables and Hermite expansions, each lane takes one primitive quartet's
// Boys + R (rounds of up to 32), and the lanes split the element loops of
// the products and of the digestion.  Only the primitives with nonzero
// coefficients are visited: the wrapper packs them first in each shell and
// passes their counts (meta), so the contraction padding of a class (K = 6
// for a core s shell) costs nothing.  Sums into J/K are f64 atomicAdd
// (native on sm_90), so J/K change in the last bits from run to run.
// Batching several quartets per warp in the Boys phase, DMMA for the
// products and one persistent launch over all classes are later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "boys.cuh"
#include "mcmurchie.cuh"

namespace jc {

// pair table rows [n][2Ka+2Kb+6] = aexp | acoef | bexp | bcoef | A | B, the
// primitives of nonzero coefficient first; meta rows [n][kMeta]:
constexpr int kMeta = 5;  // off_a, off_b, nonzero prims of a, of b, ish == jsh
constexpr int kEri4cMaxWarps = 4;

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
};

// Shared memory of one warp, in doubles.  Kab, Kcd: padded primitive-pair
// counts of the class (sizes); RS: primitive quartets per R round.  Regions
// whose lifetimes do not meet share space, so that (ff|ff) fits in one
// block's 227 KB: the E tables (steps 1-2) lie where the R round (step 3)
// goes, and the quartet block I (step 4 on) and the D blocks of the
// digestion lie over Ecd and the R round, which step 4 no longer reads.
template <int LA, int LB, int LC, int LD>
struct Eri4cSmem {
  using C = Eri4cClass<LA, LB, LC, LD>;
  int Pb, Pk, Eab, T1, Ecd, Eb, Ek, R, I, Dg, total;
  __host__ __device__ Eri4cSmem(int Kab, int Kcd, int RS) {
    Pb = 0;                              // [Kab][4]: p, Px, Py, Pz
    Pk = Pb + 4 * Kab;                   // [Kcd][4]: q, Qx, Qy, Qz
    Eab = Pk + 4 * Kcd;                  // [Kab][NAB][NHB]
    T1 = Eab + Kab * C::NAB * C::NHB;    // [Kab][NHB][NCD]
    Ecd = T1 + Kab * C::NHB * C::NCD;    // [Kcd][NCD][NHK]    steps 2-3
    Eb = Ecd + Kcd * C::NCD * C::NHK;    // [Kab][3][NEB]      steps 1-2
    Ek = Eb + Kab * 3 * C::NEB;          // [Kcd][3][NEK]      steps 1-2
    R = Eb;                              // [RS][NH]           step 3
    I = Ecd;                             // [NAB][NCD]         step 4 on
    Dg = I + C::NAB * C::NCD;            // [NDG]              digestion
    const int e = Ek + Kcd * 3 * C::NEK, r = R + RS * C::NH;
    total = e > r ? e : r;
    if (Dg + C::NDG > total) total = Dg + C::NDG;
  }
};

// Shared memory of one K6 warp: the cached block and the D blocks.
template <int LA, int LB, int LC, int LD>
struct DigestSmem {
  using C = Eri4cClass<LA, LB, LC, LD>;
  int I, Dg, total;
  __host__ __device__ DigestSmem() : I(0), Dg(C::NAB * C::NCD), total(C::NAB * C::NCD + C::NDG) {}
};

// Product centre and per-dimension E table of primitive pair k = i*kb + j
// (real primitives i of the first shell, j of the second), dimension d.
template <int L1, int L2>
__device__ __forceinline__ void pair_prim(const double* row, int K1, int K2,
                                          int kb, int k, int d, double* sE,
                                          double* sP) {
  constexpr int NE = (L1 + 1) * (L2 + 1) * (L1 + L2 + 1);
  const int i = k / kb, j = k % kb;
  const double a = row[i], b = row[2 * K1 + j];
  const double* cA = row + 2 * K1 + 2 * K2;
  const double* cB = cA + 3;
  const double p = a + b, mu = a * b / p;
  const double Pd = (a * cA[d] + b * cB[d]) / p;
  if (d == 0) sP[4 * k] = p;
  sP[4 * k + 1 + d] = Pd;
  hermite_E<L1, L2>(p, mu, Pd - cA[d], Pd - cB[d], cA[d] - cB[d],
                    sE + (k * 3 + d) * NE);
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

// The (ab|cd) block of one quartet into w[lay.I] (row-major [NAB][NCD]),
// computed by the 32 lanes of one warp; w is the warp's shared memory.
template <int LA, int LB, int LC, int LD>
__device__ void eri4c_block(const double* rb, int Ka, int Kb, const int* mb,
                            const double* rk, int Kc, int Kd, const int* mk,
                            int RS, double* w,
                            const Eri4cSmem<LA, LB, LC, LD>& lay, int lane) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NAB = C::NAB, NCD = C::NCD, NHB = C::NHB, NHK = C::NHK;
  constexpr int NH = C::NH, L = C::L, LKET = C::LKET;
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
    if (e < 3 * K2b)
      pair_prim<LA, LB>(rb, Ka, Kb, kb, e / 3, e % 3, sEb, sPb);
    else
      pair_prim<LC, LD>(rk, Kc, Kd, kd, (e - 3 * K2b) / 3, (e - 3 * K2b) % 3,
                        sEk, sPk);
  }
  __syncwarp();
  // 2. Hermite expansions; T1 = 0
  for (int e = lane; e < K2b * NAB * NHB; e += 32)
    sEab[e] = pair_expansion<LA, LB>(rb, Ka, Kb, kb, sEb, e);
  for (int e = lane; e < K2k * NCD * NHK; e += 32)
    sEcd[e] = pair_expansion<LC, LD>(rk, Kc, Kd, kd, sEk, e);
  for (int e = lane; e < K2b * NHB * NCD; e += 32) sT1[e] = 0.0;
  __syncwarp();
  // 3. primitive quartets f = k*K2k + l in rounds of RS: Boys + R by one
  //    lane each, then T1[k][h][cd] += sum_g (-1)^|g| R_kl[h+g] Ecd[l][cd][g]
  const int nprim = K2b * K2k;
  for (int f0 = 0; f0 < nprim; f0 += RS) {
    const int nr = min(RS, nprim - f0);
    if (lane < nr) {
      const int k = (f0 + lane) / K2k, l = (f0 + lane) % K2k;
      const double p = sPb[4 * k], q = sPk[4 * l];
      const double X = sPb[4 * k + 1] - sPk[4 * l + 1];
      const double Y = sPb[4 * k + 2] - sPk[4 * l + 2];
      const double Z = sPb[4 * k + 3] - sPk[4 * l + 3];
      const double psum = p + q, alpha = p * q / psum;
      const double T = alpha * (X * X + Y * Y + Z * Z);
      const double pref = kTwoPiPow2_5 / (p * q * sqrt(psum));
      double F[L + 1];
      boys<L>(T, F);
      for (int m = 0; m <= L; ++m) F[m] *= pref;
      hermite_R<L>(alpha, X, Y, Z, F, sR + lane * NH);
    }
    __syncwarp();
    for (int s = 0; s < nr; ++s) {
      const int k = (f0 + s) / K2k, l = (f0 + s) % K2k;
      const double* Rs = sR + s * NH;
      const double* El = sEcd + l * NCD * NHK;
      double* Tk = sT1 + k * NHB * NCD;
      for (int e = lane; e < NHB * NCD; e += 32) {
        const int h = e / NCD, cd = e % NCD;
        int t, u, v;
        herm_triple(h, t, u, v);
        const double* Ec = El + cd * NHK;
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
  // 4. I[ab][cd] = sum_k sum_h Eab[k][ab][h] T1[k][h][cd]
  for (int e = lane; e < NAB * NCD; e += 32) {
    const int ab = e / NCD, cd = e % NCD;
    double acc = 0.0;
    for (int k = 0; k < K2b; ++k) {
      const double* Ek = sEab + (k * NAB + ab) * NHB;
      const double* Tk = sT1 + k * NHB * NCD + cd;
      for (int h = 0; h < NHB; ++h) acc += Ek[h] * Tk[h * NCD];
    }
    sI[e] = acc;
  }
  __syncwarp();
}

// Six-image digestion of the block sI (weight w) by the lanes of one warp:
// D blocks into sDg, then each lane owns whole outputs and adds them to
// J (= JK) and K (= JK + nbf^2) with f64 atomics.
template <int LA, int LB, int LC, int LD>
__device__ void digest_block(const double* sI, double w, const int* mb,
                             const int* mk, const double* __restrict__ D,
                             int64_t nbf, double* JK, double* sDg, int lane) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  constexpr int NA = C::NA, NB = C::NB, NC = C::NC, ND = C::ND;
  constexpr int NAB = C::NAB, NCD = C::NCD;
  const int64_t oa = mb[0], ob = mb[1], oc = mk[0], od = mk[1];
  double* Dcd = sDg;
  double* Dab = Dcd + NC * ND;
  double* Dbd = Dab + NA * NB;
  double* Dbc = Dbd + NB * ND;
  double* Dad = Dbc + NB * NC;
  double* Dac = Dad + NA * ND;
  for (int e = lane; e < C::NDG; e += 32) {
    int x = e;
    int64_t r0, c0;
    int n2;
    if (x < NC * ND) { r0 = oc; c0 = od; n2 = ND; }
    else if ((x -= NC * ND) < NA * NB) { r0 = oa; c0 = ob; n2 = NB; }
    else if ((x -= NA * NB) < NB * ND) { r0 = ob; c0 = od; n2 = ND; }
    else if ((x -= NB * ND) < NB * NC) { r0 = ob; c0 = oc; n2 = NC; }
    else if ((x -= NB * NC) < NA * ND) { r0 = oa; c0 = od; n2 = ND; }
    else { x -= NA * ND; r0 = oa; c0 = oc; n2 = NC; }
    sDg[e] = D[(r0 + x / n2) * nbf + c0 + x % n2];
  }
  __syncwarp();
  double* J = JK;
  double* K = JK + nbf * nbf;
  for (int e = lane; e < C::NOUT; e += 32) {
    int x = e;
    double s = 0.0;
    double* dst;
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
    atomicAdd(dst, w * s);
  }
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

// K4: out[q][ab*NCD + cd] = (ab|cd) of quartet (sel_bra[q], sel_ket[q]).
template <int LA, int LB, int LC, int LD>
__device__ void eri4c_body(double* sm, const double* pb, int Ka, int Kb,
                           const int* mb, const double* pk, int Kc, int Kd,
                           const int* mk, const int64_t* sel_bra,
                           const int64_t* sel_ket, int64_t n, int RS,
                           double* out, int64_t q, int warp, int lane) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  if (q >= n) return;
  const Eri4cSmem<LA, LB, LC, LD> lay(Ka * Kb, Kc * Kd, RS);
  double* w = sm + (int64_t)warp * lay.total;
  const int64_t r = sel_bra[q], c = sel_ket[q];
  eri4c_block<LA, LB, LC, LD>(pb + r * (2 * Ka + 2 * Kb + 6), Ka, Kb,
                              mb + r * kMeta, pk + c * (2 * Kc + 2 * Kd + 6),
                              Kc, Kd, mk + c * kMeta, RS, w, lay, lane);
  for (int e = lane; e < C::NAB * C::NCD; e += 32)
    out[q * (C::NAB * C::NCD) + e] = w[lay.I + e];
}

// K5: quartet t0 + t's block, digested into JK at once (list or staircase
// mode); a launch covers the n quartets t0 .. t0 + n - 1, so a split of one
// class pair's quartets over ranks is a set of launches with disjoint ranges.
template <int LA, int LB, int LC, int LD>
__device__ void eri4c_jk_body(double* sm, const double* pb, int Ka, int Kb,
                              const int* mb, const double* pk, int Kc, int Kd,
                              const int* mk, const int64_t* sel_bra,
                              const int64_t* sel_ket, const double* weight,
                              const int64_t* cum, int64_t n_bra,
                              int same_block, int64_t n, int64_t t0, int RS,
                              const double* D, int64_t nbf, double* JK,
                              int64_t t, int warp, int lane) {
  if (t >= n) return;  // past the last quartet: weight 0, nothing to add
  const Eri4cSmem<LA, LB, LC, LD> lay(Ka * Kb, Kc * Kd, RS);
  double* w = sm + (int64_t)warp * lay.total;
  int64_t r, c;
  double wt;
  decode_quartet(t0 + t, sel_bra, sel_ket, weight, cum, n_bra, same_block,
                 mb, mk, r, c, wt);
  eri4c_block<LA, LB, LC, LD>(pb + r * (2 * Ka + 2 * Kb + 6), Ka, Kb,
                              mb + r * kMeta, pk + c * (2 * Kc + 2 * Kd + 6),
                              Kc, Kd, mk + c * kMeta, RS, w, lay, lane);
  digest_block<LA, LB, LC, LD>(w + lay.I, wt, mb + r * kMeta, mk + c * kMeta,
                               D, nbf, JK, w + lay.Dg, lane);
}

// K6: the cached block I[q] of quartet q, digested into JK.
template <int LA, int LB, int LC, int LD>
__device__ void digest_jk_body(double* sm, const int* mb, const int* mk,
                               const int64_t* sel_bra, const int64_t* sel_ket,
                               const double* weight, int64_t n,
                               const double* I, const double* D, int64_t nbf,
                               double* JK, int64_t q, int warp, int lane) {
  using C = Eri4cClass<LA, LB, LC, LD>;
  if (q >= n) return;
  const DigestSmem<LA, LB, LC, LD> lay;
  double* w = sm + (int64_t)warp * lay.total;
  const double* Iq = I + q * (C::NAB * C::NCD);
  for (int e = lane; e < C::NAB * C::NCD; e += 32) w[lay.I + e] = Iq[e];
  __syncwarp();
  const int64_t r = sel_bra[q], c = sel_ket[q];
  digest_block<LA, LB, LC, LD>(w + lay.I, weight[q], mb + r * kMeta,
                               mk + c * kMeta, D, nbf, JK, w + lay.Dg, lane);
}

template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(32 * kEri4cMaxWarps, 4)
eri4c_kernel(const double* __restrict__ pb, int Ka, int Kb,
             const int* __restrict__ mb, const double* __restrict__ pk,
             int Kc, int Kd, const int* __restrict__ mk,
             const int64_t* __restrict__ sel_bra,
             const int64_t* __restrict__ sel_ket, int64_t n, int RS,
             double* __restrict__ out) {
  extern __shared__ double sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  eri4c_body<LA, LB, LC, LD>(sm, pb, Ka, Kb, mb, pk, Kc, Kd, mk, sel_bra,
                             sel_ket, n, RS, out, q, warp, lane);
}

template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(32 * kEri4cMaxWarps, 4)
eri4c_jk_kernel(const double* __restrict__ pb, int Ka, int Kb,
                const int* __restrict__ mb, const double* __restrict__ pk,
                int Kc, int Kd, const int* __restrict__ mk,
                const int64_t* __restrict__ sel_bra,
                const int64_t* __restrict__ sel_ket,
                const double* __restrict__ weight,
                const int64_t* __restrict__ cum, int64_t n_bra,
                int same_block, int64_t n, int64_t t0, int RS,
                const double* __restrict__ D, int64_t nbf, double* JK) {
  extern __shared__ double sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  eri4c_jk_body<LA, LB, LC, LD>(sm, pb, Ka, Kb, mb, pk, Kc, Kd, mk, sel_bra,
                                sel_ket, weight, cum, n_bra, same_block, n,
                                t0, RS, D, nbf, JK, t, warp, lane);
}

template <int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(32 * kEri4cMaxWarps)
digest_jk_kernel(const int* __restrict__ mb, const int* __restrict__ mk,
                 const int64_t* __restrict__ sel_bra,
                 const int64_t* __restrict__ sel_ket,
                 const double* __restrict__ weight, int64_t n,
                 const double* __restrict__ I, const double* __restrict__ D,
                 int64_t nbf, double* JK) {
  extern __shared__ double sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  digest_jk_body<LA, LB, LC, LD>(sm, mb, mk, sel_bra, sel_ket, weight, n, I,
                                 D, nbf, JK, q, warp, lane);
}

}  // namespace jc
