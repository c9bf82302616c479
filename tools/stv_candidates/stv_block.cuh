// A candidate design of kernel K9 (csrc/oei.cuh) for the f and g classes,
// timed against K9 by tools/stv_candidates.py and not on the package's
// path: one block of kStvBlockThreads threads a unique shell pair, the
// nuclear sum's R in shared memory across the block.
//
// For each live primitive pair of the shell pair:
//   1. three threads build the 1-D E tables (hermite_E, ket to lb + 2), as
//      K9's group does;
//   2. the nuclei in chunks of kStvBlockNuclei: a thread a nucleus
//      evaluates Boys (boys<L, true>) and the top entry (-2p)^n F_n w_C of
//      each level n of R (w_C = -2 pi Z_C / p), then block_r_levels (the R
//      recursion of K4/K5's and K1's block routes, csrc/eri4c.cuh) builds
//      R of the chunk level by level over the whole block, one barrier a
//      level, and the block adds the chunk's R over its nuclei into the
//      pair's summed R;
//   3. the threads contract the component pairs ab = tid, tid + NT, ...
//      of S, T and V into registers, as K9's lanes do.
// After the last primitive pair the same plain stores as K9: the block,
// and (ish != jsh) its transpose.  So R never sits in a thread's
// registers or local memory (K9's f and g instances spill there), and the
// contraction has 4x K9's widest group of threads; the price is a barrier
// a level of R for every (primitive pair, chunk of nuclei).
#pragma once

#include "eri4c.cuh"
#include "oei.cuh"

namespace jc {

constexpr int kStvBlockThreads = 128;
constexpr int kStvBlockNuclei = 32;

// shared memory of one block, in doubles: the E tables, the summed R, the
// chunk's Boys values (sG, [nuclei][L + 1]) and P - C (sQ, [nuclei][4]),
// its even and odd levels of R (sR, sRs), then the Hermite triples (ints)
template <int LA, int LB>
struct StvBlockSmem {
  using C = StvClass<LA, LB>;
  static constexpr int L = C::L, NH = C::NH, NC = kStvBlockNuclei;
  static_assert(L >= 1, "the block candidate is for the f and g classes");
  static constexpr int NHS = nherm(L - 1);
  static constexpr int E = 0, Rsum = 3 * C::NE, G = Rsum + NH,
                       Q = G + NC * (L + 1), R = Q + 4 * NC, Rs = R + NC * NH,
                       Tab = Rs + NC * NHS, doubles = Tab + (NH + 1) / 2;
  static constexpr size_t bytes = sizeof(double) * doubles;
};

template <int LA, int LB>
__global__ void __launch_bounds__(kStvBlockThreads)
    stv_block_kernel(const double* __restrict__ prim,
                     const double* __restrict__ pair,
                     const int* __restrict__ meta, long long n,
                     const double* __restrict__ atoms, int natom,
                     double* __restrict__ S, double* __restrict__ T,
                     double* __restrict__ V, long long nbf) {
  using C = StvClass<LA, LB>;
  using Y = StvBlockSmem<LA, LB>;
  constexpr int L = C::L, NH = C::NH, NE = C::NE, JB = C::JB, NT = C::NT;
  constexpr int NB = C::NB, NAB = C::NAB, NTH = kStvBlockThreads;
  constexpr int NC = kStvBlockNuclei;
  constexpr int SLOTS = (NAB + NTH - 1) / NTH;
  extern __shared__ double sm[];
  double* sE = sm + Y::E;
  double* sRsum = sm + Y::Rsum;
  double* sG = sm + Y::G;
  double* sQ = sm + Y::Q;
  double* sR = sm + Y::R;
  double* sRs = sm + Y::Rs;
  int* htab = reinterpret_cast<int*>(sm + Y::Tab);
  const int tid = threadIdx.x;
  const long long s = blockIdx.x;
  if (s >= n) return;
  const int* m = meta + s * kStvMeta;
  const int p0 = m[3], cnt = m[4];
  double A[3], B[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    A[d] = pair[6 * s + d];
    B[d] = pair[6 * s + 3 + d];
  }
  for (int e = tid; e < NH; e += NTH) {
    int t, u, v;
    herm_triple(e, t, u, v);
    htab[e] = t | (u << 8) | (v << 16);
  }
  double sacc[SLOTS], tacc[SLOTS], vacc[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) sacc[k] = tacc[k] = vacc[k] = 0.0;

  for (int k = 0; k < cnt; ++k) {
    const double* q = prim + 3 * (long long)(p0 + k);
    const double a = q[0], b = q[1], cc = q[2];
    const double p = a + b, rp = 1.0 / p;
    double P[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) P[d] = (a * A[d] + b * B[d]) * rp;
    // 1. the E tables; the summed R starts at zero
    if (tid < 3) {
      const double Pd = pick3(P, tid), Ad = pick3(A, tid), Bd = pick3(B, tid);
      hermite_E<LA, LB + 2>(p, a * b * rp, Pd - Ad, Pd - Bd, Ad - Bd,
                            sE + tid * NE);
    }
    for (int h = tid; h < NH; h += NTH) sRsum[h] = 0.0;
    // 2. sum_C (-2 pi / p) Z_C R_h(p, P - C), a chunk of nuclei at a time
    const double scale = -2.0 * kStvPi * rp;
    for (int c0 = 0; c0 < natom; c0 += NC) {
      const int nc = min(NC, natom - c0);
      if (tid < nc) {
        const double* at = atoms + 4 * (c0 + tid);
        const double X = P[0] - at[0], Yc = P[1] - at[1], Z = P[2] - at[2];
        double F[L + 1];
        boys<L, true>(p * (X * X + Yc * Yc + Z * Z), F);
        double pw = scale * at[3];
        for (int i = 0; i <= L; ++i) {
          sG[tid * (L + 1) + i] = pw * F[i];
          pw *= -2.0 * p;
        }
        sQ[4 * tid + 1] = X;
        sQ[4 * tid + 2] = Yc;
        sQ[4 * tid + 3] = Z;
      }
      __syncthreads();
      block_r_levels<L, NTH>(sR, sRs, sG, sQ, htab, nc, tid);
      for (int h = tid; h < NH; h += NTH) {
        double v = 0.0;
        for (int c = 0; c < nc; ++c) v += sR[c * NH + h];
        sRsum[h] += v;
      }
      __syncthreads();
    }
    // 3. the contraction of this primitive pair
    const double rt = kStvPi * rp, pref = rt * sqrt(rt) * cc;
    const double* Ex = sE;
    const double* Ey = sE + NE;
    const double* Ez = sE + 2 * NE;
#pragma unroll
    for (int k2 = 0; k2 < SLOTS; ++k2) {
      const int ab = tid + k2 * NTH;
      if (ab < NAB) {
        const int ia = ab / NB, ib = ab - ia * NB;
        int ax, ay, az, bx, by, bz;
        cart_comp(LA, ia, ax, ay, az);
        cart_comp(LB, ib, bx, by, bz);
        const double* ex_ = Ex + (ax * JB + bx) * NT;
        const double* ey_ = Ey + (ay * JB + by) * NT;
        const double* ez_ = Ez + (az * JB + bz) * NT;
        const double ex = ex_[0], ey = ey_[0], ez = ez_[0];
        auto kin = [&](const double* e, int j) {
          double v = -2.0 * b * b * e[2 * NT] + b * (2.0 * j + 1.0) * e[0];
          if (j >= 2) v -= 0.5 * j * (j - 1.0) * e[-2 * NT];
          return v;
        };
        const double kx = kin(ex_, bx), ky = kin(ey_, by), kz = kin(ez_, bz);
        sacc[k2] += pref * (ex * ey * ez);
        tacc[k2] += pref * (kx * ey * ez + ex * ky * ez + ex * ey * kz);
        double v = 0.0;
        for (int t = 0; t <= ax + bx; ++t)
          for (int u = 0; u <= ay + by; ++u) {
            const double exy = ex_[t] * ey_[u];
            for (int w = 0; w <= az + bz; ++w)
              v += exy * ez_[w] * sRsum[herm_index(t, u, w)];
          }
        vacc[k2] += cc * v;
      }
    }
    __syncthreads();
  }

  const long long oa = m[0], ob = m[1];
  const bool diag = m[2] != 0;
#pragma unroll
  for (int k2 = 0; k2 < SLOTS; ++k2) {
    const int ab = tid + k2 * NTH;
    if (ab < NAB) {
      const int ia = ab / NB, ib = ab - ia * NB;
      int ax, ay, az, bx, by, bz;
      cart_comp(LA, ia, ax, ay, az);
      cart_comp(LB, ib, bx, by, bz);
      const double nrm = axial(LA, ax, ay, az) * axial(LB, bx, by, bz);
      const long long i = oa + ia, j = ob + ib;
      S[i * nbf + j] = sacc[k2] * nrm;
      T[i * nbf + j] = tacc[k2] * nrm;
      V[i * nbf + j] = vacc[k2] * nrm;
      if (!diag) {
        S[j * nbf + i] = sacc[k2] * nrm;
        T[j * nbf + i] = tacc[k2] * nrm;
        V[j * nbf + i] = vacc[k2] * nrm;
      }
    }
  }
}

}  // namespace jc
