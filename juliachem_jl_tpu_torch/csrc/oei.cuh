// Kernel K9: the one-electron integrals S, T and V of one (la, lb) class
// of unique shell pairs, stored straight into the nbf x nbf matrices.
//
// Replaces juliachem_jl_tpu/ops/oei.py::_stv_block (:42) with
// overlap_kinetic_nuclear (:137), which the JAX package runs on host numpy
// (and the port's plain torch version, ops/oei.py, as chunked tensor
// programs over [pairs, primitive pairs, atoms, Hermite indices]).  Same
// McMurchie-Davidson math:
//   S_ab = sum_k (pi/p)^1.5 c_k Ex(ia,jb,0) Ey Ez,
//   T_ab from the ket raised by 2 (K(i,j) = -2b^2 E(i,j+2) + b(2j+1)
//        E(i,j) - j(j-1)/2 E(i,j-2), one dimension at a time),
//   V_ab = sum_k c_k sum_h Eab[ab,h] sum_C (-2 pi/p) Z_C R_h(p, P - C),
// both scaled by the axial normalisation of the component pair.
//
// Design.  A group of G lanes (G = 8, 16 or 32, a power of two within a
// warp, a launch argument: ops/kernels.py::stv_group picks it by the
// number of nuclei) owns one shell pair:
//   1. it walks only the pair's live primitive pairs (both coefficients
//      nonzero, packed by the host: ops/oei.py::stv_tables), one at a time,
//      every lane of the warp the same number of times (the most of its
//      groups), so that the shuffles below see the whole warp;
//   2. the nuclear sum stays in the kernel: each lane takes the atoms C =
//      lane, lane + G, ..., evaluates Boys (boys<L, true>, the divide-free
//      form K1, K4 and K5 inline) and R (hermite_R_lane) in registers and
//      adds Z_C R_h into its own sum; a butterfly of shuffles gives every
//      lane of the group the pair's sum over all atoms, so no [pairs,
//      atoms, nherm] tensor exists anywhere;
//   3. three lanes build the pair's three 1-D E tables (hermite_E, ket to
//      lb + 2) in the group's shared memory beside the summed R, and each
//      lane contracts the components ab = lane, lane + G, ... of S, T and V
//      into registers;
//   4. after the last primitive pair the lane stores its components with
//      plain stores, the block and (ish != jsh) its transpose: the unique
//      pairs cover nbf x nbf once, so each element has one writer and no
//      atomics or zero fill are needed.
// A warp whose lanes all take one side of the Boys branch (T <= 35 series,
// asymptotic above) runs only that side; a warp split between them runs
// both, one after the other.  Bound on the card by the FP64 pipe: the
// asymptotic Boys branch (exp, sqrt, divide) and R of every (live primitive
// pair, nucleus) item, and the series of the warps that any lane sends
// there (PERF.md §6).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "boys.cuh"
#include "mcmurchie.cuh"

namespace jc {

constexpr int kStvThreads = 128;
constexpr int kStvMinGroup = 8;  // the smallest G: sizes the accumulators
constexpr unsigned kStvFullMask = 0xffffffffu;
constexpr double kStvPi = 3.141592653589793;
// primitive rows [np][3]: a, b, ca cb; pair rows [n][6]: A, B; meta rows
// [n][kStvMeta]: off_a, off_b, ish == jsh, first live primitive pair, count
constexpr int kStvMeta = 5;

template <int LA, int LB>
struct StvClass {
  static constexpr int L = LA + LB, NH = nherm(L);
  static constexpr int NA = ncart(LA), NB = ncart(LB), NAB = NA * NB;
  // hermite_E<LA, LB + 2>'s table of one dimension: E[i][j][t]
  static constexpr int JB = LB + 3, NT = LA + LB + 3;
  static constexpr int NE = (LA + 1) * JB * NT;
  // a group's shared memory: the three E tables, then the summed R
  static constexpr int kGroupDoubles = 3 * NE + NH;
};

template <int LA, int LB, int NTH = kStvThreads>
__host__ __device__ constexpr size_t stv_smem_bytes(int G) {
  return sizeof(double) * (NTH / G) * StvClass<LA, LB>::kGroupDoubles;
}

// x[d] for a runtime d in 0..2, x kept in registers
__device__ __forceinline__ double pick3(const double* x, int d) {
  return d == 0 ? x[0] : (d == 1 ? x[1] : x[2]);
}

// the most of v over the warp (every lane calls it)
__device__ __forceinline__ int stv_warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kStvFullMask, v, o));
  return v;
}

// G: MING, .., 32, a power of two (the launch checks it); NTH threads a
// block.  The package's instances take NTH = kStvThreads, MING =
// kStvMinGroup; tools/stv_candidates.py times a thread a pair (NTH = 32,
// MING = 1) against them.
template <int LA, int LB, int NTH = kStvThreads, int MING = kStvMinGroup>
__global__ void __launch_bounds__(NTH)
    stv_kernel(const double* __restrict__ prim, const double* __restrict__ pair,
               const int* __restrict__ meta, long long n,
               const double* __restrict__ atoms, int natom,
               double* __restrict__ S, double* __restrict__ T,
               double* __restrict__ V, long long nbf, int G) {
  using C = StvClass<LA, LB>;
  constexpr int L = C::L, NH = C::NH, NE = C::NE, JB = C::JB, NT = C::NT;
  constexpr int NB = C::NB, NAB = C::NAB;
  constexpr int SLOTS = (NAB + MING - 1) / MING;
  extern __shared__ double sm[];
  const int tid = threadIdx.x, gl = tid & (G - 1), grp = tid / G;
  double* sE = sm + grp * C::kGroupDoubles;  // [3][NE]
  double* sR = sE + 3 * NE;                  // [NH]
  const long long s = (long long)blockIdx.x * (NTH / G) + grp;
  const bool valid = s < n;
  const int* m = meta + (valid ? s : 0) * kStvMeta;
  const int p0 = valid ? m[3] : 0, cnt = valid ? m[4] : 0;
  double A[3], B[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    A[d] = valid ? pair[6 * s + d] : 0.0;
    B[d] = valid ? pair[6 * s + 3 + d] : 0.0;
  }
  double sacc[SLOTS], tacc[SLOTS], vacc[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) sacc[k] = tacc[k] = vacc[k] = 0.0;

  const int kmax = stv_warp_max(cnt);
  for (int k = 0; k < kmax; ++k) {
    const bool live = k < cnt;
    const double* q = prim + 3 * (long long)(p0 + (live ? k : 0));
    const double a = live ? q[0] : 1.0, b = live ? q[1] : 1.0;
    const double cc = live ? q[2] : 0.0;
    const double p = a + b, rp = 1.0 / p;
    double P[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) P[d] = (a * A[d] + b * B[d]) * rp;

    // 2. this lane's share of sum_C (-2 pi / p) Z_C R_h(p, P - C), summed
    //    over the group's lanes (every lane of the warp shuffles)
    double racc[NH];
    static_for<NH>([&](auto h) { racc[decltype(h)::value] = 0.0; });
    if (live) {
      const double scale = -2.0 * kStvPi * rp;
      for (int c = gl; c < natom; c += G) {
        const double* at = atoms + 4 * c;
        const double X = P[0] - at[0], Y = P[1] - at[1], Z = P[2] - at[2];
        double F[L + 1], R[NH];
        boys<L, true>(p * (X * X + Y * Y + Z * Z), F);
        const double w = scale * at[3];
        static_for<L + 1>([&](auto i) { F[decltype(i)::value] *= w; });
        hermite_R_lane<L>(p, X, Y, Z, F, R);
        static_for<NH>([&](auto h) {
          racc[decltype(h)::value] += R[decltype(h)::value];
        });
      }
    }
    for (int o = G / 2; o > 0; o >>= 1)
      static_for<NH>([&](auto h) {
        constexpr int i = decltype(h)::value;
        racc[i] += __shfl_xor_sync(kStvFullMask, racc[i], o);
      });
    // 3. the E tables and the summed R into the group's shared memory
    if (live) {
      for (int d = gl; d < 3; d += G) {
        const double Pd = pick3(P, d), Ad = pick3(A, d), Bd = pick3(B, d);
        hermite_E<LA, LB + 2>(p, a * b * rp, Pd - Ad, Pd - Bd, Ad - Bd,
                              sE + d * NE);
      }
      static_for<NH>([&](auto h) {
        constexpr int i = decltype(h)::value;
        if ((i & (G - 1)) == gl) sR[i] = racc[i];
      });
    }
    __syncwarp();
    if (live) {
      const double rt = kStvPi * rp, pref = rt * sqrt(rt) * cc;
      const double* Ex = sE;
      const double* Ey = sE + NE;
      const double* Ez = sE + 2 * NE;
#pragma unroll
      for (int k2 = 0; k2 < SLOTS; ++k2) {
        const int ab = gl + k2 * G;
        if (ab < NAB) {
          const int ia = ab / NB, ib = ab - ia * NB;
          int ax, ay, az, bx, by, bz;
          cart_comp(LA, ia, ax, ay, az);
          cart_comp(LB, ib, bx, by, bz);
          const double* ex_ = Ex + (ax * JB + bx) * NT;
          const double* ey_ = Ey + (ay * JB + by) * NT;
          const double* ez_ = Ez + (az * JB + bz) * NT;
          const double ex = ex_[0], ey = ey_[0], ez = ez_[0];
          // K(i,j) from E(i,j+2), E(i,j), E(i,j-2) at t = 0
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
                v += exy * ez_[w] * sR[herm_index(t, u, w)];
            }
          vacc[k2] += cc * v;
        }
      }
    }
    __syncwarp();
  }

  // 4. plain stores: the block, and its transpose off the diagonal
  if (!valid) return;
  const long long oa = m[0], ob = m[1];
  const bool diag = m[2] != 0;
#pragma unroll
  for (int k2 = 0; k2 < SLOTS; ++k2) {
    const int ab = gl + k2 * G;
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
