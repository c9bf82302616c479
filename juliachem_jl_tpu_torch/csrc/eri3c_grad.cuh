// Kernel K11: the two-electron part of the density-fitted nuclear
// gradient, contracted as it is computed.  Two instances of one body:
//
//   3-center: grad += 2 sum_{A, pq} gamma_{A,pq} d(A|pq)/dR
//     over every (aux shell, unique primary pair) of one class (lA | lp lq),
//     unscreened, each pair weighted by (2 - delta_pq);
//   2-center: grad -= sum_{AB} Omega_AB dM_AB/dR
//     over the unordered pairs of aux shells of one class pair (lA | lB),
//     lA <= lB, on two different atoms (a pair on one atom adds nothing:
//     dM/dA = -dM/dB), each weighted by 2.
//
// Replaces juliachem_jl_tpu/ops/eri_grad.py::_eri_grad_kernel (:52) in its
// density-fitted use, df_two_electron_gradient (:247, the 3-center term's
// loop and the metric term's), which the JAX package runs on host numpy
// (and the port's plain torch version, ops/eri_grad.py, as batches of
// [N, 3, nab, ncd] derivative blocks gathered against gamma).
//
// Math (McMurchie-Davidson, as ops/eri_grad.py::eri_grad_class with the
// aux shell the bra and a unit s partner of exponent 0): for an aux
// primitive (alpha, centre A) and a live primitive pair (a, b, P) of the
// ket, p = a + b, s = alpha + p, rho = alpha p / s,
//   R = R_{tuv}(rho, A - P) to L + 1 (L = lA + lp + lq) with
//       F_m(rho |A - P|^2) 2 pi^2.5 / (alpha p sqrt(s)),
//   V[a][h']    = sum_pq g_{a,pq} Ek[pq, h'],           h' in herm(lp + lq),
//   V_d[a][h']  = sum_pq g_{a,pq} dEk_d[pq, h'],        h' in herm(lp + lq + 1),
//   fA_d = sum_a sum_h' (-1)^|h'| V[a][h'] sum_h dEA_d[a, h] R[h + h'],
//   fC_d = sum_a sum_h' (-1)^|h'| V_d[a][h'] sum_h EA[a, h] R[h + h'],
// with g the gamma (or Omega) block times the axial norms, EA the aux
// primitive's expansion (one 1-D table: its centre is P), dEA_d = 2 alpha
// EA[a + e_d] - a_d EA[a - e_d], dEk_d = 2a Ek[p + e_d, q] - p_d Ek[p - e_d,
// q].  fA goes to the aux shell's atom, fC to p's, -(fA + fC) to q's (the
// unit partner's derivative vanishes, dD = -(dA + dB + dC)); in the
// 2-center instance fC = -fA goes to the second aux shell's atom
// (translational invariance of a 2-center integral).
//
// Design: one (aux shell, ket pair) item a thread, the items of a class
// laid out aux shell major, so that a warp's lanes take consecutive ket
// pairs of one aux shell (sorted by live primitive count, then by (p, q):
// ops/oei.py::stv_table): they walk their primitive products in step and
// read gamma[a, p, q..] near each other.  Boys (boys<L + 1, true>) and R
// (hermite_R_lane in registers up to kEri3gLaneL, hermite_R in a local
// array above) once a primitive product; the contraction runs an aux
// component at a time, so a thread holds V and V_d of one component only.
// A thread's fA is summed over its warp where the warp's items share the
// aux atom (one shared atomic a warp, not 32); every other sum is a shared
// atomic into the block's [natom][3] accumulator, which goes to the output
// with natom * 3 global atomics after the block's last item (grid-stride).
// Nothing of size [items, 3, nab, ncd] exists: the function reads gamma,
// the packed tables and writes [natom, 3].  The 3-center instance reads
// each gamma element once; its FP64 work (Boys, R and the contraction of
// every primitive product) binds it on the card (PERF.md §6).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "boys.cuh"
#include "mcmurchie.cuh"
#include "oei_grad.cuh"

namespace jc {

constexpr int kEri3gThreads = 128;
// R in registers (compile-time indices) up to this Hermite order
constexpr int kEri3gLaneL = 4;

template <int LA, int LP, int LQ>
struct Eri3gClass {
  static constexpr int LK = LP + LQ, L = LA + LK, LG = L + 1;
  static constexpr int NA = ncart(LA), NP = ncart(LP), NQ = ncart(LQ);
  static constexpr int NHK = nherm(LK), NHK1 = nherm(LK + 1), NHG = nherm(LG);
  // the ket pair's 1-D tables hermite_E<LP + 1, LQ>: E[i][j][t]
  static constexpr int PJ = LQ + 1, PT = LP + LQ + 2, PNE = (LP + 2) * PJ * PT;
  // the aux primitive's 1-D table hermite_E<LA + 1, 0>: E[i][0][t]
  static constexpr int AT = LA + 2, ANE = (LA + 2) * AT;
};

// s_a, s_p: the row strides of gamma's first two indices (the third is
// contiguous): gamma [A, nbf, nbf] takes (nbf^2, nbf), Omega [A, A] (A, 1)
// with the unit partner's offset 0.  weight: 2 (3-center) or -2 (metric).
template <int LA, int LP, int LQ, bool kMetric>
__global__ void __launch_bounds__(kEri3gThreads)
    eri3c_grad_kernel(const double* __restrict__ aprim,
                      const double* __restrict__ apair,
                      const int* __restrict__ ameta, long long na,
                      const double* __restrict__ pprim,
                      const double* __restrict__ ppair,
                      const int* __restrict__ pmeta, long long np,
                      const double* __restrict__ gam, long long s_a,
                      long long s_p, double weight, double* __restrict__ grad,
                      int natom) {
  using C = Eri3gClass<LA, LP, LQ>;
  constexpr int LK = C::LK, LG = C::LG, NA = C::NA, NP = C::NP, NQ = C::NQ;
  constexpr int NHK = C::NHK, NHK1 = C::NHK1, NHG = C::NHG;
  constexpr int PJ = C::PJ, PT = C::PT, PNE = C::PNE, AT = C::AT;
  static_assert(!kMetric || LQ == 0, "the metric's ket is an aux shell");
  extern __shared__ double acc[];  // [natom][3]
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 3 * natom; i += kEri3gThreads) acc[i] = 0.0;
  __syncthreads();

  const long long total = na * np;
  const long long stride = (long long)gridDim.x * kEri3gThreads;
  const long long rounds = (total + stride - 1) / stride;
  for (long long it = 0; it < rounds; ++it) {
    const long long item = it * stride + (long long)blockIdx.x * kEri3gThreads
                           + tid;
    const bool valid = item < total;
    const long long ia = valid ? item / np : 0, ip = valid ? item % np : 0;
    const int* ma = ameta + ia * kGradMeta;
    const int* mp = pmeta + ip * kGradMeta;
    const int atA = valid ? ma[5] : -1, atP = valid ? mp[5] : -1;
    const int atQ = valid ? mp[6] : -1;
    double fA[3] = {0.0, 0.0, 0.0}, fC[3] = {0.0, 0.0, 0.0};
    bool work = valid;
    if constexpr (kMetric) work = work && atA != atP && !(LA == LP && ia >= ip);
    if (work) {
      const long long ga = ma[0], gp = mp[0], gq = mp[1];
      const double w = kMetric ? weight : weight * (mp[2] ? 1.0 : 2.0);
      double A[3], Pc[3], Qc[3];
      for (int d = 0; d < 3; ++d) {
        A[d] = apair[6 * ia + d];
        Pc[d] = ppair[6 * ip + d];
        Qc[d] = ppair[6 * ip + 3 + d];
      }
      for (int ka = 0; ka < ma[4]; ++ka) {
        const double* qa = aprim + 3 * (long long)(ma[3] + ka);
        const double alpha = qa[0], ca = qa[2];
        double EA[C::ANE];  // EA[i][t], the same for x, y and z
        hermite_E<LA + 1, 0>(alpha, 0.0, 0.0, 0.0, 0.0, EA);
        for (int kp = 0; kp < mp[4]; ++kp) {
          const double* qp = pprim + 3 * (long long)(mp[3] + kp);
          const double a = qp[0], b = qp[1], cc = qp[2];
          const double p = a + b, rp = 1.0 / p, s = alpha + p;
          const double rho = alpha * p / s;
          double P[3], PQ[3];
          double E[3][PNE];
          for (int d = 0; d < 3; ++d) {
            P[d] = (a * Pc[d] + b * Qc[d]) * rp;
            PQ[d] = A[d] - P[d];
            hermite_E<LP + 1, LQ>(p, a * b * rp, P[d] - Pc[d], P[d] - Qc[d],
                                  Pc[d] - Qc[d], E[d]);
          }
          double F[LG + 1], R[NHG];
          boys<LG, true>(rho * (PQ[0] * PQ[0] + PQ[1] * PQ[1] + PQ[2] * PQ[2]),
                         F);
          const double pref = kTwoPiPow2_5 / (alpha * p * sqrt(s));
          for (int m = 0; m <= LG; ++m) F[m] *= pref;
          if constexpr (LG <= kEri3gLaneL)
            hermite_R_lane<LG>(rho, PQ[0], PQ[1], PQ[2], F, R);
          else
            hermite_R<LG>(rho, PQ[0], PQ[1], PQ[2], F, R);
          const double c0 = w * ca * cc;
          for (int a_ = 0; a_ < NA; ++a_) {
            int ca3[3];
            cart_comp(LA, a_, ca3[0], ca3[1], ca3[2]);
            const double nA = axial(LA, ca3[0], ca3[1], ca3[2]);
            // V (herm(LK)) and V_d (herm(LK + 1)) of this aux component
            double V[NHK], Vd[kMetric ? 1 : 3][kMetric ? 1 : NHK1];
            for (int h = 0; h < NHK; ++h) V[h] = 0.0;
            if constexpr (!kMetric)
              for (int d = 0; d < 3; ++d)
                for (int h = 0; h < NHK1; ++h) Vd[d][h] = 0.0;
            for (int p_ = 0; p_ < NP; ++p_) {
              int cp[3];
              cart_comp(LP, p_, cp[0], cp[1], cp[2]);
              const double nP = nA * axial(LP, cp[0], cp[1], cp[2]);
              for (int q_ = 0; q_ < NQ; ++q_) {
                int cq[3];
                cart_comp(LQ, q_, cq[0], cq[1], cq[2]);
                const double g = gam[(ga + a_) * s_a + (gp + p_) * s_p + gq
                                     + q_] * nP * axial(LQ, cq[0], cq[1], cq[2]);
                if (g == 0.0) continue;
                const double* ex = E[0] + (cp[0] * PJ + cq[0]) * PT;
                const double* ey = E[1] + (cp[1] * PJ + cq[1]) * PT;
                const double* ez = E[2] + (cp[2] * PJ + cq[2]) * PT;
                const int nx = cp[0] + cq[0], ny = cp[1] + cq[1];
                const int nz = cp[2] + cq[2];
                for (int t = 0; t <= nx; ++t)
                  for (int u = 0; u <= ny; ++u) {
                    const double gxy = g * ex[t] * ey[u];
                    for (int v = 0; v <= nz; ++v)
                      V[herm_index(t, u, v)] += gxy * ez[v];
                  }
                if constexpr (!kMetric)
                  for (int d = 0; d < 3; ++d) {
                    // dEk_d of this component along d, t_d <= n_d + 1
                    const double* Ed = E[d];
                    const int i = cp[d], j = cq[d];
                    double x[PT];
                    for (int t = 0; t <= i + j + 1; ++t) {
                      x[t] = 2.0 * a * Ed[((i + 1) * PJ + j) * PT + t];
                      if (i > 0) x[t] -= i * Ed[((i - 1) * PJ + j) * PT + t];
                    }
                    const double* r[3] = {ex, ey, ez};
                    int n[3] = {nx, ny, nz};
                    r[d] = x;
                    n[d] += 1;
                    for (int t = 0; t <= n[0]; ++t)
                      for (int u = 0; u <= n[1]; ++u) {
                        const double gxy = g * r[0][t] * r[1][u];
                        for (int v = 0; v <= n[2]; ++v)
                          Vd[d][herm_index(t, u, v)] += gxy * r[2][v];
                      }
                  }
              }
            }
            // the aux side: EA and dEA_d of this component, per dimension
            double ea[3][AT], da[3][AT];
            for (int d = 0; d < 3; ++d) {
              const int i = ca3[d];
              for (int t = 0; t < AT; ++t) {
                ea[d][t] = t <= i ? EA[i * AT + t] : 0.0;
                da[d][t] = 2.0 * alpha * EA[(i + 1) * AT + t];
                if (i > 0 && t <= i - 1) da[d][t] -= i * EA[(i - 1) * AT + t];
              }
            }
            const int ix = ca3[0] + 1, iy = ca3[1] + 1, iz = ca3[2] + 1;
            // fA_d: sum_h' (-1)^|h'| V[h'] sum_h dEA_d[h] R[h + h']
            int h = 0;
            for (int sl = 0; sl <= LK; ++sl)
              for (int t = sl; t >= 0; --t)
                for (int u = sl - t; u >= 0; --u, ++h) {
                  const int v = sl - t - u;
                  const double x = (sl & 1) ? -V[h] : V[h];
                  if (x == 0.0) continue;
                  fA[0] += c0 * x * herm_dot(da[0], ix + 1, ea[1], iy, ea[2],
                                             iz, R, t, u, v);
                  fA[1] += c0 * x * herm_dot(ea[0], ix, da[1], iy + 1, ea[2],
                                             iz, R, t, u, v);
                  fA[2] += c0 * x * herm_dot(ea[0], ix, ea[1], iy, da[2],
                                             iz + 1, R, t, u, v);
                }
            if constexpr (!kMetric) {
              // fC_d: sum_h' (-1)^|h'| V_d[h'] sum_h EA[h] R[h + h']
              h = 0;
              for (int sl = 0; sl <= LK + 1; ++sl)
                for (int t = sl; t >= 0; --t)
                  for (int u = sl - t; u >= 0; --u, ++h) {
                    const int v = sl - t - u;
                    const double sg = (sl & 1) ? -c0 : c0;
                    if (Vd[0][h] == 0.0 && Vd[1][h] == 0.0 && Vd[2][h] == 0.0)
                      continue;
                    const double e = herm_dot(ea[0], ix, ea[1], iy, ea[2], iz,
                                              R, t, u, v);
                    for (int d = 0; d < 3; ++d) fC[d] += sg * Vd[d][h] * e;
                  }
            }
          }
        }
      }
    }
    // fC and the unit partner's -(fA + fC) (the metric: -fA) from each
    // lane's own fA, then fA to the aux atom: summed over the warp where
    // its items share it
    if (work) {
      for (int d = 0; d < 3; ++d) {
        if constexpr (kMetric) {
          atomicAdd(acc + 3 * atP + d, -fA[d]);
        } else {
          atomicAdd(acc + 3 * atP + d, fC[d]);
          atomicAdd(acc + 3 * atQ + d, -(fA[d] + fC[d]));
        }
      }
    }
    const int a0 = __shfl_sync(0xffffffffu, atA, 0);
    if (!__any_sync(0xffffffffu, valid && atA != a0)) {
      for (int o = 16; o > 0; o >>= 1)
        for (int d = 0; d < 3; ++d)
          fA[d] += __shfl_xor_sync(0xffffffffu, fA[d], o);
      if (lane == 0 && a0 >= 0)
        for (int d = 0; d < 3; ++d) atomicAdd(acc + 3 * a0 + d, fA[d]);
    } else if (work) {
      for (int d = 0; d < 3; ++d) atomicAdd(acc + 3 * atA + d, fA[d]);
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * natom; i += kEri3gThreads)
    if (acc[i] != 0.0) atomicAdd(grad + i, acc[i]);
}

}  // namespace jc
