// Kernel K10: the one-electron part of the nuclear gradient of one (la, lb)
// class of unique shell pairs, contracted as it is computed:
//
//   grad_k += sum_pq D_pq (dT + dV)_pq / dR_k - sum_pq W_pq dS_pq / dR_k
//
// Replaces juliachem_jl_tpu/ops/oei_grad.py::_stv_grad_kernel (:66) with
// its assembly stv_gradients (:195) and the contraction of
// models/gradient.py::one_electron_gradient, which the JAX package runs on
// host numpy (and the port's plain torch version, ops/oei_grad.py, as
// chunked tensor programs that write three [natom, 3, nbf, nbf] matrices).
// Same McMurchie-Davidson math as K9 (oei.cuh) with the operator identity
//   d/dAx phi_i = 2a phi_{i+1} - i phi_{i-1}
// inside the primitive sum: S and T from the E tables with the bra raised
// by 1 and the ket by 2 (dS/dB = -dS/dA, dT/dB = -dT/dA); dV/dA and dV/dB
// from the bra- and ket-shifted expansions against sum_C Z_C R (to L + 1);
// the Hellmann-Feynman term dV/dC from the shifted R of nucleus C alone:
//   dV_ab/dC_d = -sum_h Eab[ab, h] R^{(C)}[h + e_d].
//
// Design: K9's body, with the matrices replaced by their contraction.
//   1. A group of G lanes (G = 8, 16 or 32: ops/kernels.py::stv_group, by
//      the number of nuclei) owns one shell pair at a time; the blocks
//      walk the pairs grid-stride, every lane of a warp the same number of
//      pairs and, for each, of live primitive pairs (the most of its
//      groups: ops/oei.py::stv_table packs them, sorted by count), so that
//      the shuffles below see the whole warp.
//   2. The pair's D and W blocks are read once into the group's shared
//      memory, each element weighted by (2 - delta_ab) (the mirror image of
//      an off-diagonal pair) and the axial normalisation.
//   3. A primitive pair: three lanes build its E tables (hermite_E, bra to
//      la + 1, ket to lb + 2); the group folds D into the Hermite
//      coefficients Hd[h] = cc sum_ab Dw_ab Eab[ab, h]; each lane takes the
//      nuclei C = lane, lane + G, ..., evaluates Boys and R to L + 1 in
//      registers (boys<L + 1, true>, hermite_R_lane; a local array above
//      kStvgLaneL), adds Z_C R into its share of the nuclear sum and the
//      Hellmann-Feynman term -sum_h Hd[h] R[h + e_d] into nucleus C's
//      entry of the block's accumulator; a shuffle butterfly sums the
//      nuclear sum over the group, and each lane contracts the component
//      pairs ab = lane, lane + G, ... of dS, dT, dV/dA, dV/dB with Dw and
//      Ww into nine registers.
//   4. After the pair's last primitive pair the group sums those nine
//      values (butterfly) and one lane adds them to the pair's two atoms.
//   5. The block's accumulator ([natom][3] f64 in shared memory, updated
//      with shared atomics) goes to the output with natom * 3 global
//      atomics once, after the block's last pair.
// No [pairs, nuclei, nherm] tensor and no derivative matrix exists
// anywhere: the function reads D, W, the packed tables and the nuclei and
// writes [natom, 3].  Bound on the card by the FP64 pipe (Boys, R and the
// Hellmann-Feynman dot of every (live primitive pair, nucleus) item), as
// K9 is (PERF.md §6).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "boys.cuh"
#include "mcmurchie.cuh"
#include "oei.cuh"

namespace jc {

// the packed table's meta rows: off_a, off_b, ish == jsh, first live
// primitive pair, count, atom of the first shell, atom of the second
// (ops/oei.py::stv_table with atoms; K11 reads the same rows)
constexpr int kGradMeta = 7;
// R and the nuclear sum in registers (compile-time indices) up to this
// Hermite order, in a local array above it
constexpr int kStvgLaneL = 5;

// (t, u, v) of Hermite index h (herm_list order), at compile time
struct Herm3 {
  int t, u, v;
};
__host__ __device__ constexpr Herm3 herm3(int h) {
  int s = 0;
  while (nherm(s) <= h) ++s;
  const int r = h - nherm(s - 1);
  int d = 0;
  while ((d + 1) * (d + 2) / 2 <= r) ++d;
  const int t = s - d, u = d - (r - d * (d + 1) / 2);
  return {t, u, s - t - u};
}

// the block's [natom][3] accumulator, rounded to 16 bytes
__host__ __device__ constexpr size_t grad_acc_doubles(int natom) {
  return (3 * (size_t)natom + 1) & ~(size_t)1;
}

template <int LA, int LB>
struct StvgClass {
  static constexpr int L = LA + LB, LG = L + 1;
  static constexpr int NH = nherm(L), NHG = nherm(LG);
  static constexpr int NA = ncart(LA), NB = ncart(LB), NAB = NA * NB;
  // hermite_E<LA + 1, LB + 2>'s table of one dimension: E[i][j][t]
  static constexpr int JB = LB + 3, NT = LA + LB + 4;
  static constexpr int NE = (LA + 2) * JB * NT;
  // a group's shared memory: three E tables, the summed R, Hd, Dw, Ww
  static constexpr int kGroupDoubles = 3 * NE + NHG + NH + 2 * NAB;
  // 128 threads a block where 16 groups of 8 fit in 150 KB, else 64
  static constexpr int NTH =
      kGroupDoubles * 16 * (int)sizeof(double) <= 150 * 1024 ? 128 : 64;
  static constexpr bool kLane = LG <= kStvgLaneL;
};

template <int LA, int LB>
__host__ __device__ constexpr size_t stvg_smem_bytes(int G, int natom) {
  using C = StvgClass<LA, LB>;
  return sizeof(double) *
         (grad_acc_doubles(natom) + (size_t)(C::NTH / G) * C::kGroupDoubles);
}

// f(i) for i = 0 .. N-1: unrolled with compile-time indices (registers)
// where kUnroll, a plain loop otherwise
template <bool kUnroll, int N, class F>
__device__ __forceinline__ void for_n(F&& f) {
  if constexpr (kUnroll)
    static_for<N>([&](auto i) { f(decltype(i)::value); });
  else
    for (int i = 0; i < N; ++i) f(i);
}

// sum_{t<nx, u<ny, v<nz} X[t] Y[u] Z[v] R[herm(t + t0, u + u0, v + v0)]
__device__ __forceinline__ double herm_dot(const double* X, int nx,
                                           const double* Y, int ny,
                                           const double* Z, int nz,
                                           const double* R, int t0 = 0,
                                           int u0 = 0, int v0 = 0) {
  double s = 0.0;
  for (int t = 0; t < nx; ++t) {
    if (X[t] == 0.0) continue;
    double st = 0.0;
    for (int u = 0; u < ny; ++u) {
      if (Y[u] == 0.0) continue;
      double su = 0.0;
      for (int v = 0; v < nz; ++v)
        su += Z[v] * R[herm_index(t + t0, u + u0, v + v0)];
      st += Y[u] * su;
    }
    s += X[t] * st;
  }
  return s;
}

// G: 8, 16 or 32 (the launch checks it).  grad [natom][3] f64, accumulated.
template <int LA, int LB>
__global__ void __launch_bounds__(StvgClass<LA, LB>::NTH)
    stv_grad_kernel(const double* __restrict__ prim,
                    const double* __restrict__ pair,
                    const int* __restrict__ meta, long long n,
                    const double* __restrict__ atoms, int natom,
                    const double* __restrict__ D,
                    const double* __restrict__ W, long long nbf, int G,
                    double* __restrict__ grad) {
  using C = StvgClass<LA, LB>;
  constexpr int L = C::L, LG = C::LG, NH = C::NH, NHG = C::NHG;
  constexpr int NE = C::NE, JB = C::JB, NT = C::NT, NB = C::NB;
  constexpr int NAB = C::NAB, NTH = C::NTH;
  constexpr int SLOTS = (NAB + kStvMinGroup - 1) / kStvMinGroup;
  extern __shared__ double sm[];
  const int tid = threadIdx.x, gl = tid & (G - 1), grp = tid / G;
  const int groups = NTH / G;
  double* acc = sm;  // [natom][3]
  double* sE = sm + grad_acc_doubles(natom) + grp * C::kGroupDoubles;
  double* sR = sE + 3 * NE;  // [NHG], the nuclear sum
  double* sH = sR + NHG;     // [NH], Hd
  double* sD = sH + NH;      // [NAB], Dw
  double* sW = sD + NAB;     // [NAB], Ww
  for (int i = tid; i < 3 * natom; i += NTH) acc[i] = 0.0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * groups;
  const long long rounds = (n + stride - 1) / stride;
  for (long long it = 0; it < rounds; ++it) {
    const long long s = it * stride + (long long)blockIdx.x * groups + grp;
    const bool valid = s < n;
    const int* m = meta + (valid ? s : 0) * kGradMeta;
    const int cnt = valid ? m[4] : 0, p0 = valid ? m[3] : 0;
    double A[3], B[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      A[d] = valid ? pair[6 * s + d] : 0.0;
      B[d] = valid ? pair[6 * s + 3 + d] : 0.0;
    }
    // 2. the weighted, normalised D and W blocks of the pair
    if (valid) {
      const long long oa = m[0], ob = m[1];
      const double wt = m[2] ? 1.0 : 2.0;
      for (int ab = gl; ab < NAB; ab += G) {
        const int ia = ab / NB, ib = ab - ia * NB;
        int ax, ay, az, bx, by, bz;
        cart_comp(LA, ia, ax, ay, az);
        cart_comp(LB, ib, bx, by, bz);
        const double nrm = wt * axial(LA, ax, ay, az) * axial(LB, bx, by, bz);
        const long long e = (oa + ia) * nbf + ob + ib;
        sD[ab] = nrm * D[e];
        sW[ab] = nrm * W[e];
      }
    }
    __syncwarp();
    // per lane: sum_ab Dw dT/dA - Ww dS/dA, Dw dV/dA, Dw dV/dB (x, y, z)
    double gS[3] = {0.0, 0.0, 0.0}, gVA[3] = {0.0, 0.0, 0.0},
           gVB[3] = {0.0, 0.0, 0.0};

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
      const double* Ex = sE;
      const double* Ey = sE + NE;
      const double* Ez = sE + 2 * NE;
      // 3a. the E tables
      if (live)
        for (int d = gl; d < 3; d += G) {
          const double Pd = pick3(P, d), Ad = pick3(A, d), Bd = pick3(B, d);
          hermite_E<LA + 1, LB + 2>(p, a * b * rp, Pd - Ad, Pd - Bd, Ad - Bd,
                                    sE + d * NE);
        }
      __syncwarp();
      // 3b. Hd[h] = cc sum_ab Dw_ab Eab[ab, h], h in herm(L)
      if (live)
        for (int h = gl; h < NH; h += G) {
          int t, u, v;
          herm_triple(h, t, u, v);
          double sum = 0.0;
          for (int ab = 0; ab < NAB; ++ab) {
            const int ia = ab / NB, ib = ab - ia * NB;
            int ax, ay, az, bx, by, bz;
            cart_comp(LA, ia, ax, ay, az);
            cart_comp(LB, ib, bx, by, bz);
            if (t > ax + bx || u > ay + by || v > az + bz) continue;
            sum += sD[ab] * Ex[(ax * JB + bx) * NT + t] *
                   Ey[(ay * JB + by) * NT + u] * Ez[(az * JB + bz) * NT + v];
          }
          sH[h] = cc * sum;
        }
      __syncwarp();
      // 3c. this lane's nuclei: the nuclear sum and the Hellmann-Feynman term
      constexpr bool kU = C::kLane;
      double racc[NHG];
      for_n<kU, NHG>([&](int h) { racc[h] = 0.0; });
      if (live) {
        const double scale = -2.0 * kStvPi * rp;
        for (int c = gl; c < natom; c += G) {
          const double* at = atoms + 4 * c;
          const double X = P[0] - at[0], Y = P[1] - at[1], Z = P[2] - at[2];
          double F[LG + 1], R[NHG];
          boys<LG, true>(p * (X * X + Y * Y + Z * Z), F);
          const double w = scale * at[3];
          for (int i = 0; i <= LG; ++i) F[i] *= w;
          double hx = 0.0, hy = 0.0, hz = 0.0;
          if constexpr (C::kLane) {
            hermite_R_lane<LG>(p, X, Y, Z, F, R);
            for_n<true, NHG>([&](int h) { racc[h] += R[h]; });
            static_for<NH>([&](auto h_) {
              constexpr int h = decltype(h_)::value;
              constexpr Herm3 e = herm3(h);
              const double x = sH[h];
              hx += x * R[hidx(e.t + 1, e.u, e.v)];
              hy += x * R[hidx(e.t, e.u + 1, e.v)];
              hz += x * R[hidx(e.t, e.u, e.v + 1)];
            });
          } else {
            hermite_R<LG>(p, X, Y, Z, F, R);
            for (int h = 0; h < NHG; ++h) racc[h] += R[h];
            for (int h = 0; h < NH; ++h) {
              int t, u, v;
              herm_triple(h, t, u, v);
              const double x = sH[h];
              hx += x * R[herm_index(t + 1, u, v)];
              hy += x * R[herm_index(t, u + 1, v)];
              hz += x * R[herm_index(t, u, v + 1)];
            }
          }
          atomicAdd(acc + 3 * c, -hx);
          atomicAdd(acc + 3 * c + 1, -hy);
          atomicAdd(acc + 3 * c + 2, -hz);
        }
      }
      for (int o = G / 2; o > 0; o >>= 1)
        for_n<kU, NHG>([&](int h) {
          racc[h] += __shfl_xor_sync(kStvFullMask, racc[h], o);
        });
      if (live)
        for_n<kU, NHG>([&](int h) {
          if ((h & (G - 1)) == gl) sR[h] = racc[h];
        });
      __syncwarp();
      // 3d. this lane's component pairs
      if (live) {
        const double rt = kStvPi * rp, pref = rt * sqrt(rt) * cc;
        for (int k2 = 0; k2 < SLOTS; ++k2) {
          const int ab = gl + k2 * G;
          if (ab >= NAB) break;
          const int ia = ab / NB, ib = ab - ia * NB;
          int ca[3], cb[3];
          cart_comp(LA, ia, ca[0], ca[1], ca[2]);
          cart_comp(LB, ib, cb[0], cb[1], cb[2]);
          const double Dw = sD[ab], Ww = sW[ab];
          // per dimension: E(i, j) rows, their t = 0 values, K(i, j)
          const double* row[3];
          double e0[3], de[3], k0[3], dk[3];
          for (int d = 0; d < 3; ++d) {
            const double* Ed = sE + d * NE;
            const int i = ca[d], j = cb[d];
            row[d] = Ed + (i * JB + j) * NT;
            auto kin = [&](int ii) {
              const double* e = Ed + (ii * JB + j) * NT;
              double v = -2.0 * b * b * e[2 * NT] + b * (2.0 * j + 1.0) * e[0];
              if (j >= 2) v -= 0.5 * j * (j - 1.0) * e[-2 * NT];
              return v;
            };
            e0[d] = row[d][0];
            k0[d] = kin(i);
            de[d] = 2.0 * a * Ed[((i + 1) * JB + j) * NT];
            dk[d] = 2.0 * a * kin(i + 1);
            if (i > 0) {
              de[d] -= i * Ed[((i - 1) * JB + j) * NT];
              dk[d] -= i * kin(i - 1);
            }
          }
          for (int d = 0; d < 3; ++d) {
            const int e1 = d == 0 ? 1 : 0, e2 = d == 2 ? 1 : 2;
            const double dS = pref * de[d] * e0[e1] * e0[e2];
            const double dT =
                pref * (dk[d] * e0[e1] * e0[e2] +
                        de[d] * (k0[e1] * e0[e2] + e0[e1] * k0[e2]));
            gS[d] += Dw * dT - Ww * dS;
            // dV/dA_d and dV/dB_d against the summed R (herm(L + 1))
            const double* Ed = sE + d * NE;
            const int i = ca[d], j = cb[d];
            double xa[NT], xb[NT];
            const int nd = i + j + 2;
            for (int t = 0; t < nd; ++t) {
              xa[t] = 2.0 * a * Ed[((i + 1) * JB + j) * NT + t];
              xb[t] = 2.0 * b * Ed[(i * JB + j + 1) * NT + t];
              if (i > 0) xa[t] -= i * Ed[((i - 1) * JB + j) * NT + t];
              if (j > 0) xb[t] -= j * Ed[(i * JB + j - 1) * NT + t];
            }
            const double* r1 = row[e1];
            const double* r2 = row[e2];
            const int n1 = ca[e1] + cb[e1] + 1, n2 = ca[e2] + cb[e2] + 1;
            double va, vb;
            if (d == 0) {
              va = herm_dot(xa, nd, r1, n1, r2, n2, sR);
              vb = herm_dot(xb, nd, r1, n1, r2, n2, sR);
            } else if (d == 1) {
              va = herm_dot(r1, n1, xa, nd, r2, n2, sR);
              vb = herm_dot(r1, n1, xb, nd, r2, n2, sR);
            } else {
              va = herm_dot(r1, n1, r2, n2, xa, nd, sR);
              vb = herm_dot(r1, n1, r2, n2, xb, nd, sR);
            }
            gVA[d] += cc * Dw * va;
            gVB[d] += cc * Dw * vb;
          }
        }
      }
      __syncwarp();
    }
    // 4. the group's sums to the pair's two atoms
    for (int o = G / 2; o > 0; o >>= 1)
      for (int d = 0; d < 3; ++d) {
        gS[d] += __shfl_xor_sync(kStvFullMask, gS[d], o);
        gVA[d] += __shfl_xor_sync(kStvFullMask, gVA[d], o);
        gVB[d] += __shfl_xor_sync(kStvFullMask, gVB[d], o);
      }
    if (valid && gl == 0) {
      const int ta = m[5], tb = m[6];
      for (int d = 0; d < 3; ++d) {
        atomicAdd(acc + 3 * ta + d, gS[d] + gVA[d]);
        atomicAdd(acc + 3 * tb + d, gVB[d] - gS[d]);
      }
    }
    __syncwarp();
  }
  // 5. the block's sums to the output
  __syncthreads();
  for (int i = tid; i < 3 * natom; i += NTH)
    if (acc[i] != 0.0) atomicAdd(grad + i, acc[i]);
}

}  // namespace jc
