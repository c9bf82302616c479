// McMurchie-Davidson device functions shared by the integral kernels K1
// (eri3c.cuh), K4/K5 (eri4c.cuh) and K9 (oei.cuh): Hermite index
// arithmetic, Cartesian component order, axial normalisation, the Hermite
// expansion coefficients E and the Hermite Coulomb integrals R (also with
// compile-time indices, in registers).
//
// Replaces juliachem_jl_tpu/ops/mcmurchie.py::e_dense / hermite_expansion /
// r_tensor (:58-192) and the static tables of ops/class_tables.py, which XLA
// inlined into every integral class program.  Same recurrences and orders as
// the plain torch versions (juliachem_jl_tpu_torch/ops/mcmurchie.py,
// ops/class_tables.py), so kernels and plain versions agree to rounding.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace jc {

constexpr double kTwoPiPow2_5 = 2.0 * 17.493418327624862;  // 2 pi^2.5

__host__ __device__ constexpr int ncart(int l) { return (l + 1) * (l + 2) / 2; }
__host__ __device__ constexpr int nherm(int L) {
  return (L + 1) * (L + 2) * (L + 3) / 6;
}

// Position of Hermite triple (t,u,v) in herm_list order (graded by
// t+u+v, then t descending, then u descending).
__device__ __forceinline__ int herm_index(int t, int u, int v) {
  const int s = t + u + v, d = s - t;
  return nherm(s - 1) + d * (d + 1) / 2 + (d - u);
}

__device__ __forceinline__ void herm_triple(int h, int& t, int& u, int& v) {
  int s = 0;
  while (nherm(s) <= h) ++s;
  const int r = h - nherm(s - 1);
  int d = 0;
  while ((d + 1) * (d + 2) / 2 <= r) ++d;
  t = s - d;
  u = d - (r - d * (d + 1) / 2);
  v = s - t - u;
}

// Cartesian component c of shell l (lx descending, then ly descending).
__device__ __forceinline__ void cart_comp(int l, int c, int& x, int& y, int& z) {
  int d = 0;
  while ((d + 1) * (d + 2) / 2 <= c) ++d;
  x = l - d;
  y = d - (c - d * (d + 1) / 2);
  z = l - x - y;
}

__device__ __forceinline__ double dfact(int n) {  // (2n-1)!!
  double out = 1.0;
  for (int k = 2 * n - 1; k > 0; k -= 2) out *= k;
  return out;
}

__device__ __forceinline__ double axial(int l, int x, int y, int z) {
  return sqrt(dfact(l) / (dfact(x) * dfact(y) * dfact(z)));
}

// Per-dimension Hermite expansion coefficients E[i][j][t] of a Gaussian
// product, zero where t > i + j (ops/mcmurchie.py::e_dense).
template <int LA, int LB>
__device__ void hermite_E(double p, double mu, double PA, double PB, double AB,
                          double* E) {
  constexpr int NT = LA + LB + 1;
  auto at = [](int i, int j, int t) { return (i * (LB + 1) + j) * NT + t; };
  for (int e = 0; e < (LA + 1) * (LB + 1) * NT; ++e) E[e] = 0.0;
  const double oo2p = 0.5 / p;
  auto get = [&](int i, int j, int t) {
    return (t < 0 || t > i + j) ? 0.0 : E[at(i, j, t)];
  };
  E[at(0, 0, 0)] = exp(-mu * (AB * AB));
  for (int i = 1; i <= LA; ++i)
    for (int t = 0; t <= i; ++t)
      E[at(i, 0, t)] = oo2p * get(i - 1, 0, t - 1) + PA * get(i - 1, 0, t) +
                       (t + 1) * get(i - 1, 0, t + 1);
  for (int j = 1; j <= LB; ++j)
    for (int i = 0; i <= LA; ++i)
      for (int t = 0; t <= i + j; ++t)
        E[at(i, j, t)] = oo2p * get(i, j - 1, t - 1) + PB * get(i, j - 1, t) +
                         (t + 1) * get(i, j - 1, t + 1);
}

// Hermite Coulomb integrals R^0_{tuv}, t+u+v <= L, in herm_list order, by
// the downward recursion of ops/mcmurchie.py::r_tensor.  In place: level n
// is written over level n+1 from the highest order down, since order s of
// level n reads only orders s-1 and s-2 of level n+1.  F holds the Boys
// values with the prefactor folded in.
template <int L>
__device__ void hermite_R(double alpha, double X, double Y, double Z,
                          const double* F, double* R) {
  double pw[L + 1];
  pw[0] = 1.0;
  for (int n = 1; n <= L; ++n) pw[n] = pw[n - 1] * (-2.0 * alpha);
  for (int n = L; n >= 0; --n) {
    for (int s = L - n; s >= 1; --s) {
      for (int d = 0; d <= s; ++d) {
        const int t = s - d;
        for (int u = d; u >= 0; --u) {
          const int v = d - u;
          double val;
          if (t > 0) {
            const double hi = R[herm_index(t - 1, u, v)];
            val = t >= 2 ? (t - 1) * R[herm_index(t - 2, u, v)] + X * hi : X * hi;
          } else if (u > 0) {
            const double hi = R[herm_index(t, u - 1, v)];
            val = u >= 2 ? (u - 1) * R[herm_index(t, u - 2, v)] + Y * hi : Y * hi;
          } else {
            const double hi = R[herm_index(t, u, v - 1)];
            val = v >= 2 ? (v - 1) * R[herm_index(t, u, v - 2)] + Z * hi : Z * hi;
          }
          R[herm_index(t, u, v)] = val;
        }
      }
    }
    R[0] = pw[n] * F[n];
  }
}

// ------------------------------------------------ compile-time forms

// f(std::integral_constant<int, i>) for i = 0 .. N-1, unrolled
template <class F, int... I>
__device__ __forceinline__ void static_for_seq(F&& f,
                                               std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_seq(f, std::make_integer_sequence<int, N>{});
}

// compile-time form of herm_index
__host__ __device__ constexpr int hidx(int t, int u, int v) {
  return nherm(t + u + v - 1) + (u + v) * (u + v + 1) / 2 + v;
}

// Hermite Coulomb integrals R^0_{tuv}, t+u+v <= L, in registers: the
// in-place downward recursion of hermite_R with compile-time indices.
template <int L>
__device__ __forceinline__ void hermite_R_lane(double alpha, double X,
                                               double Y, double Z,
                                               const double* F, double* R) {
  double pw[L + 1];
  pw[0] = 1.0;
  static_for<L>([&](auto n) {
    pw[decltype(n)::value + 1] = pw[decltype(n)::value] * (-2.0 * alpha);
  });
  static_for<L + 1>([&](auto n_) {
    constexpr int n = L - decltype(n_)::value;
    static_for<L - n>([&](auto s_) {
      constexpr int s = L - n - decltype(s_)::value;
      static_for<s + 1>([&](auto d_) {
        constexpr int d = decltype(d_)::value, t = s - d;
        static_for<d + 1>([&](auto u_) {
          constexpr int u = d - decltype(u_)::value, v = d - u;
          if constexpr (t > 0) {
            const double hi = R[hidx(t - 1, u, v)];
            if constexpr (t >= 2)
              R[hidx(t, u, v)] = (t - 1) * R[hidx(t - 2, u, v)] + X * hi;
            else
              R[hidx(t, u, v)] = X * hi;
          } else if constexpr (u > 0) {
            const double hi = R[hidx(t, u - 1, v)];
            if constexpr (u >= 2)
              R[hidx(t, u, v)] = (u - 1) * R[hidx(t, u - 2, v)] + Y * hi;
            else
              R[hidx(t, u, v)] = Y * hi;
          } else {
            const double hi = R[hidx(t, u, v - 1)];
            if constexpr (v >= 2)
              R[hidx(t, u, v)] = (v - 1) * R[hidx(t, u, v - 2)] + Z * hi;
            else
              R[hidx(t, u, v)] = Z * hi;
          }
        });
      });
    });
    R[0] = pw[n] * F[n];
  });
}

}  // namespace jc
