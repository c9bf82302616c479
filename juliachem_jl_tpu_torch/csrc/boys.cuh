// Boys function F_0..F_M(T) as a device function.
//
// Replaces juliachem_jl_tpu/ops/boys.py::boys (:61-98), which XLA inlined
// into every integral class program.  Same algorithm, so the kernel and the
// plain torch version (juliachem_jl_tpu_torch/ops/boys.py) agree to rounding:
//   T <= 35: 128-term series for F_M, then downward recursion (stable);
//   T  > 35: asymptotic F_0 = sqrt(pi/4T) and upward recursion.
// Bound on the card: the 128 dependent multiply-divides of the series, one
// thread per argument.  Kept branchy (the TPU form was branch-free): a warp
// whose arguments all fall on one side runs only that side.
//
// boys<M, true> is the form K1, K4 and K5 inline: the series and the downward
// recursion multiply by the compile-time reciprocals 1/(2M+2k+3) and
// 1/(2m+1) where boys<M> divides (an f64 divide is a multi-instruction
// sequence on sm_90, a multiply one instruction).  The reciprocals are
// rounded once, so the two forms differ in the last bits (within 3.1e-15
// relative for m <= 16, T in [0, 35]).  The probe K3 keeps the dividing
// form and has a second instance of this one.
#pragma once

#include <utility>

namespace jc {

constexpr double kBoysTcrit = 35.0;
constexpr int kBoysNSeries = 128;

template <int N>
struct OddRecip {  // 1 / (2N + 1), rounded at compile time
  static constexpr double value = 1.0 / (2 * N + 1);
};

// sum_{k=0..128} of the series terms of F_M at x = 2T
template <int M, int... K>
__device__ __forceinline__ double boys_series_recip(
    double x, std::integer_sequence<int, K...>) {
  double term = OddRecip<M>::value, sum = term;
  ((term = term * x * OddRecip<M + K + 1>::value, sum += term), ...);
  return sum;
}

// F[m] = (x F[m+1] + e^-T) / (2m+1) for m = M-1 .. 0
template <int M, int... K>
__device__ __forceinline__ void boys_down_recip(
    double x, double expT, double* F, std::integer_sequence<int, K...>) {
  ((F[M - 1 - K] = (x * F[M - K] + expT) * OddRecip<M - 1 - K>::value), ...);
}

template <int M, bool kRecip = false>
__device__ __forceinline__ void boys(double T, double* F) {
  if (T <= kBoysTcrit) {
    const double expT = exp(-T);
    if constexpr (kRecip) {
      const double x = 2.0 * T;
      F[M] = expT * boys_series_recip<M>(
                        x, std::make_integer_sequence<int, kBoysNSeries>{});
      boys_down_recip<M>(x, expT, F, std::make_integer_sequence<int, M>{});
    } else {
      double term = 1.0 / (2.0 * M + 1.0);
      double sum = term;
      for (int k = 0; k < kBoysNSeries; ++k) {
        term = term * (2.0 * T) / (2.0 * M + 2.0 * k + 3.0);
        sum += term;
      }
      F[M] = expT * sum;
#pragma unroll
      for (int m = M - 1; m >= 0; --m)
        F[m] = (2.0 * T * F[m + 1] + expT) / (2.0 * m + 1.0);
    }
  } else {
    F[0] = 0.5 * sqrt(3.141592653589793 / T);
    const double expT = exp(-T);
    const double inv2T = 0.5 / T;
#pragma unroll
    for (int m = 1; m <= M; ++m)
      F[m] = ((2.0 * m - 1.0) * F[m - 1] - expT) * inv2T;
  }
}

}  // namespace jc
