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
#pragma once

namespace jc {

constexpr double kBoysTcrit = 35.0;
constexpr int kBoysNSeries = 128;

template <int M>
__device__ __forceinline__ void boys(double T, double* F) {
  if (T <= kBoysTcrit) {
    const double expT = exp(-T);
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
