// Kernel K8: the two-float (split) metric fold of an f32 B,
//   Y[r, c] = sum_k Mh[r, k] X[k, c] + sum_k Ml[r, k] X[k, c],
// Mh = f32(M), Ml = f32(M - Mh) of the f64 fold matrix M, X one f32 column
// chunk of B (a strided view: row stride ldx), Y a fresh [R, C] f32 buffer
// (every row of X feeds every output row, so Y cannot overwrite X in place).
//
// Replaces juliachem_jl_tpu/models/linalg.py::_split_matmul (:57-60),
// lax.add(dot(Mh, X), dot(Ml, X)) at Precision.HIGHEST: true f32 products,
// two sums added once at the end.  Here each output keeps two FFMA
// accumulators, one per product, added at the store; no TF32, no tensor
// cores (TF32 keeps 10 mantissa bits, HIGHEST means full f32).
//
// What bounds it on the card: operations.  On the fold's path M = Ls^{-1} is
// lower triangular (``lower``): a block of output rows r0.. r0+63 needs only
// the k-slabs up to r0+63, 2 A (A+1) C FP32 operations against
// (A (A+1) + 2 A C) x 4 bytes; at the w32 fold (A = 4448, C = 6144) that is
// 2.4e11 operations over 67 TFLOP/s (3.6 ms) against 0.3 GB over 3.35 TB/s
// (0.1 ms).  The pseudo-inverse fold's M is full: 4 A^2 C operations, every
// slab.  Design, simple and right first: one block per 64 x 64 output
// tile, 16-deep k-slabs of Mh, Ml (stored k-major) and X staged in shared
// memory, 256 threads with a 4 x 4 register tile each (rows ty + 16 i,
// columns tx + 16 j: a warp reads 16 consecutive X words and two M words
// per k, no bank conflicts), 64-bit offsets throughout (A x npq reaches
// 5e9 elements at w64).  cp.async/TMA staging and a larger tile are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;   // output rows and columns per block
constexpr int kSlab = 16;   // k per shared-memory slab
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
split_fold_kernel(const float* __restrict__ Mh, const float* __restrict__ Ml,
                  int64_t ldm, const float* __restrict__ X, int64_t ldx,
                  float* __restrict__ Y, int64_t ldy, int R, int K, int C,
                  int lower) {
  __shared__ float sMh[kSlab][kTile];
  __shared__ float sMl[kSlab][kTile];
  __shared__ float sX[kSlab][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t r0 = (int64_t)blockIdx.y * kTile;
  const int64_t c0 = (int64_t)blockIdx.x * kTile;
  float acc_h[4][4], acc_l[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_h[i][j] = acc_l[i][j] = 0.0f;

  // a lower-triangular M is zero right of column r0 + kTile - 1 in these rows
  const int k_end = (lower && r0 + kTile < K) ? (int)(r0 + kTile) : K;
  for (int k0 = 0; k0 < k_end; k0 += kSlab) {
    // M slabs: consecutive threads read consecutive k of one row
    for (int e = threadIdx.x; e < kTile * kSlab; e += kThreads) {
      const int rr = e / kSlab, kk = e % kSlab;
      const int64_t r = r0 + rr, k = k0 + kk;
      const bool in = r < R && k < K;
      sMh[kk][rr] = in ? Mh[r * ldm + k] : 0.0f;
      sMl[kk][rr] = in ? Ml[r * ldm + k] : 0.0f;
    }
    // X slab: consecutive threads read consecutive columns of one row
    for (int e = threadIdx.x; e < kSlab * kTile; e += kThreads) {
      const int kk = e / kTile, cc = e % kTile;
      const int64_t k = k0 + kk, c = c0 + cc;
      sX[kk][cc] = (k < K && c < C) ? X[k * ldx + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      float h[4], l[4], x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = sMh[kk][ty + 16 * i];
        l[i] = sMl[kk][ty + 16 * i];
        x[i] = sX[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_h[i][j] = __fmaf_rn(h[i], x[j], acc_h[i][j]);
          acc_l[i][j] = __fmaf_rn(l[i], x[j], acc_l[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = c0 + tx + 16 * j;
      if (c < C) Y[r * ldy + c] = __fadd_rn(acc_h[i][j], acc_l[i][j]);
    }
  }
}

}  // namespace

// Mh, Ml: [R, K] row-major (row stride ldm); X: [K, C] (row stride ldx);
// Y: [R, C] (row stride ldy); lower != 0 promises Mh[r, k] = Ml[r, k] = 0 for
// k > r (the skipped slabs would add only zero products).  Returns the CUDA
// error of the launch.
extern "C" int jc_split_fold(const float* Mh, const float* Ml, long long ldm,
                             const float* X, long long ldx, float* Y,
                             long long ldy, int R, int K, int C, int lower,
                             void* stream) {
  const dim3 grid((unsigned)((C + kTile - 1) / kTile),
                  (unsigned)((R + kTile - 1) / kTile));
  split_fold_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Mh, Ml, ldm, X, ldx, Y, ldy, R, K, C, lower);
  return (int)cudaGetLastError();
}
