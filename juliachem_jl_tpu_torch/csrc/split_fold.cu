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
// lower triangular (``lower``): a block of output rows r0 .. r0+TM-1 needs
// only the k up to its last row, 2 A (A+1) C FP32 operations against
// (A (A+1) + 2 A C) x 4 bytes; at the w32 fold (A = 4448, C = 6144) that is
// 2.4e11 operations over 67 TFLOP/s (3.6 ms) against 0.3 GB over 3.35 TB/s
// (0.1 ms).  The pseudo-inverse fold's M is full: 4 A^2 C operations.
//
// Design (the tile from ops/kernels.py: -DJC_K8_TILE_M/_TILE_N/_SLAB):
// one block of 256 threads per TM x TN = 128 x 64 output tile, each thread
// an 8 x 4 register tile per product (rows wm*32 + ty + 4 i, columns wn*32
// + 4 tx + j for warp (wm, wn) and lane (ty, tx) = (lane / 8, lane % 8):
// 64 accumulators).  k advances in slabs of TK = 16 through a ring of
// three shared-memory stages filled by cp.async (16-byte copies where Mh,
// Ml and X allow it, 4-byte ones otherwise; zero-filled past R, K and C),
// so the copies of slab t + 2 overlap the products of slab t.  One X slab
// feeds both products: X is read once where two SGEMMs read it twice.
// cp.async cannot transpose, so Mh and Ml stay row-major in shared memory
// (row stride TK + 4): a thread reads float4s along k of its 8 rows, the 8
// lanes of a quarter-warp read the same float4 (a broadcast) and the four
// quarter-warps rows ty = 0..3 four apart, 20 floats, in distinct banks; X
// is read as float4s of 4 columns, 8 consecutive ones a quarter-warp.  Per
// 4 k a thread issues 20 float4 loads for 256 FFMAs.  Under ``lower`` a
// block stops at the slab that holds its last row's k, and the blocks of
// the heavy (bottom) rows go first (block row gridDim.y - 1 - blockIdx.y),
// so the tail of the launch is made of light tiles.  64-bit offsets
// throughout (A x npq reaches 5e9 elements at w64).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma.cuh"

#if !defined(JC_K8_TILE_M) || !defined(JC_K8_TILE_N) || !defined(JC_K8_SLAB)
#error "build with -DJC_K8_TILE_M, -DJC_K8_TILE_N, -DJC_K8_SLAB (ops/kernels.py)"
#endif

namespace jc {

constexpr int kK8TileM = JC_K8_TILE_M;  // output rows per block
constexpr int kK8TileN = JC_K8_TILE_N;  // output columns per block
constexpr int kK8Slab = JC_K8_SLAB;     // k per shared-memory stage
constexpr int kK8Stages = 3;
constexpr int kK8Threads = 256;
constexpr int kK8LdM = kK8Slab + 4;     // row stride of a stage's Mh, Ml
static_assert(kK8TileM == 128 && kK8TileN == 64 && kK8Slab % 4 == 0,
              "the thread map below is for 128 x 64 tiles, 8 warps");

struct K8Stage {
  float mh[kK8TileM][kK8LdM];
  float ml[kK8TileM][kK8LdM];
  float x[kK8Slab][kK8TileN];
};
constexpr size_t kK8SmemBytes = kK8Stages * sizeof(K8Stage);

// This thread's share of the copies of every k-slab: with 16-byte copies
// (kVecM, kVecX) two 4-wide row segments of Mh and of Ml (rows tid / 4 and
// tid / 4 + 64) and one of X (row tid / 16), their sources at slab 0 set
// once, so that a slab's copies cost an add a pointer; with 4-byte copies
// the elements e = tid + 256 m of each slab, their offsets taken anew.
template <bool kVecM, bool kVecX>
struct K8Loader {
  static_assert(kK8TileM * kK8Slab / 4 == 2 * kK8Threads &&
                    kK8Slab * kK8TileN / 4 == kK8Threads,
                "two M segments and one X segment a thread");
  const float *mh, *ml, *x;  // this thread's sources at slab 0
  const float *Mh, *Ml, *X;
  int64_t ldm, ldx, r0, c0;
  int R, K, C, tid;
  bool row_ok[2], col_ok;
  int nx;  // bytes of this thread's X segment inside C

  __device__ __forceinline__ K8Loader(const float* Mh_, const float* Ml_,
                                      int64_t ldm_, const float* X_,
                                      int64_t ldx_, int64_t r0_, int64_t c0_,
                                      int R_, int K_, int C_, int tid_)
      : Mh(Mh_), Ml(Ml_), X(X_), ldm(ldm_), ldx(ldx_), r0(r0_), c0(c0_),
        R(R_), K(K_), C(C_), tid(tid_) {
    const int64_t r = r0 + (tid >> 2);
    row_ok[0] = r < R;
    row_ok[1] = r + 64 < R;
    const int64_t o = row_ok[0] ? r * ldm + 4 * (tid & 3) : 0;
    mh = Mh + o;
    ml = Ml + o;
    const int64_t c = c0 + 4 * (tid & 15);
    col_ok = c < C;
    nx = col_ok ? 4 * (int)(C - c < 4 ? C - c : 4) : 0;
    x = X + (col_ok ? (tid >> 4) * ldx + c : 0);
  }

  // the k-slab at k0 into st
  __device__ __forceinline__ void load(K8Stage& st, int64_t k0) const {
    if constexpr (kVecM) {
      const int row = tid >> 2, kc = 4 * (tid & 3);
      const int64_t k = k0 + kc;
      const int n = k < K ? 4 * (int)(K - k < 4 ? K - k : 4) : 0;
      const int n0 = row_ok[0] ? n : 0, n1 = row_ok[1] ? n : 0;
      const int64_t step = 64 * ldm;
      cp_async16(&st.mh[row][kc], n0 ? mh + k0 : Mh, n0);
      cp_async16(&st.ml[row][kc], n0 ? ml + k0 : Ml, n0);
      cp_async16(&st.mh[row + 64][kc], n1 ? mh + step + k0 : Mh, n1);
      cp_async16(&st.ml[row + 64][kc], n1 ? ml + step + k0 : Ml, n1);
    } else {
      for (int e = tid; e < kK8TileM * kK8Slab; e += kK8Threads) {
        const int row = e / kK8Slab, kk = e % kK8Slab;
        const int64_t r = r0 + row, k = k0 + kk;
        const bool ok = r < R && k < K;
        const int64_t o = ok ? r * ldm + k : 0;
        cp_async4(&st.mh[row][kk], Mh + o, ok);
        cp_async4(&st.ml[row][kk], Ml + o, ok);
      }
    }
    if constexpr (kVecX) {
      const int kr = tid >> 4, cc = 4 * (tid & 15);
      const int n = k0 + kr < K ? nx : 0;
      cp_async16(&st.x[kr][cc], n ? x + k0 * ldx : X, n);
    } else {
      for (int e = tid; e < kK8Slab * kK8TileN; e += kK8Threads) {
        const int kr = e / kK8TileN, cc = e % kK8TileN;
        const int64_t k = k0 + kr, c = c0 + cc;
        const bool ok = k < K && c < C;
        cp_async4(&st.x[kr][cc], X + (ok ? k * ldx + c : 0), ok);
      }
    }
  }
};

// The products of one stage into this thread's accumulators.
__device__ __forceinline__ void k8_compute(const K8Stage& st, int wm, int wn,
                                           int ty, int tx, float (&ah)[8][4],
                                           float (&al)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < kK8Slab; kk += 4) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = *reinterpret_cast<const float4*>(&st.x[kk + u][wn * 32 + 4 * tx]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = wm * 32 + ty + 4 * i;
      const float4 h = *reinterpret_cast<const float4*>(&st.mh[row][kk]);
      const float4 l = *reinterpret_cast<const float4*>(&st.ml[row][kk]);
      const float hv[4] = {h.x, h.y, h.z, h.w};
      const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float xv[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ah[i][j] = __fmaf_rn(hv[u], xv[j], ah[i][j]);
          al[i][j] = __fmaf_rn(lv[u], xv[j], al[i][j]);
        }
      }
    }
  }
}

template <bool kVecM, bool kVecX>
__global__ void __launch_bounds__(kK8Threads, 2)
split_fold_kernel(const float* __restrict__ Mh, const float* __restrict__ Ml,
                  int64_t ldm, const float* __restrict__ X, int64_t ldx,
                  float* __restrict__ Y, int64_t ldy, int R, int K, int C,
                  int lower, int vec_y) {
  extern __shared__ float4 k8_smem[];
  K8Stage* st = reinterpret_cast<K8Stage*>(k8_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, ty = lane >> 3, tx = lane & 7;
  // heavy block rows (the bottom of a lower-triangular M) first
  const int64_t r0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kK8TileM;
  const int64_t c0 = (int64_t)blockIdx.x * kK8TileN;
  const int64_t last = (r0 + kK8TileM < R ? r0 + kK8TileM : R);
  const int64_t k_end = (lower && last < K) ? last : K;
  const int nslab = (int)((k_end + kK8Slab - 1) / kK8Slab);
  float ah[8][4], al[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ah[i][j] = al[i][j] = 0.0f;

  const K8Loader<kVecM, kVecX> ld(Mh, Ml, ldm, X, ldx, r0, c0, R, K, C, tid);
#pragma unroll
  for (int s = 0; s < kK8Stages - 1; ++s) {
    if (s < nslab) ld.load(st[s], (int64_t)s * kK8Slab);
    cp_async_commit();
  }
  for (int t = 0; t < nslab; ++t) {
    cp_async_wait<kK8Stages - 2>();
    __syncthreads();  // slab t is in; every thread is done with slab t - 1
    const int nx = t + kK8Stages - 1;
    if (nx < nslab) ld.load(st[nx % kK8Stages], (int64_t)nx * kK8Slab);
    cp_async_commit();
    k8_compute(st[t % kK8Stages], wm, wn, ty, tx, ah, al);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = r0 + wm * 32 + ty + 4 * i;
    if (r >= R) continue;
    const int64_t c = c0 + wn * 32 + 4 * tx;
    float* y = Y + r * ldy + c;
    if (vec_y && c + 3 < C) {
      *reinterpret_cast<float4*>(y) = make_float4(
          __fadd_rn(ah[i][0], al[i][0]), __fadd_rn(ah[i][1], al[i][1]),
          __fadd_rn(ah[i][2], al[i][2]), __fadd_rn(ah[i][3], al[i][3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < C) y[j] = __fadd_rn(ah[i][j], al[i][j]);
    }
  }
}

}  // namespace jc

#ifdef __CUDACC__
namespace {

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kVecM, bool kVecX>
cudaError_t k8_launch(dim3 grid, const float* Mh, const float* Ml,
                      long long ldm, const float* X, long long ldx, float* Y,
                      long long ldy, int R, int K, int C, int lower, int vec_y,
                      cudaStream_t stream) {
  auto kern = jc::split_fold_kernel<kVecM, kVecX>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)jc::kK8SmemBytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, jc::kK8Threads, jc::kK8SmemBytes, stream>>>(
      Mh, Ml, ldm, X, ldx, Y, ldy, R, K, C, lower, vec_y);
  return cudaGetLastError();
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
  if (R <= 0 || C <= 0) return 0;
  const dim3 grid((unsigned)((C + jc::kK8TileN - 1) / jc::kK8TileN),
                  (unsigned)((R + jc::kK8TileM - 1) / jc::kK8TileM));
  const bool vm = aligned16(Mh) && aligned16(Ml) && ldm % 4 == 0;
  const bool vx = aligned16(X) && ldx % 4 == 0;
  const int vy = aligned16(Y) && ldy % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto launch) {
    return (int)launch(grid, Mh, Ml, ldm, X, ldx, Y, ldy, R, K, C, lower, vy,
                       s);
  };
  if (vm && vx) return go(k8_launch<true, true>);
  if (vm) return go(k8_launch<true, false>);
  if (vx) return go(k8_launch<false, true>);
  return go(k8_launch<false, false>);
}
#endif  // __CUDACC__
