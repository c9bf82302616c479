// Kernel K7: the fused RI-MP2 pair energy.  From the MO-basis fitted factors
// Bx [A, nox, nvx] and By [A, noy, nvy] (Q outermost, contiguous f64) and the
// orbital energies, for every (i, j, a, b)
//   X  = (ia|jb) = sum_Q Bx[Q, i, a] By[Q, j, b],
//   X' = (ib|ja)                                   (modes rmp2, ss: x = y),
//   D  = e_i + e_j - e_a - e_b,
// reduced to f64 energies:
//   rmp2  sum X (2X - X') / D      (closed-shell RI-MP2), and in the same
//         launch sum X^2 / D       (its opposite-spin part, for SCS-MP2)
//   ss    1/4 sum (X - X')^2 / D   (same-spin UMP2 channel)
//   os    sum X^2 / D              (opposite-spin channel, x = alpha, y = beta)
//
// Replaces the lax.scans of juliachem_jl_tpu/models/mp2.py: _e2_kernel (:41),
// _e2_ss_kernel (:158) and _e2_os_kernel (:175).  Each scan step there wrote
// the [no, nv, nv] block of (ia|jb) to device memory and read it back for the
// epilogue; here the integrals live only in registers.  A launch sums the
// terms of an occupied range [i0, i1) of i, so that the ranks of a sharded
// RI-MP2 each sum a disjoint part (the per-device i-blocks of
// make_sharded_e2, juliachem_jl_tpu/models/mp2.py:66).
//
// What bounds it on the card: operations.  The work the energy needs is the
// (ia|jb) product: 2 A nox noy nvx nvy flops for os; for rmp2 and ss, where
// (ia|jb) = (jb|ia) and D is symmetric, only the pairs (ia) <= (jb) of it,
// A (no nv) (no nv + 1) flops (7.0e11 at benzene_2_water's RI-MP2: A 1447,
// no 47, nv 468), about 10.4 ms at the 67 TFLOP/s f64 tensor-core rate.
//
// Design: the products run on the f64 tensor cores (mma.sync m16n8k4,
// dmma.cuh), Q being the k dimension; Q-chunks of 16 rows stream through a
// cp.async ring in shared memory (3 stages; 4 for os), so the loads of the
// next chunks overlap the products of this one.  Loads run along a (or the
// flattened (i a)), contiguous in memory, so they coalesce (8-byte copies;
// os 16-byte ones where a slice's rows are 16-byte aligned: nv may be
// odd).  What limits the products is the data the SMs move per product:
// from L2 into shared memory (a chunk's slices are read again by every
// block that needs them) and from shared memory into the fragments, so the
// tiles are as large as the register file allows.
// - rmp2, ss: one block of 4 warps per (i, j, a-tile, b-tile) of 64 x 64
//   virtuals, each warp a 32 x 32 quarter of X and of X' in DMMA
//   accumulators (64 doubles a lane, 212 registers: 2 blocks an SM,
//   __launch_bounds__(128, 2)).  A chunk stages Bx[q, i, aT], By[q, j,
//   bT], Bx[q, i, bT] and By[q, j, aT] (X' = (ib|ja) is the transposed
//   product of the swapped slices); a diagonal tile pair (aT = bT) stages
//   only the first two and takes X' = X^T from shared memory after the
//   product, so its X' costs no DMMA.  (One block for two pairs (i, j),
//   (i, j + 1), sharing the slices of i, stages 6 slices for 4 products
//   instead of 8, but at 8 warps it fits one block an SM and ran slower
//   on an H100.)  Symmetry: the energy of pair (j, i) equals that of
//   (i, j), and D is symmetric in (a, b), so only j <= i (weight 2 off the
//   diagonal) and a-tile <= b-tile are launched; an off-diagonal tile pair
//   accounts for both tiles: X (2X - X') + X' (2X' - X) = 2 (X^2 + X'^2 -
//   X X'), X^2 + X'^2 for the opposite-spin part, and (X - X')^2 twice.
// - os: no symmetry, so it is one product of the flattened [(i a), A] x
//   [A, (j b)] factors (rows over the occupied range only) with the energy
//   in its epilogue: blocks of 4 warps own 128 x 64 tiles, each warp 64 x
//   32 (2 blocks an SM; 128 x 128 tiles of 8 warps, one block an SM, ran
//   9 % slower), and walk the tiles in groups of 8 row tiles, so that the
//   blocks in flight share their row and column panels in L2.  Flattening
//   leaves no padding per occupied orbital: only the last row and column
//   tiles are partial.
// - The epilogue forms D from the orbital energies and reduces the block's
//   terms (warp shuffles, then shared memory) to one partial per block and
//   energy in a buffer the wrapper allocates (of the size
//   jc_mp2_e2_partials gives) and sums with torch.sum: the result is the
//   same on every run (no atomics).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dmma.cuh"

namespace {

using jc::DmmaTile;

constexpr int kRMP2 = 0, kSS = 1, kOS = 2;
constexpr int kQC = 16;     // Q rows per staged chunk (4 DMMA k-steps)
constexpr int kStages = 3;  // cp.async ring depth (rmp2, ss)

// rmp2, ss: 64 x 64 tile pairs, 2 x 2 warps of 32 x 32
constexpr int kT = 64;
constexpr int kPThreads = 128;
constexpr int kPStride = kT + 4;  // shared row stride (doubles)
constexpr int kPSlice = kQC * kPStride;
constexpr int kPStage = 4 * kPSlice;  // Xa | Yb | Xb | Ya
// os: 128 x 64 tiles of the flattened product, 2 x 2 warps of 64 x 32
constexpr int kOM = 128, kON = 64;             // rows (i a), cols (j b)
constexpr int kOThreads = 32 * (kOM / 64) * (kON / 32);
constexpr int kOSM = kOM + 4, kOSN = kON + 4;  // shared row strides
constexpr int kOStage = kQC * (kOSM + kOSN);
constexpr int kGroup = 8;  // row tiles per group of the os walk
constexpr int kOStages = 4;

constexpr size_t kPairSmem = sizeof(double) * kStages * kPStage;
constexpr size_t kOsSmem = sizeof(double) * kOStages * kOStage;

// p -> (lo, hi) with lo <= hi, p = hi (hi + 1) / 2 + lo
__device__ __forceinline__ void tri_decode(long long p, int& lo, int& hi) {
  long long h = (long long)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (h * (h + 1) / 2 > p) --h;
  while ((h + 1) * (h + 2) / 2 <= p) ++h;
  hi = (int)h;
  lo = (int)(p - h * (h + 1) / 2);
}

// Stage rows [q0, q0 + kQC) x columns [0, W) of a slice (src: element (0, 0),
// row stride ld) at dst (row stride S); rows at or past A and columns at or
// past nvalid are zero-filled.  With V16, 16-byte copies where every row of
// the slice starts 16-byte aligned (src aligned, ld even); else 8-byte ones
// (the pair kernel takes 8-byte copies only: the second path costs it
// registers, 255 against 212, and time).
template <int W, int S, int NT, bool V16>
__device__ __forceinline__ void stage_slice(double* dst, const double* src,
                                            long long ld, int q0, int A,
                                            int nvalid, int tid) {
  if (V16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (ld & 1) == 0) {
#pragma unroll 4
    for (int e = tid; e < kQC * W / 2; e += NT) {
      const int qq = e / (W / 2), c = 2 * (e % (W / 2));
      const int n = q0 + qq < A ? 8 * max(0, min(2, nvalid - c)) : 0;
      jc::cp_async16(dst + qq * S + c,
                     n ? src + (long long)(q0 + qq) * ld + c : src, n);
    }
    return;
  }
#pragma unroll 4
  for (int e = tid; e < kQC * W; e += NT) {
    const int qq = e / W, c = e % W;
    const bool ok = q0 + qq < A && c < nvalid;
    jc::cp_async8(dst + qq * S + c,
                  ok ? src + (long long)(q0 + qq) * ld + c : src, ok);
  }
}

// sum over the block of one value per thread (NT threads); valid in thread 0
template <int NT>
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  }
  return s;
}

template <int MODE>
__global__ void __launch_bounds__(kPThreads, 2)
mp2_e2_pair_kernel(const double* __restrict__ B, int A, int no, int nv,
                   const double* __restrict__ eo,
                   const double* __restrict__ ev, long long p0,
                   double* __restrict__ partial) {
  extern __shared__ __align__(16) double smem[];
  __shared__ double sEa[kT], sEb[kT];
  __shared__ double sRed[kPThreads / 32];

  // the launch's pairs start at p0 (the occupied range [i0, i1), below)
  int i, j, ta, tb;
  tri_decode(p0 + blockIdx.x, j, i);
  tri_decode(blockIdx.y, ta, tb);
  const bool diag = ta == tb;
  const int a0 = ta * kT, b0 = tb * kT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const long long ld = (long long)no * nv;
  const double* Bi = B + (long long)i * nv;
  const double* Bj = B + (long long)j * nv;

  if (tid < kT) {
    sEa[tid] = a0 + tid < nv ? ev[a0 + tid] : 0.0;
  } else {
    sEb[tid - kT] = b0 + tid - kT < nv ? ev[b0 + tid - kT] : 0.0;
  }

  DmmaTile<2, 4> X, Xp;  // X[a, b] and X'[a, b] = (ib|ja)
  X.zero();
  Xp.zero();

  const int nch = (A + kQC - 1) / kQC;
  // chunk c into its stage: Xa | Yb | Xb | Ya, each [kQC][kPStride] (a
  // diagonal tile pair stages the first two only)
  auto issue = [&](int c) {
    if (c < nch) {
      double* st = smem + (c % kStages) * kPStage;
      const int q0 = c * kQC;
      stage_slice<kT, kPStride, kPThreads, false>(st, Bi + a0, ld, q0, A, nv - a0,
                                           tid);
      stage_slice<kT, kPStride, kPThreads, false>(st + kPSlice, Bj + b0, ld, q0, A,
                                           nv - b0, tid);
      if (!diag) {
        stage_slice<kT, kPStride, kPThreads, false>(st + 2 * kPSlice, Bi + b0, ld,
                                             q0, A, nv - b0, tid);
        stage_slice<kT, kPStride, kPThreads, false>(st + 3 * kPSlice, Bj + a0, ld,
                                             q0, A, nv - a0, tid);
      }
    }
    jc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int c = 0; c < nch; ++c) {
    jc::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed for every thread; c - 1 is consumed
    issue(c + kStages - 1);
    const double* st = smem + (c % kStages) * kPStage;
    const double* sXa = st;
    const double* sYb = st + kPSlice;
    const double* sXb = st + 2 * kPSlice;
    const double* sYa = st + 3 * kPSlice;
#pragma unroll
    for (int kk = 0; kk < kQC; kk += 4) {
      X.step(sXa + kk * kPStride + wm, kPStride, sYb + kk * kPStride + wn,
             kPStride, lane);
      if (!diag)
        Xp.step(sYa + kk * kPStride + wm, kPStride, sXb + kk * kPStride + wn,
                kPStride, lane);
    }
  }
  jc::cp_async_wait<0>();
  if (diag) {  // X' = X^T on a diagonal tile pair, through the free ring
    constexpr int TS = kT + 1;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          smem[(wm + DmmaTile<2, 4>::row(u, e, lane)) * TS + wn +
               DmmaTile<2, 4>::col(v, e, lane)] = X.c[u][v][e];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Xp.c[u][v][e] = smem[(wn + DmmaTile<2, 4>::col(v, e, lane)) * TS +
                               wm + DmmaTile<2, 4>::row(u, e, lane)];
  }

  const double eij = eo[i] + eo[j];
  double acc = 0.0, acc_os = 0.0;  // acc_os: rmp2's opposite-spin part
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ca = wm + DmmaTile<2, 4>::row(u, e, lane);
        const int cb = wn + DmmaTile<2, 4>::col(v, e, lane);
        if (a0 + ca >= nv || b0 + cb >= nv) continue;
        const double d = eij - sEa[ca] - sEb[cb];
        const double x = X.c[u][v][e], r = Xp.c[u][v][e];
        if (MODE == kRMP2) {
          acc += (diag ? x * (2.0 * x - r) : 2.0 * (x * x + r * r - x * r)) / d;
          acc_os += (diag ? x * x : x * x + r * r) / d;
        } else {
          acc += (diag ? 0.25 : 0.5) * (x - r) * (x - r) / d;
        }
      }
    }
  }
  if (i != j) {
    acc *= 2.0;
    acc_os *= 2.0;
  }
  const long long nb = (long long)gridDim.x * gridDim.y;
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const double s = block_sum<kPThreads>(acc, sRed);
  if (tid == 0) partial[blk] = s;
  if constexpr (MODE == kRMP2) {
    const double s_os = block_sum<kPThreads>(acc_os, sRed);
    if (tid == 0) partial[nb + blk] = s_os;
  }
}

__global__ void __launch_bounds__(kOThreads, 256 / kOThreads)
mp2_e2_os_kernel(const double* __restrict__ Bx, const double* __restrict__ By,
                 int A, int nox, int nvx, int noy, int nvy,
                 const double* __restrict__ eox,
                 const double* __restrict__ evx,
                 const double* __restrict__ eoy,
                 const double* __restrict__ evy, int i0, int rows,
                 int row_tiles, int col_tiles, double* __restrict__ partial) {
  extern __shared__ __align__(16) double smem[];
  __shared__ double sRed[kOThreads / 32];

  // grouped walk: kGroup row tiles at a time, each over every column tile
  const long long L = blockIdx.x;
  const long long per_group = (long long)kGroup * col_tiles;
  const int first = (int)(L / per_group) * kGroup;
  const int gsz = min(row_tiles - first, kGroup);
  const int in = (int)(L % per_group);
  const int tr = first + in % gsz, tc = in / gsz;
  const int r0 = tr * kOM, c0 = tc * kON;
  const int cols = noy * nvy;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / (kON / 32)) * 64, wn = (warp % (kON / 32)) * 32;
  const double* Xs = Bx + (long long)i0 * nvx + r0;
  const double* Ys = By + c0;
  const long long ldx = (long long)nox * nvx, ldy = (long long)cols;

  DmmaTile<4, 4> X;
  X.zero();
  const int nch = (A + kQC - 1) / kQC;
  auto issue = [&](int c) {
    if (c < nch) {
      double* st = smem + (c % kOStages) * kOStage;
      stage_slice<kOM, kOSM, kOThreads, true>(st, Xs, ldx, c * kQC, A, rows - r0,
                                        tid);
      stage_slice<kON, kOSN, kOThreads, true>(st + kQC * kOSM, Ys, ldy, c * kQC, A,
                                        cols - c0, tid);
    }
    jc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kOStages - 1; ++s) issue(s);
  for (int c = 0; c < nch; ++c) {
    jc::cp_async_wait<kOStages - 2>();
    __syncthreads();
    issue(c + kOStages - 1);
    const double* sX = smem + (c % kOStages) * kOStage;
    const double* sY = sX + kQC * kOSM;
#pragma unroll
    for (int kk = 0; kk < kQC; kk += 4)
      X.step(sX + kk * kOSM + wm, kOSM, sY + kk * kOSN + wn, kOSN, lane);
  }
  jc::cp_async_wait<0>();

  double acc = 0.0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the fragment
      const int r = r0 + wm + DmmaTile<4, 4>::row(u, 2 * h, lane);
      if (r >= rows) continue;
      const int i = i0 + r / nvx;
      const double ei = eox[i] - evx[r % nvx];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const int cl = c0 + wn + DmmaTile<4, 4>::col(v, e, lane);
          if (cl >= cols) continue;
          const double d = ei + eoy[cl / nvy] - evy[cl % nvy];
          const double p = X.c[u][v][e];
          acc += p * p / d;
        }
      }
    }
  }
  const double s = block_sum<kOThreads>(acc, sRed);
  if (tid == 0) partial[L] = s;
}

// The launch grid of one mode over the occupied range [i0, i1) of i: for
// rmp2 and ss, x = the occupied pairs j <= i with i in the range (p0 =
// i0 (i0 + 1) / 2 the first; i0 = 0, i1 = no gives all no (no + 1) / 2) and
// y = nt (nt + 1) / 2 virtual tile pairs (nt = ceil(nv / 64)); for os, one
// dimension of row_tiles x col_tiles blocks, row_tiles = ceil((i1 - i0) nvx
// / 128) and col_tiles = ceil(noy nvy / 64) (p0 unused).  Disjoint ranges
// that cover [0, no) sum to the whole-range energy.  false for shapes K7
// does not take (rmp2/ss with x != y, an empty range or channel, a grid or
// a flattened index over CUDA's or int32's limits).
bool e2_grid(int mode, int nox, int nvx, int noy, int nvy, int i0, int i1,
             long long& gx, long long& gy, long long& p0) {
  if (i0 < 0 || i1 > nox || i0 >= i1 || nvx <= 0 || noy <= 0 || nvy <= 0)
    return false;
  if (mode == kOS) {
    const long long rows = (long long)(i1 - i0) * nvx;
    const long long cols = (long long)noy * nvy;
    if ((long long)nox * nvx >= 2147483647LL || cols >= 2147483647LL)
      return false;
    p0 = 0;
    gx = ((rows + kOM - 1) / kOM) * ((cols + kON - 1) / kON);
    gy = 1;
  } else if ((mode == kRMP2 || mode == kSS) && nox == noy && nvx == nvy) {
    const long long nt = (nvx + kT - 1) / kT;
    p0 = (long long)i0 * (i0 + 1) / 2;
    gx = (long long)i1 * (i1 + 1) / 2 - p0;
    gy = nt * (nt + 1) / 2;
  } else {
    return false;
  }
  return gx > 0 && gy > 0 && gx <= 2147483647LL && gy <= 65535;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// The length of the partial buffer jc_mp2_e2 writes for this mode, these
// shapes and the occupied range [i0, i1) (one energy per block; two for
// rmp2: E2, then its opposite-spin part), or -1 if K7 does not take them.
extern "C" long long jc_mp2_e2_partials(int mode, int nox, int nvx, int noy,
                                        int nvy, int i0, int i1) {
  long long gx, gy, p0;
  if (!e2_grid(mode, nox, nvx, noy, nvy, i0, i1, gx, gy, p0)) return -1;
  return (mode == kRMP2 ? 2 : 1) * gx * gy;
}

// mode 0 rmp2, 1 ss (Bx = By, eox = eoy, evx = evy), 2 os; the terms of the
// occupied range [i0, i1) of i; partial holds n_partial =
// jc_mp2_e2_partials(...) doubles.
extern "C" int jc_mp2_e2(int mode, const double* Bx, const double* By, int A,
                         int nox, int nvx, int noy, int nvy, int i0, int i1,
                         const double* eox, const double* evx,
                         const double* eoy, const double* evy,
                         long long n_partial, double* partial, void* stream) {
  long long gx, gy, p0;
  if (A <= 0 || !e2_grid(mode, nox, nvx, noy, nvy, i0, i1, gx, gy, p0) ||
      n_partial != jc_mp2_e2_partials(mode, nox, nvx, noy, nvy, i0, i1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (mode == kOS) {
    const int rows = (i1 - i0) * nvx;
    const int rt = (rows + kOM - 1) / kOM, ct = (noy * nvy + kON - 1) / kON;
    if ((err = allow_smem(mp2_e2_os_kernel, kOsSmem)) != cudaSuccess)
      return (int)err;
    mp2_e2_os_kernel<<<(unsigned)gx, kOThreads, kOsSmem, s>>>(
        Bx, By, A, nox, nvx, noy, nvy, eox, evx, eoy, evy, i0, rows, rt, ct,
        partial);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (mode == kRMP2) {
    if ((err = allow_smem(mp2_e2_pair_kernel<kRMP2>, kPairSmem)) != cudaSuccess)
      return (int)err;
    mp2_e2_pair_kernel<kRMP2><<<grid, kPThreads, kPairSmem, s>>>(
        Bx, A, nox, nvx, eox, evx, p0, partial);
  } else {
    if ((err = allow_smem(mp2_e2_pair_kernel<kSS>, kPairSmem)) != cudaSuccess)
      return (int)err;
    mp2_e2_pair_kernel<kSS><<<grid, kPThreads, kPairSmem, s>>>(
        Bx, A, nox, nvx, eox, evx, p0, partial);
  }
  return (int)cudaGetLastError();
}
