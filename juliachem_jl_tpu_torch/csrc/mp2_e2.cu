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
// no 47, nv 468), about 10.4 ms at the 67 TFLOP/s f64 tensor-core (DMMA)
// rate.  This kernel uses the plain f64 FMA pipes, so it can reach at most
// half that rate (34 TFLOP/s).
//
// Design (simple and right first; DMMA, TMA staging and persistent blocks are
// later work):
// - One thread block per (i, j, a-tile, b-tile) of 64 x 64 virtuals; 256
//   threads, each owning a 4 x 4 set of (a, b) (strided by 16, so the shared
//   memory reads of a warp are conflict-free: two addresses broadcast for
//   the a operand, 16 consecutive doubles for the b operand).
// - Q-chunks of 16 rows of the slices Bx[:, i, aT] and By[:, j, bT] (and, for
//   rmp2/ss, Bx[:, i, bT] and By[:, j, aT]) are staged in shared memory with
//   coalesced loads; two register tiles accumulate X[a, b] and X'[a, b] =
//   X[b, a] over all Q.  4 x 4 tiles do two FMAs per shared-memory load;
//   shared-memory bandwidth and the FMA pipes are then about equally busy
//   (16-byte loads of 4 consecutive a do not help: a 16-byte load is served
//   in four 8-lane phases, so it takes more wavefronts, measured slower).
// - Symmetry (rmp2, ss): the energy of pair (j, i) equals that of (i, j),
//   and D is symmetric in (a, b), so only j <= i (weight 2 off the
//   diagonal) and a-tile <= b-tile are launched; an off-diagonal tile pair
//   accounts for both tiles: X (2X - X') + X' (2X' - X) = 2 (X^2 + X'^2 - X X'),
//   X^2 + X'^2 for the opposite-spin part, and (X - X')^2 twice.  Work:
//   A no (no + 1) / 2 nv^2 (1 + 1/n_tiles) multiply-adds for X and X'
//   together, the needed work above times (1 + 1/n_tiles) (the diagonal
//   tiles compute both halves).  os has no such symmetry and launches every
//   (i, j, aT, bT).
// - The epilogue forms D from the orbital energies staged in shared memory
//   and reduces the block's terms (warp shuffles, then shared memory) to one
//   partial per block and energy in a buffer the wrapper allocates (of the
//   size jc_mp2_e2_partials gives) and sums with torch.sum: the result is
//   the same on every run (no atomics).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // virtuals per tile (a and b)
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kQC = 16;        // Q rows per staged chunk
constexpr int kRMP2 = 0, kSS = 1, kOS = 2;

// p -> (lo, hi) with lo <= hi, p = hi (hi + 1) / 2 + lo
__device__ __forceinline__ void tri_decode(long long p, int& lo, int& hi) {
  long long h = (long long)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (h * (h + 1) / 2 > p) --h;
  while ((h + 1) * (h + 2) / 2 <= p) ++h;
  hi = (int)h;
  lo = (int)(p - h * (h + 1) / 2);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
mp2_e2_kernel(const double* __restrict__ Bx, const double* __restrict__ By,
              int A, int nox, int nvx, int noy, int nvy,
              const double* __restrict__ eox, const double* __restrict__ evx,
              const double* __restrict__ eoy, const double* __restrict__ evy,
              int nty, long long p0, double* __restrict__ partial) {
  constexpr bool kSwap = MODE != kOS;
  constexpr int kQS = kSwap ? kQC : 1;
  __shared__ double sXa[kQC][kT];  // Bx[q, i, aT]
  __shared__ double sYb[kQC][kT];  // By[q, j, bT]
  __shared__ double sXb[kQS][kT];  // Bx[q, i, bT]  (rmp2, ss)
  __shared__ double sYa[kQS][kT];  // By[q, j, aT]  (rmp2, ss)
  __shared__ double sEa[kT], sEb[kT];
  __shared__ double sRed[2][kThreads / 32];

  // the launch's pairs start at p0 (the occupied range [i0, i1), below)
  int i, j, ta, tb;
  if constexpr (kSwap) {
    tri_decode(p0 + blockIdx.x, j, i);
    tri_decode(blockIdx.y, ta, tb);
  } else {
    i = (int)((p0 + blockIdx.x) / noy);
    j = (int)((p0 + blockIdx.x) % noy);
    ta = blockIdx.y / nty;
    tb = blockIdx.y % nty;
  }
  const int a0 = ta * kT, b0 = tb * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long sx = (long long)nox * nvx, sy = (long long)noy * nvy;
  const double* Bxi = Bx + (long long)i * nvx;
  const double* Byj = By + (long long)j * nvy;

  if (threadIdx.x < kT) {
    const int a = a0 + threadIdx.x;
    sEa[threadIdx.x] = a < nvx ? evx[a] : 0.0;
  } else if (threadIdx.x < 2 * kT) {
    const int b = b0 + threadIdx.x - kT;
    sEb[threadIdx.x - kT] = b < nvy ? evy[b] : 0.0;
  }

  double P[4][4], R[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) P[u][v] = R[u][v] = 0.0;

  for (int q0 = 0; q0 < A; q0 += kQC) {
    for (int e = threadIdx.x; e < kQC * kT; e += kThreads) {
      const int qq = e / kT, c = e % kT;
      const long long q = q0 + qq;
      const bool qok = q < A;
      const int a = a0 + c, b = b0 + c;
      sXa[qq][c] = (qok && a < nvx) ? Bxi[q * sx + a] : 0.0;
      sYb[qq][c] = (qok && b < nvy) ? Byj[q * sy + b] : 0.0;
      if constexpr (kSwap) {
        sXb[qq][c] = (qok && b < nvx) ? Bxi[q * sx + b] : 0.0;
        sYa[qq][c] = (qok && a < nvy) ? Byj[q * sy + a] : 0.0;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kQC; ++qq) {
      double xa[4], yb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) xa[u] = sXa[qq][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) yb[v] = sYb[qq][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) P[u][v] = fma(xa[u], yb[v], P[u][v]);
      if constexpr (kSwap) {
        double ya[4], xb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) ya[u] = sYa[qq][ty + 16 * u];
#pragma unroll
        for (int v = 0; v < 4; ++v) xb[v] = sXb[qq][tx + 16 * v];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) R[u][v] = fma(xb[v], ya[u], R[u][v]);
      }
    }
    __syncthreads();
  }

  const double eij = eox[i] + eoy[j];
  double acc = 0.0, acc_os = 0.0;  // acc_os: rmp2's opposite-spin part
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ca = ty + 16 * u, cb = tx + 16 * v;
      if (a0 + ca >= nvx || b0 + cb >= nvy) continue;
      const double d = eij - sEa[ca] - sEb[cb];
      const double p = P[u][v];
      if constexpr (MODE == kOS) {
        acc += p * p / d;
      } else {
        const double r = R[u][v];
        if (MODE == kRMP2) {
          acc += (ta == tb ? p * (2.0 * p - r) : 2.0 * (p * p + r * r - p * r)) / d;
          acc_os += (ta == tb ? p * p : p * p + r * r) / d;
        } else {
          acc += (ta == tb ? 0.25 : 0.5) * (p - r) * (p - r) / d;
        }
      }
    }
  }
  if (kSwap && i != j) {
    acc *= 2.0;
    acc_os *= 2.0;
  }

  constexpr int kOut = MODE == kRMP2 ? 2 : 1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    if constexpr (kOut == 2)
      acc_os += __shfl_down_sync(0xffffffffu, acc_os, off);
  }
  if ((threadIdx.x & 31) == 0) {
    sRed[0][threadIdx.x >> 5] = acc;
    sRed[1][threadIdx.x >> 5] = acc_os;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += sRed[threadIdx.x][w];
    const long long nb = (long long)gridDim.x * gridDim.y;
    partial[threadIdx.x * nb + (long long)blockIdx.y * gridDim.x +
            blockIdx.x] = s;
  }
}

// The launch grid of one mode over the occupied range [i0, i1) of i: for
// rmp2 and ss, x = the occupied pairs j <= i with i in the range (p0 =
// i0 (i0 + 1) / 2 the first; i0 = 0, i1 = no gives all no (no + 1) / 2) and
// y = nt (nt + 1) / 2 virtual tile pairs (nt = ceil(nv / 64)); for os,
// x = (i1 - i0) noy (p0 = i0 noy) and y = ntx nty.  Disjoint ranges that
// cover [0, no) sum to the whole-range energy.  false for shapes K7 does not
// take (rmp2/ss with x != y, an empty range or channel, a grid over CUDA's
// limits).
bool e2_grid(int mode, int nox, int nvx, int noy, int nvy, int i0, int i1,
             long long& gx, long long& gy, long long& p0) {
  const long long ntx = (nvx + kT - 1) / kT, nty = (nvy + kT - 1) / kT;
  if (i0 < 0 || i1 > nox || i0 >= i1) return false;
  if (mode == kOS) {
    p0 = (long long)i0 * noy;
    gx = (long long)(i1 - i0) * noy;
    gy = ntx * nty;
  } else if ((mode == kRMP2 || mode == kSS) && nox == noy && nvx == nvy) {
    p0 = (long long)i0 * (i0 + 1) / 2;
    gx = (long long)i1 * (i1 + 1) / 2 - p0;
    gy = ntx * (ntx + 1) / 2;
  } else {
    return false;
  }
  return gx > 0 && gy > 0 && gx <= 2147483647LL && gy <= 65535;
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
  const long long nty = (nvy + kT - 1) / kT;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kRMP2)
    mp2_e2_kernel<kRMP2><<<grid, kThreads, 0, s>>>(
        Bx, By, A, nox, nvx, noy, nvy, eox, evx, eoy, evy, (int)nty, p0, partial);
  else if (mode == kSS)
    mp2_e2_kernel<kSS><<<grid, kThreads, 0, s>>>(
        Bx, By, A, nox, nvx, noy, nvy, eox, evx, eoy, evy, (int)nty, p0, partial);
  else
    mp2_e2_kernel<kOS><<<grid, kThreads, 0, s>>>(
        Bx, By, A, nox, nvx, noy, nvy, eox, evx, eoy, evy, (int)nty, p0, partial);
  return (int)cudaGetLastError();
}
