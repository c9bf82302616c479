// Kernel K1: 3-center integrals (Q | ab) of one (la, lb | lq) class,
// McMurchie-Davidson, written straight into the device-resident B.
//
// Replaces juliachem_jl_tpu/ops/eri3c.py::_threecenter_compute_kernel
// (:125-189) with its inlined Boys function (ops/boys.py:61-98) and Hermite
// E / R recurrences (ops/mcmurchie.py:58-192), plus the host scatter
// (_scatter_block_host, :192-208).  Math, per primitive pair k of the bra and
// primitive r of the aux shell (aux partner: unit shell, exponent 0):
//   out[ab, c] = sum_{k,h} Eab[k,ab,h] T1[k,h,c],
//   T1[k,h,c]  = sum_{r,g} (-1)^|g| R[k,r](h+g) Ecd[r,c,g].
//
// What bounds it on the card: the recurrences are serial per primitive pair
// and the working set of a class reaches nherm(8) = 165 R values, 36 x 35 E
// values and 35 x 15 T1 values ((dd|g)), far past what one thread can keep
// in registers.  Design: one thread block per (bra pair, tile of aux
// shells).  The bra expansion Eab is built once per block in shared memory
// and reused over the aux tile; for each aux shell the R tensors of all
// primitive pairs (one thread each) and then T1 and the output (threads over
// their elements) go through shared memory.  Every (aux row, column) target
// belongs to exactly one (pair, aux function), so outputs are plain stores:
// no atomics.  Simple and right first; wgmma/DMMA, TMA and persistent
// blocks are later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "boys.cuh"
#include "mcmurchie.cuh"

namespace jc {

// Shared-memory layout of one block, in doubles.
template <int LA, int LB, int LQ>
struct Eri3cSmem {
  static constexpr int LP = LA + LB, L = LP + LQ;
  static constexpr int NAB = ncart(LA) * ncart(LB), NHB = nherm(LP);
  static constexpr int NCQ = ncart(LQ), NHQ = nherm(LQ), NH = nherm(L);
  static constexpr int NE = (LA + 1) * (LB + 1) * (LP + 1);
  static constexpr int NEQ = (LQ + 1) * (LQ + 1);
  int E, Eab, P, EQ, Ecd, Qc, R, T1, total;
  __host__ __device__ Eri3cSmem(int K2, int Kq) {
    E = 0;                        // [K2][3][NE] bra E tables
    Eab = E + K2 * 3 * NE;        // [K2][NAB][NHB]
    P = Eab + K2 * NAB * NHB;     // [K2][4]: p, Px, Py, Pz
    EQ = P + K2 * 4;              // [Kq][3][NEQ] aux E tables
    Ecd = EQ + Kq * 3 * NEQ;      // [Kq][NCQ][NHQ]
    Qc = Ecd + Kq * NCQ * NHQ;    // [Kq][4]: q, Qx, Qy, Qz
    R = Qc + Kq * 4;              // [K2][NH]
    T1 = R + K2 * NH;             // [K2][NHB][NCQ]
    total = T1 + K2 * NHB * NCQ;
  }
};

constexpr int kEri3cThreads = 128;
constexpr int kEri3cQTile = 8;  // aux shells per block

// pair: [n][2Ka+2Kb+6] = aexp | acoef | bexp | bcoef | A | B
// aux:  [nq][2Kq+3]    = qexp | qcoef | Q
// out[(qrow[q] + c) * ld + cols[p*NAB + ab]] (and cols_t when mirror[p])
template <int LA, int LB, int LQ>
__global__ void __launch_bounds__(kEri3cThreads)
eri3c_kernel(const double* __restrict__ pair, int Ka, int Kb,
             const double* __restrict__ aux, const int64_t* __restrict__ qrow,
             int nq, int Kq, const int64_t* __restrict__ cols,
             const int64_t* __restrict__ cols_t,
             const uint8_t* __restrict__ mirror, double* __restrict__ out,
             int64_t ld) {
  using S = Eri3cSmem<LA, LB, LQ>;
  constexpr int NCB = ncart(LB), NAB = S::NAB, NHB = S::NHB, NCQ = S::NCQ;
  constexpr int NHQ = S::NHQ, NH = S::NH, NE = S::NE, NEQ = S::NEQ;
  constexpr int LP = S::LP, L = S::L, NT = LP + 1;
  extern __shared__ double sm[];
  const int K2 = Ka * Kb;
  const S lay(K2, Kq);
  double* sE = sm + lay.E;
  double* sEab = sm + lay.Eab;
  double* sP = sm + lay.P;
  double* sEQ = sm + lay.EQ;
  double* sEcd = sm + lay.Ecd;
  double* sQ = sm + lay.Qc;
  double* sR = sm + lay.R;
  double* sT1 = sm + lay.T1;

  const int64_t pidx = blockIdx.x;
  const double* pr = pair + pidx * (2 * Ka + 2 * Kb + 6);
  const double* cA = pr + 2 * Ka + 2 * Kb;
  const double* cB = cA + 3;
  const int tid = threadIdx.x, nthr = blockDim.x;

  // 1. bra primitive pairs: product centres and per-dimension E tables
  for (int k = tid; k < K2; k += nthr) {
    const double a = pr[k / Kb], b = pr[2 * Ka + k % Kb];
    const double p = a + b, mu = a * b / p;
    sP[4 * k] = p;
    for (int d = 0; d < 3; ++d) {
      const double Pd = (a * cA[d] + b * cB[d]) / p;
      sP[4 * k + 1 + d] = Pd;
      hermite_E<LA, LB>(p, mu, Pd - cA[d], Pd - cB[d], cA[d] - cB[d],
                        sE + (k * 3 + d) * NE);
    }
  }
  __syncthreads();
  // 2. bra Hermite expansion with axial norms and contraction folded in
  for (int e = tid; e < K2 * NAB * NHB; e += nthr) {
    const int k = e / (NAB * NHB), ab = (e / NHB) % NAB, h = e % NHB;
    int ax, ay, az, bx, by, bz, t, u, v;
    cart_comp(LA, ab / NCB, ax, ay, az);
    cart_comp(LB, ab % NCB, bx, by, bz);
    herm_triple(h, t, u, v);
    const double* Ek = sE + k * 3 * NE;
    auto at = [](int i, int j, int tt) { return (i * (LB + 1) + j) * NT + tt; };
    const double val = Ek[at(ax, bx, t)] * Ek[NE + at(ay, by, u)] *
                       Ek[2 * NE + at(az, bz, v)];
    const double cc = pr[Ka + k / Kb] * pr[2 * Ka + Kb + k % Kb];
    sEab[e] = val * (axial(LA, ax, ay, az) * axial(LB, bx, by, bz)) * cc;
  }

  const int q0 = blockIdx.y * kEri3cQTile;
  const int q1 = min(q0 + kEri3cQTile, nq);
  const uint8_t mir = mirror[pidx];
  for (int q = q0; q < q1; ++q) {
    const double* qa = aux + (int64_t)q * (2 * Kq + 3);
    __syncthreads();  // previous shell's output pass is done with sT1
    // 3. aux expansion: the pair (aux shell, unit shell) of exponent 0
    for (int r = tid; r < Kq; r += nthr) {
      const double a = qa[r], p = a + 0.0, mu = a * 0.0 / p;
      sQ[4 * r] = p;
      for (int d = 0; d < 3; ++d) {
        const double Qd = qa[2 * Kq + d];
        const double Pd = (a * Qd + 0.0 * Qd) / p;
        sQ[4 * r + 1 + d] = Pd;
        hermite_E<LQ, 0>(p, mu, Pd - Qd, Pd - Qd, 0.0, sEQ + (r * 3 + d) * NEQ);
      }
    }
    for (int e = tid; e < K2 * NHB * NCQ; e += nthr) sT1[e] = 0.0;
    __syncthreads();
    for (int e = tid; e < Kq * NCQ * NHQ; e += nthr) {
      const int r = e / (NCQ * NHQ), c = (e / NHQ) % NCQ, g = e % NHQ;
      int cx, cy, cz, t, u, v;
      cart_comp(LQ, c, cx, cy, cz);
      herm_triple(g, t, u, v);
      const double* Er = sEQ + r * 3 * NEQ;
      const double val = Er[cx * (LQ + 1) + t] * Er[NEQ + cy * (LQ + 1) + u] *
                         Er[2 * NEQ + cz * (LQ + 1) + v];
      sEcd[e] = val * (axial(LQ, cx, cy, cz) * 1.0) * (qa[Kq + r] * 1.0);
    }
    __syncthreads();
    for (int r = 0; r < Kq; ++r) {
      // 4. R tensors, one thread per bra primitive pair
      for (int k = tid; k < K2; k += nthr) {
        const double p = sP[4 * k], qe = sQ[4 * r];
        const double X = sP[4 * k + 1] - sQ[4 * r + 1];
        const double Y = sP[4 * k + 2] - sQ[4 * r + 2];
        const double Z = sP[4 * k + 3] - sQ[4 * r + 3];
        const double psum = p + qe, alpha = p * qe / psum;
        const double T = alpha * (X * X + Y * Y + Z * Z);
        const double pref = kTwoPiPow2_5 / (p * qe * sqrt(psum));
        double F[L + 1];
        boys<L>(T, F);
        for (int m = 0; m <= L; ++m) F[m] *= pref;
        hermite_R<L>(alpha, X, Y, Z, F, sR + k * NH);
      }
      __syncthreads();
      // 5. T1[k][h][c] += sum_g (-1)^|g| R[k](h+g) Ecd[r][c][g]
      for (int e = tid; e < K2 * NHB * NCQ; e += nthr) {
        const int k = e / (NHB * NCQ), h = (e / NCQ) % NHB, c = e % NCQ;
        int t, u, v;
        herm_triple(h, t, u, v);
        const double* Rk = sR + k * NH;
        const double* Ec = sEcd + (r * NCQ + c) * NHQ;
        double acc = 0.0;
        for (int s = 0, g = 0; s <= LQ; ++s)
          for (int d = 0; d <= s; ++d)
            for (int u2 = d; u2 >= 0; --u2, ++g) {
              const int t2 = s - d, v2 = d - u2;
              const double m = Rk[herm_index(t + t2, u + u2, v + v2)];
              acc += ((s & 1) ? -m : m) * Ec[g];
            }
        sT1[e] += acc;
      }
      __syncthreads();
    }
    // 6. out[ab][c] = sum_{k,h} Eab[k][ab][h] T1[k][h][c], stored into B
    const int64_t row0 = qrow[q];
    for (int e = tid; e < NAB * NCQ; e += nthr) {
      const int ab = e / NCQ, c = e % NCQ;
      double acc = 0.0;
      for (int k = 0; k < K2; ++k) {
        const double* Ek = sEab + (k * NAB + ab) * NHB;
        const double* Tk = sT1 + k * NHB * NCQ + c;
        for (int h = 0; h < NHB; ++h) acc += Ek[h] * Tk[h * NCQ];
      }
      double* orow = out + (row0 + c) * ld;
      orow[cols[pidx * NAB + ab]] = acc;
      if (mir) orow[cols_t[pidx * NAB + ab]] = acc;
    }
  }
}

template <int LA, int LB, int LQ>
int eri3c_launch(const double* pair, long long n, int Ka, int Kb,
                 const double* aux, const long long* qrow, int nq, int Kq,
                 const long long* cols, const long long* cols_t,
                 const unsigned char* mirror, double* out, long long ld,
                 cudaStream_t stream) {
  const size_t bytes = sizeof(double) * Eri3cSmem<LA, LB, LQ>(Ka * Kb, Kq).total;
  auto kern = eri3c_kernel<LA, LB, LQ>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)n, (unsigned)((nq + kEri3cQTile - 1) / kEri3cQTile));
  kern<<<grid, kEri3cThreads, bytes, stream>>>(
      pair, Ka, Kb, aux, reinterpret_cast<const int64_t*>(qrow), nq, Kq,
      reinterpret_cast<const int64_t*>(cols),
      reinterpret_cast<const int64_t*>(cols_t),
      reinterpret_cast<const uint8_t*>(mirror), out, ld);
  return (int)cudaGetLastError();
}

}  // namespace jc

// One translation unit per aux angular momentum LQ, so nvcc builds the
// classes in parallel: defines jc_eri3c_lq<LQ>(la, lb, ...).
#define JC_ERI3C_CASE(LA, LB, LQ)                                            \
  if (la == LA && lb == LB)                                                  \
    return jc::eri3c_launch<LA, LB, LQ>(pair, n, Ka, Kb, aux, qrow, nq, Kq,  \
                                        cols, cols_t, mirror, out, ld,       \
                                        (cudaStream_t)stream);

#define JC_ERI3C_LQ(LQ)                                                      \
  extern "C" int jc_eri3c_lq##LQ(                                            \
      int la, int lb, const double* pair, long long n, int Ka, int Kb,      \
      const double* aux, const long long* qrow, int nq, int Kq,              \
      const long long* cols, const long long* cols_t,                        \
      const unsigned char* mirror, double* out, long long ld, void* stream) { \
    JC_ERI3C_CASE(0, 0, LQ)                                                  \
    JC_ERI3C_CASE(0, 1, LQ)                                                  \
    JC_ERI3C_CASE(0, 2, LQ)                                                  \
    JC_ERI3C_CASE(1, 1, LQ)                                                  \
    JC_ERI3C_CASE(1, 2, LQ)                                                  \
    JC_ERI3C_CASE(2, 2, LQ)                                                  \
    JC_ERI3C_CASE(0, 3, LQ)                                                  \
    JC_ERI3C_CASE(0, 4, LQ)                                                  \
    return (int)cudaErrorInvalidValue;                                       \
  }
