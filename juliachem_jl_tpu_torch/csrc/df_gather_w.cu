// Kernel K2: exchange factor W of one Q-block of packed B,
//   W[q, i, n] = sum_m Bc[q, col_map[m * nbf + n]] * C[m, i],
// with the trash column (screened-out (m, n)) read as 0.
//
// Replaces the gather + W einsum of juliachem_jl_tpu/models/df_screened.py::
// _jk_chunk / _jk_chunk_signed / _jk_chunk_lower (:302-375) and their
// _fused forms, which expanded the block to a dense [Qc, nbf, nbf] tile in
// device memory first (tile = Bc[:, col_map]; W = einsum("qmn,mi->qin",
// tile, C)).
//
// What bounds it on the card: bytes.  The dense tile never exists: each live
// B element is gathered once per i-group straight into shared memory, and
// the least the function can move is B's block once (its f32 or f64 words),
// col_map, C and W.  What limits this body is the traffic from L2 into the
// SMs: per slab a block reads its col_map tile, its C slab and the gathered
// B, so a block takes several rows q at once and shares the first two
// among them.
//
// Design of the f64 and f32-B instances (DMMA):
// - A block owns 2 rows q, one n-tile of 64 columns and an i-group of 64
//   orbitals, and computes the [64 x 64] tiles W[q, iT, nT] = C[:, iT]^T
//   tile_q[:, nT] on the f64 tensor cores (mma.sync m16n8k4, dmma.cuh):
//   4 warps, each a 32 x 32 tile of (i, n) for both rows, C's fragments
//   loaded once for the two (2 blocks an SM).
// - It walks only the live m-slabs of its n-tile: slabs of 16 rows of m in
//   which some col_map entry is not trash.  The basis is ordered by atom, so
//   screened-out pairs come in whole tiles; the CSR list (slab_ptr[n-tile],
//   slab_idx) is built once per builder from col_map
//   (models/df_screened.py::k2_slabs).  Within a live slab a trash entry
//   gathers the zero trash column: no branch.
// - A 3-stage ring in shared memory holds, per slab, the gathered B tile
//   [16 m][64 n] per row q and the C slab [16 m][64 i] (contiguous rows of
//   C, cp.async,
//   16-byte copies where k is even).
//   The col_map entries of a slab are fetched into registers one slab before
//   its gather is issued, so the gather's addresses are ready when it goes
//   out and the dependent load never stalls the products.  The f64 instance
//   gathers with cp.async; the f32-B instance loads the f32 word one more
//   slab ahead into registers and converts it as it stores to shared memory
//   (cp.async cannot convert).  The shared tiles, and so every DMMA, are
//   then those of the f64 instance on Bc.double(): the two agree bit for bit.
// - The grid runs the i-groups of an n-tile next to each other and q
//   slowest, so the blocks in flight share a few rows of B and col_map in
//   L2.
//
// The f32 instance (the mixed-precision f32 phase: f32 B, C and W) keeps the
// FMA body below: the f32 tensor-core path is TF32, about three decimal
// digits, which is not the JAX package's f32 product.  A block owns one q,
// 16 orbitals and 128 consecutive n; consecutive threads walk consecutive n,
// so the col_map reads are coalesced and, pq_flat being sorted, the B
// gathers of one m mostly are too; trash entries are skipped one at a time.
//
// The signed factor of an indefinite density is just another C; its sign is
// applied in the W^T W product outside.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma.cuh"

namespace {

using jc::DmmaTile;

// ---- DMMA body (f64 and f32-B instances)
// rows of m per slab and columns of n per block: given by the build
// (ops/kernels.py), whose slab list (models/df_screened.py::k2_slabs) is
// made on the same tiles
constexpr int kSlabM = JC_K2_SLAB_M;
constexpr int kTileN = JC_K2_TILE_N;
constexpr int kStages = 3;
constexpr int kBStride = kTileN + 4;

// A block: an i-group of kKT orbitals x kTileN n x kNQ rows q.  Each warp
// owns a 32 x 32 tile of (i, n) for kQW of the rows.  (kKT, kNQ) = (64, 2)
// ran fastest at the Q-blocks of benzene_2_water, w32 and w64, f64 and f32
// B, against (64, 1), (64, 4) and (128, 2).
constexpr int kKT = 64, kNQ = 2;
constexpr int kQW = kNQ == 1 ? 1 : 2;
constexpr int kWarpsN = kTileN / 32;  // warps along n
constexpr int kWarps = (kKT / 32) * kWarpsN * (kNQ / kQW);
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = kSlabM * kTileN / kThreads;  // col_map a thread
static_assert(kSlabM % 4 == 0 && kTileN % 32 == 0 &&
                  kSlabM * kTileN % kThreads == 0,
              "slabs in DMMA k-steps of 4, warps of 32 columns, the slab's "
              "col_map spread evenly over the threads");
constexpr int kCStride = kKT + 4;
constexpr int kBTile = kSlabM * kBStride;
constexpr int kStage = kNQ * kBTile + kSlabM * kCStride;
constexpr size_t kSmemBytes = sizeof(double) * kStages * kStage;

template <typename TB>
__global__ void __launch_bounds__(kThreads)
df_gather_w_dmma(const TB* __restrict__ Bc, int64_t ldb, int qc,
                 const int32_t* __restrict__ col_map,
                 const int32_t* __restrict__ slab_ptr,
                 const int32_t* __restrict__ slab_idx,
                 const double* __restrict__ C, int nbf, int k, int n_groups,
                 double* __restrict__ W) {
  constexpr int KT = kKT, NQ = kNQ, NT = kThreads, PER = kPer, QW = kQW;
  constexpr int CS = kCStride;
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x % n_groups, t = blockIdx.x / n_groups;
  const int64_t q0 = (int64_t)blockIdx.y * NQ;
  const int nq = min(NQ, (int)(qc - q0));
  const int i0 = g * KT, n0 = t * kTileN;
  const int wm = (warp % (KT / 32)) * 32;
  const int wn = ((warp / (KT / 32)) % kWarpsN) * 32;
  const int wq = warp / (KT / 32 * kWarpsN) * QW;  // first of its QW rows
  const TB* Bq = Bc + q0 * ldb;
  const int s0 = slab_ptr[t], ns = slab_ptr[t + 1] - s0;
  const bool c16 = (reinterpret_cast<uintptr_t>(C) & 15) == 0 && (k & 1) == 0;

  // this thread's gathered elements e = tid + u NT: (e / kTileN, e % kTileN)
  int cm[PER];       // col_map of the next slab to gather (-1: outside)
  TB bv[NQ][PER];    // f32-B: the B words of the next slab to store
  auto fetch_cm = [&](int s) {
    if (s >= ns) return;
    const int m0 = slab_idx[s0 + s] * kSlabM;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * NT;
      const int m = m0 + e / kTileN, n = n0 + e % kTileN;
      cm[u] = (m < nbf && n < nbf) ? col_map[(int64_t)m * nbf + n] : -1;
    }
  };
  auto load_bv = [&](int s) {
    if (s >= ns) return;
#pragma unroll
    for (int r = 0; r < NQ; ++r)
#pragma unroll
      for (int u = 0; u < PER; ++u)
        bv[r][u] = (cm[u] >= 0 && r < nq) ? Bq[r * ldb + cm[u]] : TB(0);
  };
  // slab s into its stage: NQ gathered tiles and the C slab; one commit
  auto issue = [&](int s) {
    if (s < ns) {
      double* st = smem + (s % kStages) * kStage;
      double* sC = st + NQ * kBTile;
#pragma unroll
      for (int r = 0; r < NQ; ++r)
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int e = tid + u * NT;
          double* dst = st + r * kBTile + (e / kTileN) * kBStride +
                        e % kTileN;
          if constexpr (sizeof(TB) == sizeof(double)) {
            const bool ok = cm[u] >= 0 && r < nq;
            jc::cp_async8(dst, ok ? Bq + r * ldb + cm[u] : Bc, ok);
          } else {
            *dst = static_cast<double>(bv[r][u]);
          }
        }
      const int m0 = slab_idx[s0 + s] * kSlabM;
      if (c16) {  // 16-byte copies: every row of C starts 16-byte aligned
        for (int e = tid; e < kSlabM * KT / 2; e += NT) {
          const int mm = e / (KT / 2), ii = 2 * (e % (KT / 2));
          const int n = m0 + mm < nbf ? 8 * max(0, min(2, k - i0 - ii)) : 0;
          jc::cp_async16(sC + mm * CS + ii,
                         n ? C + (int64_t)(m0 + mm) * k + i0 + ii : C, n);
        }
      } else {
        for (int e = tid; e < kSlabM * KT; e += NT) {
          const int mm = e / KT, ii = e % KT;
          const bool ok = m0 + mm < nbf && i0 + ii < k;
          jc::cp_async8(sC + mm * CS + ii,
                        ok ? C + (int64_t)(m0 + mm) * k + i0 + ii : C, ok);
        }
      }
    }
    jc::cp_async_commit();
  };

  DmmaTile<2, 4> acc[QW];
#pragma unroll
  for (int w = 0; w < QW; ++w) acc[w].zero();
  // prologue: slabs 0 .. kStages - 2 issued; col_map (and the f32 words)
  // of the following ones in registers
  if constexpr (sizeof(TB) == sizeof(double)) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      fetch_cm(s);
      issue(s);
    }
    fetch_cm(kStages - 1);
  } else {
    fetch_cm(0);
    load_bv(0);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      fetch_cm(s + 1);
      issue(s);
      load_bv(s + 1);
    }
    fetch_cm(kStages);
  }
  for (int c = 0; c < ns; ++c) {
    jc::cp_async_wait<kStages - 2>();
    __syncthreads();  // slab c landed for every thread; c - 1 is consumed
    issue(c + kStages - 1);
    if constexpr (sizeof(TB) == sizeof(double)) {
      fetch_cm(c + kStages);
    } else {
      load_bv(c + kStages);
      fetch_cm(c + kStages + 1);
    }
    const double* st = smem + (c % kStages) * kStage;
    const double* sC = st + NQ * kBTile;
#pragma unroll
    for (int kk = 0; kk < kSlabM; kk += 4) {
      // C's fragments once for the warp's rows of B
      const auto a = DmmaTile<2, 4>::load_a(sC + kk * CS + wm, CS, lane);
#pragma unroll
      for (int w = 0; w < QW; ++w)
        acc[w].step_with(a, st + (wq + w) * kBTile + kk * kBStride + wn,
                         kBStride, lane);
    }
  }
  jc::cp_async_wait<0>();

  // W[q, i, n]: each lane writes pairs of consecutive n
#pragma unroll
  for (int w = 0; w < QW; ++w) {
    if (wq + w >= nq) continue;
    const int64_t q = q0 + wq + w;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the fragment
        const int i = i0 + wm + DmmaTile<2, 4>::row(u, 2 * h, lane);
        if (i >= k) continue;
        double* Wr = W + (q * k + i) * nbf;
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const int n = n0 + wn + DmmaTile<2, 4>::col(v, e, lane);
            if (n < nbf) Wr[n] = acc[w].c[u][v][e];
          }
      }
    }
  }
}

template <typename TB>
int launch_dmma(const TB* Bc, long long ldb, const int32_t* col_map,
                const int32_t* slab_ptr, const int32_t* slab_idx,
                const double* C, int nbf, int k, int qc, double* W,
                void* stream) {
  if (nbf <= 0 || k <= 0 || qc <= 0 || qc > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_groups = (k + kKT - 1) / kKT;
  const int n_tiles = (nbf + kTileN - 1) / kTileN;
  if ((long long)n_groups * n_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      df_gather_w_dmma<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles * n_groups, (qc + kNQ - 1) / kNQ);
  df_gather_w_dmma<TB><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      Bc, ldb, qc, col_map, slab_ptr, slab_idx, C, nbf, k, n_groups, W);
  return (int)cudaGetLastError();
}

// ---- FMA body (f32 instance)
constexpr int kFThreads = 128;  // consecutive n per block
constexpr int kFKT = 16;        // orbitals per block
constexpr int kMT = 32;         // rows of C staged per slab

__global__ void __launch_bounds__(kFThreads)
df_gather_w_f32_kernel(const float* __restrict__ Bc, int64_t ldb,
                       int64_t trash, const int32_t* __restrict__ col_map,
                       const float* __restrict__ C, int nbf, int k,
                       float* __restrict__ W) {
  __shared__ float Cs[kMT][kFKT];
  const int n = blockIdx.x * kFThreads + threadIdx.x;
  const int64_t q = blockIdx.y;
  const int i0 = blockIdx.z * kFKT;
  const float* Bq = Bc + q * ldb;
  float acc[kFKT];
#pragma unroll
  for (int ii = 0; ii < kFKT; ++ii) acc[ii] = 0.0f;
  for (int m0 = 0; m0 < nbf; m0 += kMT) {
    for (int e = threadIdx.x; e < kMT * kFKT; e += kFThreads) {
      const int mm = e / kFKT, ii = e % kFKT;
      Cs[mm][ii] = (m0 + mm < nbf && i0 + ii < k)
                       ? C[(int64_t)(m0 + mm) * k + i0 + ii] : 0.0f;
    }
    __syncthreads();
    if (n < nbf) {
      const int mend = min(kMT, nbf - m0);
      for (int mm = 0; mm < mend; ++mm) {
        const int64_t c = col_map[(int64_t)(m0 + mm) * nbf + n];
        if (c == trash) continue;
        const float b = Bq[c];
#pragma unroll
        for (int ii = 0; ii < kFKT; ++ii) acc[ii] += b * Cs[mm][ii];
      }
    }
    __syncthreads();
  }
  if (n < nbf) {
#pragma unroll
    for (int ii = 0; ii < kFKT; ++ii)
      if (i0 + ii < k) W[(q * k + i0 + ii) * nbf + n] = acc[ii];
  }
}

}  // namespace

// Bc: [qc, ldb] rows of packed B (ldb = npq + 1, trash column npq, zero);
// col_map: [nbf * nbf] int32; slab_ptr [ceil(nbf / kTileN) + 1], slab_idx:
// the live kSlabM-row m-slabs of each n-tile (CSR); C: [nbf, k] f64;
// W: [qc, k, nbf] f64.
extern "C" int jc_df_gather_w_f64(const double* Bc, long long ldb,
                                  const int32_t* col_map,
                                  const int32_t* slab_ptr,
                                  const int32_t* slab_idx, const double* C,
                                  int nbf, int k, int qc, double* W,
                                  void* stream) {
  return launch_dmma<double>(Bc, ldb, col_map, slab_ptr, slab_idx, C, nbf, k,
                             qc, W, stream);
}

// The same on an f32 B (the f64 iterations on a df_b_dtype "f32" B): bit for
// bit jc_df_gather_w_f64 on Bc.double().
extern "C" int jc_df_gather_w_f32b(const float* Bc, long long ldb,
                                   const int32_t* col_map,
                                   const int32_t* slab_ptr,
                                   const int32_t* slab_idx, const double* C,
                                   int nbf, int k, int qc, double* W,
                                   void* stream) {
  return launch_dmma<float>(Bc, ldb, col_map, slab_ptr, slab_idx, C, nbf, k,
                            qc, W, stream);
}

// f32 B, C and W (the mixed-precision phase): the FMA body, all of m.
extern "C" int jc_df_gather_w_f32(const float* Bc, long long ldb,
                                  long long trash, const int32_t* col_map,
                                  const float* C, int nbf, int k, int qc,
                                  float* W, void* stream) {
  const dim3 grid((nbf + kFThreads - 1) / kFThreads, qc, (k + kFKT - 1) / kFKT);
  df_gather_w_f32_kernel<<<grid, kFThreads, 0, (cudaStream_t)stream>>>(
      Bc, ldb, trash, col_map, C, nbf, k, W);
  return (int)cudaGetLastError();
}
