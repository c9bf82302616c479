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
// What bounds the f64 and f32-B instances on the card: bytes (the f32
// instance: below).  The dense tile never exists: each live
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
// Design of the f32 instance (the mixed-precision phase: f32 B, C and W):
// FP32 FMA in registers, walking the same live slabs.
// - What binds it.  The function is the f64 instance's at half the bytes:
//   at w32's Q-block (4448 rows, nbf 736, k 160) its 2.76e11 FP32
//   operations need 4.119 ms at 67 TFLOP/s against ~1.0 ms for its bytes
//   (B once, col_map, C, W), so the least it could take is the operations
//   bound.  The FMA body it replaces walked every row m of one q for 16
//   orbitals, paid a col_map read and a branch for each gathered word and
//   fed that word to 16 FMAs, and read col_map and B again for every q and
//   every 16 orbitals: ~100 GB of col_map from L2 per w32 Q-block, 18.8x
//   its bound.
// - A block owns kFNQ rows q, an i-group of kFKT orbitals and one n-tile of
//   kTileN columns (the tile the slab list is made on), and walks only its
//   n-tile's live slabs.  The col_map slab and the C slab are read once for
//   the kFNQ rows, and each gathered word feeds kFKT FMAs (a block's
//   kFKT / 8 thread rows each use it for 8 orbitals).
// - Each thread keeps a register tile of 8 orbitals x 4 n for each of the
//   kFNQ rows (64 FP32 accumulators at kFNQ 2): orbitals 4 ti .. 4 ti + 3
//   and kFKT / 2 + 4 ti .. + 3, columns 4 tn .. 4 tn + 3.  Per row m of a
//   slab it reads two float4 of C and one float4 of B per row q from shared
//   memory for 32 kFNQ FMAs.  A warp's lanes are ti = lane % 8 (+ 8 per
//   warp along i), tn = lane / 8 (+ 4 per warp along n): its float4 reads
//   of C fall on 8 distinct float4 covering the 32 banks, those of B on 4
//   consecutive ones, each shared by 8 lanes (broadcast).
// - A ring of kFStages stages in shared memory holds, per slab, the
//   gathered B tiles [kFNQ][16 m][64 n] and the C slab [16 m][kFKT i] (row
//   strides padded by 4 floats, so every row starts 16-byte aligned).  B is
//   gathered by 4-byte cp.async, C copied by 16-byte cp.async where k is a
//   multiple of 4 (4-byte otherwise); the col_map entries of slab s +
//   kFStages are fetched into registers while slab s is multiplied, so a
//   gather's addresses are ready when it is issued.  A trash entry inside
//   a live slab is zero-filled by a cp.async that reads nothing (source
//   size 0), with no branch: the trash column is never read, and a warp's
//   copies touch only the live words (10-16 % faster at the w32 and w64
//   Q-blocks than gathering the zero column, in one call).
// - Grid as the f64 instance's: the i-groups of an n-tile next to each
//   other, q slowest.  The epilogue stages each row q's [kFKT][64] tile in
//   shared memory and writes W with consecutive n on consecutive lanes.
// - FP32 FMA and not the tensor cores: the f32 tensor-core path is TF32
//   (10 mantissa bits, or three products for split TF32), which is not the
//   JAX package's f32 product.  Here every product is an IEEE FP32 fused
//   multiply-add (__fmaf_rn) accumulated in f32; only the order of the sum
//   over m differs from XLA's (live slabs ascending, m ascending in each).
//   Its SASS holds FFMA and no HMMA or DMMA (chip_smoke.py checks).
// - The tile (kFNQ, kFKT, kFStages = 2, 64, 3, from ops/kernels.py's
//   K2F_*) ran fastest at the Q-blocks of benzene_2_water, w32 and w64
//   (tools/k2_f32_times.py; PERF.md §6) against 4 rows q, 1 row, 128
//   orbitals, 4-6 stages, two row groups sharing a C slab, other unrolls
//   and a 128-register cap: 2.4-3.0x faster than the body it replaced,
//   0.82-1.06x the f64 instance on the same blocks.  What binds it there:
//   the slab walk multiplies every entry of a live slab, 2.8x (w32) and
//   3.7x (w64) the live ones, at ~30 TFLOP/s, and its gathers from L2
//   (col_map, B, C: 1/8 byte an FMA) overlap the FMAs only in part (w32,
//   before trash entries were zero-filled: 38 ms against 23 ms without the
//   B gathers and 24 ms without the FMAs).
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
constexpr int kFNQ = JC_K2F_NQ;           // rows q a block
constexpr int kFKT = JC_K2F_KT;           // orbitals a block
constexpr int kFStages = JC_K2F_STAGES;   // slabs in flight
constexpr int kFRowsI = kFKT / 8;         // thread rows along i
constexpr int kFWarpsI = kFRowsI / 8;     // warps along i
constexpr int kFThreads = kFRowsI * (kTileN / 4);
constexpr int kFPer = kSlabM * kTileN / kFThreads;  // col_map a thread
constexpr int kFBStride = kTileN + 4;
constexpr int kFCStride = kFKT + 4;
constexpr int kFBTile = kSlabM * kFBStride;
constexpr int kFStage = kFNQ * kFBTile + kSlabM * kFCStride;  // floats
constexpr int kFOStride = kTileN + 4;     // the epilogue's row stride
constexpr size_t kFSmemBytes = sizeof(float) * kFStages * kFStage;
static_assert(kFKT % 64 == 0 && kTileN % 16 == 0 && kFStages >= 2 &&
                  kSlabM * kTileN % kFThreads == 0,
              "whole warps of 8 thread rows x 4 thread columns; the slab's "
              "col_map spread evenly over the threads");
static_assert(kFKT * kFOStride <= kFStages * kFStage,
              "one row q's output tile fits the ring");

__global__ void __launch_bounds__(kFThreads)
df_gather_w_f32_kernel(const float* __restrict__ Bc, int64_t ldb, int qc,
                       const int32_t* __restrict__ col_map,
                       const int32_t* __restrict__ slab_ptr,
                       const int32_t* __restrict__ slab_idx,
                       const float* __restrict__ C, int nbf, int k,
                       int n_groups, float* __restrict__ W) {
  constexpr int NQ = kFNQ, KT = kFKT, NT = kFThreads, PER = kFPer;
  constexpr int BS = kFBStride, CS = kFCStride, OS = kFOStride;
  extern __shared__ __align__(16) float k2f_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x % n_groups, t = blockIdx.x / n_groups;
  const int64_t q0 = (int64_t)blockIdx.y * NQ;
  const int nq = min(NQ, (int)(qc - q0));
  const int i0 = g * KT, n0 = t * kTileN;
  // this thread's register tile: orbitals 4 ti + (KT / 2) j + e, columns
  // 4 tn + e
  const int ti = (lane & 7) + 8 * (warp % kFWarpsI);
  const int tn = (lane >> 3) + 4 * (warp / kFWarpsI);
  const float* Bq = Bc + q0 * ldb;
  const int s0 = slab_ptr[t], ns = slab_ptr[t + 1] - s0;
  const bool c16 = (reinterpret_cast<uintptr_t>(C) & 15) == 0 && (k & 3) == 0;

  // this thread's gathered elements e = tid + u NT: (e / kTileN, e % kTileN)
  const int trash = (int)(ldb - 1);
  int cm[PER];   // col_map of the next slab to gather (-1: trash, outside)
  int m_next = 0;  // its first row m
  auto fetch_cm = [&](int s) {
    if (s >= ns) return;
    m_next = slab_idx[s0 + s] * kSlabM;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * NT;
      const int m = m_next + e / kTileN, n = n0 + e % kTileN;
      const int c = (m < nbf && n < nbf) ? col_map[(int64_t)m * nbf + n] : -1;
      cm[u] = c == trash ? -1 : c;
    }
  };
  // slab s into its stage: NQ gathered tiles and the C slab; one commit
  auto issue = [&](int s) {
    if (s < ns) {
      float* st = k2f_smem + (s % kFStages) * kFStage;
      float* sC = st + NQ * kFBTile;
#pragma unroll
      for (int r = 0; r < NQ; ++r)
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int e = tid + u * NT;
          const bool ok = cm[u] >= 0 && r < nq;
          jc::cp_async4(st + r * kFBTile + (e / kTileN) * BS + e % kTileN,
                        ok ? Bq + r * ldb + cm[u] : Bc, ok);
        }
      const int m0 = m_next;
      if (c16) {  // 16-byte copies: every row of C starts 16-byte aligned
        for (int e = tid; e < kSlabM * KT / 4; e += NT) {
          const int mm = e / (KT / 4), ii = 4 * (e % (KT / 4));
          const int n = m0 + mm < nbf ? 4 * max(0, min(4, k - i0 - ii)) : 0;
          jc::cp_async16(sC + mm * CS + ii,
                         n ? C + (int64_t)(m0 + mm) * k + i0 + ii : C, n);
        }
      } else {
        for (int e = tid; e < kSlabM * KT; e += NT) {
          const int mm = e / KT, ii = e % KT;
          const bool ok = m0 + mm < nbf && i0 + ii < k;
          jc::cp_async4(sC + mm * CS + ii,
                        ok ? C + (int64_t)(m0 + mm) * k + i0 + ii : C, ok);
        }
      }
    }
    jc::cp_async_commit();
  };

  float acc[NQ][2][4][4];  // [row q][orbital half][orbital][column]
#pragma unroll
  for (int r = 0; r < NQ; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[r][j][a][b] = 0.0f;
  // prologue: slabs 0 .. kFStages - 2 issued, the col_map of the next in
  // registers
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    fetch_cm(s);
    issue(s);
  }
  fetch_cm(kFStages - 1);
  for (int c = 0; c < ns; ++c) {
    jc::cp_async_wait<kFStages - 2>();
    __syncthreads();  // slab c landed for every thread; c - 1 is consumed
    issue(c + kFStages - 1);
    fetch_cm(c + kFStages);
    const float* st = k2f_smem + (c % kFStages) * kFStage;
    const float* sC = st + NQ * kFBTile + 4 * ti;
#pragma unroll 4
    for (int mm = 0; mm < kSlabM; ++mm) {
      const float4 c0 = *reinterpret_cast<const float4*>(sC + mm * CS);
      const float4 c1 =
          *reinterpret_cast<const float4*>(sC + mm * CS + KT / 2);
      const float cv[2][4] = {{c0.x, c0.y, c0.z, c0.w},
                              {c1.x, c1.y, c1.z, c1.w}};
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        const float4 b = *reinterpret_cast<const float4*>(
            st + r * kFBTile + mm * BS + 4 * tn);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][j][a][e] = __fmaf_rn(cv[j][a], bv[e], acc[r][j][a][e]);
      }
    }
  }
  jc::cp_async_wait<0>();

  // W[q, i, n], one row q at a time through shared memory: consecutive n
  // on consecutive lanes
  float* so = k2f_smem;
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    if (r >= nq) break;  // the same for the whole block
    __syncthreads();     // the ring (or the previous row) is consumed
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(so + (4 * ti + j * (KT / 2) + a) * OS +
                                   4 * tn) =
            make_float4(acc[r][j][a][0], acc[r][j][a][1], acc[r][j][a][2],
                        acc[r][j][a][3]);
    __syncthreads();
    float* Wq = W + (q0 + r) * k * nbf;
    for (int e = tid; e < KT * kTileN; e += NT) {
      const int ii = e / kTileN, nn = e % kTileN;
      const int i = i0 + ii, n = n0 + nn;
      if (i < k && n < nbf) Wq[(int64_t)i * nbf + n] = so[ii * OS + nn];
    }
  }
}

int launch_f32(const float* Bc, long long ldb, const int32_t* col_map,
               const int32_t* slab_ptr, const int32_t* slab_idx,
               const float* C, int nbf, int k, int qc, float* W,
               void* stream) {
  if (nbf <= 0 || k <= 0 || qc <= 0 || qc > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_groups = (k + kFKT - 1) / kFKT;
  const int n_tiles = (nbf + kTileN - 1) / kTileN;
  if ((long long)n_groups * n_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      df_gather_w_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles * n_groups, (qc + kFNQ - 1) / kFNQ);
  df_gather_w_f32_kernel<<<grid, kFThreads, kFSmemBytes,
                           (cudaStream_t)stream>>>(
      Bc, ldb, qc, col_map, slab_ptr, slab_idx, C, nbf, k, n_groups, W);
  return (int)cudaGetLastError();
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

// f32 B, C and W (the mixed-precision phase): the FMA body on the live
// slabs; Bc's trash column is never read.
extern "C" int jc_df_gather_w_f32(const float* Bc, long long ldb,
                                  const int32_t* col_map,
                                  const int32_t* slab_ptr,
                                  const int32_t* slab_idx, const float* C,
                                  int nbf, int k, int qc, float* W,
                                  void* stream) {
  return launch_f32(Bc, ldb, col_map, slab_ptr, slab_idx, C, nbf, k, qc, W,
                    stream);
}
