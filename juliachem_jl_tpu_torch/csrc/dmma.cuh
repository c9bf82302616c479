// f64 tensor-core (DMMA) and cp.async building blocks for Hopper, shared by
// K2 (df_gather_w.cu), K7 (mp2_e2.cu), K1's block route (eri3c.cuh) and
// K4/K5's block route (eri4c.cuh); K6 (eri4c.cuh) and K8 (split_fold.cu)
// take the cp.async helpers.
//
// wgmma has no f64 form, so the route to the f64 tensor cores on sm_90 is
// the warp-synchronous mma.sync: here mma.sync.aligned.m16n8k4.row.col.f64,
// D[16x8] += A[16x4] B[4x8].  On an H100 SXM (700 W) the m16n8k4, k8 and
// k16 shapes that PTX ISA 7.8 adds for sm_90 each run at 66-67 TFLOP/s on
// registers, the m8n8k4 shape of sm_80 at 33 (tools/dmma_probe.cu: 8 warps
// a block, 8 independent accumulators a warp); k4 needs the fewest
// registers per step.  Fragment maps (PTX ISA, "Matrix Fragments for
// mma.m16n8k4 with .f64"), lane = 0..31, g = lane / 4, t = lane % 4:
//   A pair a0, a1: (row g, col t), (row g + 8, col t)
//   B element:     (row t, col g)
//   C / D c0..c3:  (row g + 8 (e / 2), col 2 t + e % 2), e = 0..3
//
// DmmaTile<FM, FN> is one warp's FM x FN grid of 16 x 8 output fragments (a
// (16 FM) x (8 FN) tile) in registers.  Its operands are staged in shared
// memory k-major: A as sA[k][m] and B as sB[k][n], so every fragment load
// reads one double per lane at (k = t, m or n = g [+ 8]).  With a row
// stride of (a multiple of 16) + 4 doubles the two half-warps of each
// 64-bit load hit 16 distinct bank pairs: no conflicts.
//
// Without __CUDACC__ (a host compiler) only the tile helper is declared
// here: dmma_16x8x4 and the cp.async helpers then come from the including
// file, so the kernel bodies can be exercised on the CPU with lanes
// emulated as threads.
#pragma once

#include <stdint.h>

namespace jc {

#ifdef __CUDACC__

// c += A B for this lane's share of the 16 x 8 product (maps above)
__device__ __forceinline__ void dmma_16x8x4(double (&c)[4], double a0,
                                            double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Asynchronous global -> shared copies of 8 or 16 bytes.  With ok false
// nothing is read (src-size 0) and the destination is zero-filled; src must
// still be a valid address.  16-byte copies need 16-byte aligned addresses
// and go around L1 (.cg).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}

// 4 bytes, or with ok false a zero-filled destination (src still valid)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16 bytes of which the first n (0 to 16, a multiple of 4) are read, the
// rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

// close the copies issued since the last commit into one group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

#endif  // __CUDACC__

template <int FM, int FN>
struct DmmaTile {
  double c[FM][FN][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int u = 0; u < FM; ++u)
#pragma unroll
      for (int v = 0; v < FN; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[u][v][e] = 0.0;
  }

  // this lane's A fragments of one k-step (FM pairs), for step_with
  struct AFrag {
    double v[FM][2];
  };
  static __device__ __forceinline__ AFrag load_a(const double* sA, int lda,
                                                 int lane) {
    const int g = lane >> 2, t = lane & 3;
    AFrag a;
#pragma unroll
    for (int u = 0; u < FM; ++u) {
      a.v[u][0] = sA[t * lda + u * 16 + g];
      a.v[u][1] = sA[t * lda + u * 16 + 8 + g];
    }
    return a;
  }

  // One k-step of 4 with both operands' fragments in registers: b[v] is
  // this lane's B[k0 + t][n0 + 8 v + g]
  __device__ __forceinline__ void step_ab(const AFrag& a,
                                          const double (&b)[FN]) {
#pragma unroll
    for (int u = 0; u < FM; ++u)
#pragma unroll
      for (int v = 0; v < FN; ++v)
        dmma_16x8x4(c[u][v], a.v[u][0], a.v[u][1], b[v]);
  }

  // One k-step of 4 with A's fragments loaded: c += A B[k0 .. k0 + 4,
  // n0 .. n0 + 8 FN], sB pointing at B[k0][n0] (row stride ldb).
  __device__ __forceinline__ void step_with(const AFrag& a, const double* sB,
                                            int ldb, int lane) {
    const int g = lane >> 2, t = lane & 3;
    double b[FN];
#pragma unroll
    for (int v = 0; v < FN; ++v) b[v] = sB[t * ldb + v * 8 + g];
    step_ab(a, b);
  }

  // One k-step of 4: c += A[m0 .. m0 + 16 FM, k0 .. k0 + 4] B[k0 .., n0 ..],
  // sA pointing at A[k0][m0] (row stride lda), sB at B[k0][n0] (ldb).
  __device__ __forceinline__ void step(const double* sA, int lda,
                                       const double* sB, int ldb, int lane) {
    step_with(load_a(sA, lda, lane), sB, ldb, lane);
  }

  // tile coordinates of this lane's element (u, v, e), e = 0..3
  static __device__ __forceinline__ int row(int u, int e, int lane) {
    return u * 16 + (lane >> 2) + 8 * (e >> 1);
  }
  static __device__ __forceinline__ int col(int v, int e, int lane) {
    return v * 8 + 2 * (lane & 3) + (e & 1);
  }
};

}  // namespace jc
