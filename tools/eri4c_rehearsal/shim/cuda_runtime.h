// CPU stand-in for the parts of the CUDA runtime that csrc/eri4c.cuh and
// csrc/eri3c.cuh use, so that their device code compiles with g++ (C++20):
// each thread of a block is a std::thread, a warp's __syncwarp a
// std::barrier of its 32 threads, __syncthreads one of the block's, a
// shuffle an exchange through the warp's slots between two barrier waits,
// atomicAdd an atomic_ref, and dmma.cuh's mma.sync m16n8k4 f64 step an
// exchange of the 32 lanes' fragments (the PTX ISA's fragment maps).  Used
// by harness.cpp and eri3c_harness.cpp only.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __restrict__ __restrict

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
extern thread_local dim3 threadIdx, blockIdx, blockDim;

struct WarpCtx {
  std::barrier<>* bar;
  unsigned char slots[32][8];
  double mma[32][3];  // each lane's a0, a1, b of one dmma_16x8x4
};
extern thread_local WarpCtx* tl_warp;
extern thread_local std::barrier<>* tl_block;

using std::exp;
using std::max;
using std::min;
using std::sqrt;

inline double atomicAdd(double* p, double v) {
  return std::atomic_ref<double>(*p).fetch_add(v);
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  tl_warp->bar->arrive_and_wait();
}

inline void __syncthreads() { tl_block->arrive_and_wait(); }

namespace jc {
// c += A B for this lane's share of the 16 x 8 product, lane = 4 g + t:
// a0 = A[g][t], a1 = A[g + 8][t], b = B[t][g], c[e] = C[g + 8 (e / 2)]
// [2 t + e % 2] (csrc/dmma.cuh)
inline void dmma_16x8x4(double (&c)[4], double a0, double a1, double b) {
  const int lane = threadIdx.x & 31;
  double (*m)[3] = tl_warp->mma;
  m[lane][0] = a0;
  m[lane][1] = a1;
  m[lane][2] = b;
  tl_warp->bar->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  double d[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double acc = c[e];
    for (int k = 0; k < 4; ++k)
      acc += m[(row & 7) * 4 + k][row >> 3] * m[col * 4 + k][2];
    d[e] = acc;
  }
  tl_warp->bar->arrive_and_wait();
  for (int e = 0; e < 4; ++e) c[e] = d[e];
}
}  // namespace jc

template <class T>
T shfl_from(T v, int src) {
  static_assert(sizeof(T) <= 8);
  const int lane = threadIdx.x & 31;
  std::memcpy(tl_warp->slots[lane], &v, sizeof(T));
  tl_warp->bar->arrive_and_wait();
  T o;
  std::memcpy(&o, tl_warp->slots[src], sizeof(T));
  tl_warp->bar->arrive_and_wait();
  return o;
}

template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return shfl_from(v, lane >= d ? lane - d : lane);
}

template <class T>
T __shfl_down_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return shfl_from(v, lane + d < 32 ? lane + d : lane);
}
