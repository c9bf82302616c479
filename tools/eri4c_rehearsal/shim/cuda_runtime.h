// CPU stand-in for the parts of the CUDA runtime that csrc/eri4c.cuh uses,
// so that its device code compiles with g++ (C++20): each thread of a
// block is a std::thread, a warp's __syncwarp a std::barrier of its 32
// threads, a shuffle an exchange through the warp's slots between two
// barrier waits, atomicAdd an atomic_ref.  Used by harness.cpp only.
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
};
extern thread_local WarpCtx* tl_warp;

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
