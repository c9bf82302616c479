// CPU stand-in for the parts of the CUDA runtime that csrc/eri4c.cuh,
// csrc/eri3c.cuh and csrc/oei.cuh use, so that their device code compiles
// with g++ (C++20): each thread of a block is a std::thread, a warp's
// __syncwarp a std::barrier of its 32 threads, __syncthreads one of the
// block's, a shuffle an exchange through the warp's slots between two
// barrier waits, atomicAdd an atomic_ref, and dmma.cuh's mma.sync m16n8k4 f64 step an
// exchange of the 32 lanes' fragments (the PTX ISA's fragment maps), and
// dmma.cuh's cp.async copies queued per thread and done at the wait that
// retires their group (zero-filled past the bytes read; the card's
// alignment asserted).  Used by harness.cpp, eri3c_harness.cpp and
// oei_harness.cpp only.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cassert>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

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
extern thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

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

struct CpAsyncCopy {
  void* dst;
  const void* src;
  int size, n;
};
inline thread_local std::vector<std::vector<CpAsyncCopy>> tl_cp_groups;
inline thread_local std::vector<CpAsyncCopy> tl_cp_open;

inline void cp_async_queue(void* dst, const void* src, int size, int n) {
  assert(reinterpret_cast<uintptr_t>(dst) % size == 0);
  assert(n == 0 || reinterpret_cast<uintptr_t>(src) % size == 0);
  assert(n >= 0 && n <= size);
  tl_cp_open.push_back({dst, src, size, n});
}
inline void cp_async4(void* dst, const void* src, bool ok) {
  cp_async_queue(dst, src, 4, ok ? 4 : 0);
}
inline void cp_async8(void* dst, const void* src, bool ok) {
  cp_async_queue(dst, src, 8, ok ? 8 : 0);
}
inline void cp_async16(void* dst, const void* src, int n) {
  cp_async_queue(dst, src, 16, n);
}
inline void cp_async_commit() {
  tl_cp_groups.push_back(std::move(tl_cp_open));
  tl_cp_open.clear();
}
template <int N>
inline void cp_async_wait() {
  while (tl_cp_groups.size() > (size_t)N) {
    for (const CpAsyncCopy& c : tl_cp_groups.front()) {
      std::memcpy(c.dst, c.src, c.n);
      std::memset(static_cast<char*>(c.dst) + c.n, 0, c.size - c.n);
    }
    tl_cp_groups.erase(tl_cp_groups.begin());
  }
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

inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }

// the lanes of the warp whose key equals this lane's
inline unsigned __match_any_sync(unsigned, unsigned long long key) {
  const int lane = threadIdx.x & 31;
  std::memcpy(tl_warp->slots[lane], &key, 8);
  tl_warp->bar->arrive_and_wait();
  unsigned m = 0;
  for (int j = 0; j < 32; ++j) {
    unsigned long long o;
    std::memcpy(&o, tl_warp->slots[j], 8);
    if (o == key) m |= 1u << j;
  }
  tl_warp->bar->arrive_and_wait();
  return m;
}

inline bool __any_sync(unsigned, bool p) {
  const int lane = threadIdx.x & 31;
  tl_warp->slots[lane][0] = p;
  tl_warp->bar->arrive_and_wait();
  bool any = false;
  for (int j = 0; j < 32; ++j) any = any || tl_warp->slots[j][0];
  tl_warp->bar->arrive_and_wait();
  return any;
}

template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return shfl_from(v, src & 31);
}

template <class T>
T __shfl_xor_sync(unsigned, T v, int m) {
  const int lane = threadIdx.x & 31;
  return shfl_from(v, (lane ^ m) & 31);
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
