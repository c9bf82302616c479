// Kernel K2: exchange factor W of one Q-block of packed B,
//   W[q, i, n] = sum_m Bc[q, col_map[m * nbf + n]] * C[m, i],
// with the trash column (screened-out (m, n)) read as 0.
//
// Replaces the gather + W einsum of juliachem_jl_tpu/models/df_screened.py::
// _jk_chunk / _jk_chunk_signed / _jk_chunk_lower (:302-375), which expanded
// the block to a dense [Qc, nbf, nbf] tile in device memory first
// (tile = Bc[:, col_map]; W = einsum("qmn,mi->qin", tile, C)).
//
// What bounds it on the card: bytes.  The dense tile costs Qc * nbf^2 words
// written and read back; here it never exists: each B element is gathered
// once per i-tile straight into registers.  Design: a block owns one q, one
// tile of KT orbitals and 128 consecutive n; consecutive threads walk
// consecutive n, so the col_map reads are coalesced and, pq_flat being
// sorted, the B gathers of one m mostly are too.  The C tile of a slab of m
// is staged in shared memory and read by every thread.  Templated on B's type
// apart from C's and W's: double (f64 iterations), float (the
// mixed-precision f32 phase) and an f32 B with f64 C and W (the f64
// iterations on a df_b_dtype "f32" B, where the JAX package promotes the f32
// block against f64 C: the B load converts to double and the rest is the
// f64 body, so the result equals the f64 instance on Bc.double() bit for
// bit).  The signed factor of an indefinite density is just another C; its
// sign is applied in the W^T W product outside.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // consecutive n per block
constexpr int kKT = 16;        // orbitals per block
constexpr int kMT = 32;        // rows of C staged per slab

template <typename TB, typename T>
__global__ void __launch_bounds__(kThreads)
df_gather_w_kernel(const TB* __restrict__ Bc, int64_t ldb, int64_t trash,
                   const int32_t* __restrict__ col_map,
                   const T* __restrict__ C, int nbf, int k,
                   T* __restrict__ W) {
  __shared__ T Cs[kMT][kKT];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int64_t q = blockIdx.y;
  const int i0 = blockIdx.z * kKT;
  const TB* Bq = Bc + q * ldb;
  T acc[kKT];
#pragma unroll
  for (int ii = 0; ii < kKT; ++ii) acc[ii] = T(0);
  for (int m0 = 0; m0 < nbf; m0 += kMT) {
    for (int e = threadIdx.x; e < kMT * kKT; e += kThreads) {
      const int mm = e / kKT, ii = e % kKT;
      Cs[mm][ii] = (m0 + mm < nbf && i0 + ii < k)
                       ? C[(int64_t)(m0 + mm) * k + i0 + ii] : T(0);
    }
    __syncthreads();
    if (n < nbf) {
      const int mend = min(kMT, nbf - m0);
      for (int mm = 0; mm < mend; ++mm) {
        const int64_t c = col_map[(int64_t)(m0 + mm) * nbf + n];
        if (c == trash) continue;
        const T b = static_cast<T>(Bq[c]);
#pragma unroll
        for (int ii = 0; ii < kKT; ++ii) acc[ii] += b * Cs[mm][ii];
      }
    }
    __syncthreads();
  }
  if (n < nbf) {
#pragma unroll
    for (int ii = 0; ii < kKT; ++ii)
      if (i0 + ii < k) W[(q * k + i0 + ii) * nbf + n] = acc[ii];
  }
}

template <typename TB, typename T>
int launch(const TB* Bc, long long ldb, long long trash, const int32_t* col_map,
           const T* C, int nbf, int k, int qc, T* W, void* stream) {
  const dim3 grid((nbf + kThreads - 1) / kThreads, qc, (k + kKT - 1) / kKT);
  df_gather_w_kernel<TB, T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Bc, ldb, trash, col_map, C, nbf, k, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Bc: [qc, ldb] rows of packed B (ldb = npq + 1, trash column npq);
// col_map: [nbf * nbf] int32; C: [nbf, k]; W: [qc, k, nbf].
extern "C" int jc_df_gather_w_f64(const double* Bc, long long ldb,
                                  long long trash, const int32_t* col_map,
                                  const double* C, int nbf, int k, int qc,
                                  double* W, void* stream) {
  return launch<double, double>(Bc, ldb, trash, col_map, C, nbf, k, qc, W, stream);
}

extern "C" int jc_df_gather_w_f32(const float* Bc, long long ldb,
                                  long long trash, const int32_t* col_map,
                                  const float* C, int nbf, int k, int qc,
                                  float* W, void* stream) {
  return launch<float, float>(Bc, ldb, trash, col_map, C, nbf, k, qc, W, stream);
}

extern "C" int jc_df_gather_w_f32b(const float* Bc, long long ldb,
                                   long long trash, const int32_t* col_map,
                                   const double* C, int nbf, int k, int qc,
                                   double* W, void* stream) {
  return launch<float, double>(Bc, ldb, trash, col_map, C, nbf, k, qc, W,
                               stream);
}
