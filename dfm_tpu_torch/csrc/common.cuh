// Shared device helpers for the dfm_tpu_torch kernels.
//
// Every kernel source is built on its own into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes).  Each C entry point
// launches on the stream it is given and returns cudaGetLastError(), so a
// refused launch reaches the Python wrapper, which raises.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

// Each source is built once per dtype (kernels/__init__.py passes
// -DDFM_DTYPE=32 or 64), so the two halves compile in parallel; without
// the flag both entry points are built.
#ifndef DFM_DTYPE
#define DFM_DTYPE 0
#endif
#define DFM_WANT_F32 (DFM_DTYPE != 64)
#define DFM_WANT_F64 (DFM_DTYPE != 32)

// Largest factor count the kernels take; the wrappers raise above it.
#define DFM_KMAX 16
// Largest state width of the wide kernels (K12: the lone masked K2, the K4
// pair and K1 at 16 < k <= 32, the mixed-frequency augmented state): one
// warp still owns a column per lane.
#define DFM_WIDE_KMAX 32
// Largest state width of the generic kernels (the lone K2, the K4 pair, K1
// and K3 and their batched twins K2b-m, K4b, K1b(-m), K3b-m and K6b at 32
// < k <= 128): a runtime k, the k x k algebra tiled in 32s.
#define DFM_GEN_KMAX 128

// The element arrays of a parallel-in-time scan, one pointer an element
// component: the filter's (A, b, C or U, eta, J or Z), the smoother's (E,
// g, L or D) in the first three.
template <typename T>
struct Arrays {
  T* p[5];
};

// Scalar maths with one spelling for float and double.
__device__ __forceinline__ float dfm_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dfm_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dfm_log(float x) { return logf(x); }
__device__ __forceinline__ double dfm_log(double x) { return log(x); }

// psd_cholesky's diagonal jitter, matched to precision (ops/linalg.py).
template <typename T> __device__ __forceinline__ T dfm_jitter();
template <> __device__ __forceinline__ float dfm_jitter<float>() { return 1e-6f; }
template <> __device__ __forceinline__ double dfm_jitter<double>() { return 1e-10; }

template <typename T> __device__ __forceinline__ T dfm_max_finite();
template <> __device__ __forceinline__ float dfm_max_finite<float>() { return FLT_MAX; }
template <> __device__ __forceinline__ double dfm_max_finite<double>() { return DBL_MAX; }

// torch.nan_to_num / jnp.nan_to_num: NaN -> 0, +-inf -> +-largest finite.
// Missing entries of a panel may be NaN, and 0 * NaN would poison a sum.
template <typename T>
__device__ __forceinline__ T nan_to_num(T x) {
  if (isnan(x)) return T(0);
  if (isinf(x)) return x > T(0) ? dfm_max_finite<T>() : -dfm_max_finite<T>();
  return x;
}

// Sum of v over the block; the result is valid in thread 0.  smem holds at
// least 32 values.  Callers that reduce again must __syncthreads() first.
template <typename A>
__device__ A block_reduce_sum(A v, A* smem) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) smem[wid] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  if (wid == 0) {
    v = lane < nw ? smem[lane] : A(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Calls BODY with a compile-time constant K equal to the runtime k, for
// k = 1..DFM_KMAX; any other k returns cudaErrorInvalidValue.
#define DFM_CASE_K(KV, ...) case KV: { constexpr int K = KV; __VA_ARGS__; } break;
#define DFM_DISPATCH_K(k, ...)                                               \
  switch (k) {                                                               \
    DFM_CASE_K(1, __VA_ARGS__) DFM_CASE_K(2, __VA_ARGS__)                    \
    DFM_CASE_K(3, __VA_ARGS__) DFM_CASE_K(4, __VA_ARGS__)                    \
    DFM_CASE_K(5, __VA_ARGS__) DFM_CASE_K(6, __VA_ARGS__)                    \
    DFM_CASE_K(7, __VA_ARGS__) DFM_CASE_K(8, __VA_ARGS__)                    \
    DFM_CASE_K(9, __VA_ARGS__) DFM_CASE_K(10, __VA_ARGS__)                   \
    DFM_CASE_K(11, __VA_ARGS__) DFM_CASE_K(12, __VA_ARGS__)                  \
    DFM_CASE_K(13, __VA_ARGS__) DFM_CASE_K(14, __VA_ARGS__)                  \
    DFM_CASE_K(15, __VA_ARGS__) DFM_CASE_K(16, __VA_ARGS__)                  \
    default: return (int)cudaErrorInvalidValue;                              \
  }
// The same for k = 1..DFM_WIDE_KMAX.
#define DFM_DISPATCH_WIDE_K(k, ...)                                          \
  switch (k) {                                                               \
    DFM_CASE_K(1, __VA_ARGS__) DFM_CASE_K(2, __VA_ARGS__)                    \
    DFM_CASE_K(3, __VA_ARGS__) DFM_CASE_K(4, __VA_ARGS__)                    \
    DFM_CASE_K(5, __VA_ARGS__) DFM_CASE_K(6, __VA_ARGS__)                    \
    DFM_CASE_K(7, __VA_ARGS__) DFM_CASE_K(8, __VA_ARGS__)                    \
    DFM_CASE_K(9, __VA_ARGS__) DFM_CASE_K(10, __VA_ARGS__)                   \
    DFM_CASE_K(11, __VA_ARGS__) DFM_CASE_K(12, __VA_ARGS__)                  \
    DFM_CASE_K(13, __VA_ARGS__) DFM_CASE_K(14, __VA_ARGS__)                  \
    DFM_CASE_K(15, __VA_ARGS__) DFM_CASE_K(16, __VA_ARGS__)                  \
    DFM_CASE_K(17, __VA_ARGS__) DFM_CASE_K(18, __VA_ARGS__)                  \
    DFM_CASE_K(19, __VA_ARGS__) DFM_CASE_K(20, __VA_ARGS__)                  \
    DFM_CASE_K(21, __VA_ARGS__) DFM_CASE_K(22, __VA_ARGS__)                  \
    DFM_CASE_K(23, __VA_ARGS__) DFM_CASE_K(24, __VA_ARGS__)                  \
    DFM_CASE_K(25, __VA_ARGS__) DFM_CASE_K(26, __VA_ARGS__)                  \
    DFM_CASE_K(27, __VA_ARGS__) DFM_CASE_K(28, __VA_ARGS__)                  \
    DFM_CASE_K(29, __VA_ARGS__) DFM_CASE_K(30, __VA_ARGS__)                  \
    DFM_CASE_K(31, __VA_ARGS__) DFM_CASE_K(32, __VA_ARGS__)                  \
    default: return (int)cudaErrorInvalidValue;                              \
  }

// Opts ``kernel`` in to ``bytes`` of dynamic shared memory where that is
// above the 48 KB a launch gets without asking.
template <typename F>
static cudaError_t dfm_smem_optin(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
