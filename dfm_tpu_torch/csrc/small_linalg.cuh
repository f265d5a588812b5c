// K6 and K7: small dense linear algebra for ONE thread, on fixed-size
// arrays (k is a template constant, k <= DFM_QR_KMAX).
//
// K6 replaces dfm_tpu/ops/linalg.py:chol_unrolled (line 73), matmul_vpu
// (107), matvec_vpu (120) and chol_solve_unrolled (125); K7 replaces
// tria_unrolled (186), tri_solve_unrolled (237) and psd_factor_unrolled
// (284), the forms their gates tria (224), tri_solve (273) and psd_factor
// (319) take for k <= QR_UNROLL_K_MAX = 10.  The JAX versions are
// Python-unrolled elementwise programs batched over a leading axis; here
// the batch is the grid (one thread per matrix, qr_elements.cu) and each
// function is the same scalar algorithm in the same order, with the same
// edge contracts:
//   chol_unrolled   no clamp: a negative pivot gives NaN (linalg.py:91-94);
//   tria            modified Gram-Schmidt on the rows; an exactly-zero
//                   residual row gives a zero row of L and q = 0;
//   tri_solve       where(diag > 0, s / diag, 0) on every pivot;
//   psd_factor      a pivot at or below eps(dtype) * k * |P_ii| becomes an
//                   exact zero row and column.
// Bound: latency of one thread's dependent scalar chain (k <= 10 gives
// ~k^3 flops per call); the batch over T supplies the parallelism.
//
// The routines are __noinline__: each template instance is compiled once
// and called, so that ptxas sees a few hundred small functions instead of
// kernels with every k x k loop nest inlined at each of ~30 call sites
// (the build time of the square-root kernels, not their speed, is what
// this trades for).  Arrays passed by reference live in local memory.
// For the same reason the outer loop of each routine is not unrolled
// (#pragma unroll 1): fully unrolled nests of every k instance made the
// front end the longest step of the build.
#pragma once

#include "common.cuh"

// Largest k of the square-root engine's kernels (QR_UNROLL_K_MAX).
#define DFM_QR_KMAX 10

template <typename T> __device__ __forceinline__ T dfm_eps();
template <> __device__ __forceinline__ float dfm_eps<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double dfm_eps<double>() { return DBL_EPSILON; }

// C = A B.
template <typename T, int K, int N, int R>
__device__ __noinline__ void mat_mul(const T (&A)[K][N], const T (&B)[N][R],
                                        T (&C)[K][R]) {
#pragma unroll 1
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < R; ++j) {
      T s = T(0);
      for (int l = 0; l < N; ++l) s += A[i][l] * B[l][j];
      C[i][j] = s;
    }
}

// C = A' B.
template <typename T, int K, int N, int R>
__device__ __noinline__ void mat_mul_tn(const T (&A)[N][K],
                                           const T (&B)[N][R], T (&C)[K][R]) {
#pragma unroll 1
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < R; ++j) {
      T s = T(0);
      for (int l = 0; l < N; ++l) s += A[l][i] * B[l][j];
      C[i][j] = s;
    }
}

// C = A B'.
template <typename T, int K, int N, int R>
__device__ __noinline__ void mat_mul_nt(const T (&A)[K][N],
                                           const T (&B)[R][N], T (&C)[K][R]) {
#pragma unroll 1
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < R; ++j) {
      T s = T(0);
      for (int l = 0; l < N; ++l) s += A[i][l] * B[j][l];
      C[i][j] = s;
    }
}

// y = A v  (TA: y = A' v).
template <typename T, int K, bool TA = false>
__device__ __noinline__ void mat_vec(const T (&A)[K][K], const T (&v)[K],
                                        T (&y)[K]) {
  for (int i = 0; i < K; ++i) {
    T s = T(0);
    for (int l = 0; l < K; ++l) s += (TA ? A[l][i] : A[i][l]) * v[l];
    y[i] = s;
  }
}

template <typename T, int R, int C>
__device__ __forceinline__ void transpose(const T (&A)[R][C], T (&B)[C][R]) {
  for (int i = 0; i < R; ++i)
    for (int j = 0; j < C; ++j) B[j][i] = A[i][j];
}

template <typename T, int K>
__device__ __forceinline__ void set_identity(T (&A)[K][K]) {
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j) A[i][j] = i == j ? T(1) : T(0);
}

// K6: Cholesky of the lower triangle of P; NaN on a negative pivot.
template <typename T, int K>
__device__ __noinline__ void chol_unrolled(const T (&P)[K][K], T (&L)[K][K]) {
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j) L[i][j] = T(0);
#pragma unroll 1
  for (int i = 0; i < K; ++i) {
    T s = P[i][i];
    for (int j = 0; j < i; ++j) s = s - L[i][j] * L[i][j];
    L[i][i] = dfm_sqrt(s);
    for (int r = i + 1; r < K; ++r) {
      T s2 = P[r][i];
      for (int j = 0; j < i; ++j) s2 = s2 - L[r][j] * L[i][j];
      L[r][i] = s2 / L[i][i];
    }
  }
}

// K6: X = (L L')^{-1} B by forward and back substitution.
template <typename T, int K, int R>
__device__ __noinline__ void chol_solve_unrolled(const T (&L)[K][K], const T (&B)[K][R],
                                    T (&X)[K][R]) {
#pragma unroll 1
  for (int c = 0; c < R; ++c) {
    T y[K];
    for (int i = 0; i < K; ++i) {
      T s = B[i][c];
      for (int j = 0; j < i; ++j) s = s - L[i][j] * y[j];
      y[i] = s / L[i][i];
    }
    for (int i = K - 1; i >= 0; --i) {
      T s = y[i];
      for (int j = i + 1; j < K; ++j) s = s - L[j][i] * X[j][c];
      X[i][c] = s / L[i][i];
    }
  }
}

template <typename T, int K>
__device__ __noinline__ void chol_solve_vec(const T (&L)[K][K], const T (&b)[K],
                               T (&x)[K]) {
  T y[K];
  for (int i = 0; i < K; ++i) {
    T s = b[i];
    for (int j = 0; j < i; ++j) s = s - L[i][j] * y[j];
    y[i] = s / L[i][i];
  }
  for (int i = K - 1; i >= 0; --i) {
    T s = y[i];
    for (int j = i + 1; j < K; ++j) s = s - L[j][i] * x[j];
    x[i] = s / L[i][i];
  }
}

// K7: lower-triangular L with L L' = X X' (X is K x M), by modified
// Gram-Schmidt on the rows of X.
template <typename T, int K, int M>
__device__ __noinline__ void tria(const T (&X)[K][M], T (&L)[K][K]) {
  T q[K][M];
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j) L[i][j] = T(0);
#pragma unroll 1
  for (int i = 0; i < K; ++i) {
    T v[M];
    for (int m = 0; m < M; ++m) v[m] = X[i][m];
    for (int j = 0; j < i; ++j) {
      T c = T(0);
      for (int m = 0; m < M; ++m) c += v[m] * q[j][m];
      L[i][j] = c;
      for (int m = 0; m < M; ++m) v[m] = v[m] - c * q[j][m];
    }
    T ss = T(0);
    for (int m = 0; m < M; ++m) ss += v[m] * v[m];
    const T nrm = dfm_sqrt(ss);
    L[i][i] = nrm;
    for (int m = 0; m < M; ++m) q[i][m] = nrm > T(0) ? v[m] / nrm : T(0);
  }
}

// tria of the side-by-side block [X1 | X2] (each K x K).
template <typename T, int K>
__device__ __noinline__ void tria2(const T (&X1)[K][K], const T (&X2)[K][K],
                                      T (&L)[K][K]) {
  T X[K][2 * K];
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j) {
      X[i][j] = X1[i][j];
      X[i][K + j] = X2[i][j];
    }
  tria<T, K, 2 * K>(X, L);
}

// K7: L X = B (TRANS: L' X = B) for lower-triangular L; a zero pivot
// gives a zero entry.
template <typename T, int K, int R, bool TRANS>
__device__ __noinline__ void tri_solve(const T (&L)[K][K], const T (&B)[K][R],
                          T (&X)[K][R]) {
#pragma unroll 1
  for (int c = 0; c < R; ++c) {
    if (TRANS) {
      for (int i = K - 1; i >= 0; --i) {
        T s = B[i][c];
        for (int j = i + 1; j < K; ++j) s = s - L[j][i] * X[j][c];
        X[i][c] = L[i][i] > T(0) ? s / L[i][i] : T(0);
      }
    } else {
      for (int i = 0; i < K; ++i) {
        T s = B[i][c];
        for (int j = 0; j < i; ++j) s = s - L[i][j] * X[j][c];
        X[i][c] = L[i][i] > T(0) ? s / L[i][i] : T(0);
      }
    }
  }
}

// K7: guarded factor of a possibly singular PSD matrix.
template <typename T, int K>
__device__ __noinline__ void psd_factor(const T (&P)[K][K], T (&L)[K][K]) {
  const T eps_k = T(dfm_eps<T>() * K);
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j) L[i][j] = T(0);
#pragma unroll 1
  for (int i = 0; i < K; ++i) {
    T s = P[i][i];
    for (int j = 0; j < i; ++j) s = s - L[i][j] * L[i][j];
    const bool live = s > eps_k * fabs(P[i][i]);
    const T d = dfm_sqrt(live ? s : T(1));
    L[i][i] = live ? d : T(0);
    for (int r = i + 1; r < K; ++r) {
      T s2 = P[r][i];
      for (int j = 0; j < i; ++j) s2 = s2 - L[r][j] * L[i][j];
      L[r][i] = live ? s2 / d : T(0);
    }
  }
}

// Fixed-size arrays from/to global memory (row-major, contiguous).
template <typename T, int R, int C>
__device__ __forceinline__ void load_mat(const T* src, T (&A)[R][C]) {
  for (int i = 0; i < R; ++i)
    for (int j = 0; j < C; ++j) A[i][j] = src[i * C + j];
}
template <typename T, int R, int C>
__device__ __forceinline__ void store_mat(T* dst, const T (&A)[R][C]) {
  for (int i = 0; i < R; ++i)
    for (int j = 0; j < C; ++j) dst[i * C + j] = A[i][j];
}
template <typename T, int K>
__device__ __forceinline__ void load_vec(const T* src, T (&v)[K]) {
  for (int i = 0; i < K; ++i) v[i] = src[i];
}
template <typename T, int K>
__device__ __forceinline__ void store_vec(T* dst, const T (&v)[K]) {
  for (int i = 0; i < K; ++i) dst[i] = v[i];
}

// Calls BODY with a compile-time K equal to the runtime k, 1 <= k <=
// DFM_QR_KMAX; any other k returns cudaErrorInvalidValue.
#define DFM_DISPATCH_QR_K(k, ...)                                            \
  switch (k) {                                                               \
    DFM_CASE_K(1, __VA_ARGS__) DFM_CASE_K(2, __VA_ARGS__)                    \
    DFM_CASE_K(3, __VA_ARGS__) DFM_CASE_K(4, __VA_ARGS__)                    \
    DFM_CASE_K(5, __VA_ARGS__) DFM_CASE_K(6, __VA_ARGS__)                    \
    DFM_CASE_K(7, __VA_ARGS__) DFM_CASE_K(8, __VA_ARGS__)                    \
    DFM_CASE_K(9, __VA_ARGS__) DFM_CASE_K(10, __VA_ARGS__)                   \
    default: return (int)cudaErrorInvalidValue;                              \
  }
