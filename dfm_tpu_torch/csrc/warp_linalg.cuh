// One-warp k x k linear algebra in shared memory, shared by K4
// (info_scan.cu), K5a (ss_cov_path.cu) and K14 (pit_elements.cu,
// pit_scan.cu).
//
// All matrices are row-major in shared memory with a leading dimension one
// past the widest k they take, so lanes reading different rows hit
// different banks: LD = DFM_KMAX + 1 for the k <= DFM_KMAX kernels, WIDE_LD
// = DFM_WIDE_KMAX + 1 for the wide K4 pair (k <= 32, the matrices in
// dynamic shared memory); the leading dimension is a template parameter
// deduced from the matrices passed.  Lane j computes column j of each
// product and solves for column j of each right-hand side; the Cholesky
// factorization goes column by column, lane i updating row i; the LU
// factorization picks its pivot across the lanes (lane i holds row i) and
// updates the trailing block a column a lane.
// __syncwarp() separates the phases, so every function is called by all
// 32 lanes of one warp.  The lane is threadIdx.x % 32, so any warp of a
// block may call them on its own matrices.
#pragma once

#include "common.cuh"

constexpr int LD = DFM_KMAX + 1;
constexpr int WIDE_LD = DFM_WIDE_KMAX + 1;

template <typename T, int LDV = LD>
using SMat = T (*)[LDV];

__device__ __forceinline__ int warp_lane() { return threadIdx.x & 31; }

__device__ __forceinline__ float dfm_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double dfm_abs(double x) { return fabs(x); }

// Matrix slot i of k rows at leading dimension LDV in shared memory.
template <typename T, int LDV>
__device__ __forceinline__ SMat<T, LDV> smem_slot(T* base, int i, int k) {
  return reinterpret_cast<SMat<T, LDV>>(base + (size_t)i * k * LDV);
}

// k x k row-major global <-> shared, lanes over the elements; ``symm``
// loads the symmetric part 0.5 (M + M').  Each ends with __syncwarp().
template <typename T, int LDV>
__device__ void warp_load(SMat<T, LDV> M, const T* __restrict__ g, int k,
                          bool symm = false) {
  for (int e = warp_lane(); e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    M[i][j] = symm ? T(0.5) * (g[i * k + j] + g[j * k + i]) : g[e];
  }
  __syncwarp();
}
template <typename T, int LDV>
__device__ void warp_store(T* __restrict__ g, SMat<T, LDV> M, int k) {
  for (int e = warp_lane(); e < k * k; e += 32) g[e] = M[e / k][e % k];
  __syncwarp();
}
template <typename T, int LDV>
__device__ void warp_copy(SMat<T, LDV> D, SMat<T, LDV> S, int k) {
  for (int e = warp_lane(); e < k * k; e += 32)
    D[e / k][e % k] = S[e / k][e % k];
  __syncwarp();
}

// sum_l op(M)[i][l] v[l], one row in one lane.
template <typename T, int LDV, bool TM>
__device__ T row_dot(SMat<T, LDV> M, const T* v, int i, int k) {
  T s = T(0);
  for (int l = 0; l < k; ++l) s += (TM ? M[l][i] : M[i][l]) * v[l];
  return s;
}

// C = op(A) op(B); lane j computes column j.  C aliases neither A nor B.
template <typename T, bool TA, bool TB, int LDV>
__device__ void mm(SMat<T, LDV> C, SMat<T, LDV> A, SMat<T, LDV> B, int k) {
  const int j = warp_lane();
  if (j < k) {
    for (int i = 0; i < k; ++i) {
      T s = T(0);
      for (int l = 0; l < k; ++l)
        s += (TA ? A[l][i] : A[i][l]) * (TB ? B[j][l] : B[l][j]);
      C[i][j] = s;
    }
  }
  __syncwarp();
}

// In-place Cholesky of the lower triangle of W (which already holds
// sym(M) + jitter I); the strict upper triangle is zeroed.  No clamp: a
// negative pivot gives NaN, as jnp.linalg.cholesky does.
template <typename T, int LDV>
__device__ void chol_inplace(SMat<T, LDV> W, int k) {
  const int lane = warp_lane();
  for (int p = 0; p < k; ++p) {
    const T d = dfm_sqrt(W[p][p]);
    __syncwarp();
    if (lane == p) W[p][p] = d;
    else if (lane > p && lane < k) W[lane][p] /= d;
    __syncwarp();
    if (lane > p && lane < k) {
      const T ljp = W[lane][p];
      for (int i = lane; i < k; ++i) W[i][lane] -= W[i][p] * ljp;
    }
    __syncwarp();
  }
  if (lane < k)
    for (int i = 0; i < lane; ++i) W[i][lane] = T(0);
  __syncwarp();
}

// X = (L L')^{-1} op(B); lane j solves for column j.  X may alias B when
// op is the identity.
template <typename T, bool TB, int LDV>
__device__ void chol_solve_cols(SMat<T, LDV> X, SMat<T, LDV> L,
                                SMat<T, LDV> B, int k) {
  const int j = warp_lane();
  if (j < k) {
    for (int i = 0; i < k; ++i) {
      T s = TB ? B[j][i] : B[i][j];
      for (int m = 0; m < i; ++m) s -= L[i][m] * X[m][j];
      X[i][j] = s / L[i][i];
    }
    for (int i = k - 1; i >= 0; --i) {
      T s = X[i][j];
      for (int m = i + 1; m < k; ++m) s -= L[m][i] * X[m][j];
      X[i][j] = s / L[i][i];
    }
  }
  __syncwarp();
}

// The covariance half of one information-form update, from the predicted
// P:  Lp = chol(sym(P) + jitter I);  G = I + Lp' C Lp;  Lg = chol(sym(G))
// with no jitter (G >= I);  Pf = sym(Lp G^{-1} Lp').  CL, G and X are
// scratch; Lp and Lg keep the two factors.
template <typename T, int LDV>
__device__ void info_cov_update(SMat<T, LDV> P, SMat<T, LDV> Cm,
                                SMat<T, LDV> Lp, SMat<T, LDV> CL,
                                SMat<T, LDV> G, SMat<T, LDV> Lg,
                                SMat<T, LDV> X, SMat<T, LDV> Pf, int k) {
  const int lane = warp_lane();
  const T jit = dfm_jitter<T>();
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    Lp[i][j] = T(0.5) * (P[i][j] + P[j][i]) + (i == j ? jit : T(0));
  }
  __syncwarp();
  chol_inplace<T>(Lp, k);
  mm<T, false, false>(CL, Cm, Lp, k);                   // C Lp
  mm<T, true, false>(G, Lp, CL, k);                     // Lp' C Lp
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    const T d = i == j ? T(1) : T(0);
    Lg[i][j] = T(0.5) * ((d + G[i][j]) + (d + G[j][i]));
  }
  __syncwarp();
  chol_inplace<T>(Lg, k);
  chol_solve_cols<T, true>(X, Lg, Lp, k);               // G^{-1} Lp'
  mm<T, false, false>(G, Lp, X, k);                     // Lp G^{-1} Lp'
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    Pf[i][j] = T(0.5) * (G[i][j] + G[j][i]);
  }
  __syncwarp();
}

// The prediction  P = sym(A Pf A' + Q);  W1 and W2 are scratch.
template <typename T, int LDV>
__device__ void predict_cov(SMat<T, LDV> P, SMat<T, LDV> Pf, SMat<T, LDV> Am,
                            SMat<T, LDV> Qm, SMat<T, LDV> W1, SMat<T, LDV> W2,
                            int k) {
  mm<T, false, false>(W1, Am, Pf, k);                   // A P_f
  mm<T, false, true>(W2, W1, Am, k);                    // A P_f A'
  for (int e = warp_lane(); e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    P[i][j] = T(0.5) * ((W2[i][j] + Qm[i][j]) + (W2[j][i] + Qm[j][i]));
  }
  __syncwarp();
}

// 2 sum_i log L[i][i], valid in every lane.
template <typename T, int LDV>
__device__ T chol_logdet_warp(SMat<T, LDV> L, int k) {
  T s = T(0);
  for (int i = 0; i < k; ++i) s += dfm_log(L[i][i]);
  return T(2) * s;
}

// In-place LU factorization with partial pivoting, W = P L U (L unit lower
// below the diagonal, U on and above it), as LAPACK's getrf pivots: at
// column p the pivot row is the first index of the largest |W[i][p]|, i >=
// p (a warp arg-max, ties to the lower index), and piv[p] records it.  No
// check for a zero pivot: a singular W gives inf/NaN, as an unchecked
// solve does.  piv holds k ints in shared memory.
template <typename T, int LDV>
__device__ void lu_inplace(SMat<T, LDV> W, int* piv, int k) {
  const int lane = warp_lane();
  for (int p = 0; p < k; ++p) {
    const bool cand = lane >= p && lane < k;
    T best = cand ? dfm_abs(W[lane][p]) : T(-1);
    int idx = cand ? lane : 32;
    for (int o = 16; o > 0; o >>= 1) {
      const T ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (ob > best || (ob == best && oi < idx)) {
        best = ob;
        idx = oi;
      }
    }
    // NaN compares false, so lanes may disagree on a NaN column: take
    // lane 0's answer, and no swap past k.
    idx = __shfl_sync(0xffffffffu, idx, 0);
    if (idx >= k) idx = p;
    if (lane == 0) piv[p] = idx;
    if (idx != p && lane < k) {
      const T tmp = W[p][lane];
      W[p][lane] = W[idx][lane];
      W[idx][lane] = tmp;
    }
    __syncwarp();
    const T d = W[p][p];
    if (lane > p && lane < k) W[lane][p] /= d;
    __syncwarp();
    if (lane > p && lane < k) {
      const T u = W[p][lane];
      for (int i = p + 1; i < k; ++i) W[i][lane] -= W[i][p] * u;
    }
    __syncwarp();
  }
}

// X = W^{-1} X (the first nrhs columns of X) with W's factors from
// lu_inplace: the row interchanges, then unit-lower forward and upper back
// substitution; lane j solves column j.
template <typename T, int LDV>
__device__ void lu_solve_cols(SMat<T, LDV> LU, const int* piv,
                              SMat<T, LDV> X, int k, int nrhs) {
  const int j = warp_lane();
  if (j < nrhs) {
    for (int p = 0; p < k; ++p) {
      const int r = piv[p];
      if (r != p) {
        const T tmp = X[p][j];
        X[p][j] = X[r][j];
        X[r][j] = tmp;
      }
    }
    for (int i = 1; i < k; ++i) {
      T s = X[i][j];
      for (int m = 0; m < i; ++m) s -= LU[i][m] * X[m][j];
      X[i][j] = s;
    }
    for (int i = k - 1; i >= 0; --i) {
      T s = X[i][j];
      for (int m = i + 1; m < k; ++m) s -= LU[i][m] * X[m][j];
      X[i][j] = s / LU[i][i];
    }
  }
  __syncwarp();
}

// v = W^{-1} v for one right-hand side vector in shared memory (lane 0).
template <typename T, int LDV>
__device__ void lu_solve_vec(SMat<T, LDV> LU, const int* piv, T* v, int k) {
  if (warp_lane() == 0) {
    for (int p = 0; p < k; ++p) {
      const int r = piv[p];
      if (r != p) {
        const T tmp = v[p];
        v[p] = v[r];
        v[r] = tmp;
      }
    }
    for (int i = 1; i < k; ++i) {
      T s = v[i];
      for (int m = 0; m < i; ++m) s -= LU[i][m] * v[m];
      v[i] = s;
    }
    for (int i = k - 1; i >= 0; --i) {
      T s = v[i];
      for (int m = i + 1; m < k; ++m) s -= LU[i][m] * v[m];
      v[i] = s / LU[i][i];
    }
  }
  __syncwarp();
}
