// The combine bodies of the square-root engine's one-thread scans at k
// <= DFM_QR_KMAX, shared by K8 (qr_scan.cu: the blocked scans) and
// K8-assoc (pit_assoc.cu: the log-depth associative scans).  Each is the
// JAX package's combine (dfm_tpu/ssm/parallel_filter.py: qr_combine_filter
// 395, qr_combine_smoother 497) on one thread's fixed-size elements
// (FElem, SElem), in registers and local memory; load and store move an
// element between them and the element arrays.
#pragma once

#include "small_linalg.cuh"

template <typename T, int K>
struct FElem {
  T A[K][K], b[K], U[K][K], eta[K], Z[K][K];
};

template <typename T, int K>
struct SElem {
  T E[K][K], g[K], D[K][K];
};

template <typename T, int K>
__device__ __forceinline__ void load(const Arrays<T>& a, int i, FElem<T, K>& e) {
  const size_t kk = (size_t)K * K;
  load_mat(a.p[0] + i * kk, e.A);
  load_vec(a.p[1] + (size_t)i * K, e.b);
  load_mat(a.p[2] + i * kk, e.U);
  load_vec(a.p[3] + (size_t)i * K, e.eta);
  load_mat(a.p[4] + i * kk, e.Z);
}
template <typename T, int K>
__device__ __forceinline__ void store(const Arrays<T>& a, int i,
                                      const FElem<T, K>& e) {
  const size_t kk = (size_t)K * K;
  store_mat(a.p[0] + i * kk, e.A);
  store_vec(a.p[1] + (size_t)i * K, e.b);
  store_mat(a.p[2] + i * kk, e.U);
  store_vec(a.p[3] + (size_t)i * K, e.eta);
  store_mat(a.p[4] + i * kk, e.Z);
}
template <typename T, int K>
__device__ __forceinline__ void load(const Arrays<T>& a, int i, SElem<T, K>& e) {
  const size_t kk = (size_t)K * K;
  load_mat(a.p[0] + i * kk, e.E);
  load_vec(a.p[1] + (size_t)i * K, e.g);
  load_mat(a.p[2] + i * kk, e.D);
}
template <typename T, int K>
__device__ __forceinline__ void store(const Arrays<T>& a, int i,
                                      const SElem<T, K>& e) {
  const size_t kk = (size_t)K * K;
  store_mat(a.p[0] + i * kk, e.E);
  store_vec(a.p[1] + (size_t)i * K, e.g);
  store_mat(a.p[2] + i * kk, e.D);
}

// qr_combine_filter(ei, ej): ei earlier, ej later.
template <typename T, int K>
__device__ __noinline__ void combine(const FElem<T, K>& ei, const FElem<T, K>& ej,
                        FElem<T, K>& o) {
  T I[K][K], Yf[K][K], YfT[K][K], Theta[K][K], Lam[K][K];
  set_identity(I);
  mat_mul_tn(ei.U, ej.Z, Yf);                     // U_i' Z_j
  transpose(Yf, YfT);
  tria2(Yf, I, Theta);
  tria2(YfT, I, Lam);

  // A = A_j Dinv(A_i),  Dinv(M) = M - U_i chol_slv(Theta, Yf (Z_j' M)).
  T X1[K][K], X2[K][K], X3[K][K];
  mat_mul_tn(ej.Z, ei.A, X1);                     // Z_j' A_i
  mat_mul(Yf, X1, X2);
  chol_solve_unrolled(Theta, X2, X3);
  mat_mul(ei.U, X3, X1);
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j) X2[i][j] = ei.A[i][j] - X1[i][j];
  mat_mul(ej.A, X2, o.A);

  // b = A_j Dinv_v(b_i + U_i (U_i' eta_j)) + b_j.
  T v1[K], v2[K], v3[K];
  mat_vec<T, K, true>(ei.U, ej.eta, v1);          // U_i' eta_j
  mat_vec(ei.U, v1, v2);
  for (int i = 0; i < K; ++i) v1[i] = ei.b[i] + v2[i];
  mat_vec<T, K, true>(ej.Z, v1, v2);              // Z_j' v
  mat_vec(Yf, v2, v3);
  chol_solve_vec(Theta, v3, v2);
  mat_vec(ei.U, v2, v3);
  for (int i = 0; i < K; ++i) v1[i] = v1[i] - v3[i];
  mat_vec(ej.A, v1, v2);
  for (int i = 0; i < K; ++i) o.b[i] = v2[i] + ej.b[i];

  // U = tria([A_j U_i Theta^{-T} | U_j]).
  mat_mul(ej.A, ei.U, X1);                        // A_j U_i
  transpose(X1, X2);
  tri_solve<T, K, K, false>(Theta, X2, X3);
  transpose(X3, X1);
  tria2(X1, ej.U, o.U);

  // eta = A_i' Einv_v(eta_j - Z_j (Z_j' b_i)) + eta_i,
  // Einv_v(v) = v - Z_j chol_slv(Lam, Yf' (U_i' v)).
  mat_vec<T, K, true>(ej.Z, ei.b, v1);            // Z_j' b_i
  mat_vec(ej.Z, v1, v2);
  for (int i = 0; i < K; ++i) v1[i] = ej.eta[i] - v2[i];
  mat_vec<T, K, true>(ei.U, v1, v2);              // U_i' v
  mat_vec(YfT, v2, v3);
  chol_solve_vec(Lam, v3, v2);
  mat_vec(ej.Z, v2, v3);
  for (int i = 0; i < K; ++i) v1[i] = v1[i] - v3[i];
  mat_vec<T, K, true>(ei.A, v1, v2);              // A_i' v
  for (int i = 0; i < K; ++i) o.eta[i] = v2[i] + ei.eta[i];

  // Z = tria([A_i' Z_j Lam^{-T} | Z_i]).
  mat_mul_tn(ei.A, ej.Z, X1);                     // A_i' Z_j
  transpose(X1, X2);
  tri_solve<T, K, K, false>(Lam, X2, X3);
  transpose(X3, X1);
  tria2(X1, ei.Z, o.Z);
}

// qr_combine_smoother(el, ee): el later, ee earlier.
template <typename T, int K>
__device__ __noinline__ void combine(const SElem<T, K>& el, const SElem<T, K>& ee,
                        SElem<T, K>& o) {
  T X[K][K], v[K];
  mat_mul(ee.E, el.E, o.E);
  mat_vec(ee.E, el.g, v);
  for (int i = 0; i < K; ++i) o.g[i] = v[i] + ee.g[i];
  mat_mul(ee.E, el.D, X);
  tria2(X, ee.D, o.D);
}
