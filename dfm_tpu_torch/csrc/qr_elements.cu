// The batched per-step work of the square-root parallel-in-time engine
// (pit_qr), one thread per time step, on the K6/K7 device functions of
// small_linalg.cuh.  Modes:
//
//   0 filter elements     dfm_tpu/ssm/parallel_filter.py:qr_generic_elements
//                         (line 293) with the t = 0 prior correction of
//                         qr_init_posterior / qr_filter_elements (354, 378):
//                         (bobs, C_t, F, Q, mu0, P0) -> (A, b, U, eta, Z)_t
//   1 smoother elements   _qr_smoother_elements (509):
//                         (x_pred, P_pred, x_filt, P_filt, F, Q)
//                         -> (E, g, D)_t and the gains J_t
//   2 filter assembly     the post-scan part of pit_qr_from_stats (458-481):
//                         (x_f, U_f, C_t, F, Q, mu0, P0) -> x_pred, P_pred =
//                         Lp Lp' with Lp_t = tria([F U_f,t-1 | Lq]), P_f =
//                         U_f U_f', log|I + Lp' C_t Lp|
//   3 smoother assembly   the post-scan part of pit_qr_smoother (549-554):
//                         (D_sm, J) -> P_sm = D D', P_lag,t = P_sm,t J_{t-1}'
//   4 unit                one K6/K7 function over a batch (op: 0 chol, 1
//                         chol_solve, 2 tria of a k x 2k block, 3 tri_solve,
//                         4 tri_solve transposed, 5 psd_factor), so that each
//                         can be held against its plain twin alone.
//
// Bound on the H100: operations, ~100 k^3 flops a step in the element
// builds (f64 at k = 10: ~0.1 MFLOP a step, 50 MFLOP at T = 500, under a
// microsecond at the card's peak); the per-thread chains of dependent
// scalar operations set the time.  Design: every step is independent, so
// one thread per step with its k x k matrices in registers and local
// memory; no shared memory, no synchronization.  k <= DFM_QR_KMAX.
#include "small_linalg.cuh"

constexpr int QE_THREADS = 64;

template <typename T, int K>
__device__ __forceinline__ void add_identity(T (&A)[K][K]) {
  for (int i = 0; i < K; ++i) A[i][i] += T(1);
}

template <typename T, int K>
__device__ __forceinline__ void store_zero(T* dst, int n) {
  for (int i = 0; i < n; ++i) dst[i] = T(0);
}

template <typename T, int K>
__global__ void __launch_bounds__(QE_THREADS)
filter_elements_kernel(const T* __restrict__ bobs, const T* __restrict__ C,
                       int c_stride, const T* __restrict__ F,
                       const T* __restrict__ Q, const T* __restrict__ mu0,
                       const T* __restrict__ P0, T* __restrict__ A_el,
                       T* __restrict__ b_el, T* __restrict__ U_el,
                       T* __restrict__ eta_el, T* __restrict__ Z_el, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t kk = (size_t)K * K, tk = (size_t)t * K, tkk = (size_t)t * kk;
  T Ct[K][K], Qm[K][K], bt[K];
  load_mat(C + (size_t)t * c_stride, Ct);
  load_mat(Q, Qm);
  load_vec(bobs + tk, bt);
  if (t == 0) {
    // The first filtered posterior from the prior (qr_init_posterior).
    T P0m[K][K], m0[K], Lp0[K][K], X1[K][K], G[K][K], E0[K][K], Lp0T[K][K],
        Xs[K][K], U0[K][K];
    load_mat(P0, P0m);
    load_vec(mu0, m0);
    psd_factor(P0m, Lp0);
    mat_mul_tn(Lp0, Ct, X1);                      // Lp0' C0
    mat_mul(X1, Lp0, G);                          // Lp0' C0 Lp0
    add_identity(G);
    chol_unrolled(G, E0);
    transpose(Lp0, Lp0T);
    tri_solve<T, K, K, false>(E0, Lp0T, Xs);
    transpose(Xs, U0);
    T W0[K][K], H[K][K], Hp[K][K];
    psd_factor(Ct, W0);
    mat_mul_tn(W0, P0m, X1);                      // W0' P0
    mat_mul(X1, W0, H);                           // W0' P0 W0
    add_identity(H);
    chol_unrolled(H, Hp);
    T Cm0[K], v0[K], Pv[K], w[K], s[K], Ws[K], n0[K], Pn[K], b0[K];
    mat_vec(Ct, m0, Cm0);
    for (int i = 0; i < K; ++i) v0[i] = bt[i] - Cm0[i];
    mat_vec(P0m, v0, Pv);
    mat_vec<T, K, true>(W0, Pv, w);               // W0' P0 v0
    chol_solve_vec(Hp, w, s);
    mat_vec(W0, s, Ws);
    for (int i = 0; i < K; ++i) n0[i] = v0[i] - Ws[i];
    mat_vec(P0m, n0, Pn);
    for (int i = 0; i < K; ++i) b0[i] = m0[i] + Pn[i];
    store_zero<T, K>(A_el, K * K);
    store_vec(b_el, b0);
    store_mat(U_el, U0);
    store_zero<T, K>(eta_el, K);
    store_zero<T, K>(Z_el, K * K);
    return;
  }
  T Fm[K][K], Lq[K][K], X1[K][K], G[K][K], E[K][K], LqT[K][K], Xs[K][K],
      Ut[K][K];
  load_mat(F, Fm);
  psd_factor(Qm, Lq);
  mat_mul_tn(Lq, Ct, X1);                         // Lq' C_t
  mat_mul(X1, Lq, G);                             // Lq' C_t Lq
  add_identity(G);
  chol_unrolled(G, E);
  transpose(Lq, LqT);
  tri_solve<T, K, K, false>(E, LqT, Xs);
  transpose(Xs, Ut);                              // U_t = Lq E^{-T}
  store_mat(U_el + tkk, Ut);

  T W[K][K], QW[K][K], Hm[K][K], H[K][K];
  psd_factor(Ct, W);
  mat_mul(Qm, W, QW);
  mat_mul_tn(W, QW, Hm);                          // W' Q W
  add_identity(Hm);
  chol_unrolled(Hm, H);
  T Qb[K], WQb[K], s[K], Ws[K], nt[K], bq[K], eta[K];
  mat_vec(Qm, bt, Qb);
  mat_vec<T, K, true>(W, Qb, WQb);
  chol_solve_vec(H, WQb, s);
  mat_vec(W, s, Ws);
  for (int i = 0; i < K; ++i) nt[i] = bt[i] - Ws[i];
  mat_vec(Qm, nt, bq);
  mat_vec<T, K, true>(Fm, nt, eta);               // F' n_t
  store_vec(b_el + tk, bq);
  store_vec(eta_el + tk, eta);

  T FTW[K][K], WF[K][K], Zt[K][K];
  mat_mul_tn(Fm, W, FTW);                         // F' W
  transpose(FTW, WF);                             // (F' W)'
  tri_solve<T, K, K, false>(H, WF, Xs);
  transpose(Xs, Zt);                              // Z_t = F' W H^{-T}
  store_mat(Z_el + tkk, Zt);
  mat_mul_tn(W, Fm, WF);                          // W' F
  chol_solve_unrolled(H, WF, Xs);
  mat_mul(QW, Xs, G);
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j) X1[i][j] = Fm[i][j] - G[i][j];
  store_mat(A_el + tkk, X1);                      // A_t = F - Q W (HH')^-1 W'F
}

template <typename T, int K>
__global__ void __launch_bounds__(QE_THREADS)
smoother_elements_kernel(const T* __restrict__ x_pred,
                         const T* __restrict__ P_pred,
                         const T* __restrict__ x_filt,
                         const T* __restrict__ P_filt,
                         const T* __restrict__ F, const T* __restrict__ Q,
                         T* __restrict__ E_el, T* __restrict__ g_el,
                         T* __restrict__ D_el, T* __restrict__ J_out, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t kk = (size_t)K * K, tk = (size_t)t * K, tkk = (size_t)t * kk;
  T Pf[K][K], Uf[K][K];
  load_mat(P_filt + tkk, Pf);
  psd_factor(Pf, Uf);
  if (t == n - 1) {
    store_zero<T, K>(E_el + tkk, K * K);
    for (int i = 0; i < K; ++i) g_el[tk + i] = x_filt[tk + i];
    store_mat(D_el + tkk, Uf);
    return;
  }
  T Fm[K][K], Qm[K][K], Lq[K][K], Ppn[K][K], Lpn[K][K], APf[K][K], X[K][K],
      J[K][K];
  load_mat(F, Fm);
  load_mat(Q, Qm);
  psd_factor(Qm, Lq);
  load_mat(P_pred + tkk + kk, Ppn);
  psd_factor(Ppn, Lpn);
  mat_mul(Fm, Pf, APf);
  chol_solve_unrolled(Lpn, APf, X);
  transpose(X, J);                                // J_t
  store_mat(E_el + tkk, J);
  store_mat(J_out + tkk, J);
  T xp[K], Jx[K];
  load_vec(x_pred + tk + K, xp);
  mat_vec(J, xp, Jx);
  for (int i = 0; i < K; ++i) g_el[tk + i] = x_filt[tk + i] - Jx[i];
  T ImJA[K][K], X1[K][K], X2[K][K], D[K][K];
  mat_mul(J, Fm, ImJA);
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j)
      ImJA[i][j] = (i == j ? T(1) : T(0)) - ImJA[i][j];
  mat_mul(ImJA, Uf, X1);
  mat_mul(J, Lq, X2);
  tria2(X1, X2, D);
  store_mat(D_el + tkk, D);
}

template <typename T, int K>
__global__ void __launch_bounds__(QE_THREADS)
filter_assemble_kernel(const T* __restrict__ x_f, const T* __restrict__ U_f,
                       const T* __restrict__ C, int c_stride,
                       const T* __restrict__ F, const T* __restrict__ Q,
                       const T* __restrict__ mu0, const T* __restrict__ P0,
                       T* __restrict__ x_pred, T* __restrict__ P_pred,
                       T* __restrict__ P_f, T* __restrict__ logdetG, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t kk = (size_t)K * K, tk = (size_t)t * K, tkk = (size_t)t * kk;
  T Fm[K][K], Uf[K][K], X[K][K], Lp[K][K];
  load_mat(F, Fm);
  load_mat(U_f + tkk, Uf);
  mat_mul_nt(Uf, Uf, X);
  store_mat(P_f + tkk, X);
  if (t == 0) {
    T P0m[K][K];
    load_mat(P0, P0m);
    psd_factor(P0m, Lp);
    for (int i = 0; i < K; ++i) x_pred[i] = mu0[i];
  } else {
    T Qm[K][K], Lq[K][K], Ufp[K][K], AU[K][K], xf[K], xp[K];
    load_mat(Q, Qm);
    psd_factor(Qm, Lq);
    load_mat(U_f + tkk - kk, Ufp);
    mat_mul(Fm, Ufp, AU);
    tria2(AU, Lq, Lp);
    load_vec(x_f + tk - K, xf);
    mat_vec(Fm, xf, xp);
    store_vec(x_pred + tk, xp);
  }
  mat_mul_nt(Lp, Lp, X);
  store_mat(P_pred + tkk, X);
  T Ct[K][K], X1[K][K], Lg[K][K];
  load_mat(C + (size_t)t * c_stride, Ct);
  mat_mul_tn(Lp, Ct, X1);                         // Lp' C_t
  mat_mul(X1, Lp, X);
  add_identity(X);
  chol_unrolled(X, Lg);
  T s = T(0);
  for (int i = 0; i < K; ++i) s += dfm_log(Lg[i][i]);
  logdetG[t] = T(2) * s;
}

template <typename T, int K>
__global__ void __launch_bounds__(QE_THREADS)
smoother_assemble_kernel(const T* __restrict__ D_sm, const T* __restrict__ J,
                         T* __restrict__ P_sm, T* __restrict__ P_lag, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t kk = (size_t)K * K, tkk = (size_t)t * kk;
  T D[K][K], P[K][K];
  load_mat(D_sm + tkk, D);
  mat_mul_nt(D, D, P);
  store_mat(P_sm + tkk, P);
  if (t == 0) {
    store_zero<T, K>(P_lag, K * K);
  } else {
    T Jm[K][K], X[K][K];
    load_mat(J + tkk - kk, Jm);
    mat_mul_nt(P, Jm, X);
    store_mat(P_lag + tkk, X);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(QE_THREADS)
unit_kernel(int op, const T* __restrict__ X, const T* __restrict__ B,
            T* __restrict__ out, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t kk = (size_t)K * K, tkk = (size_t)t * kk;
  T R[K][K];
  if (op == 2) {
    T Xm[K][2 * K];
    load_mat(X + 2 * tkk, Xm);
    tria(Xm, R);
  } else {
    T Xm[K][K];
    load_mat(X + tkk, Xm);
    if (op == 0) {
      chol_unrolled(Xm, R);
    } else if (op == 5) {
      psd_factor(Xm, R);
    } else {
      T Bm[K][K];
      load_mat(B + tkk, Bm);
      if (op == 1) chol_solve_unrolled(Xm, Bm, R);
      else if (op == 3) tri_solve<T, K, K, false>(Xm, Bm, R);
      else tri_solve<T, K, K, true>(Xm, Bm, R);
    }
  }
  store_mat(out + tkk, R);
}

template <typename T>
static int launch(int mode, int op, const T* i0, const T* i1, const T* i2,
                  const T* i3, const T* i4, const T* i5, const T* i6, T* o0,
                  T* o1, T* o2, T* o3, T* o4, int n, int k, int c_stride,
                  cudaStream_t s) {
  if (n < 1 || op < 0 || op > 5) return (int)cudaErrorInvalidValue;
  const int blocks = (n + QE_THREADS - 1) / QE_THREADS;
  switch (mode) {
    case 0:
      DFM_DISPATCH_QR_K(k, filter_elements_kernel<T, K><<<blocks, QE_THREADS, 0, s>>>(
                               i0, i1, c_stride, i2, i3, i4, i5, o0, o1, o2,
                               o3, o4, n))
      break;
    case 1:
      DFM_DISPATCH_QR_K(k, smoother_elements_kernel<T, K><<<blocks, QE_THREADS, 0, s>>>(
                               i0, i1, i2, i3, i4, i5, o0, o1, o2, o3, n))
      break;
    case 2:
      DFM_DISPATCH_QR_K(k, filter_assemble_kernel<T, K><<<blocks, QE_THREADS, 0, s>>>(
                               i0, i1, i2, c_stride, i3, i4, i5, i6, o0, o1,
                               o2, o3, n))
      break;
    case 3:
      DFM_DISPATCH_QR_K(k, smoother_assemble_kernel<T, K><<<blocks, QE_THREADS, 0, s>>>(
                               i0, i1, o0, o1, n))
      break;
    case 4:
      DFM_DISPATCH_QR_K(k, unit_kernel<T, K><<<blocks, QE_THREADS, 0, s>>>(
                               op, i0, i1, o0, n))
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {
#if DFM_WANT_F32
int qr_elements_f32(int mode, int op, const float* i0, const float* i1,
                    const float* i2, const float* i3, const float* i4,
                    const float* i5, const float* i6, float* o0, float* o1,
                    float* o2, float* o3, float* o4, int n, int k,
                    int c_stride, void* stream) {
  return launch<float>(mode, op, i0, i1, i2, i3, i4, i5, i6, o0, o1, o2, o3,
                       o4, n, k, c_stride, (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int qr_elements_f64(int mode, int op, const double* i0, const double* i1,
                    const double* i2, const double* i3, const double* i4,
                    const double* i5, const double* i6, double* o0,
                    double* o1, double* o2, double* o3, double* o4, int n,
                    int k, int c_stride, void* stream) {
  return launch<double>(mode, op, i0, i1, i2, i3, i4, i5, i6, o0, o1, o2, o3,
                        o4, n, k, c_stride, (cudaStream_t)stream);
}
#endif
}
