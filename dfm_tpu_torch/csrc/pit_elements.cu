// K14-el: the per-step work of the covariance-form parallel-in-time engine
// (pit), one warp a step, a block a step over the grid.  Modes:
//
//   0 filter elements     dfm_tpu/ssm/parallel_filter.py:_filter_elements
//                         (line 70): (bobs, C_t, F, Q, mu0, P0) ->
//                         (A, b, C, eta, J)_t by the push-through solves
//                         with I + Q C_t and I + C_t Q; t = 0 from (mu0, P0)
//                         with A = 0, eta = 0, J = 0.  A static C comes
//                         with a stride of 0.
//   1 filter assembly     the post-scan part of pit_from_stats (147-181):
//                         (x_f, P_f, C_t, F, Q, mu0, P0) -> x_pred, P_pred =
//                         sym(F P_f,t-1 F' + Q) (P0 at t = 0), log|I + Lp'
//                         C_t Lp| with Lp the jittered Cholesky of P_pred
//                         and G's Cholesky unjittered.
//   2 smoother elements   _smoother_elements (201): (x_pred, P_pred, x_f,
//                         P_f, F) -> E_t = J_t = (chol_solve(chol(sym(
//                         P_pred,t+1) + jitter I), F P_f,t))', g_t = x_f,t
//                         - J_t x_pred,t+1, L_t = sym(P_f,t - J_t P_pred,t+1
//                         J_t'); the last step (E = 0, g = x_f, L = P_f).
//   3 smoother assembly   the P_lag of pit_smoother (245-246): P_lag,t =
//                         P_sm,t J_{t-1}', P_lag,0 = 0.
//
// The general solves are LU with partial pivoting (warp_linalg.cuh's
// lu_inplace / lu_solve_cols, the pivot rule of LAPACK's getrf, which
// jnp.linalg.solve runs); the Cholesky factorizations and the symmetric
// parts follow the JAX expressions term by term.
//
// Bound on the H100: operations, ~(4/3 + 2 + 6) k^3 flops a step in the
// element build (two LU factorizations, 3k + 1 right-hand sides, three
// products), ~6 k^3 in the assembly and the smoother elements: at k = 10,
// T = 500 ~5 MFLOP, under a tenth of a microsecond at the card's peak, and
// the bytes (~4 T k^2 values) ~0.2 us.  Steps are independent, so the time
// is one step's chain of dependent warp-level factorizations and products
// (a lane owns a column: ~k^2 dependent FMAs a product) plus the launch.
// Design: a warp a step with its k x k matrices in dynamic shared memory at
// a leading dimension of 17 (k <= 16) or 33 (k <= 32, opted in above 48
// KB), so lanes reading different rows hit different banks.
//
// K14-el-gen (pit_elements_gen): the four modes at 32 < k <= DFM_GEN_KMAX
// = 128 (the pit fits, fused fits, sessions and the mixed-frequency pit
// route past 32), the same arithmetic term by term.  A warp cannot hold a
// k x k problem past 32, so each step runs on a CTA of GEN_THREADS threads
// with cta_linalg.cuh's block-wide routines (the general solves by
// cta_getrf / cta_getrs: LU with partial pivoting, LAPACK getrf's pivot
// rule; Cholesky, triangular solves and products as in K4-gen), its
// matrices in global memory that stays in L2: the step's output rows and a
// per-CTA workspace of four k x k matrices.  The grid is persistent (a
// CTA an SM, ``ctas`` from the wrapper, each looping over the steps t =
// blockIdx.x, + gridDim.x, ...), so the workspace scales with the card,
// not with T (80 KB a matrix in f64 at k = 100).  Bound: operations, as
// the k <= 32 kernel (~(4/3 + 2 + 6) k^3 flops a step in mode 0), but
// each CTA is a chain of dependent block-wide routines: T / ctas steps of
// ~15 routines.
#include "cta_linalg.cuh"

// The number of k x LDV matrix slots each mode uses.
constexpr int PE_MATS[4] = {6, 8, 8, 2};

// Shared memory of a mode: its matrices, two k-vectors (padded to 32) and
// k pivots.
template <typename T, int LDV>
static size_t pe_smem(int mode, int k) {
  return sizeof(T) * ((size_t)PE_MATS[mode] * k * LDV + 64) + 32 * sizeof(int);
}

// sym(M) = 0.5 (M + M') into global memory.
template <typename T, int LDV>
__device__ void store_sym(T* __restrict__ g, SMat<T, LDV> M, int k) {
  for (int e = warp_lane(); e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    g[e] = T(0.5) * (M[i][j] + M[j][i]);
  }
  __syncwarp();
}

template <typename T>
__device__ void store_zero(T* __restrict__ g, int n) {
  for (int e = warp_lane(); e < n; e += 32) g[e] = T(0);
  __syncwarp();
}

template <typename T, int LDV>
__device__ void add_identity(SMat<T, LDV> M, int k) {
  if (warp_lane() < k) M[warp_lane()][warp_lane()] += T(1);
  __syncwarp();
}

// Mode 0.
template <typename T, int LDV>
__global__ void __launch_bounds__(32)
filter_elements_kernel(const T* __restrict__ bobs, const T* __restrict__ C,
                       int c_stride, const T* __restrict__ F,
                       const T* __restrict__ Q, const T* __restrict__ mu0,
                       const T* __restrict__ P0, T* __restrict__ A_el,
                       T* __restrict__ b_el, T* __restrict__ C_el,
                       T* __restrict__ eta_el, T* __restrict__ J_el, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int t = blockIdx.x, lane = warp_lane();
  const size_t kk = (size_t)k * k;
  auto S = [&](int i) { return smem_slot<T, LDV>(sm, i, k); };
  SMat<T, LDV> Ct = S(0), Qm = S(1), Fm = S(2), LU = S(3), X = S(4), Y = S(5);
  T* v = sm + (size_t)6 * k * LDV;
  T* w = v + 32;
  int* piv = reinterpret_cast<int*>(w + 32);
  warp_load(Ct, C + (size_t)t * c_stride, k);
  if (lane < k) v[lane] = bobs[(size_t)t * k + lane];
  if (t == 0) {
    // The first posterior from the prior: b0 = mu0 + P0 (I + C0 P0)^{-1}
    // (bobs0 - C0 mu0), C0 = sym((I + P0 C0)^{-1} P0).
    warp_load(Y, P0, k);
    if (lane < k) w[lane] = mu0[lane];
    __syncwarp();
    if (lane < k) v[lane] = v[lane] - row_dot<T, LDV, false>(Ct, w, lane, k);
    mm<T, false, false>(LU, Ct, Y, k);            // C0 P0
    add_identity(LU, k);
    lu_inplace(LU, piv, k);
    lu_solve_vec(LU, piv, v, k);
    if (lane < k)
      b_el[lane] = w[lane] + row_dot<T, LDV, false>(Y, v, lane, k);
    mm<T, false, false>(LU, Y, Ct, k);            // P0 C0
    add_identity(LU, k);
    lu_inplace(LU, piv, k);
    warp_copy(X, Y, k);
    lu_solve_cols(LU, piv, X, k, k);
    store_sym(C_el, X, k);
    store_zero(A_el, (int)kk);
    store_zero(eta_el, k);
    store_zero(J_el, (int)kk);
    return;
  }
  warp_load(Qm, Q, k);
  warp_load(Fm, F, k);
  mm<T, false, false>(LU, Qm, Ct, k);             // I + Q C_t
  add_identity(LU, k);
  lu_inplace(LU, piv, k);
  warp_copy(X, Fm, k);
  lu_solve_cols(LU, piv, X, k, k);
  warp_store(A_el + t * kk, X, k);                // (I + Q C)^{-1} F
  warp_copy(X, Qm, k);
  lu_solve_cols(LU, piv, X, k, k);
  store_sym(C_el + t * kk, X, k);                 // sym((I + Q C)^{-1} Q)
  mm<T, false, false>(LU, Ct, Qm, k);             // I + C_t Q
  add_identity(LU, k);
  lu_inplace(LU, piv, k);
  lu_solve_vec(LU, piv, v, k);                    // (I + C Q)^{-1} bobs
  if (lane < k) {
    b_el[(size_t)t * k + lane] = row_dot<T, LDV, false>(Qm, v, lane, k);
    eta_el[(size_t)t * k + lane] = row_dot<T, LDV, true>(Fm, v, lane, k);
  }
  warp_copy(X, Ct, k);
  lu_solve_cols(LU, piv, X, k, k);                // (I + C Q)^{-1} C
  mm<T, true, false>(Y, Fm, X, k);                // F' (.)
  mm<T, false, false>(X, Y, Fm, k);               // F' (.) F
  store_sym(J_el + t * kk, X, k);
}

// Mode 1.
template <typename T, int LDV>
__global__ void __launch_bounds__(32)
filter_assemble_kernel(const T* __restrict__ x_f, const T* __restrict__ P_f,
                       const T* __restrict__ C, int c_stride,
                       const T* __restrict__ F, const T* __restrict__ Q,
                       const T* __restrict__ mu0, const T* __restrict__ P0,
                       T* __restrict__ x_pred, T* __restrict__ P_pred,
                       T* __restrict__ logdetG, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int t = blockIdx.x, lane = warp_lane();
  const size_t kk = (size_t)k * k;
  auto S = [&](int i) { return smem_slot<T, LDV>(sm, i, k); };
  SMat<T, LDV> Am = S(0), Qm = S(1), Pf = S(2), P = S(3), W1 = S(4), W2 = S(5),
               Lp = S(6), Cm = S(7);
  T* v = sm + (size_t)8 * k * LDV;
  if (t == 0) {
    warp_load(P, P0, k);
    if (lane < k) x_pred[lane] = mu0[lane];
  } else {
    warp_load(Am, F, k);
    warp_load(Qm, Q, k);
    warp_load(Pf, P_f + (t - 1) * kk, k);
    if (lane < k) v[lane] = x_f[(size_t)(t - 1) * k + lane];
    __syncwarp();
    if (lane < k)
      x_pred[(size_t)t * k + lane] = row_dot<T, LDV, false>(Am, v, lane, k);
    predict_cov(P, Pf, Am, Qm, W1, W2, k);        // sym(F P_f F' + Q)
  }
  warp_store(P_pred + t * kk, P, k);
  const T jit = dfm_jitter<T>();
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    Lp[i][j] = T(0.5) * (P[i][j] + P[j][i]) + (i == j ? jit : T(0));
  }
  __syncwarp();
  chol_inplace<T>(Lp, k);
  warp_load(Cm, C + (size_t)t * c_stride, k);
  mm<T, false, false>(W1, Cm, Lp, k);             // C Lp
  mm<T, true, false>(W2, Lp, W1, k);              // Lp' C Lp
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    const T d = i == j ? T(1) : T(0);
    Pf[i][j] = T(0.5) * ((d + W2[i][j]) + (d + W2[j][i]));
  }
  __syncwarp();
  chol_inplace<T>(Pf, k);                         // unjittered: G >= I
  if (lane == 0) logdetG[t] = chol_logdet_warp<T>(Pf, k);
}

// Mode 2.
template <typename T, int LDV>
__global__ void __launch_bounds__(32)
smoother_elements_kernel(const T* __restrict__ x_pred,
                         const T* __restrict__ P_pred,
                         const T* __restrict__ x_f, const T* __restrict__ P_f,
                         const T* __restrict__ F, T* __restrict__ E_el,
                         T* __restrict__ g_el, T* __restrict__ L_el, int n,
                         int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int t = blockIdx.x, lane = warp_lane();
  const size_t kk = (size_t)k * k;
  if (t == n - 1) {
    store_zero(E_el + t * kk, (int)kk);
    for (int e = lane; e < k; e += 32)
      g_el[(size_t)t * k + e] = x_f[(size_t)t * k + e];
    for (int e = lane; e < k * k; e += 32) L_el[t * kk + e] = P_f[t * kk + e];
    return;
  }
  auto S = [&](int i) { return smem_slot<T, LDV>(sm, i, k); };
  SMat<T, LDV> P = S(0), Lw = S(1), Am = S(2), Pf = S(3), X = S(4), Y = S(5),
               W = S(6), V = S(7);
  T* v = sm + (size_t)8 * k * LDV;
  warp_load(P, P_pred + (t + 1) * kk, k);
  warp_load(Am, F, k);
  warp_load(Pf, P_f + t * kk, k);
  if (lane < k) v[lane] = x_pred[(size_t)(t + 1) * k + lane];
  const T jit = dfm_jitter<T>();
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    Lw[i][j] = T(0.5) * (P[i][j] + P[j][i]) + (i == j ? jit : T(0));
  }
  __syncwarp();
  chol_inplace<T>(Lw, k);
  mm<T, false, false>(X, Am, Pf, k);              // F P_f
  chol_solve_cols<T, false>(Y, Lw, X, k);         // Y = J'
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    E_el[t * kk + e] = Y[j][i];
  }
  if (lane < k)
    g_el[(size_t)t * k + lane] =
        x_f[(size_t)t * k + lane] - row_dot<T, LDV, true>(Y, v, lane, k);
  mm<T, true, false>(W, Y, P, k);                 // J P_pred
  mm<T, false, false>(V, W, Y, k);                // J P_pred J'
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    L_el[t * kk + e] = T(0.5) * ((Pf[i][j] - V[i][j]) + (Pf[j][i] - V[j][i]));
  }
}

// Mode 3.
template <typename T, int LDV>
__global__ void __launch_bounds__(32)
smoother_assemble_kernel(const T* __restrict__ P_sm, const T* __restrict__ J,
                         T* __restrict__ P_lag, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int t = blockIdx.x;
  const size_t kk = (size_t)k * k;
  if (t == 0) {
    store_zero(P_lag, (int)kk);
    return;
  }
  auto S = [&](int i) { return smem_slot<T, LDV>(sm, i, k); };
  SMat<T, LDV> P = S(0), Jm = S(1);
  warp_load(P, P_sm + t * kk, k);
  warp_load(Jm, J + (t - 1) * kk, k);
  const int j = warp_lane();
  if (j < k)
    for (int i = 0; i < k; ++i) {
      T s = T(0);
      for (int l = 0; l < k; ++l) s += P[i][l] * Jm[j][l];
      P_lag[t * kk + (size_t)i * k + j] = s;
    }
}

template <typename T, int LDV>
static int launch_ld(int mode, const T* i0, const T* i1, const T* i2,
                     const T* i3, const T* i4, const T* i5, const T* i6,
                     T* o0, T* o1, T* o2, T* o3, T* o4, int n, int k,
                     int c_stride, cudaStream_t s) {
  const size_t bytes = pe_smem<T, LDV>(mode, k);
  cudaError_t err = cudaSuccess;
  switch (mode) {
    case 0:
      err = dfm_smem_optin(filter_elements_kernel<T, LDV>, bytes);
      if (err == cudaSuccess)
        filter_elements_kernel<T, LDV><<<n, 32, bytes, s>>>(
            i0, i1, c_stride, i2, i3, i4, i5, o0, o1, o2, o3, o4, k);
      break;
    case 1:
      err = dfm_smem_optin(filter_assemble_kernel<T, LDV>, bytes);
      if (err == cudaSuccess)
        filter_assemble_kernel<T, LDV><<<n, 32, bytes, s>>>(
            i0, i1, i2, c_stride, i3, i4, i5, i6, o0, o1, o2, k);
      break;
    case 2:
      err = dfm_smem_optin(smoother_elements_kernel<T, LDV>, bytes);
      if (err == cudaSuccess)
        smoother_elements_kernel<T, LDV><<<n, 32, bytes, s>>>(
            i0, i1, i2, i3, i4, o0, o1, o2, n, k);
      break;
    case 3:
      err = dfm_smem_optin(smoother_assemble_kernel<T, LDV>, bytes);
      if (err == cudaSuccess)
        smoother_assemble_kernel<T, LDV><<<n, 32, bytes, s>>>(i0, i1, o0, k);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(int mode, const T* i0, const T* i1, const T* i2,
                  const T* i3, const T* i4, const T* i5, const T* i6, T* o0,
                  T* o1, T* o2, T* o3, T* o4, int n, int k, int c_stride,
                  cudaStream_t s) {
  if (n < 1 || k < 1 || k > DFM_WIDE_KMAX) return (int)cudaErrorInvalidValue;
  if (k <= DFM_KMAX)
    return launch_ld<T, LD>(mode, i0, i1, i2, i3, i4, i5, i6, o0, o1, o2, o3,
                            o4, n, k, c_stride, s);
  return launch_ld<T, WIDE_LD>(mode, i0, i1, i2, i3, i4, i5, i6, o0, o1, o2,
                               o3, o4, n, k, c_stride, s);
}

// ---- K14-el-gen ----

// A CTA's scratch: two shared k-vectors, four k x k workspace matrices
// (the last also holds two k-vectors).
template <typename T>
using PegCta = CtaScratch<T, 2, 4>;

// Mode 0.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
filter_elements_gen_kernel(const T* bobs, const T* C, int c_stride,
                           const T* F, const T* Q, const T* mu0, const T* P0,
                           T* A_el, T* b_el, T* C_el, T* eta_el, T* J_el,
                           T* work, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PegCta<T> g(smem_raw, work, k);
  const size_t kk = (size_t)k * k;
  T* LU = g.w;
  T* X = g.w + kk;
  T* Y = g.w + 2 * kk;
  T* vg = g.w + 3 * kk;
  T* vg2 = vg + k;
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    const T* Ct = C + (size_t)t * c_stride;
    if (t == 0) {
      // b0 = mu0 + P0 (I + C0 P0)^{-1} (bobs0 - C0 mu0), C0 = sym((I + P0
      // C0)^{-1} P0), A = 0, eta = 0, J = 0.
      cta_load_vec(g.v[0], mu0, k);
      cta_matvec<T>(g.v[1], bobs, T(-1), Ct, g.v[0], k, vg);
      cta_gemm<T>(LU, k, Ct, k, false, P0, k, false, k, k, k, T(1), nullptr,
                  0, true, g.sm);                              // I + C0 P0
      cta_getrf<T>(LU, k, g.piv, g.sm);
      cta_getrs<T>(LU, g.piv, k, vg, 1, false, vg2, 1, 1, g.perm, g.sm);
      cta_load_vec(g.v[1], vg2, k);
      cta_matvec<T>(g.v[0], mu0, T(1), P0, g.v[1], k, b_el);
      cta_gemm<T>(LU, k, P0, k, false, Ct, k, false, k, k, k, T(1), nullptr,
                  0, true, g.sm);                              // I + P0 C0
      cta_getrf<T>(LU, k, g.piv, g.sm);
      cta_getrs<T>(LU, g.piv, k, P0, k, false, X, k, k, g.perm, g.sm);
      cta_sym<T>(C_el, X, k, false, g.sm);
      cta_copy<T>(A_el, nullptr, (int)kk);
      cta_copy<T>(eta_el, nullptr, k);
      cta_copy<T>(J_el, nullptr, (int)kk);
      continue;
    }
    cta_gemm<T>(LU, k, Q, k, false, Ct, k, false, k, k, k, T(1), nullptr, 0,
                true, g.sm);                                   // I + Q C_t
    cta_getrf<T>(LU, k, g.piv, g.sm);
    cta_getrs<T>(LU, g.piv, k, F, k, false, A_el + t * kk, k, k, g.perm,
                 g.sm);                                        // (I + QC)^-1 F
    cta_getrs<T>(LU, g.piv, k, Q, k, false, X, k, k, g.perm, g.sm);
    cta_sym<T>(C_el + t * kk, X, k, false, g.sm);             // sym((.)^-1 Q)
    cta_gemm<T>(LU, k, Ct, k, false, Q, k, false, k, k, k, T(1), nullptr, 0,
                true, g.sm);                                   // I + C_t Q
    cta_getrf<T>(LU, k, g.piv, g.sm);
    cta_getrs<T>(LU, g.piv, k, bobs + (size_t)t * k, 1, false, vg, 1, 1,
                 g.perm, g.sm);                                // (I+CQ)^-1 bobs
    cta_load_vec(g.v[0], vg, k);
    cta_matvec<T>(g.v[1], nullptr, T(1), Q, g.v[0], k, b_el + (size_t)t * k);
    cta_matvec_t<T>(nullptr, nullptr, T(1), F, g.v[0], k,
                    eta_el + (size_t)t * k);                   // F' (.)
    cta_getrs<T>(LU, g.piv, k, Ct, k, false, X, k, k, g.perm, g.sm);
    cta_gemm<T>(Y, k, F, k, true, X, k, false, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                  // F' (.)
    T* Jt = J_el + t * kk;
    cta_gemm<T>(Jt, k, Y, k, false, F, k, false, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                  // (.) F
    cta_sym<T>(Jt, Jt, k, false, g.sm);
  }
}

// Mode 1.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
filter_assemble_gen_kernel(const T* x_f, const T* P_f, const T* C,
                           int c_stride, const T* F, const T* Q,
                           const T* mu0, const T* P0, T* x_pred, T* P_pred,
                           T* logdetG, T* work, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PegCta<T> g(smem_raw, work, k);
  const size_t kk = (size_t)k * k;
  T* Lp = g.w;
  T* X = g.w + kk;
  T* Lg = g.w + 2 * kk;
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    T* Pp = P_pred + t * kk;
    if (t == 0) {
      cta_copy<T>(Pp, P0, (int)kk);
      if (threadIdx.x < k) x_pred[threadIdx.x] = mu0[threadIdx.x];
    } else {
      cta_load_vec(g.v[0], x_f + (size_t)(t - 1) * k, k);
      cta_matvec<T>(g.v[1], nullptr, T(1), F, g.v[0], k, x_pred + (size_t)t * k);
      cta_gemm<T>(X, k, F, k, false, P_f + (t - 1) * kk, k, false, k, k, k,
                  T(1), nullptr, 0, false, g.sm);              // F P_f
      cta_gemm<T>(Pp, k, X, k, false, F, k, true, k, k, k, T(1), Q, k, false,
                  g.sm);                                       // (.) F' + Q
      cta_sym<T>(Pp, Pp, k, false, g.sm);
    }
    cta_sym<T>(Lp, Pp, k, true, g.sm);
    cta_potrf<T>(Lp, k, g.sm);
    cta_gemm<T>(X, k, C + (size_t)t * c_stride, k, false, Lp, k, false, k, k,
                k, T(1), nullptr, 0, false, g.sm);             // C Lp
    cta_gemm<T>(Lg, k, Lp, k, true, X, k, false, k, k, k, T(1), nullptr, 0,
                true, g.sm);                                   // I + Lp' C Lp
    cta_sym<T>(Lg, Lg, k, false, g.sm);
    cta_potrf<T>(Lg, k, g.sm);                                 // unjittered
    cta_logdet<T>(Lg, k, logdetG + t);
    __syncthreads();
  }
}

// Mode 2.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
smoother_elements_gen_kernel(const T* x_pred, const T* P_pred, const T* x_f,
                             const T* P_f, const T* F, T* E_el, T* g_el,
                             T* L_el, T* work, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PegCta<T> g(smem_raw, work, k);
  const size_t kk = (size_t)k * k;
  T* Lw = g.w;
  T* X = g.w + kk;
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    T* Et = E_el + t * kk;
    T* Lt = L_el + t * kk;
    const T* Pft = P_f + t * kk;
    if (t == n - 1) {
      cta_copy<T>(Et, nullptr, (int)kk);
      cta_copy<T>(g_el + (size_t)t * k, x_f + (size_t)t * k, k);
      cta_copy<T>(Lt, Pft, (int)kk);
      continue;
    }
    const T* Ppn = P_pred + (t + 1) * kk;
    cta_sym<T>(Lw, Ppn, k, true, g.sm);
    cta_potrf<T>(Lw, k, g.sm);
    cta_gemm<T>(Et, k, Pft, k, true, F, k, true, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                  // (F P_f)'
    cta_trsm_right<T>(Et, k, Lw, k, true, g.sm);
    cta_trsm_right<T>(Et, k, Lw, k, false, g.sm);             // J_t
    cta_load_vec(g.v[0], x_pred + (size_t)(t + 1) * k, k);
    cta_matvec<T>(g.v[1], x_f + (size_t)t * k, T(-1), Et, g.v[0], k,
                  g_el + (size_t)t * k);                       // x_f - J x_p
    cta_gemm<T>(X, k, Et, k, false, Ppn, k, false, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                  // J P_pred
    cta_gemm<T>(Lt, k, X, k, false, Et, k, true, k, k, k, T(-1), Pft, k,
                false, g.sm);                                  // P_f - (.) J'
    cta_sym<T>(Lt, Lt, k, false, g.sm);
  }
}

// Mode 3.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
smoother_assemble_gen_kernel(const T* P_sm, const T* J, T* P_lag, T* work,
                             int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PegCta<T> g(smem_raw, work, k);
  const size_t kk = (size_t)k * k;
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    if (t == 0) {
      cta_copy<T>(P_lag, nullptr, (int)kk);
      continue;
    }
    cta_gemm<T>(P_lag + t * kk, k, P_sm + t * kk, k, false, J + (t - 1) * kk,
                k, true, k, k, k, T(1), nullptr, 0, false, g.sm);
  }
}

// Mode ``mode`` over n steps on ``ctas`` persistent CTAs; ``work`` holds
// ctas x 4 k x k matrices.
template <typename T>
static int launch_gen(int mode, const T* i0, const T* i1, const T* i2,
                      const T* i3, const T* i4, const T* i5, const T* i6,
                      T* o0, T* o1, T* o2, T* o3, T* o4, T* work, int n,
                      int k, int c_stride, int ctas, cudaStream_t s) {
  if (n < 1 || k < 1 || k > DFM_GEN_KMAX || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = PegCta<T>::bytes(k);
  const int grid = n < ctas ? n : ctas;
  cudaError_t err = cudaSuccess;
  switch (mode) {
    case 0:
      err = dfm_smem_optin(filter_elements_gen_kernel<T>, bytes);
      if (err == cudaSuccess)
        filter_elements_gen_kernel<T><<<grid, GEN_THREADS, bytes, s>>>(
            i0, i1, c_stride, i2, i3, i4, i5, o0, o1, o2, o3, o4, work, n,
            k);
      break;
    case 1:
      err = dfm_smem_optin(filter_assemble_gen_kernel<T>, bytes);
      if (err == cudaSuccess)
        filter_assemble_gen_kernel<T><<<grid, GEN_THREADS, bytes, s>>>(
            i0, i1, i2, c_stride, i3, i4, i5, i6, o0, o1, o2, work, n, k);
      break;
    case 2:
      err = dfm_smem_optin(smoother_elements_gen_kernel<T>, bytes);
      if (err == cudaSuccess)
        smoother_elements_gen_kernel<T><<<grid, GEN_THREADS, bytes, s>>>(
            i0, i1, i2, i3, i4, o0, o1, o2, work, n, k);
      break;
    case 3:
      err = dfm_smem_optin(smoother_assemble_gen_kernel<T>, bytes);
      if (err == cudaSuccess)
        smoother_assemble_gen_kernel<T><<<grid, GEN_THREADS, bytes, s>>>(
            i0, i1, o0, work, n, k);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- K8-gen elements: qr_elements_gen ----
//
// The per-step work of the square-root parallel-in-time engine (pit_qr)
// past QR_UNROLL_K_MAX = 10: the five modes of qr_elements.cu (0 filter
// elements with the t = 0 correction, 1 smoother elements with J, 2
// filter assembly, 3 smoother assembly, 4 one generic K6/K7 function a
// matrix) at 10 < k <= DFM_GEN_KMAX = 128.  In this source, beside
// K14-el-gen, so that the block-wide routines of cta_linalg.cuh compile
// once a dtype for both engines (in two sources of their own the square-
// root generic kernels took the parallel build from ~200 s to ~320 s).
//
// Past 10 the JAX package leaves modified Gram-Schmidt and guarded
// substitution for its generic branches (dfm_tpu/ops/linalg.py: tria
// :224 = psd_cholesky(X X'), tri_solve :273 = solve_triangular,
// psd_factor :319 = psd_cholesky; in
// parallel_filter.py the chol of the elements, the t = 0 posterior and the
// logdet = psd_cholesky(M, jitter=0.0) and chol_solve = chol_solve,
// :319-321, 362-364, 407-408, 478-479, 519-520).  This kernel computes
// those branches, not MGS: tria([X1 | X2]) is two products into one Gram
// X1 X1' + X2 X2', cta_sym with the dtype's jitter and cta_potrf; the
// triangular solves, always of the form X L^{-T} (U = Lq E^{-T}, Z = F' W
// H^{-T}) or chol_solve(L, B) taken transposed (B' L^{-T} L^{-1}), are
// cta_trsm_right; a non-positive pivot gives NaN, with no clamp.  A k x k
// problem no longer fits a thread, so each step runs on a CTA of
// GEN_THREADS threads with cta_linalg.cuh's block-wide routines, its
// matrices in global memory that stays in L2 (the step's output rows and
// QR_EL_MATS k x k workspace matrices a CTA, the last holding row
// vectors), on a persistent grid (a CTA an SM, ``ctas`` from the wrapper,
// each CTA looping over t = blockIdx.x, + gridDim.x, ...) as K14-el-gen.
// Lq = psd_factor(Q), the same at every step, is factored once a CTA.
// Bound: operations, ~16 k^3 flops a step in mode 0 (six k x k products,
// 12 k^3; three Cholesky factorizations, k^3; three triangular solves of
// k rows, 3 k^3; chip_smoke.qr_gen_flops counts every mode), but each CTA
// is a chain of ~25 dependent block-wide routines a step.


// k x k workspace matrices a CTA (kernels.GEN_MATS["qr_elements_gen"]);
// the last holds the row vectors the triangular solves take.
constexpr int QR_EL_MATS = 8;

template <typename T>
using QegCta = CtaScratch<T, 4, QR_EL_MATS>;

// Mode 0: qr_generic_elements and, at t = 0, qr_init_posterior.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
qr_filter_elements_gen_kernel(const T* bobs, const T* C, int c_stride,
                           const T* F, const T* Q, const T* mu0, const T* P0,
                           T* A_el, T* b_el, T* U_el, T* eta_el, T* Z_el,
                           T* work, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QegCta<T> g(smem_raw, work, k);
  const size_t kk = (size_t)k * k;
  T *Lq = g.w, *X = Lq + kk, *E = X + kk, *W = E + kk, *QW = W + kk,
    *H = QW + kk, *Y = H + kk, *V = Y + kk, *V1 = V + k;
  cta_psd_chol<T>(Lq, Q, k, true, g.sm);                  // psd_factor(Q)
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    const T* Ct = C + (size_t)t * c_stride;
    const T* bt = bobs + (size_t)t * k;
    if (t == 0) {
      // U0 = Lp0 E0^{-T}, E0 = chol(I + Lp0' C0 Lp0), Lp0 = psd_factor(P0).
      cta_psd_chol<T>(Y, P0, k, true, g.sm);
      cta_gemm<T>(X, k, Y, k, true, Ct, k, false, k, k, k, T(1), nullptr, 0,
                  false, g.sm);                               // Lp0' C0
      cta_gemm<T>(E, k, X, k, false, Y, k, false, k, k, k, T(1), nullptr, 0,
                  true, g.sm);                                // I + (.) Lp0
      cta_psd_chol<T>(E, E, k, false, g.sm);
      cta_copy<T>(U_el, Y, (int)kk);
      cta_trsm_right<T>(U_el, k, E, k, true, g.sm);
      // b0 = mu0 + P0 n0, n0 = v0 - W0 chol_solve(Hp, W0' P0 v0), v0 =
      // bobs0 - C0 mu0, W0 = psd_factor(C0), Hp = chol(I + W0' P0 W0).
      cta_psd_chol<T>(W, Ct, k, true, g.sm);
      cta_gemm<T>(QW, k, P0, k, false, W, k, false, k, k, k, T(1), nullptr,
                  0, false, g.sm);                            // P0 W0
      cta_gemm<T>(H, k, W, k, true, QW, k, false, k, k, k, T(1), nullptr, 0,
                  true, g.sm);                                // I + W0'(.)
      cta_psd_chol<T>(H, H, k, false, g.sm);
      cta_load_vec(g.v[0], mu0, k);
      cta_matvec<T>(g.v[1], bt, T(-1), Ct, g.v[0], k, V1);    // v0
      cta_matvec<T>(g.v[2], nullptr, T(1), P0, g.v[1], k, nullptr);
      cta_matvec_t<T>(nullptr, nullptr, T(1), W, g.v[2], k, V);
      cta_chol_solve_rows<T>(V, 1, H, k, g.sm);
      cta_load_vec(g.v[0], V, k);
      cta_matvec<T>(g.v[2], V1, T(-1), W, g.v[0], k, nullptr);  // n0
      cta_matvec<T>(g.v[3], mu0, T(1), P0, g.v[2], k, b_el);     // b0
      cta_copy<T>(A_el, nullptr, (int)kk);
      cta_copy<T>(eta_el, nullptr, k);
      cta_copy<T>(Z_el, nullptr, (int)kk);
      continue;
    }
    // U_t = Lq E^{-T}, E = chol(I + Lq' C_t Lq).
    cta_gemm<T>(X, k, Lq, k, true, Ct, k, false, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                 // Lq' C_t
    cta_gemm<T>(E, k, X, k, false, Lq, k, false, k, k, k, T(1), nullptr, 0,
                true, g.sm);                                  // I + (.) Lq
    cta_psd_chol<T>(E, E, k, false, g.sm);
    T* Ut = U_el + t * kk;
    cta_copy<T>(Ut, Lq, (int)kk);
    cta_trsm_right<T>(Ut, k, E, k, true, g.sm);
    // W = psd_factor(C_t), H = chol(I + W' Q W).
    cta_psd_chol<T>(W, Ct, k, true, g.sm);
    cta_gemm<T>(QW, k, Q, k, false, W, k, false, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                 // Q W
    cta_gemm<T>(H, k, W, k, true, QW, k, false, k, k, k, T(1), nullptr, 0,
                true, g.sm);                                  // I + W' Q W
    cta_psd_chol<T>(H, H, k, false, g.sm);
    // n_t = bobs - W chol_solve(H, W' Q bobs); b = Q n_t, eta = F' n_t.
    cta_load_vec(g.v[0], bt, k);
    cta_matvec<T>(g.v[1], nullptr, T(1), Q, g.v[0], k, nullptr);
    cta_matvec_t<T>(nullptr, nullptr, T(1), W, g.v[1], k, V);
    cta_chol_solve_rows<T>(V, 1, H, k, g.sm);
    cta_load_vec(g.v[0], V, k);
    cta_matvec<T>(g.v[2], bt, T(-1), W, g.v[0], k, nullptr);  // n_t
    cta_matvec<T>(g.v[3], nullptr, T(1), Q, g.v[2], k, b_el + (size_t)t * k);
    cta_matvec_t<T>(nullptr, nullptr, T(1), F, g.v[2], k,
                    eta_el + (size_t)t * k);
    // Z_t = F' W H^{-T};  A_t = F - Q W chol_solve(H, W' F), the solve
    // taken transposed: (F' W) H^{-T} H^{-1} = Z_t H^{-1}.
    T* Zt = Z_el + t * kk;
    cta_gemm<T>(Zt, k, F, k, true, W, k, false, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                 // F' W
    cta_trsm_right<T>(Zt, k, H, k, true, g.sm);
    cta_copy<T>(Y, Zt, (int)kk);
    cta_trsm_right<T>(Y, k, H, k, false, g.sm);
    cta_gemm<T>(A_el + t * kk, k, QW, k, false, Y, k, true, k, k, k, T(-1), F,
                k, false, g.sm);                              // F - QW Y'
  }
}

// Mode 1: _qr_smoother_elements.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
qr_smoother_elements_gen_kernel(const T* x_pred, const T* P_pred,
                             const T* x_filt, const T* P_filt, const T* F,
                             const T* Q, T* E_el, T* g_el, T* D_el, T* J_out,
                             T* work, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QegCta<T> g(smem_raw, work, k);
  const size_t kk = (size_t)k * k;
  T *Lq = g.w, *Uf = Lq + kk, *Lpn = Uf + kk, *X1 = Lpn + kk, *X2 = X1 + kk;
  cta_psd_chol<T>(Lq, Q, k, true, g.sm);
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    const T* Pft = P_filt + t * kk;
    cta_psd_chol<T>(Uf, Pft, k, true, g.sm);                // psd_factor(P_f)
    if (t == n - 1) {
      cta_copy<T>(E_el + t * kk, nullptr, (int)kk);
      cta_copy<T>(g_el + (size_t)t * k, x_filt + (size_t)t * k, k);
      cta_copy<T>(D_el + t * kk, Uf, (int)kk);
      continue;
    }
    // J_t = chol_solve(Lp_{t+1}, F P_f)' = (F P_f)' Lp^{-T} Lp^{-1}.
    cta_psd_chol<T>(Lpn, P_pred + (t + 1) * kk, k, true, g.sm);
    T* Jt = E_el + t * kk;
    cta_gemm<T>(Jt, k, Pft, k, true, F, k, true, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                 // (F P_f)'
    cta_chol_solve_rows<T>(Jt, k, Lpn, k, g.sm);
    cta_copy<T>(J_out + t * kk, Jt, (int)kk);
    cta_load_vec(g.v[0], x_pred + (size_t)(t + 1) * k, k);
    cta_matvec<T>(g.v[1], x_filt + (size_t)t * k, T(-1), Jt, g.v[0], k,
                  g_el + (size_t)t * k);                      // x_f - J x_p
    // D_t = tria([(I - J F) U_f | J Lq]).
    cta_gemm<T>(X1, k, Jt, k, false, F, k, false, k, k, k, T(-1), nullptr, 0,
                true, g.sm);                                  // I - J F
    cta_gemm<T>(X2, k, X1, k, false, Uf, k, false, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                 // (.) U_f
    cta_gemm<T>(X1, k, Jt, k, false, Lq, k, false, k, k, k, T(1), nullptr, 0,
                false, g.sm);                                 // J Lq
    cta_tria<T>(D_el + t * kk, X2, false, X1, k, g.sm);
  }
}

// Mode 2: the post-scan assembly of pit_qr_from_stats.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
qr_filter_assemble_gen_kernel(const T* x_f, const T* U_f, const T* C,
                           int c_stride, const T* F, const T* Q,
                           const T* mu0, const T* P0, T* x_pred, T* P_pred,
                           T* P_f, T* logdetG, T* work, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QegCta<T> g(smem_raw, work, k);
  const size_t kk = (size_t)k * k;
  T *Lq = g.w, *AU = Lq + kk, *Lp = AU + kk, *X = Lp + kk, *Lg = X + kk;
  cta_psd_chol<T>(Lq, Q, k, true, g.sm);
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    const T* Uft = U_f + t * kk;
    cta_gemm<T>(P_f + t * kk, k, Uft, k, false, Uft, k, true, k, k, k, T(1),
                nullptr, 0, false, g.sm);                     // U_f U_f'
    if (t == 0) {
      cta_psd_chol<T>(Lp, P0, k, true, g.sm);               // psd_factor(P0)
      if (threadIdx.x < k) x_pred[threadIdx.x] = mu0[threadIdx.x];
    } else {
      cta_gemm<T>(AU, k, F, k, false, U_f + (t - 1) * kk, k, false, k, k, k,
                  T(1), nullptr, 0, false, g.sm);             // F U_f,t-1
      cta_tria<T>(Lp, AU, false, Lq, k, g.sm);
      cta_load_vec(g.v[0], x_f + (size_t)(t - 1) * k, k);
      cta_matvec<T>(g.v[1], nullptr, T(1), F, g.v[0], k,
                    x_pred + (size_t)t * k);
    }
    cta_gemm<T>(P_pred + t * kk, k, Lp, k, false, Lp, k, true, k, k, k, T(1),
                nullptr, 0, false, g.sm);                     // Lp Lp'
    cta_gemm<T>(X, k, Lp, k, true, C + (size_t)t * c_stride, k, false, k, k,
                k, T(1), nullptr, 0, false, g.sm);            // Lp' C_t
    cta_gemm<T>(Lg, k, X, k, false, Lp, k, false, k, k, k, T(1), nullptr, 0,
                true, g.sm);                                  // I + (.) Lp
    cta_psd_chol<T>(Lg, Lg, k, false, g.sm);                // unjittered
    cta_logdet<T>(Lg, k, logdetG + t);
    __syncthreads();
  }
}

// Mode 3: P_sm = D D', P_lag,t = P_sm,t J_{t-1}', P_lag,0 = 0.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
qr_smoother_assemble_gen_kernel(const T* D_sm, const T* J, T* P_sm, T* P_lag,
                             T* work, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QegCta<T> g(smem_raw, work, k);
  const size_t kk = (size_t)k * k;
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    T* Pt = P_sm + t * kk;
    cta_gemm<T>(Pt, k, D_sm + t * kk, k, false, D_sm + t * kk, k, true, k, k,
                k, T(1), nullptr, 0, false, g.sm);
    if (t == 0)
      cta_copy<T>(P_lag, nullptr, (int)kk);
    else
      cta_gemm<T>(P_lag + t * kk, k, Pt, k, false, J + (t - 1) * kk, k, true,
                  k, k, k, T(1), nullptr, 0, false, g.sm);
  }
}

// Mode 4: one generic K6/K7 function a matrix (op as the unit kernel's):
// 0 chol = psd_cholesky(X, 0), 1 chol_solve, 2 tria of a k x 2k block,
// 3 tri_solve (L X = B), 4 transposed (L' X = B), 5 psd_factor.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
qr_unit_gen_kernel(int op, const T* X, const T* B, T* out, T* work, int n,
                int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QegCta<T> g(smem_raw, work, k);
  const size_t kk = (size_t)k * k;
  T* R = g.w;
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    T* Ot = out + t * kk;
    if (op == 0 || op == 5) {
      cta_psd_chol<T>(Ot, X + t * kk, k, op == 5, g.sm);
    } else if (op == 2) {
      const T* Xt = X + 2 * t * kk;
      cta_gemm<T>(Ot, k, Xt, 2 * k, false, Xt, 2 * k, true, k, k, 2 * k,
                  T(1), nullptr, 0, false, g.sm);             // X X'
      cta_psd_chol<T>(Ot, Ot, k, true, g.sm);
    } else {
      // X' = B' L^{-T} (L X = B), B' L^{-1} (L' X = B) or both (chol).
      cta_transpose<T>(R, B + t * kk, k);
      if (op != 4) cta_trsm_right<T>(R, k, X + t * kk, k, true, g.sm);
      if (op != 3) cta_trsm_right<T>(R, k, X + t * kk, k, false, g.sm);
      cta_transpose<T>(Ot, R, k);
    }
  }
}

// Mode ``mode`` over n items on ``ctas`` persistent CTAs; ``work`` holds
// ctas x QR_EL_MATS k x k matrices; 4 <= k <= DFM_GEN_KMAX (the row
// vectors of the last matrix).
template <typename T>
static int launch_qr_gen(int mode, int op, const T* i0, const T* i1,
                      const T* i2, const T* i3, const T* i4, const T* i5,
                      const T* i6, T* o0, T* o1, T* o2, T* o3, T* o4,
                      T* work, int n, int k, int c_stride, int ctas,
                      cudaStream_t s) {
  if (n < 1 || k < 4 || k > DFM_GEN_KMAX || ctas < 1 || op < 0 || op > 5)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = QegCta<T>::bytes(k);
  const int grid = n < ctas ? n : ctas;
  cudaError_t err = cudaSuccess;
  switch (mode) {
    case 0:
      err = dfm_smem_optin(qr_filter_elements_gen_kernel<T>, bytes);
      if (err == cudaSuccess)
        qr_filter_elements_gen_kernel<T><<<grid, GEN_THREADS, bytes, s>>>(
            i0, i1, c_stride, i2, i3, i4, i5, o0, o1, o2, o3, o4, work, n,
            k);
      break;
    case 1:
      err = dfm_smem_optin(qr_smoother_elements_gen_kernel<T>, bytes);
      if (err == cudaSuccess)
        qr_smoother_elements_gen_kernel<T><<<grid, GEN_THREADS, bytes, s>>>(
            i0, i1, i2, i3, i4, i5, o0, o1, o2, o3, work, n, k);
      break;
    case 2:
      err = dfm_smem_optin(qr_filter_assemble_gen_kernel<T>, bytes);
      if (err == cudaSuccess)
        qr_filter_assemble_gen_kernel<T><<<grid, GEN_THREADS, bytes, s>>>(
            i0, i1, i2, c_stride, i3, i4, i5, i6, o0, o1, o2, o3, work, n,
            k);
      break;
    case 3:
      err = dfm_smem_optin(qr_smoother_assemble_gen_kernel<T>, bytes);
      if (err == cudaSuccess)
        qr_smoother_assemble_gen_kernel<T><<<grid, GEN_THREADS, bytes, s>>>(
            i0, i1, o0, o1, work, n, k);
      break;
    case 4:
      err = dfm_smem_optin(qr_unit_gen_kernel<T>, bytes);
      if (err == cudaSuccess)
        qr_unit_gen_kernel<T><<<grid, GEN_THREADS, bytes, s>>>(op, i0, i1, o0,
                                                            work, n, k);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" {
#if DFM_WANT_F32
int pit_elements_f32(int mode, const float* i0, const float* i1,
                     const float* i2, const float* i3, const float* i4,
                     const float* i5, const float* i6, float* o0, float* o1,
                     float* o2, float* o3, float* o4, int n, int k,
                     int c_stride, void* stream) {
  return launch<float>(mode, i0, i1, i2, i3, i4, i5, i6, o0, o1, o2, o3, o4,
                       n, k, c_stride, (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F32
int pit_elements_gen_f32(int mode, const float* i0, const float* i1,
                         const float* i2, const float* i3, const float* i4,
                         const float* i5, const float* i6, float* o0,
                         float* o1, float* o2, float* o3, float* o4,
                         float* work, int n, int k, int c_stride, int ctas,
                         void* stream) {
  return launch_gen<float>(mode, i0, i1, i2, i3, i4, i5, i6, o0, o1, o2, o3,
                           o4, work, n, k, c_stride, ctas,
                           (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int pit_elements_gen_f64(int mode, const double* i0, const double* i1,
                         const double* i2, const double* i3, const double* i4,
                         const double* i5, const double* i6, double* o0,
                         double* o1, double* o2, double* o3, double* o4,
                         double* work, int n, int k, int c_stride, int ctas,
                         void* stream) {
  return launch_gen<double>(mode, i0, i1, i2, i3, i4, i5, i6, o0, o1, o2, o3,
                            o4, work, n, k, c_stride, ctas,
                            (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int pit_elements_f64(int mode, const double* i0, const double* i1,
                     const double* i2, const double* i3, const double* i4,
                     const double* i5, const double* i6, double* o0,
                     double* o1, double* o2, double* o3, double* o4, int n,
                     int k, int c_stride, void* stream) {
  return launch<double>(mode, i0, i1, i2, i3, i4, i5, i6, o0, o1, o2, o3, o4,
                        n, k, c_stride, (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F32
int qr_elements_gen_f32(int mode, int op, const float* i0, const float* i1,
                        const float* i2, const float* i3, const float* i4,
                        const float* i5, const float* i6, float* o0,
                        float* o1, float* o2, float* o3, float* o4,
                        float* work, int n, int k, int c_stride, int ctas,
                        void* stream) {
  return launch_qr_gen<float>(mode, op, i0, i1, i2, i3, i4, i5, i6, o0,
                              o1, o2, o3, o4, work, n, k, c_stride, ctas,
                              (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int qr_elements_gen_f64(int mode, int op, const double* i0,
                        const double* i1, const double* i2, const double* i3,
                        const double* i4, const double* i5, const double* i6,
                        double* o0, double* o1, double* o2, double* o3,
                        double* o4, double* work, int n, int k, int c_stride,
                        int ctas, void* stream) {
  return launch_qr_gen<double>(mode, op, i0, i1, i2, i3, i4, i5, i6, o0,
                               o1, o2, o3, o4, work, n, k, c_stride, ctas,
                               (cudaStream_t)stream);
}
#endif
}
