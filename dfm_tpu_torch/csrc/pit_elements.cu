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
#include "warp_linalg.cuh"

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
}
