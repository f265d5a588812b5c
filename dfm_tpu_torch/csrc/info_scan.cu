// K4: the information-form filter scan (forward) and the RTS smoother
// (backward), each a whole T loop in one launch.
//
// Forward replaces dfm_tpu/ssm/info_filter.py:info_scan (line 104).  Per
// step, from the predicted (x, P):
//   Lp = chol(sym(P) + jitter I);  G = I + Lp' C_t Lp;  Lg = chol(sym(G))
//   (no jitter: G >= I);  P_f = sym(Lp (Lg Lg')^{-1} Lp');
//   x_f = x + P_f (b_t - C_t x);  x <- A x_f;  P <- sym(A P_f A' + Q)
// and it emits x_pred, P_pred, x_filt, P_filt and log|G| = 2 sum log diag Lg.
//
// Backward replaces dfm_tpu/ssm/kalman.py:rts_smoother (line 84).  Per step
// t = T-2 .. 0:  J_t = ((chol(sym(P_pred,t+1) + jitter I) solve A P_filt,t))'
//   x_s = x_f + J (x_next - x_pred,t+1);
//   P_s = sym(P_f + J (P_next - P_pred,t+1) J');  P_lag,t+1 = P_next J'
// with P_lag[0] = 0 and the last step's smoothed moments the filtered ones.
//
// Bound on the H100: neither bytes nor operations.  Each pass moves ~0.45
// MB and does ~13 k^3 flops a step (~6.5 MFLOP at T = 500, k = 10), a few
// microseconds at the card's rates; but step t+1 needs step t, so the
// pass is a chain of T dependent k x k factorizations, solves and products,
// and its floor is T times the latency of one step's dependent chain.
//
// Design: one warp per problem lane, all k x k matrices in shared memory;
// the one-warp routines (warp_linalg.cuh) are shared with K5a
// (ss_cov_path.cu), whose covariance steps are this forward step without
// the data.  k <= DFM_KMAX.
//
// K4b, the batched twins, are the same two kernels launched with one block
// per lane (B blocks, each lane's tensors batch-major at a lane stride):
//   forward replaces dfm_tpu/estim/batched.py:_batched_info_scan (line
//   358), with C (B, k, k) static per lane, and the fleet's
//   dfm_tpu/estim/batched.py:_batched_info_scan_tv (line 614), with a
//   per-step C (c_lane = T k^2, c_stride = k^2) and no t_mask, so a dead
//   capacity step (C_t = 0) still advances the prediction; and with the
//   t_seq freeze: where t_mask[b, t] <= 0 the filtered moments
//   and the next prediction are the moments that entered the step, chosen
//   by a branch (never multiplied by the mask), so pad-step junk, even inf
//   or NaN, cannot reach them;
//   backward replaces dfm_tpu/estim/batched.py:_batched_rts (line 444).
// Each lane is the lone chain, so the batched passes are latency-bound as
// K4 is: B lanes run side by side on B SMs, a pass takes about the lone
// pass's time.  The lone entry points launch one block with no mask.
//
// K12 = K4-wide, the wide pair (info_scan_wide, rts_smoother_wide): the
// same two passes for a lone chain at any k <= DFM_WIDE_KMAX = 32, which
// the lone wrappers take for 16 < k <= 32.  It replaces the same two JAX
// routines where dfm_tpu/models/mixed_freq.py:mf_em_core runs them on the
// m = L k augmented state (lines 183 and 202; m = 25 at S3, in f64 on the
// card as the module's docstring sets out).  One warp still owns a column
// per lane (k <= 32), so the pass bodies and the warp routines are the k <=
// 16 kernels' own, instantiated at a leading dimension of 33; the ten (nine)
// m x m matrices live in dynamic shared memory sized from the runtime k
// (67 KB forward in f64 at m = 25, 85 KB at m = 32; opted in above 48 KB).
// Bound: latency, as K4: a chain of T dependent m x m factorizations,
// solves and products, one lane's work growing ~m^2 a product.  The k <= 16
// kernels keep their static shared arrays and launch as before.
//
// K4b-wide, the batched wide pair (batched_info_scan_wide,
// batched_rts_wide): the wide kernels launched with one block a lane, as
// K4b launches K4's, for the batched wrappers at 16 < k <= 32.  They
// replace the same JAX routines as K4b (dfm_tpu/estim/batched.py:
// _batched_info_scan, line 358, with C static per lane or per step, the
// fleet's _batched_info_scan_tv, line 614; _batched_rts, line 444) at wide
// k: fit_many, the k-grid and the rolling windows past k = 16, and a fleet
// bucket padded past 16.  The t_seq freeze is the shared pass body's
// branch (the wide lone launch passes no mask).  Each block opts in to its
// dynamic shared memory as the lone wide launch does (85 KB forward in f64
// at k = 32: two blocks an SM).  Bound: latency, as the lone wide pair:
// the B lanes run side by side, one SM each.
//
// The generic pair past k = 32 (K4-gen, K4b-gen) is info_scan_gen.cu, a
// source of its own: the k <= 32 kernels build apart from the block-wide
// routines, and first (the first groups of chip_smoke.py wait on them).
#include "warp_linalg.cuh"

// One forward pass in one warp; the matrices and vectors are the caller's
// shared memory (static for k <= 16, dynamic for the wide kernel).
template <typename T, int LDV>
__device__ __forceinline__ void info_scan_pass(
    SMat<T, LDV> P, SMat<T, LDV> Lp, SMat<T, LDV> Cm, SMat<T, LDV> CL,
    SMat<T, LDV> G, SMat<T, LDV> Lg, SMat<T, LDV> X, SMat<T, LDV> Pf,
    SMat<T, LDV> Am, SMat<T, LDV> Qm, T* x, T* u, T* xf,
    const T* __restrict__ b, const T* __restrict__ C, int c_lane,
    int c_stride, const T* __restrict__ A, const T* __restrict__ Q,
    const T* __restrict__ mu0, const T* __restrict__ P0,
    const T* __restrict__ t_mask, T* __restrict__ x_pred,
    T* __restrict__ P_pred, T* __restrict__ x_filt, T* __restrict__ P_filt,
    T* __restrict__ logdetG, int T_, int k) {
  const int lane = threadIdx.x;
  const int kk = k * k;
  // This block's problem lane.
  const size_t pb = blockIdx.x, tk = (size_t)T_ * k, tkk = (size_t)T_ * kk;
  b += pb * tk;
  C += pb * c_lane;
  A += pb * kk;
  Q += pb * kk;
  P0 += pb * kk;
  mu0 += pb * k;
  if (t_mask) t_mask += pb * T_;
  x_pred += pb * tk;
  x_filt += pb * tk;
  P_pred += pb * tkk;
  P_filt += pb * tkk;
  logdetG += pb * T_;
  for (int e = lane; e < kk; e += 32) {
    const int i = e / k, j = e % k;
    Am[i][j] = A[e];
    Qm[i][j] = Q[e];
    P[i][j] = P0[e];
  }
  if (lane < k) x[lane] = mu0[lane];
  __syncwarp();
  for (int t = 0; t < T_; ++t) {
    const T* Ct = C + (size_t)t * c_stride;
    for (int e = lane; e < kk; e += 32) {
      P_pred[(size_t)t * kk + e] = P[e / k][e % k];
      Cm[e / k][e % k] = Ct[e];
    }
    if (lane < k) x_pred[(size_t)t * k + lane] = x[lane];
    __syncwarp();
    info_cov_update<T>(P, Cm, Lp, CL, G, Lg, X, Pf, k);
    // A pad step (t_mask <= 0) holds the carry: P_f = P, x_f = x, and no
    // prediction.  The branch is uniform across the warp.
    const bool real = t_mask == nullptr || t_mask[t] > T(0);
    if (!real) {
      for (int e = lane; e < kk; e += 32) Pf[e / k][e % k] = P[e / k][e % k];
      __syncwarp();
    }
    if (lane < k) {
      T s = T(0);
      for (int l = 0; l < k; ++l) s += Cm[lane][l] * x[l];
      u[lane] = b[(size_t)t * k + lane] - s;
    }
    __syncwarp();
    if (lane < k) {
      T s = T(0);
      for (int l = 0; l < k; ++l) s += Pf[lane][l] * u[l];
      xf[lane] = real ? x[lane] + s : x[lane];
      x_filt[(size_t)t * k + lane] = xf[lane];
    }
    for (int e = lane; e < kk; e += 32)
      P_filt[(size_t)t * kk + e] = Pf[e / k][e % k];
    if (lane == 0) logdetG[t] = chol_logdet_warp<T>(Lg, k);
    __syncwarp();
    if (!real) continue;
    if (lane < k) {
      T s = T(0);
      for (int l = 0; l < k; ++l) s += Am[lane][l] * xf[l];
      x[lane] = s;
    }
    predict_cov<T>(P, Pf, Am, Qm, CL, G, k);
  }
}

template <typename T>
__global__ void __launch_bounds__(32)
info_scan_kernel(const T* __restrict__ b, const T* __restrict__ C,
                 int c_lane, int c_stride, const T* __restrict__ A,
                 const T* __restrict__ Q, const T* __restrict__ mu0,
                 const T* __restrict__ P0, const T* __restrict__ t_mask,
                 T* __restrict__ x_pred, T* __restrict__ P_pred,
                 T* __restrict__ x_filt, T* __restrict__ P_filt,
                 T* __restrict__ logdetG, int T_, int k) {
  __shared__ T P[DFM_KMAX][LD], Lp[DFM_KMAX][LD], Cm[DFM_KMAX][LD],
      CL[DFM_KMAX][LD], G[DFM_KMAX][LD], Lg[DFM_KMAX][LD], X[DFM_KMAX][LD],
      Pf[DFM_KMAX][LD], Am[DFM_KMAX][LD], Qm[DFM_KMAX][LD];
  __shared__ T x[DFM_KMAX], u[DFM_KMAX], xf[DFM_KMAX];
  info_scan_pass<T, LD>(P, Lp, Cm, CL, G, Lg, X, Pf, Am, Qm, x, u, xf, b, C,
                        c_lane, c_stride, A, Q, mu0, P0, t_mask, x_pred,
                        P_pred, x_filt, P_filt, logdetG, T_, k);
}

// The k x WIDE_LD slot i of the dynamic shared memory at ``base``.
template <typename T>
__device__ __forceinline__ SMat<T, WIDE_LD> wide_slot(T* base, int i,
                                                      int k) {
  return reinterpret_cast<SMat<T, WIDE_LD>>(base + (size_t)i * k * WIDE_LD);
}

// Dynamic shared memory of the wide passes: ``mats`` k x WIDE_LD matrices
// and three k-vectors.
template <typename T>
static size_t wide_smem(int k, int mats) {
  return sizeof(T) * ((size_t)mats * k * WIDE_LD + 3 * (size_t)k);
}

template <typename T>
__global__ void __launch_bounds__(32)
info_scan_wide_kernel(const T* __restrict__ b, const T* __restrict__ C,
                      int c_lane, int c_stride, const T* __restrict__ A,
                      const T* __restrict__ Q, const T* __restrict__ mu0,
                      const T* __restrict__ P0, const T* __restrict__ t_mask,
                      T* __restrict__ x_pred, T* __restrict__ P_pred,
                      T* __restrict__ x_filt, T* __restrict__ P_filt,
                      T* __restrict__ logdetG, int T_, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* vec = sm + (size_t)10 * k * WIDE_LD;
  info_scan_pass<T, WIDE_LD>(
      wide_slot(sm, 0, k), wide_slot(sm, 1, k), wide_slot(sm, 2, k),
      wide_slot(sm, 3, k), wide_slot(sm, 4, k), wide_slot(sm, 5, k),
      wide_slot(sm, 6, k), wide_slot(sm, 7, k), wide_slot(sm, 8, k),
      wide_slot(sm, 9, k), vec, vec + k, vec + 2 * k, b, C, c_lane, c_stride,
      A, Q, mu0, P0, t_mask, x_pred, P_pred, x_filt, P_filt, logdetG, T_, k);
}

// One backward pass in one warp, as info_scan_pass.
template <typename T, int LDV>
__device__ __forceinline__ void rts_pass(
    SMat<T, LDV> Am, SMat<T, LDV> Lc, SMat<T, LDV> Ppn, SMat<T, LDV> Pft,
    SMat<T, LDV> Z, SMat<T, LDV> D, SMat<T, LDV> T1, SMat<T, LDV> T2,
    SMat<T, LDV> Pn, T* xn, T* dx, T* xs,
    const T* __restrict__ x_pred, const T* __restrict__ P_pred,
    const T* __restrict__ x_filt, const T* __restrict__ P_filt,
    const T* __restrict__ A, T* __restrict__ x_sm, T* __restrict__ P_sm,
    T* __restrict__ P_lag, int T_, int k) {
  const int lane = threadIdx.x;
  const int kk = k * k;
  const T jit = dfm_jitter<T>();
  const size_t last = (size_t)(T_ - 1);
  // This block's problem lane.
  const size_t pb = blockIdx.x, tk = (size_t)T_ * k, tkk = (size_t)T_ * kk;
  x_pred += pb * tk;
  x_filt += pb * tk;
  x_sm += pb * tk;
  P_pred += pb * tkk;
  P_filt += pb * tkk;
  P_sm += pb * tkk;
  P_lag += pb * tkk;
  A += pb * kk;
  for (int e = lane; e < kk; e += 32) {
    const int i = e / k, j = e % k;
    Am[i][j] = A[e];
    Pn[i][j] = P_filt[last * kk + e];
    P_sm[last * kk + e] = P_filt[last * kk + e];
    P_lag[e] = T(0);
  }
  if (lane < k) {
    xn[lane] = x_filt[last * k + lane];
    x_sm[last * k + lane] = xn[lane];
  }
  __syncwarp();
  for (int t = T_ - 2; t >= 0; --t) {
    const T* Pp1 = P_pred + (size_t)(t + 1) * kk;
    for (int e = lane; e < kk; e += 32) {
      const int i = e / k, j = e % k;
      Ppn[i][j] = Pp1[e];
      Pft[i][j] = P_filt[(size_t)t * kk + e];
    }
    __syncwarp();
    for (int e = lane; e < kk; e += 32) {
      const int i = e / k, j = e % k;
      Lc[i][j] = T(0.5) * (Ppn[i][j] + Ppn[j][i]) + (i == j ? jit : T(0));
      D[i][j] = Pn[i][j] - Ppn[i][j];
    }
    if (lane < k) dx[lane] = xn[lane] - x_pred[(size_t)(t + 1) * k + lane];
    __syncwarp();
    chol_inplace<T>(Lc, k);
    mm<T, false, false>(Z, Am, Pft, k);                 // A P_f,t
    chol_solve_cols<T, false>(Z, Lc, Z, k);             // Z = J_t'
    if (lane < k) {
      T s = T(0);
      for (int l = 0; l < k; ++l) s += Z[l][lane] * dx[l];
      xs[lane] = x_filt[(size_t)t * k + lane] + s;
    }
    mm<T, true, false>(T1, Z, D, k);                    // J D
    mm<T, false, false>(T2, T1, Z, k);                  // J D J'
    mm<T, false, false>(T1, Pn, Z, k);                  // P_next J'
    for (int e = lane; e < kk; e += 32) {
      const int i = e / k, j = e % k;
      P_lag[(size_t)(t + 1) * kk + e] = T1[i][j];
      Pn[i][j] = T(0.5) * ((Pft[i][j] + T2[i][j]) + (Pft[j][i] + T2[j][i]));
    }
    if (lane < k) {
      xn[lane] = xs[lane];
      x_sm[(size_t)t * k + lane] = xs[lane];
    }
    __syncwarp();
    for (int e = lane; e < kk; e += 32)
      P_sm[(size_t)t * kk + e] = Pn[e / k][e % k];
  }
}

template <typename T>
__global__ void __launch_bounds__(32)
rts_smoother_kernel(const T* __restrict__ x_pred,
                    const T* __restrict__ P_pred,
                    const T* __restrict__ x_filt,
                    const T* __restrict__ P_filt, const T* __restrict__ A,
                    T* __restrict__ x_sm, T* __restrict__ P_sm,
                    T* __restrict__ P_lag, int T_, int k) {
  __shared__ T Am[DFM_KMAX][LD], Lc[DFM_KMAX][LD], Ppn[DFM_KMAX][LD],
      Pft[DFM_KMAX][LD], Z[DFM_KMAX][LD], D[DFM_KMAX][LD], T1[DFM_KMAX][LD],
      T2[DFM_KMAX][LD], Pn[DFM_KMAX][LD];
  __shared__ T xn[DFM_KMAX], dx[DFM_KMAX], xs[DFM_KMAX];
  rts_pass<T, LD>(Am, Lc, Ppn, Pft, Z, D, T1, T2, Pn, xn, dx, xs, x_pred,
                  P_pred, x_filt, P_filt, A, x_sm, P_sm, P_lag, T_, k);
}

template <typename T>
__global__ void __launch_bounds__(32)
rts_smoother_wide_kernel(const T* __restrict__ x_pred,
                         const T* __restrict__ P_pred,
                         const T* __restrict__ x_filt,
                         const T* __restrict__ P_filt,
                         const T* __restrict__ A, T* __restrict__ x_sm,
                         T* __restrict__ P_sm, T* __restrict__ P_lag, int T_,
                         int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* vec = sm + (size_t)9 * k * WIDE_LD;
  rts_pass<T, WIDE_LD>(
      wide_slot(sm, 0, k), wide_slot(sm, 1, k), wide_slot(sm, 2, k),
      wide_slot(sm, 3, k), wide_slot(sm, 4, k), wide_slot(sm, 5, k),
      wide_slot(sm, 6, k), wide_slot(sm, 7, k), wide_slot(sm, 8, k), vec,
      vec + k, vec + 2 * k, x_pred, P_pred, x_filt, P_filt, A, x_sm, P_sm,
      P_lag, T_, k);
}

template <typename T>
static int launch_scan(const T* b, const T* C, int c_lane, int c_stride,
                       const T* A, const T* Q, const T* mu0, const T* P0,
                       const T* t_mask, T* x_pred, T* P_pred, T* x_filt,
                       T* P_filt, T* logdetG, int B, int T_, int k,
                       cudaStream_t stream) {
  if (k < 1 || k > DFM_KMAX) return (int)cudaErrorInvalidValue;
  if (B > 0 && T_ > 0)
    info_scan_kernel<T><<<B, 32, 0, stream>>>(b, C, c_lane, c_stride, A, Q,
                                              mu0, P0, t_mask, x_pred, P_pred,
                                              x_filt, P_filt, logdetG, T_, k);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_rts(const T* x_pred, const T* P_pred, const T* x_filt,
                      const T* P_filt, const T* A, T* x_sm, T* P_sm,
                      T* P_lag, int B, int T_, int k, cudaStream_t stream) {
  if (k < 1 || k > DFM_KMAX) return (int)cudaErrorInvalidValue;
  if (B > 0 && T_ > 0)
    rts_smoother_kernel<T><<<B, 32, 0, stream>>>(x_pred, P_pred, x_filt,
                                                 P_filt, A, x_sm, P_sm, P_lag,
                                                 T_, k);
  return (int)cudaGetLastError();
}

// The wide pair over B lanes (B = 1, no mask: the lone chain), 1 <= k <=
// DFM_WIDE_KMAX.
template <typename T>
static int launch_scan_wide(const T* b, const T* C, int c_lane, int c_stride,
                            const T* A, const T* Q, const T* mu0, const T* P0,
                            const T* t_mask, T* x_pred, T* P_pred, T* x_filt,
                            T* P_filt, T* logdetG, int B, int T_, int k,
                            cudaStream_t stream) {
  if (k < 1 || k > DFM_WIDE_KMAX) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T_ <= 0) return (int)cudaGetLastError();
  const size_t bytes = wide_smem<T>(k, 10);
  const cudaError_t e = dfm_smem_optin(info_scan_wide_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  info_scan_wide_kernel<T><<<B, 32, bytes, stream>>>(
      b, C, c_lane, c_stride, A, Q, mu0, P0, t_mask, x_pred, P_pred, x_filt,
      P_filt, logdetG, T_, k);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_rts_wide(const T* x_pred, const T* P_pred, const T* x_filt,
                           const T* P_filt, const T* A, T* x_sm, T* P_sm,
                           T* P_lag, int B, int T_, int k,
                           cudaStream_t stream) {
  if (k < 1 || k > DFM_WIDE_KMAX) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T_ <= 0) return (int)cudaGetLastError();
  const size_t bytes = wide_smem<T>(k, 9);
  const cudaError_t e = dfm_smem_optin(rts_smoother_wide_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  rts_smoother_wide_kernel<T><<<B, 32, bytes, stream>>>(
      x_pred, P_pred, x_filt, P_filt, A, x_sm, P_sm, P_lag, T_, k);
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_SCAN_ENTRIES(SFX, T)                                               \
  int info_scan_##SFX(const T* b, const T* C, int c_stride, const T* A,      \
                      const T* Q, const T* mu0, const T* P0, T* x_pred,      \
                      T* P_pred, T* x_filt, T* P_filt, T* logdetG, int T_,   \
                      int k, void* stream) {                                 \
    return launch_scan<T>(b, C, 0, c_stride, A, Q, mu0, P0, nullptr, x_pred, \
                          P_pred, x_filt, P_filt, logdetG, 1, T_, k,         \
                          (cudaStream_t)stream);                             \
  }                                                                          \
  int batched_info_scan_##SFX(const T* b, const T* C, int c_lane,            \
                              int c_stride, const T* A, const T* Q,          \
                              const T* mu0, const T* P0, const T* t_mask,    \
                              T* x_pred, T* P_pred, T* x_filt, T* P_filt,    \
                              T* logdetG, int B, int T_, int k,              \
                              void* stream) {                                \
    return launch_scan<T>(b, C, c_lane, c_stride, A, Q, mu0, P0, t_mask,     \
                          x_pred, P_pred, x_filt, P_filt, logdetG, B, T_, k, \
                          (cudaStream_t)stream);                             \
  }                                                                          \
  int rts_smoother_##SFX(const T* x_pred, const T* P_pred, const T* x_filt,  \
                         const T* P_filt, const T* A, T* x_sm, T* P_sm,      \
                         T* P_lag, int T_, int k, void* stream) {            \
    return launch_rts<T>(x_pred, P_pred, x_filt, P_filt, A, x_sm, P_sm,      \
                         P_lag, 1, T_, k, (cudaStream_t)stream);             \
  }                                                                          \
  int batched_rts_##SFX(const T* x_pred, const T* P_pred, const T* x_filt,   \
                        const T* P_filt, const T* A, T* x_sm, T* P_sm,       \
                        T* P_lag, int B, int T_, int k, void* stream) {      \
    return launch_rts<T>(x_pred, P_pred, x_filt, P_filt, A, x_sm, P_sm,      \
                         P_lag, B, T_, k, (cudaStream_t)stream);             \
  }                                                                          \
  int info_scan_wide_##SFX(const T* b, const T* C, int c_stride,             \
                           const T* A, const T* Q, const T* mu0,             \
                           const T* P0, T* x_pred, T* P_pred, T* x_filt,     \
                           T* P_filt, T* logdetG, int T_, int k,             \
                           void* stream) {                                   \
    return launch_scan_wide<T>(b, C, 0, c_stride, A, Q, mu0, P0, nullptr,    \
                               x_pred, P_pred, x_filt, P_filt, logdetG, 1,   \
                               T_, k, (cudaStream_t)stream);                 \
  }                                                                          \
  int batched_info_scan_wide_##SFX(const T* b, const T* C, int c_lane,       \
                                   int c_stride, const T* A, const T* Q,     \
                                   const T* mu0, const T* P0,                \
                                   const T* t_mask, T* x_pred, T* P_pred,    \
                                   T* x_filt, T* P_filt, T* logdetG, int B,  \
                                   int T_, int k, void* stream) {            \
    return launch_scan_wide<T>(b, C, c_lane, c_stride, A, Q, mu0, P0,        \
                               t_mask, x_pred, P_pred, x_filt, P_filt,       \
                               logdetG, B, T_, k, (cudaStream_t)stream);     \
  }                                                                          \
  int rts_smoother_wide_##SFX(const T* x_pred, const T* P_pred,              \
                              const T* x_filt, const T* P_filt, const T* A,  \
                              T* x_sm, T* P_sm, T* P_lag, int T_, int k,     \
                              void* stream) {                                \
    return launch_rts_wide<T>(x_pred, P_pred, x_filt, P_filt, A, x_sm, P_sm, \
                              P_lag, 1, T_, k, (cudaStream_t)stream);        \
  }                                                                          \
  int batched_rts_wide_##SFX(const T* x_pred, const T* P_pred,               \
                             const T* x_filt, const T* P_filt, const T* A,   \
                             T* x_sm, T* P_sm, T* P_lag, int B, int T_,      \
                             int k, void* stream) {                          \
    return launch_rts_wide<T>(x_pred, P_pred, x_filt, P_filt, A, x_sm, P_sm, \
                              P_lag, B, T_, k, (cudaStream_t)stream);        \
  }
#if DFM_WANT_F32
DFM_SCAN_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_SCAN_ENTRIES(f64, double)
#endif
}
