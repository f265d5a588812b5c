// K5a: the k x k part of the steady-state engine, in one launch of one CTA.
//
// Replaces dfm_tpu/ssm/steady.py:_cov_path (line 124) and the k x k
// smoother of ss_from_stats (lines 198-234).  With a time-invariant C the
// covariance recursion does not depend on the data, so tau exact steps
// stand in for all T:
//   phase A (warp 0), t = 0 .. tau-1, from P = P0:
//     K4-forward's covariance step (warp_linalg.cuh: Lp = chol(sym(P) +
//     jitter), G = I + Lp' C Lp, Lg = chol(sym(G)) with no jitter, P_f =
//     sym(Lp G^{-1} Lp')), then M_t = A - P_f (C A), log|G|_t, and
//     P <- sym(A P_f A' + Q); it emits P_pred,t (the P it started from),
//     P_filt,t, M_t, log|G|_t and delta = max|P_tau - P_pred,tau-1| /
//     (max|P_tau| + 1e-30), the freeze diagnostic.
//   phase B (all warps, one t per warp at a time):
//     J_t = (chol(sym(P_pred,u) + jitter) solve A P_filt,t)',
//     u = min(t + 1, tau - 1); no J_t needs another, so they run in
//     parallel.  J_{tau-1} is the steady gain J_ss.
//   phase C (warp 0): the two backward passes of the smoothed covariance,
//     bstep_ss: P <- sym(P_f,ss + J_ss (P - P_pred,ss) J_ss'), tau steps
//       from P_f,ss, emitted in step order (Psm_end_rev); the last is the
//       interior fixed point;
//     bstep_ex: t = tau-1 .. 0 from that fixed point,
//       P <- sym(P_f,t + J_t (P - P_pred,u) J_t'), emitted at t (Psm_front).
//
// Bound on the H100: neither bytes (~40 k^2 tau values) nor operations
// (~25 k^3 tau flops, ~5 MFLOP at tau = 192, k = 10): phases A and C are
// chains of tau dependent k x k steps, so the floor is 2 tau step
// latencies; phase B has tau independent problems.  Design: all matrices
// in dynamic shared memory (leading dimension DFM_KMAX + 1), the one-warp
// routines of K4, the J_t spread over SS_WARPS warps, one launch so the
// 3 tau steps cost no launches.  k <= DFM_KMAX.
//
// K5a-wide (ss_cov_path_wide): the same kernel at k <= DFM_WIDE_KMAX = 32,
// which the wrapper takes for 16 < k <= 32 (the unmasked auto -> ss fit at
// wide k).  The matrices sit at the wide leading dimension (33) in slots
// of k rows; 12 + 3 SS_WARPS slots would be 507 KB in f64 at k = 32, over
// the 227 KB a block may opt in to, so phase B runs on SS_WIDE_WARPS = 4
// warps: 24 slots, 203 KB in f64 at k = 32.
//
// K5a-gen (ss_cov_path_gen): the same pass at 32 < k <= DFM_GEN_KMAX = 128,
// which the wrapper takes there (the unmasked auto -> ss fit past 32).  One
// shared-memory CTA cannot hold the slots past 32 (a k = 100 matrix is 80
// KB in f64), so the matrices are the pass's own output rows (P_pred,t,
// P_filt,t, M_t, J_t, Psm) and a (5, k, k) workspace the wrapper allocates,
// in global memory that stays in L2, and the algebra is cta_linalg.cuh's
// block-wide routines, as in the K4-gen pair.  One C call, three kernels
// (counted as three launches):
//   phase A (one CTA): K4-gen's covariance step without the data: Lp =
//     chol(sym(P) + jitter), G = I + Lp' C Lp, Lg = chol(sym(G)), Z = Lp
//     Lg^{-T}, P_f = Z Z', M_t = A - P_f (C A), log|G|, P <- sym(A P_f A' +
//     Q); delta from the step-tau P;
//   phase B (a CTA a step, tau CTAs): J_t = (A P_f,t)' Lc^{-T} Lc^{-1}, Lc
//     = chol(sym(P_pred,u) + jitter) factored in the row Psm_front[t],
//     which phase C overwrites;
//   phase C (one CTA): bstep_ss and bstep_ex, each P <- sym(P_f + J (P -
//     P_pred) J') by two products and a sym.
// Bound: phases A and C are 3 tau dependent steps of ~12 k^3 (A) and ~4
// k^3 (C) flops on one SM; phase B's tau gains run side by side.
#include "cta_linalg.cuh"

constexpr int SS_WARPS = 16;
constexpr int SS_WIDE_WARPS = 4;

__host__ __device__ constexpr int ss_slots(int warps) { return 12 + 3 * warps; }

// Matrix slot i of ``mat`` elements (rows x LDV) in shared memory.
template <typename T, int LDV>
__device__ __forceinline__ SMat<T, LDV> slot(T* base, int i, int mat) {
  return reinterpret_cast<SMat<T, LDV>>(base + (size_t)i * mat);
}

// max that keeps a NaN, as jnp.max does.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (isnan(a) || a > b) ? a : b;
}

// The pass at leading dimension LDV with NW warps; ``mat`` elements a slot.
template <typename T, int LDV, int NW>
__global__ void __launch_bounds__(32 * NW)
ss_cov_path_kernel(const T* __restrict__ C, const T* __restrict__ A,
                   const T* __restrict__ Q, const T* __restrict__ P0,
                   T* Pp, T* Pf, T* __restrict__ M, T* __restrict__ ldG,
                   T* __restrict__ delta, T* J, T* __restrict__ Psm_front,
                   T* __restrict__ Psm_end_rev, int tau, int k, int mat) {
  using SM = SMat<T, LDV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int lane = warp_lane(), warp = threadIdx.x >> 5;
  const int kk = k * k;
  const T jit = dfm_jitter<T>();
  SM Am = slot<T, LDV>(sm, 8, mat);

  // ---- phase A: tau exact covariance steps (warp 0) ----
  if (warp == 0) {
    SM P = slot<T, LDV>(sm, 0, mat), Lp = slot<T, LDV>(sm, 1, mat),
       Cm = slot<T, LDV>(sm, 2, mat), CL = slot<T, LDV>(sm, 3, mat),
       G = slot<T, LDV>(sm, 4, mat), Lg = slot<T, LDV>(sm, 5, mat),
       X = slot<T, LDV>(sm, 6, mat), Pfm = slot<T, LDV>(sm, 7, mat),
       Qm = slot<T, LDV>(sm, 9, mat), CA = slot<T, LDV>(sm, 10, mat),
       Pprev = slot<T, LDV>(sm, 11, mat);
    for (int e = lane; e < kk; e += 32) {
      const int i = e / k, j = e % k;
      Am[i][j] = A[e];
      Qm[i][j] = Q[e];
      Cm[i][j] = C[e];
      P[i][j] = P0[e];
    }
    __syncwarp();
    mm<T, false, false>(CA, Cm, Am, k);                 // C A
    for (int t = 0; t < tau; ++t) {
      for (int e = lane; e < kk; e += 32) {
        const int i = e / k, j = e % k;
        Pp[(size_t)t * kk + e] = P[i][j];
        Pprev[i][j] = P[i][j];
      }
      __syncwarp();
      info_cov_update<T>(P, Cm, Lp, CL, G, Lg, X, Pfm, k);
      mm<T, false, false>(G, Pfm, CA, k);               // P_f C A
      for (int e = lane; e < kk; e += 32) {
        const int i = e / k, j = e % k;
        M[(size_t)t * kk + e] = Am[i][j] - G[i][j];
        Pf[(size_t)t * kk + e] = Pfm[i][j];
      }
      if (lane == 0) ldG[t] = chol_logdet_warp<T>(Lg, k);
      __syncwarp();
      predict_cov<T>(P, Pfm, Am, Qm, CL, G, k);
    }
    T dmax = T(0), pmax = T(0);
    for (int e = lane; e < kk; e += 32) {
      const int i = e / k, j = e % k;
      dmax = nan_max(dmax, T(fabs(P[i][j] - Pprev[i][j])));
      pmax = nan_max(pmax, T(fabs(P[i][j])));
    }
    for (int o = 16; o > 0; o >>= 1) {
      dmax = nan_max(dmax, __shfl_xor_sync(0xffffffffu, dmax, o));
      pmax = nan_max(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
    }
    if (lane == 0) delta[0] = dmax / (pmax + T(1e-30));
  }
  __syncthreads();

  // ---- phase B: the gains, one warp per t ----
  {
    SM Lc = slot<T, LDV>(sm, 12 + 3 * warp, mat),
       Pft = slot<T, LDV>(sm, 13 + 3 * warp, mat),
       Z = slot<T, LDV>(sm, 14 + 3 * warp, mat);
    for (int t = warp; t < tau; t += NW) {
      const T* Ppu = Pp + (size_t)min(t + 1, tau - 1) * kk;
      for (int e = lane; e < kk; e += 32) {
        const int i = e / k, j = e % k;
        Lc[i][j] = T(0.5) * (Ppu[e] + Ppu[j * k + i]) + (i == j ? jit : T(0));
        Pft[i][j] = Pf[(size_t)t * kk + e];
      }
      __syncwarp();
      chol_inplace<T>(Lc, k);
      mm<T, false, false>(Z, Am, Pft, k);               // A P_f,t
      chol_solve_cols<T, false>(Z, Lc, Z, k);           // Z = J_t'
      for (int e = lane; e < kk; e += 32)
        J[(size_t)t * kk + e] = Z[e % k][e / k];
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- phase C: the backward passes of the smoothed covariance ----
  if (warp == 0) {
    SM Jm = slot<T, LDV>(sm, 0, mat), D = slot<T, LDV>(sm, 1, mat),
       T1 = slot<T, LDV>(sm, 2, mat), T2 = slot<T, LDV>(sm, 3, mat),
       Ps = slot<T, LDV>(sm, 4, mat), Pfs = slot<T, LDV>(sm, 5, mat),
       Pps = slot<T, LDV>(sm, 6, mat);
    const size_t ss = (size_t)(tau - 1) * kk;
    for (int e = lane; e < kk; e += 32) {
      const int i = e / k, j = e % k;
      Jm[i][j] = J[ss + e];
      Pfs[i][j] = Pf[ss + e];
      Pps[i][j] = Pp[ss + e];
      Ps[i][j] = Pf[ss + e];
    }
    __syncwarp();
    for (int s = 0; s < tau; ++s) {                     // bstep_ss
      for (int e = lane; e < kk; e += 32)
        D[e / k][e % k] = Ps[e / k][e % k] - Pps[e / k][e % k];
      __syncwarp();
      mm<T, false, false>(T1, Jm, D, k);                // J D
      mm<T, false, true>(T2, T1, Jm, k);                // J D J'
      for (int e = lane; e < kk; e += 32) {
        const int i = e / k, j = e % k;
        const T v = T(0.5) * ((Pfs[i][j] + T2[i][j]) + (Pfs[j][i] + T2[j][i]));
        Ps[i][j] = v;
        Psm_end_rev[(size_t)s * kk + e] = v;
      }
      __syncwarp();
    }
    for (int t = tau - 1; t >= 0; --t) {                // bstep_ex
      const size_t u = (size_t)min(t + 1, tau - 1) * kk;
      for (int e = lane; e < kk; e += 32) {
        const int i = e / k, j = e % k;
        Jm[i][j] = J[(size_t)t * kk + e];
        Pfs[i][j] = Pf[(size_t)t * kk + e];
        D[i][j] = Ps[i][j] - Pp[u + e];
      }
      __syncwarp();
      mm<T, false, false>(T1, Jm, D, k);
      mm<T, false, true>(T2, T1, Jm, k);
      for (int e = lane; e < kk; e += 32) {
        const int i = e / k, j = e % k;
        const T v = T(0.5) * ((Pfs[i][j] + T2[i][j]) + (Pfs[j][i] + T2[j][i]));
        Ps[i][j] = v;
        Psm_front[(size_t)t * kk + e] = v;
      }
      __syncwarp();
    }
  }
}

// k <= kmax at leading dimension LDV on NW warps; slots of ``rows`` rows.
template <typename T, int LDV, int NW>
static int launch_pass(const T* C, const T* A, const T* Q, const T* P0,
                       T* Pp, T* Pf, T* M, T* ldG, T* delta, T* J,
                       T* Psm_front, T* Psm_end_rev, int tau, int k, int kmax,
                       int rows, cudaStream_t stream) {
  if (k < 1 || k > kmax || tau < 1) return (int)cudaErrorInvalidValue;
  const int mat = rows * LDV;
  const size_t smem = (size_t)ss_slots(NW) * mat * sizeof(T);
  const cudaError_t err =
      dfm_smem_optin(ss_cov_path_kernel<T, LDV, NW>, smem);
  if (err != cudaSuccess) return (int)err;
  ss_cov_path_kernel<T, LDV, NW><<<1, 32 * NW, smem, stream>>>(
      C, A, Q, P0, Pp, Pf, M, ldG, delta, J, Psm_front, Psm_end_rev, tau, k,
      mat);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* C, const T* A, const T* Q, const T* P0, T* Pp,
                  T* Pf, T* M, T* ldG, T* delta, T* J, T* Psm_front,
                  T* Psm_end_rev, int tau, int k, cudaStream_t stream) {
  return launch_pass<T, LD, SS_WARPS>(C, A, Q, P0, Pp, Pf, M, ldG, delta, J,
                                      Psm_front, Psm_end_rev, tau, k,
                                      DFM_KMAX, DFM_KMAX, stream);
}

template <typename T>
static int launch_wide(const T* C, const T* A, const T* Q, const T* P0, T* Pp,
                       T* Pf, T* M, T* ldG, T* delta, T* J, T* Psm_front,
                       T* Psm_end_rev, int tau, int k, cudaStream_t stream) {
  return launch_pass<T, WIDE_LD, SS_WIDE_WARPS>(
      C, A, Q, P0, Pp, Pf, M, ldG, delta, J, Psm_front, Psm_end_rev, tau, k,
      DFM_WIDE_KMAX, k, stream);
}

// ---- K5a-gen: the three kernels ----

// Dynamic shared memory of the generic kernels: the routines' scratch and
// 32 values for a reduction.
template <typename T>
static size_t ssg_smem(int k) {
  return sizeof(T) * ((size_t)gen_scratch(k) + 32);
}

// Phase A.  work: Lp (then Z), a product, Lg, C A, and P after step tau-1.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
ss_cov_gen_forward(const T* C, const T* A, const T* Q, const T* P0, T* Pp,
                   T* Pf, T* M, T* ldG, T* delta, T* work, int tau, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* red = sm + gen_scratch(k);
  const int tid = threadIdx.x;
  const size_t kk = (size_t)k * k;
  T* Lp = work;
  T* W1 = work + kk;
  T* Lg = work + 2 * kk;
  T* CA = work + 3 * kk;
  T* Pend = work + 4 * kk;
  cta_copy<T>(Pp, P0, (int)kk);
  cta_gemm<T>(CA, k, C, k, false, A, k, false, k, k, k, T(1), nullptr, 0,
              false, sm);                                     // C A
  for (int t = 0; t < tau; ++t) {
    const T* P = Pp + (size_t)t * kk;
    T* Pft = Pf + (size_t)t * kk;
    cta_sym<T>(Lp, P, k, true, sm);
    cta_potrf<T>(Lp, k, sm);
    cta_gemm<T>(W1, k, C, k, false, Lp, k, false, k, k, k, T(1), nullptr, 0,
                false, sm);                                   // C Lp
    cta_gemm<T>(Lg, k, Lp, k, true, W1, k, false, k, k, k, T(1), nullptr, 0,
                true, sm);                                    // I + Lp' C Lp
    cta_sym<T>(Lg, Lg, k, false, sm);
    cta_potrf<T>(Lg, k, sm);                                  // no jitter
    if (tid < 32) {
      T s = T(0);
      for (int i = tid; i < k; i += 32) s += dfm_log(Lg[(size_t)i * k + i]);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (tid == 0) ldG[t] = T(2) * s;
    }
    cta_trsm_right<T>(Lp, k, Lg, k, true, sm);                // Z = Lp Lg^{-T}
    cta_gemm<T>(Pft, k, Lp, k, false, Lp, k, true, k, k, k, T(1), nullptr, 0,
                false, sm);                                   // P_f = Z Z'
    cta_gemm<T>(M + (size_t)t * kk, k, Pft, k, false, CA, k, false, k, k, k,
                T(-1), A, k, false, sm);                      // A - P_f C A
    cta_gemm<T>(W1, k, A, k, false, Pft, k, false, k, k, k, T(1), nullptr, 0,
                false, sm);                                   // A P_f
    T* Pn = t + 1 < tau ? Pp + (size_t)(t + 1) * kk : Pend;
    cta_gemm<T>(Pn, k, W1, k, false, A, k, true, k, k, k, T(1), Q, k, false,
                sm);                                          // A P_f A' + Q
    cta_sym<T>(Pn, Pn, k, false, sm);
  }
  // delta = max|P_tau - P_pred,tau-1| / (max|P_tau| + 1e-30), NaN kept.
  const T* Plast = Pp + (size_t)(tau - 1) * kk;
  T dmax = T(0), pmax = T(0);
  for (size_t e = tid; e < kk; e += GEN_THREADS) {
    dmax = nan_max(dmax, T(fabs(Pend[e] - Plast[e])));
    pmax = nan_max(pmax, T(fabs(Pend[e])));
  }
  for (int o = 16; o > 0; o >>= 1) {
    dmax = nan_max(dmax, __shfl_xor_sync(0xffffffffu, dmax, o));
    pmax = nan_max(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
  }
  const int warp = tid >> 5, nw = GEN_THREADS / 32;
  if ((tid & 31) == 0) {
    red[warp] = dmax;
    red[nw + warp] = pmax;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nw; ++w) {
      dmax = nan_max(dmax, red[w]);
      pmax = nan_max(pmax, red[nw + w]);
    }
    delta[0] = dmax / (pmax + T(1e-30));
  }
}

// Phase B: J_t, a CTA a step; Lc is factored in the row Lrow[t].
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
ss_cov_gen_gains(const T* A, const T* Pp, const T* Pf, T* J, T* Lrow,
                 int tau, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const size_t kk = (size_t)k * k;
  const int t = blockIdx.x, u = min(t + 1, tau - 1);
  T* Lc = Lrow + (size_t)t * kk;
  T* Jt = J + (size_t)t * kk;
  cta_sym<T>(Lc, Pp + (size_t)u * kk, k, true, sm);
  cta_potrf<T>(Lc, k, sm);
  cta_gemm<T>(Jt, k, Pf + (size_t)t * kk, k, true, A, k, true, k, k, k, T(1),
              nullptr, 0, false, sm);                         // (A P_f)'
  cta_trsm_right<T>(Jt, k, Lc, k, true, sm);
  cta_trsm_right<T>(Jt, k, Lc, k, false, sm);                 // J_t
}

// One backward step: out = sym(Pf + Jm (Ps - Ppr) Jm').
template <typename T>
__device__ void ss_bstep_gen(T* out, const T* Ps, const T* Ppr, const T* Jm,
                             const T* Pf, T* D, T* T1, int k, T* sm) {
  cta_batched(
      k * k, [&](int e) { return Ps[e] - Ppr[e]; },
      [&](int e, T v) { D[e] = v; });
  cta_gemm<T>(T1, k, Jm, k, false, D, k, false, k, k, k, T(1), nullptr, 0,
              false, sm);                                     // J D
  cta_gemm<T>(out, k, T1, k, false, Jm, k, true, k, k, k, T(1), Pf, k, false,
              sm);                                            // P_f + J D J'
  cta_sym<T>(out, out, k, false, sm);
}

// Phase C: bstep_ss from P_f,ss (tau steps into Psm_end_rev), then
// bstep_ex (t = tau-1 .. 0 into Psm_front).  work: D and J D.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
ss_cov_gen_smooth(const T* Pp, const T* Pf, const T* J, T* Psm_front,
                  T* Psm_end_rev, T* work, int tau, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const size_t kk = (size_t)k * k, ss = (size_t)(tau - 1) * kk;
  T* D = work;
  T* T1 = work + kk;
  const T* Ps = Pf + ss;
  for (int s = 0; s < tau; ++s) {
    T* out = Psm_end_rev + (size_t)s * kk;
    ss_bstep_gen<T>(out, Ps, Pp + ss, J + ss, Pf + ss, D, T1, k, sm);
    Ps = out;
  }
  for (int t = tau - 1; t >= 0; --t) {
    T* out = Psm_front + (size_t)t * kk;
    const size_t u = (size_t)min(t + 1, tau - 1) * kk;
    ss_bstep_gen<T>(out, Ps, Pp + u, J + (size_t)t * kk, Pf + (size_t)t * kk,
                    D, T1, k, sm);
    Ps = out;
  }
}

// 1 <= k <= DFM_GEN_KMAX; ``work`` holds (5, k, k).
template <typename T>
static int launch_gen(const T* C, const T* A, const T* Q, const T* P0, T* Pp,
                      T* Pf, T* M, T* ldG, T* delta, T* J, T* Psm_front,
                      T* Psm_end_rev, T* work, int tau, int k,
                      cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX || tau < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = ssg_smem<T>(k);
  cudaError_t e;
  if ((e = dfm_smem_optin(ss_cov_gen_forward<T>, bytes)) != cudaSuccess ||
      (e = dfm_smem_optin(ss_cov_gen_gains<T>, bytes)) != cudaSuccess ||
      (e = dfm_smem_optin(ss_cov_gen_smooth<T>, bytes)) != cudaSuccess)
    return (int)e;
  ss_cov_gen_forward<T><<<1, GEN_THREADS, bytes, stream>>>(
      C, A, Q, P0, Pp, Pf, M, ldG, delta, work, tau, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ss_cov_gen_gains<T><<<tau, GEN_THREADS, bytes, stream>>>(A, Pp, Pf, J,
                                                           Psm_front, tau, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ss_cov_gen_smooth<T><<<1, GEN_THREADS, bytes, stream>>>(
      Pp, Pf, J, Psm_front, Psm_end_rev, work, tau, k);
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_SS_ENTRIES(SFX, T)                                                 \
  int ss_cov_path_##SFX(const T* C, const T* A, const T* Q, const T* P0,     \
                        T* Pp, T* Pf, T* M, T* ldG, T* delta, T* J,          \
                        T* Psm_front, T* Psm_end_rev, int tau, int k,        \
                        void* stream) {                                      \
    return launch<T>(C, A, Q, P0, Pp, Pf, M, ldG, delta, J, Psm_front,       \
                     Psm_end_rev, tau, k, (cudaStream_t)stream);             \
  }                                                                          \
  int ss_cov_path_wide_##SFX(const T* C, const T* A, const T* Q,             \
                             const T* P0, T* Pp, T* Pf, T* M, T* ldG,        \
                             T* delta, T* J, T* Psm_front, T* Psm_end_rev,   \
                             int tau, int k, void* stream) {                 \
    return launch_wide<T>(C, A, Q, P0, Pp, Pf, M, ldG, delta, J, Psm_front,  \
                          Psm_end_rev, tau, k, (cudaStream_t)stream);        \
  }                                                                          \
  int ss_cov_path_gen_##SFX(const T* C, const T* A, const T* Q,              \
                            const T* P0, T* Pp, T* Pf, T* M, T* ldG,         \
                            T* delta, T* J, T* Psm_front, T* Psm_end_rev,    \
                            T* work, int tau, int k, void* stream) {         \
    return launch_gen<T>(C, A, Q, P0, Pp, Pf, M, ldG, delta, J, Psm_front,   \
                         Psm_end_rev, work, tau, k, (cudaStream_t)stream);   \
  }
#if DFM_WANT_F32
DFM_SS_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_SS_ENTRIES(f64, double)
#endif
}
