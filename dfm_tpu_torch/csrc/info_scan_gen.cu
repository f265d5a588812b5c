// K4-gen and K4b-gen, the generic pair of K4 (info_scan.cu holds K4, its
// wide tier and their batched twins; the formulas are there).
//
// K4-gen, the generic pair (info_scan_gen, rts_smoother_gen): the same two
// passes for a lone chain at 32 < k <= DFM_GEN_KMAX = 128 (the lone info
// and lowrank fits, fused fits and sessions past 32, and the
// mixed-frequency seq route at m = L k > 32), replacing
// dfm_tpu/ssm/info_filter.py:info_scan (line 104) and
// dfm_tpu/ssm/kalman.py:rts_smoother (line 84) there.  The wide design
// does not scale: its ten k x 33 matrices are 808 KB in f64 at k = 100,
// against 227 KB of shared memory a block.  Design: one block of 256
// threads a lane; the k x k matrices are the pass's own output rows
// (P_pred[t], P_filt[t]; P_sm[t], P_lag[t]) and a (4, k, k) workspace the
// wrapper allocates, in global memory that stays in L2; the algebra is
// cta_linalg.cuh's block-wide routines over 32-wide tiles staged in shared
// memory: a right-looking blocked Cholesky, blocked triangular solves and
// register-tiled products.  Forward, P_f = Z Z' with Z = Lp Lg^{-T} (one
// triangular solve, and P_f exactly symmetric); backward, J_t = (A
// P_f,t)' Lc^{-T} Lc^{-1} with Lc = chol(sym(P_pred,t+1) + jitter I).  Only
// the step's own dependence serializes the pass: every product, panel and
// solve inside a step runs on the whole block.  Bound: latency, a chain of
// T dependent steps of ~12 k^3 (forward) and ~11 k^3 (backward) flops, on
// one SM (~0.5 TFLOP/s of its peak in f32: >= 12 ms a pass at T = 500,
// k = 100).  One instantiation a dtype takes every k (the products pick a
// 2, 4 or 8 register block at run time).
//
// K4b-gen, the batched generic pair (batched_info_scan_gen,
// batched_rts_gen): the K4-gen kernels themselves launched with one block a
// lane (blockIdx.x; the lone entry points launch B = 1 with no mask), each
// lane's tensors batch-major at a lane stride, C at K4b's c_lane /
// c_stride, and a (B, 4, k, k) workspace the wrapper allocates.  They
// replace dfm_tpu/estim/batched.py:_batched_info_scan (line 358, C static
// per lane, with the t_seq freeze), the fleet's _batched_info_scan_tv
// (line 614, a per-step C, no freeze) and _batched_rts (line 444) at 32 <
// k <= 128: fit_many, the k-grid, the rolling windows and fleet buckets
// past k = 32.  The freeze is a block-uniform branch: at a pad step the
// filtered moments are copies of the carried prediction, the next
// prediction is the carry again, and log|G| is still the step's.  Bound:
// latency, as K4-gen: each lane is the lone chain on one SM, B lanes side
// by side on B SMs, their working sets ((4 + 2) k^2 values a lane, ~0.24
// MB at k = 100 in f32) together in L2.
#include "cta_linalg.cuh"

// Dynamic shared memory of the generic pair: the routines' scratch and
// three k-vectors.
template <typename T>
static size_t gen_smem(int k) {
  return sizeof(T) * ((size_t)gen_scratch(k) + 3 * DFM_GEN_KMAX);
}

// blockIdx.x is the problem lane (B = 1 for the lone chain): every tensor
// of a lane sits at a lane stride, C at c_lane, the workspace at 4 k^2.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
info_scan_gen_kernel(const T* b, const T* C, int c_lane, int c_stride,
                     const T* A, const T* Q, const T* mu0, const T* P0,
                     const T* t_mask, T* x_pred, T* P_pred, T* x_filt,
                     T* P_filt, T* logdetG, T* work, int T_, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* x = sm + gen_scratch(k);
  T* u = x + DFM_GEN_KMAX;
  T* xf = u + DFM_GEN_KMAX;
  const int tid = threadIdx.x, kk = k * k;
  const size_t pb = blockIdx.x, tk = (size_t)T_ * k, tkk = (size_t)T_ * kk;
  b += pb * tk;
  C += pb * c_lane;
  A += pb * kk;
  Q += pb * kk;
  mu0 += pb * k;
  P0 += pb * kk;
  if (t_mask) t_mask += pb * T_;
  x_pred += pb * tk;
  x_filt += pb * tk;
  P_pred += pb * tkk;
  P_filt += pb * tkk;
  logdetG += pb * T_;
  work += pb * 4 * kk;
  T* Lp = work;                   // Lp, then Z = Lp Lg^{-T}
  T* W1 = work + kk;              // C_t Lp, then A P_f
  T* Lg = work + 2 * kk;          // I + Lp' C_t Lp, then its factor
  for (int e = tid; e < kk; e += GEN_THREADS) P_pred[e] = P0[e];
  if (tid < k) x[tid] = mu0[tid];
  __syncthreads();
  for (int t = 0; t < T_; ++t) {
    const T* Pp = P_pred + (size_t)t * kk;
    T* Pf = P_filt + (size_t)t * kk;
    const T* Ct = C + (size_t)t * c_stride;
    // A pad step (t_mask <= 0) holds the carry: P_f = P, x_f = x, and the
    // next prediction is the carry again; log|G| is still the step's.
    // The branch is uniform across the block.
    const bool real = t_mask == nullptr || t_mask[t] > T(0);
    if (tid < k) x_pred[(size_t)t * k + tid] = x[tid];
    cta_sym<T>(Lp, Pp, k, true, sm);
    cta_potrf<T>(Lp, k, sm);
    cta_gemm<T>(W1, k, Ct, k, false, Lp, k, false, k, k, k, T(1), nullptr, 0,
                false, sm);                                   // C_t Lp
    cta_gemm<T>(Lg, k, Lp, k, true, W1, k, false, k, k, k, T(1), nullptr, 0,
                true, sm);                                    // I + Lp' C_t Lp
    cta_sym<T>(Lg, Lg, k, false, sm);
    cta_potrf<T>(Lg, k, sm);                                  // no jitter: G >= I
    if (tid < 32) {
      T s = T(0);
      for (int i = tid; i < k; i += 32) s += dfm_log(Lg[(size_t)i * k + i]);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (tid == 0) logdetG[t] = T(2) * s;
    }
    if (real) {
      cta_trsm_right<T>(Lp, k, Lg, k, true, sm);              // Z = Lp Lg^{-T}
      cta_gemm<T>(Pf, k, Lp, k, false, Lp, k, true, k, k, k, T(1), nullptr,
                  0, false, sm);                              // P_f = Z Z'
      cta_matvec<T>(u, b + (size_t)t * k, T(-1), Ct, x, k, nullptr);
      cta_matvec<T>(xf, x, T(1), Pf, u, k, x_filt + (size_t)t * k);
    } else {
      cta_batched(
          kk, [&](int e) { return Pp[e]; }, [&](int e, T v) { Pf[e] = v; });
      if (tid < k) x_filt[(size_t)t * k + tid] = x[tid];
      __syncthreads();
    }
    if (t + 1 == T_) break;
    T* Pn = P_pred + (size_t)(t + 1) * kk;
    if (!real) {
      cta_batched(
          kk, [&](int e) { return Pp[e]; }, [&](int e, T v) { Pn[e] = v; });
      __syncthreads();
      continue;
    }
    cta_gemm<T>(W1, k, A, k, false, Pf, k, false, k, k, k, T(1), nullptr, 0,
                false, sm);                                   // A P_f
    cta_gemm<T>(Pn, k, W1, k, false, A, k, true, k, k, k, T(1), Q, k, false,
                sm);                                          // A P_f A' + Q
    cta_sym<T>(Pn, Pn, k, false, sm);
    cta_matvec<T>(x, nullptr, T(1), A, xf, k, nullptr);       // A x_f
  }
}

template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
rts_smoother_gen_kernel(const T* x_pred, const T* P_pred, const T* x_filt,
                        const T* P_filt, const T* A, T* x_sm, T* P_sm,
                        T* P_lag, T* work, int T_, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* xn = sm + gen_scratch(k);
  T* dx = xn + DFM_GEN_KMAX;
  const int tid = threadIdx.x, kk = k * k;
  const size_t last = (size_t)(T_ - 1);
  // This block's problem lane, as the forward pass.
  const size_t pb = blockIdx.x, tk = (size_t)T_ * k, tkk = (size_t)T_ * kk;
  x_pred += pb * tk;
  x_filt += pb * tk;
  x_sm += pb * tk;
  P_pred += pb * tkk;
  P_filt += pb * tkk;
  P_sm += pb * tkk;
  P_lag += pb * tkk;
  A += pb * kk;
  work += pb * 4 * kk;
  T* Lc = work;                   // chol(sym(P_pred,t+1) + jitter I)
  T* D = work + kk;               // P_sm,t+1 - P_pred,t+1
  T* J = work + 2 * kk;           // (A P_f,t)', then J_t
  T* T1 = work + 3 * kk;          // J D
  for (int e = tid; e < kk; e += GEN_THREADS) {
    P_sm[last * kk + e] = P_filt[last * kk + e];
    P_lag[e] = T(0);
  }
  if (tid < k) {
    xn[tid] = x_filt[last * k + tid];
    x_sm[last * k + tid] = xn[tid];
  }
  __syncthreads();
  for (int t = T_ - 2; t >= 0; --t) {
    const T* Ppn = P_pred + (size_t)(t + 1) * kk;
    const T* Pft = P_filt + (size_t)t * kk;
    const T* Pn = P_sm + (size_t)(t + 1) * kk;
    cta_sym<T>(Lc, Ppn, k, true, sm);
    cta_batched(
        kk, [&](int e) { return Pn[e] - Ppn[e]; },
        [&](int e, T v) { D[e] = v; });
    if (tid < k) dx[tid] = xn[tid] - x_pred[(size_t)(t + 1) * k + tid];
    cta_potrf<T>(Lc, k, sm);
    cta_gemm<T>(J, k, Pft, k, true, A, k, true, k, k, k, T(1), nullptr, 0,
                false, sm);                                   // (A P_f)'
    cta_trsm_right<T>(J, k, Lc, k, true, sm);
    cta_trsm_right<T>(J, k, Lc, k, false, sm);                // J_t
    cta_matvec<T>(xn, x_filt + (size_t)t * k, T(1), J, dx, k,
                  x_sm + (size_t)t * k);                      // x_s
    cta_gemm<T>(T1, k, J, k, false, D, k, false, k, k, k, T(1), nullptr, 0,
                false, sm);                                   // J D
    T* Ps = P_sm + (size_t)t * kk;
    cta_gemm<T>(Ps, k, T1, k, false, J, k, true, k, k, k, T(1), Pft, k, false,
                sm);                                          // P_f + J D J'
    cta_sym<T>(Ps, Ps, k, false, sm);
    cta_gemm<T>(P_lag + (size_t)(t + 1) * kk, k, Pn, k, false, J, k, true, k,
                k, k, T(1), nullptr, 0, false, sm);           // P_next J'
  }
}

// The generic pair over B lanes (B = 1, no mask: the lone chain), 1 <= k
// <= DFM_GEN_KMAX; ``work`` holds B (4, k, k) workspaces.
template <typename T>
static int launch_scan_gen(const T* b, const T* C, int c_lane, int c_stride,
                           const T* A, const T* Q, const T* mu0, const T* P0,
                           const T* t_mask, T* x_pred, T* P_pred, T* x_filt,
                           T* P_filt, T* logdetG, T* work, int B, int T_,
                           int k, cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T_ <= 0) return (int)cudaGetLastError();
  const size_t bytes = gen_smem<T>(k);
  const cudaError_t e = dfm_smem_optin(info_scan_gen_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  info_scan_gen_kernel<T><<<B, GEN_THREADS, bytes, stream>>>(
      b, C, c_lane, c_stride, A, Q, mu0, P0, t_mask, x_pred, P_pred, x_filt,
      P_filt, logdetG, work, T_, k);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_rts_gen(const T* x_pred, const T* P_pred, const T* x_filt,
                          const T* P_filt, const T* A, T* x_sm, T* P_sm,
                          T* P_lag, T* work, int B, int T_, int k,
                          cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T_ <= 0) return (int)cudaGetLastError();
  const size_t bytes = gen_smem<T>(k);
  const cudaError_t e = dfm_smem_optin(rts_smoother_gen_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  rts_smoother_gen_kernel<T><<<B, GEN_THREADS, bytes, stream>>>(
      x_pred, P_pred, x_filt, P_filt, A, x_sm, P_sm, P_lag, work, T_, k);
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_SCAN_GEN_ENTRIES(SFX, T)                                           \
  int info_scan_gen_##SFX(const T* b, const T* C, int c_stride, const T* A,  \
                          const T* Q, const T* mu0, const T* P0, T* x_pred,  \
                          T* P_pred, T* x_filt, T* P_filt, T* logdetG,       \
                          T* work, int T_, int k, void* stream) {            \
    return launch_scan_gen<T>(b, C, 0, c_stride, A, Q, mu0, P0, nullptr,     \
                              x_pred, P_pred, x_filt, P_filt, logdetG, work, \
                              1, T_, k, (cudaStream_t)stream);               \
  }                                                                          \
  int batched_info_scan_gen_##SFX(const T* b, const T* C, int c_lane,        \
                                  int c_stride, const T* A, const T* Q,      \
                                  const T* mu0, const T* P0,                 \
                                  const T* t_mask, T* x_pred, T* P_pred,     \
                                  T* x_filt, T* P_filt, T* logdetG, T* work, \
                                  int B, int T_, int k, void* stream) {      \
    return launch_scan_gen<T>(b, C, c_lane, c_stride, A, Q, mu0, P0, t_mask, \
                              x_pred, P_pred, x_filt, P_filt, logdetG, work, \
                              B, T_, k, (cudaStream_t)stream);               \
  }                                                                          \
  int rts_smoother_gen_##SFX(const T* x_pred, const T* P_pred,               \
                             const T* x_filt, const T* P_filt, const T* A,   \
                             T* x_sm, T* P_sm, T* P_lag, T* work, int T_,    \
                             int k, void* stream) {                          \
    return launch_rts_gen<T>(x_pred, P_pred, x_filt, P_filt, A, x_sm, P_sm,  \
                             P_lag, work, 1, T_, k, (cudaStream_t)stream);   \
  }                                                                          \
  int batched_rts_gen_##SFX(const T* x_pred, const T* P_pred,                \
                            const T* x_filt, const T* P_filt, const T* A,    \
                            T* x_sm, T* P_sm, T* P_lag, T* work, int B,      \
                            int T_, int k, void* stream) {                   \
    return launch_rts_gen<T>(x_pred, P_pred, x_filt, P_filt, A, x_sm, P_sm,  \
                             P_lag, work, B, T_, k, (cudaStream_t)stream);   \
  }
#if DFM_WANT_F32
DFM_SCAN_GEN_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_SCAN_GEN_ENTRIES(f64, double)
#endif
}
