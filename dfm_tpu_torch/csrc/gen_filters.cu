// The generic kernels of the rank-r engine (K9-basis-gen, K9-fwd-gen,
// K9-bwd-gen) and of the dense filter (K15-gen): a runtime k <= 128 (and
// r <= k, N <= 128), one CTA of GEN_THREADS a problem lane, the k x k, k x
// r, r x r and N x N matrices in L2-resident global memory (the pass's
// output rows and a per-lane workspace the wrapper allocates, sized by the
// rules lowrank_gen_work / dense_gen_work below), run through the
// block-wide routines of cta_linalg.cuh.  lowrank_scan.cu and
// dense_filter.cu keep their own ranges (k <= 100, r <= 32; N, k <= 32):
// kernels.route_lowrank and kernels.route_dense pick these kernels past
// them.
//
// K9-basis-gen replaces dfm_tpu/ssm/lowrank_filter.py:policy_basis (line
// 96) past that range: the top-r eigenvectors of sym(C), largest first, by
// lowrank_scan.cu's cyclic Jacobi (Brent-Luk round-robin pairs, sweeps
// until no off-diagonal entry exceeds eps |C|_F).  The rotated matrix
// stays in shared memory (128 KB in f64 at k = 128); the accumulated
// rotations do not fit beside it and live in the workspace, stored
// transposed (row p is eigenvector p) so a rotation of two eigenvectors
// is two coalesced rows.  The r largest eigenvalues are ranked a thread
// an eigenvalue (ties: the lower index first).  Only the projector V V'
// is defined (the engine is invariant to V -> V B).
//
// K9-fwd-gen replaces lowrank_from_stats (line 107, scan lines 153-174),
// K9-bwd-gen lowrank_smoother (line 207, scan lines 229-241): the same
// steps as lowrank_scan.cu's kernels (the formulas are there), with every
// product a cta_gemm, the r x r factorizations cta_potrf (any r), the
// solves against them cta_trsm_right (a vector solve is a one-row trsm).
// A static C (time stride 0) projects once: J = C V, Gam and its factor
// are kept for every step.
//
// K15-gen replaces dfm_tpu/ssm/kalman.py:kalman_filter (line 43; the step
// of lines 54-80) past dense_filter.cu's range, with its association (the
// formulas are in dense_filter.cu): (H P) H' + diag(r), sym then the
// jitter, [K' | S^{-1} v] by two triangular solves, (I - K H) P first,
// (K * r) K'.  (H P)' is formed once (P' H' by a transposed gemm, the same
// sums) and serves both S and the solve.
//
// Bound on the H100: neither bytes nor operations.  Step t + 1 needs step
// t, so each pass is a chain of T steps of dependent block-wide routines
// (~15 a forward rank-r step, ~20 a backward one, ~14 a dense one), each
// beginning and ending with a barrier; at k = 128 the two k^3 products of
// the prediction dominate a step's ~4.3 MFLOP.  The floor is T times one
// step's dependent chain; the routines keep their operands in L2, so a
// step costs tens of microseconds, not the nanoseconds its flops would.
#include "cta_linalg.cuh"

#define DFM_GEN_FILTER_NMAX DFM_GEN_KMAX

template <typename T>
__device__ __forceinline__ T lrg_eps();
template <> __device__ __forceinline__ float lrg_eps<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double lrg_eps<double>() { return DBL_EPSILON; }

// Sum of v over the calling warp; the result in every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 2 sum_i log L[i][i] over the n x n factor at L (leading dimension n), by
// one whole warp; the result in every lane.
template <typename T>
__device__ T warp_logdet(const T* L, int n) {
  T s = T(0);
  for (int i = threadIdx.x & 31; i < n; i += 32)
    s += dfm_log(L[(size_t)i * n + i]);
  return T(2) * warp_sum(s);
}

// x (one row of n values in global memory) <- x (L L')^{-1}: the two
// one-row triangular solves against the n x n factor L.
template <typename T>
__device__ void row_chol_solve(T* x, const T* L, int n, T* sm) {
  cta_trsm_right<T>(x, 1, L, n, true, sm);
  cta_trsm_right<T>(x, 1, L, n, false, sm);
}

// X (m x n, leading dimension n) <- X (L L')^{-1}.
template <typename T>
__device__ void rows_chol_solve(T* X, int m, const T* L, int n, T* sm) {
  cta_trsm_right<T>(X, m, L, n, true, sm);
  cta_trsm_right<T>(X, m, L, n, false, sm);
}

// Workspace elements a lane of each kernel takes (the wrappers allocate B
// times this; ``kernels.query`` reads the rule): 0 K9-basis-gen (the
// rotations, k x k), 1 K9-fwd-gen (W k x k | J, PJ, Kt k x r | Gam, its
// factor, S r x r | two r-rows), 2 K9-bwd-gen (A'V, G1, W1, PV k x r |
// Sig, E, X r x r | an r-row).
__host__ __device__ inline int lowrank_gen_work_rule(int which, int k,
                                                 int r) {
  if (which == 0) return k * k;
  if (which == 1) return k * k + 3 * k * r + 3 * r * r + 2 * r;
  return 4 * k * r + 3 * r * r + r;
}

// K15-gen's workspace: H (N x k, masked only) | K, K * r (k x N) | S (N x
// N) | I - K H, two temporaries (k x k) | the v-row (N).
__host__ __device__ inline int dense_gen_work_rule(int N, int k) {
  return 3 * N * k + N * N + 3 * k * k + N;
}

// ---------------------------------------------------------------- basis --

template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
lowrank_basis_gen_kernel(const T* C, T* V, T* work, int k, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = GEN_THREADS, kk = k * k;
  const int n = k + (k & 1), half = n / 2;       // round-robin players
  T* M = reinterpret_cast<T*>(smem_raw);
  T* cs = M + kk;                                // (c, s) per pair
  int* pq = reinterpret_cast<int*>(cs + 2 * half);    // (p, q) per pair
  int* idx = pq + 2 * half;                      // selected columns
  __shared__ T red[32];
  __shared__ T tol;
  __shared__ int rotated;
  C += (size_t)blockIdx.x * kk;
  V += (size_t)blockIdx.x * k * r;
  T* Ut = work + (size_t)blockIdx.x * kk;        // Ut[p][j] = U[j][p]
  T ss = T(0);
  for (int e = tid; e < kk; e += nt) {
    const int i = e / k, j = e % k;
    const T v = T(0.5) * (C[e] + C[j * k + i]);
    M[e] = v;
    Ut[e] = i == j ? T(1) : T(0);
    ss += v * v;
  }
  ss = block_reduce_sum<T>(ss, red);
  if (tid == 0) tol = lrg_eps<T>() * dfm_sqrt(ss);
  __syncthreads();
  for (int sweep = 0; sweep < 60; ++sweep) {
    if (tid == 0) rotated = 0;
    __syncthreads();
    for (int s = 0; s < n - 1; ++s) {
      for (int i = tid; i < half; i += nt) {
        int p = i == 0 ? 0 : ((i - 1 + s) % (n - 1)) + 1;
        int q = ((n - 2 - i + s) % (n - 1)) + 1;
        if (p > q) { const int t = p; p = q; q = t; }
        T c = T(1), sn = T(0);
        if (q < k) {
          const T apq = M[p * k + q];
          if (fabs(apq) > tol) {
            const T theta = (M[q * k + q] - M[p * k + p]) / (T(2) * apq);
            const T t = (theta >= T(0) ? T(1) : T(-1))
                        / (fabs(theta) + dfm_sqrt(theta * theta + T(1)));
            c = T(1) / dfm_sqrt(t * t + T(1));
            sn = t * c;
            rotated = 1;
          }
        }
        cs[2 * i] = c;
        cs[2 * i + 1] = sn;
        pq[2 * i] = p;
        pq[2 * i + 1] = q < k ? q : -1;
      }
      __syncthreads();
      // Rows p and q of each pair: M <- J'M (a row's entries on
      // consecutive threads).
      for (int e = tid; e < half * k; e += nt) {
        const int i = e / k, j = e % k, q = pq[2 * i + 1];
        const T sn = cs[2 * i + 1];
        if (q < 0 || sn == T(0)) continue;
        const int p = pq[2 * i];
        const T c = cs[2 * i], mp = M[p * k + j], mq = M[q * k + j];
        M[p * k + j] = c * mp - sn * mq;
        M[q * k + j] = sn * mp + c * mq;
      }
      __syncthreads();
      // Columns p and q: M <- M J (the pairs on consecutive threads, so a
      // warp's shared accesses fall in different banks), U <- U J (rows p
      // and q of Ut, coalesced).
      for (int e = tid; e < half * k; e += nt) {
        const int i = e % half, j = e / half, q = pq[2 * i + 1];
        const T sn = cs[2 * i + 1];
        if (q < 0 || sn == T(0)) continue;
        const int p = pq[2 * i];
        const T c = cs[2 * i];
        const T mp = M[j * k + p], mq = M[j * k + q];
        M[j * k + p] = c * mp - sn * mq;
        M[j * k + q] = sn * mp + c * mq;
      }
      for (int e = tid; e < half * k; e += nt) {
        const int i = e / k, j = e % k, q = pq[2 * i + 1];
        const T sn = cs[2 * i + 1];
        if (q < 0 || sn == T(0)) continue;
        const int p = pq[2 * i];
        const T c = cs[2 * i];
        const T up = Ut[(size_t)p * k + j], uq = Ut[(size_t)q * k + j];
        Ut[(size_t)p * k + j] = c * up - sn * uq;
        Ut[(size_t)q * k + j] = sn * up + c * uq;
      }
      __syncthreads();
    }
    if (!rotated) break;
    __syncthreads();
  }
  // The r largest eigenvalues, largest first (ties: the lower index): the
  // rank of eigenvalue i is the count of those above it.
  for (int i = tid; i < k; i += nt) {
    const T d = M[i * k + i];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const T dj = M[j * k + j];
      rank += dj > d || (dj == d && j < i);
    }
    if (rank < r) idx[rank] = i;
  }
  __syncthreads();
  for (int e = tid; e < k * r; e += nt)
    V[e] = Ut[(size_t)idx[e % r] * k + e / r];
}

// -------------------------------------------------------------- forward --

// Dynamic shared memory of the scans: the routines' scratch at the wider
// of the two widths, and six vectors of DFM_GEN_KMAX.
template <typename T>
static size_t gen_filter_smem(int kmax) {
  return sizeof(T) * ((size_t)gen_scratch(kmax) + 6 * DFM_GEN_KMAX);
}

template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
lowrank_fwd_gen_kernel(const T* b, const T* C, int c_lane, int c_stride,
                       const T* Vg, const T* A, const T* Q, const T* mu0,
                       const T* P0, T* x_pred, T* P_pred, T* x_filt,
                       T* P_filt, T* logdetG, T* corr, T* work, int T_, int k,
                       int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* x = sm + gen_scratch(k);
  T* u = x + DFM_GEN_KMAX;
  T* xf = u + DFM_GEN_KMAX;
  T* z = xf + DFM_GEN_KMAX;
  const int tid = threadIdx.x, kk = k * k, kr = k * r, rr = r * r;
  __shared__ T ldg;
  const size_t pb = blockIdx.x, tk = (size_t)T_ * k, tkk = (size_t)T_ * kk;
  b += pb * tk;
  C += pb * (size_t)c_lane;
  Vg += pb * kr;
  A += pb * kk;
  Q += pb * kk;
  P0 += pb * kk;
  mu0 += pb * k;
  x_pred += pb * tk;
  x_filt += pb * tk;
  P_pred += pb * tkk;
  P_filt += pb * tkk;
  logdetG += pb * T_;
  corr += pb * T_;
  T* W = work + pb * lowrank_gen_work_rule(1, k, r);     // A P_f
  T* J = W + kk;                  // C_t V
  T* PJ = J + kr;                 // P J
  T* Kt = PJ + kr;                // PJ S^{-1}
  T* G = Kt + kr;                 // Gam = sym(V'J) + eps I
  T* Lg = G + rr;                 // its factor
  T* S = Lg + rr;                 // sym(J'PJ) + Gam, then its factor
  T* za = S + rr;                 // z, then z S^{-1}
  T* zy = za + r;                 // z, then z Gam^{-1}
  cta_copy<T>(P_pred, P0, kk);
  if (tid < k) x[tid] = mu0[tid];
  __syncthreads();
  for (int t = 0; t < T_; ++t) {
    const T* Ct = C + (size_t)t * c_stride;
    const T* Pp = P_pred + (size_t)t * kk;
    T* Pf = P_filt + (size_t)t * kk;
    if (tid < k) x_pred[(size_t)t * k + tid] = x[tid];
    cta_matvec<T>(u, b + (size_t)t * k, T(-1), Ct, x, k, nullptr);  // b - C x
    if (t == 0 || c_stride != 0) {
      cta_gemm<T>(J, r, Ct, k, false, Vg, r, false, k, r, k, T(1), nullptr,
                  0, false, sm);                                      // C V
      cta_gemm<T>(G, r, Vg, r, true, J, r, false, r, r, k, T(1), nullptr, 0,
                  false, sm);                                         // V'J
      cta_sym<T>(G, G, r, true, sm);
      cta_copy<T>(Lg, G, rr);
      cta_potrf<T>(Lg, r, sm);
      if (tid < 32) {
        const T v = warp_logdet<T>(Lg, r);
        if (tid == 0) ldg = v;
      }
    }
    // z = V'u, into both rows.
    for (int m = tid; m < r; m += GEN_THREADS) {
      T s = T(0);
      for (int i = 0; i < k; ++i) s += Vg[(size_t)i * r + m] * u[i];
      z[m] = s;
      za[m] = s;
      zy[m] = s;
    }
    cta_gemm<T>(PJ, r, Pp, k, false, J, r, false, k, r, k, T(1), nullptr, 0,
                false, sm);                                           // P J
    cta_gemm<T>(S, r, J, r, true, PJ, r, false, r, r, k, T(1), nullptr, 0,
                false, sm);                                           // J'PJ
    cta_sym<T>(S, S, r, false, sm);
    for (int e = tid; e < rr; e += GEN_THREADS) S[e] += G[e];
    cta_potrf<T>(S, r, sm);
    cta_copy<T>(Kt, PJ, kr);
    rows_chol_solve<T>(Kt, k, S, r, sm);                     // PJ S^{-1}
    row_chol_solve<T>(za, S, r, sm);                         // a = S^{-1} z
    row_chol_solve<T>(zy, Lg, r, sm);                        // Gam^{-1} z
    // x_f = x + PJ a; the loglik terms.
    if (tid < k) {
      T s = T(0);
      for (int m = 0; m < r; ++m) s += PJ[(size_t)tid * r + m] * za[m];
      xf[tid] = x[tid] + s;
      x_filt[(size_t)t * k + tid] = xf[tid];
    } else if (tid >= 128 && tid < 160) {
      const T lds = warp_logdet<T>(S, r);
      T s1 = T(0), s2 = T(0);
      for (int m = tid - 128; m < r; m += 32) {
        s1 += z[m] * za[m];
        s2 += z[m] * zy[m];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (tid == 128) {
        logdetG[t] = lds - ldg;
        corr[t] = s2 - s1;
      }
    }
    // P_f = sym(P - PJ (PJ S^{-1})').
    cta_gemm<T>(Pf, k, PJ, r, false, Kt, r, true, k, k, r, T(-1), Pp, k,
                false, sm);
    cta_sym<T>(Pf, Pf, k, false, sm);
    if (t + 1 == T_) break;
    T* Pn = P_pred + (size_t)(t + 1) * kk;
    cta_gemm<T>(W, k, A, k, false, Pf, k, false, k, k, k, T(1), nullptr, 0,
                false, sm);                                           // A P_f
    cta_gemm<T>(Pn, k, W, k, false, A, k, true, k, k, k, T(1), Q, k, false,
                sm);                                          // A P_f A' + Q
    cta_sym<T>(Pn, Pn, k, false, sm);
    cta_matvec<T>(x, nullptr, T(1), A, xf, k, nullptr);               // A x_f
  }
}

// ------------------------------------------------------------- backward --

template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
lowrank_bwd_gen_kernel(const T* x_pred, const T* P_pred, const T* x_filt,
                       const T* P_filt, const T* A, const T* Vg, T* work,
                       T* x_sm, T* P_sm, T* P_lag, int T_, int k, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* xn = sm + gen_scratch(k);    // the carry x_sm,t+1
  T* dx = xn + DFM_GEN_KMAX;
  const int tid = threadIdx.x, kk = k * k, kr = k * r, rr = r * r;
  const size_t pb = blockIdx.x, tk = (size_t)T_ * k, tkk = (size_t)T_ * kk;
  x_pred += pb * tk;
  x_filt += pb * tk;
  x_sm += pb * tk;
  P_pred += pb * tkk;
  P_filt += pb * tkk;
  P_sm += pb * tkk;
  P_lag += pb * tkk;
  A += pb * kk;
  Vg += pb * kr;
  T* AV = work + pb * lowrank_gen_work_rule(2, k, r);    // A'V
  T* G1 = AV + kr;                // P_f,t A'V
  T* W1 = G1 + kr;                // P_pred,t+1 V, then H = G1 sym(S)
  T* PV = W1 + kr;                // P_n V, then P_n V Sig^{-1}
  T* Sg = PV + kr;                // Sig, then its factor
  T* E = Sg + rr;                 // V'P_n V - Sig + eps I, then E Sig^{-1}
  T* X = E + rr;                  // (E Sig^{-1})' Sig^{-1} = S'
  T* va = X + rr;                 // v = V'dx, then Sig^{-1} v
  const T eps = dfm_jitter<T>();
  const size_t last = (size_t)(T_ - 1);
  cta_gemm<T>(AV, r, A, k, true, Vg, r, false, k, r, k, T(1), nullptr, 0,
              false, sm);                                             // A'V
  cta_copy<T>(P_sm + last * kk, P_filt + last * kk, kk);
  cta_copy<T>(P_lag, nullptr, kk);
  if (tid < k) {
    xn[tid] = x_filt[last * k + tid];
    x_sm[last * k + tid] = xn[tid];
  }
  __syncthreads();
  for (int t = T_ - 2; t >= 0; --t) {
    const T* Pft = P_filt + (size_t)t * kk;
    const T* Pp1 = P_pred + (size_t)(t + 1) * kk;
    const T* Pn = P_sm + (size_t)(t + 1) * kk;
    T* Ps = P_sm + (size_t)t * kk;
    cta_gemm<T>(G1, r, Pft, k, false, AV, r, false, k, r, k, T(1), nullptr,
                0, false, sm);                                        // G1
    cta_gemm<T>(W1, r, Pp1, k, false, Vg, r, false, k, r, k, T(1), nullptr,
                0, false, sm);                                        // W1
    cta_gemm<T>(PV, r, Pn, k, false, Vg, r, false, k, r, k, T(1), nullptr,
                0, false, sm);                                        // PV
    if (tid < k) dx[tid] = xn[tid] - x_pred[(size_t)(t + 1) * k + tid];
    cta_gemm<T>(Sg, r, Vg, r, true, W1, r, false, r, r, k, T(1), nullptr, 0,
                false, sm);                                           // V'W1
    cta_sym<T>(Sg, Sg, r, true, sm);                          // + eps I
    cta_gemm<T>(E, r, Vg, r, true, PV, r, false, r, r, k, T(1), nullptr, 0,
                false, sm);                                           // V'PV
    for (int e = tid; e < rr; e += GEN_THREADS)
      E[e] = E[e] - Sg[e] + (e / r == e % r ? eps : T(0));
    for (int m = tid; m < r; m += GEN_THREADS) {
      T s = T(0);
      for (int i = 0; i < k; ++i) s += Vg[(size_t)i * r + m] * dx[i];
      va[m] = s;
    }
    cta_potrf<T>(Sg, r, sm);
    row_chol_solve<T>(va, Sg, r, sm);                        // a
    rows_chol_solve<T>(E, r, Sg, r, sm);                     // E Sig^{-1}
    for (int e = tid; e < rr; e += GEN_THREADS)
      X[e] = E[(size_t)(e % r) * r + e / r];
    rows_chol_solve<T>(X, r, Sg, r, sm);                     // S'
    cta_sym<T>(X, X, r, false, sm);                          // sym(S)
    // x_s = x_f + G1 a.
    if (tid < k) {
      T s = T(0);
      for (int m = 0; m < r; ++m) s += G1[(size_t)tid * r + m] * va[m];
      xn[tid] = x_filt[(size_t)t * k + tid] + s;
      x_sm[(size_t)t * k + tid] = xn[tid];
    }
    cta_gemm<T>(W1, r, G1, r, false, X, r, false, k, r, r, T(1), nullptr, 0,
                false, sm);                                  // H = G1 sym(S)
    rows_chol_solve<T>(PV, k, Sg, r, sm);                    // P_n V Sig^{-1}
    cta_gemm<T>(P_lag + (size_t)(t + 1) * kk, k, PV, r, false, G1, r, true,
                k, k, r, T(1), nullptr, 0, false, sm);       // P_lag,t+1
    cta_gemm<T>(Ps, k, W1, r, false, G1, r, true, k, k, r, T(1), Pft, k,
                false, sm);                                  // P_f + H G1'
    cta_sym<T>(Ps, Ps, k, false, sm);
  }
}

// ---------------------------------------------------------------- dense --

template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
dense_filter_gen_kernel(const T* Y, const T* mask, const T* Lam, const T* R,
                        const T* A, const T* Q, const T* mu0, const T* P0,
                        T* x_pred, T* P_pred, T* x_filt, T* P_filt, T* ll,
                        T* work, int T_, int N, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int kmax = N > k ? N : k;
  T* x = sm + gen_scratch(kmax);
  T* xf = x + DFM_GEN_KMAX;
  T* yv = xf + DFM_GEN_KMAX;
  T* rv = yv + DFM_GEN_KMAX;
  T* vv = rv + DFM_GEN_KMAX;
  T* wv = vv + DFM_GEN_KMAX;
  __shared__ T n_t;
  const int tid = threadIdx.x, kk = k * k, Nk = N * k;
  const T log2pi = T(1.8378770664093453);
  T* Hw = work;                   // diag(w) Lam (masked)
  T* K = Hw + Nk;                 // (H P)', then K = (H P)' S^{-1}
  T* Kr = K + Nk;                 // K * r
  T* S = Kr + Nk;                 // (H P) H' + diag(r), then its factor
  T* IKH = S + (size_t)N * N;     // I - K H
  T* W1 = IKH + kk;               // (I - K H) P, then A P_f
  T* W2 = W1 + kk;                // (K * r) K'
  T* vs = W2 + kk;                // v, then S^{-1} v
  const T* H = mask ? Hw : Lam;
  cta_copy<T>(P_pred, P0, kk);
  if (tid < k) x[tid] = mu0[tid];
  __syncthreads();
  for (int t = 0; t < T_; ++t) {
    const size_t row = (size_t)t * N;
    const T* Pp = P_pred + (size_t)t * kk;
    T* Pf = P_filt + (size_t)t * kk;
    // The masking rewrite; emit the prediction this step starts from.
    for (int n = tid; n < N; n += GEN_THREADS) {
      const T y = Y[row + n];
      if (mask) {
        const T w = mask[row + n];
        yv[n] = w * nan_to_num(y);
        rv[n] = w * R[n] + (T(1) - w);
        wv[n] = w;
      } else {
        yv[n] = y;
        rv[n] = R[n];
        wv[n] = T(1);
      }
    }
    if (mask)
      for (int e = tid; e < Nk; e += GEN_THREADS)
        Hw[e] = mask[row + e / k] * Lam[e];
    if (tid < k) x_pred[(size_t)t * k + tid] = x[tid];
    __syncthreads();
    // v = y - H x (a thread a series); n_t.
    for (int n = tid; n < N; n += GEN_THREADS) {
      T s = T(0);
      for (int l = 0; l < k; ++l) s += H[(size_t)n * k + l] * x[l];
      const T v = yv[n] - s;
      vv[n] = v;
      vs[n] = v;
    }
    if (tid >= 224) {
      T c = T(0);
      for (int n = tid - 224; n < N; n += 32) c += wv[n];
      c = warp_sum(c);
      if (tid == 224) n_t = mask ? c : T(N);
    }
    cta_gemm<T>(K, N, Pp, k, true, H, k, true, k, N, k, T(1), nullptr, 0,
                false, sm);                                   // (H P)'
    cta_gemm<T>(S, N, K, N, true, H, k, true, N, N, k, T(1), nullptr, 0,
                false, sm);                                   // (H P) H'
    for (int n = tid; n < N; n += GEN_THREADS) S[(size_t)n * N + n] += rv[n];
    cta_sym<T>(S, S, N, true, sm);                            // + jitter
    cta_potrf<T>(S, N, sm);
    rows_chol_solve<T>(K, k, S, N, sm);                       // K
    row_chol_solve<T>(vs, S, N, sm);                          // S^{-1} v
    // x_f = x + K v; K * r; the loglik term.
    if (tid < k) {
      T s = T(0);
      for (int n = 0; n < N; ++n) s += K[(size_t)tid * N + n] * vv[n];
      xf[tid] = x[tid] + s;
      x_filt[(size_t)t * k + tid] = xf[tid];
    }
    for (int e = tid; e < Nk; e += GEN_THREADS) Kr[e] = K[e] * rv[e % N];
    if (tid >= 224) {
      const T ld = warp_logdet<T>(S, N);
      T q = T(0);
      for (int n = tid - 224; n < N; n += 32) q += vv[n] * vs[n];
      q = warp_sum(q);
      if (tid == 224) ll[t] = T(-0.5) * ((n_t * log2pi + ld) + q);
    }
    cta_gemm<T>(IKH, k, K, N, false, H, k, false, k, k, N, T(-1), nullptr, 0,
                true, sm);                                    // I - K H
    cta_gemm<T>(W2, k, Kr, N, false, K, N, true, k, k, N, T(1), nullptr, 0,
                false, sm);                                   // (K r) K'
    cta_gemm<T>(W1, k, IKH, k, false, Pp, k, false, k, k, k, T(1), nullptr,
                0, false, sm);                                // (I - K H) P
    cta_gemm<T>(Pf, k, W1, k, false, IKH, k, true, k, k, k, T(1), W2, k,
                false, sm);                                   // ... + (K r) K'
    cta_sym<T>(Pf, Pf, k, false, sm);
    if (t + 1 == T_) break;
    T* Pn = P_pred + (size_t)(t + 1) * kk;
    cta_gemm<T>(W1, k, A, k, false, Pf, k, false, k, k, k, T(1), nullptr, 0,
                false, sm);                                   // A P_f
    cta_gemm<T>(Pn, k, W1, k, false, A, k, true, k, k, k, T(1), Q, k, false,
                sm);                                          // A P_f A' + Q
    cta_sym<T>(Pn, Pn, k, false, sm);
    cta_matvec<T>(x, nullptr, T(1), A, xf, k, nullptr);       // A x_f
  }
}

// ------------------------------------------------------------ launchers --

static bool lrg_range(int k, int r) {
  return k >= 1 && k <= DFM_GEN_KMAX && r >= 1 && r <= k;
}

template <typename K, typename... Args>
static int gen_launch(K kernel, size_t bytes, int B, cudaStream_t stream,
                      Args... args) {
  const cudaError_t e = dfm_smem_optin(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, GEN_THREADS, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_basis_gen(const T* C, T* V, T* work, int B, int k, int r,
                            cudaStream_t stream) {
  if (!lrg_range(k, r)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const int half = (k + (k & 1)) / 2;
  const size_t bytes = sizeof(T) * ((size_t)k * k + 2 * half)
                       + sizeof(int) * (2 * half + r);
  return gen_launch(lowrank_basis_gen_kernel<T>, bytes, B, stream, C, V,
                    work, k, r);
}

template <typename T>
static int launch_fwd_gen(const T* b, const T* C, int c_lane, int c_stride,
                          const T* V, const T* A, const T* Q, const T* mu0,
                          const T* P0, T* x_pred, T* P_pred, T* x_filt,
                          T* P_filt, T* logdetG, T* corr, T* work, int B,
                          int T_, int k, int r, cudaStream_t stream) {
  if (!lrg_range(k, r)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T_ <= 0) return (int)cudaGetLastError();
  return gen_launch(lowrank_fwd_gen_kernel<T>, gen_filter_smem<T>(k), B,
                    stream, b, C, c_lane, c_stride, V, A, Q, mu0, P0, x_pred,
                    P_pred, x_filt, P_filt, logdetG, corr, work, T_, k, r);
}

template <typename T>
static int launch_bwd_gen(const T* x_pred, const T* P_pred, const T* x_filt,
                          const T* P_filt, const T* A, const T* V, T* work,
                          T* x_sm, T* P_sm, T* P_lag, int B, int T_, int k,
                          int r, cudaStream_t stream) {
  if (!lrg_range(k, r)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T_ <= 0) return (int)cudaGetLastError();
  return gen_launch(lowrank_bwd_gen_kernel<T>, gen_filter_smem<T>(k), B,
                    stream, x_pred, P_pred, x_filt, P_filt, A, V, work, x_sm,
                    P_sm, P_lag, T_, k, r);
}

template <typename T>
static int launch_dense_gen(const T* Y, const T* mask, const T* Lam,
                            const T* R, const T* A, const T* Q, const T* mu0,
                            const T* P0, T* x_pred, T* P_pred, T* x_filt,
                            T* P_filt, T* ll, T* work, int T_, int N, int k,
                            cudaStream_t stream) {
  if (N < 1 || N > DFM_GEN_FILTER_NMAX || k < 1 || k > DFM_GEN_KMAX
      || T_ < 0)
    return (int)cudaErrorInvalidValue;
  if (T_ == 0) return (int)cudaGetLastError();
  return gen_launch(dense_filter_gen_kernel<T>,
                    gen_filter_smem<T>(N > k ? N : k), 1, stream, Y, mask,
                    Lam, R, A, Q, mu0, P0, x_pred, P_pred, x_filt, P_filt, ll,
                    work, T_, N, k);
}

extern "C" {
#define DFM_GEN_FILTER_ENTRIES(SFX, T)                                         \
  int lowrank_basis_gen_##SFX(const T* C, T* V, T* work, int B, int k, int r, \
                              void* stream) {                                \
    return launch_basis_gen<T>(C, V, work, B, k, r, (cudaStream_t)stream);   \
  }                                                                          \
  int lowrank_scan_gen_##SFX(const T* b, const T* C, int c_lane,             \
                             int c_stride, const T* V, const T* A,           \
                             const T* Q, const T* mu0, const T* P0,          \
                             T* x_pred, T* P_pred, T* x_filt, T* P_filt,     \
                             T* logdetG, T* corr, T* work, int B, int T_,    \
                             int k, int r, void* stream) {                   \
    return launch_fwd_gen<T>(b, C, c_lane, c_stride, V, A, Q, mu0, P0,       \
                             x_pred, P_pred, x_filt, P_filt, logdetG, corr,  \
                             work, B, T_, k, r, (cudaStream_t)stream);       \
  }                                                                          \
  int lowrank_smoother_gen_##SFX(const T* x_pred, const T* P_pred,           \
                                 const T* x_filt, const T* P_filt,           \
                                 const T* A, const T* V, T* work, T* x_sm,   \
                                 T* P_sm, T* P_lag, int B, int T_, int k,    \
                                 int r, void* stream) {                      \
    return launch_bwd_gen<T>(x_pred, P_pred, x_filt, P_filt, A, V, work,     \
                             x_sm, P_sm, P_lag, B, T_, k, r,                 \
                             (cudaStream_t)stream);                          \
  }                                                                          \
  int dense_filter_gen_##SFX(const T* Y, const T* mask, const T* Lam,        \
                             const T* R, const T* A, const T* Q,             \
                             const T* mu0, const T* P0, T* x_pred,           \
                             T* P_pred, T* x_filt, T* P_filt, T* ll,         \
                             T* work, int T_, int N, int k, void* stream) {  \
    return launch_dense_gen<T>(Y, mask, Lam, R, A, Q, mu0, P0, x_pred,       \
                               P_pred, x_filt, P_filt, ll, work, T_, N, k,   \
                               (cudaStream_t)stream);                        \
  }                                                                          \
  int lowrank_gen_work_##SFX(int which, int k, int r) {                      \
    return lowrank_gen_work_rule(which, k, r);                               \
  }                                                                          \
  int dense_gen_work_##SFX(int N, int k) { return dense_gen_work_rule(N, k); }
#if DFM_WANT_F32
DFM_GEN_FILTER_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_GEN_FILTER_ENTRIES(f64, double)
#endif
}
