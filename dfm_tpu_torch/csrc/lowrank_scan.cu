// K9: the rank-r computation-aware engine: its policy basis, the rank-r
// downdate filter scan (forward) and the projected RTS smoother
// (backward), each a whole loop in one launch, one block per problem lane.
//
// K9-basis replaces dfm_tpu/ssm/lowrank_filter.py:policy_basis (line 96):
// the top-r eigenvectors of C = sym(Lam' R^{-1} Lam).  The wrapper forms
// C with torch.matmul (the product the unmasked obs_stats forms); the
// kernel symmetrizes it and runs a cyclic Jacobi eigensolve in shared
// memory: the Brent-Luk round-robin order rotates k/2 disjoint (p, q) pairs
// at once (rows, then columns, then the eigenvector columns), sweeps until
// no off-diagonal entry exceeds eps |C|_F, and writes the r columns of the
// largest eigenvalues, largest first.  The engine is invariant to V -> V B,
// so only the projector V V' is defined.  (torch.linalg.eigh on CUDA reads
// its LAPACK info on the host, a blocking sync inside every E-step.)
//
// K9-fwd replaces lowrank_from_stats (line 107, scan line 174).  Per step,
// from the predicted (x, P):
//   u = b_t - C_t x;  z = V'u;  J = C_t V;  Gam = sym(V'J) + eps I;
//   PJ = P J;  S = sym(J'PJ) + Gam;  a = S^{-1} z;  x_f = x + PJ a;
//   P_f = sym(P - PJ S^{-1} PJ');  ld = log|S| - log|Gam|;
//   corr = z'Gam^{-1}z - z'a;  x <- A x_f;  P <- sym(A P_f A' + Q)
// and it emits x_pred, P_pred, x_filt, P_filt, ld and corr.  A static C
// (the unmasked panel) has a time stride of 0.  S and Gam are factored by
// the same code, so a fully masked step (C_t = 0, S = Gam bit for bit)
// gives ld = 0 and corr = 0 exactly.
//
// K9-bwd replaces lowrank_smoother (line 207, scan line 241).  Per step
// t = T-2 .. 0, with (x_n, P_n) the smoothed moments of t+1:
//   Sig = sym(V'P_pred,t+1 V) + eps I;  G1 = P_f,t A'V;
//   a = Sig^{-1} V'(x_n - x_pred,t+1);  x_s = x_f,t + G1 a;
//   E = V'P_n V - Sig + eps I;  S = Sig^{-1} E Sig^{-1};
//   P_s = sym(P_f,t + G1 sym(S) G1');  P_lag,t+1 = P_n V Sig^{-1} G1'
// with P_lag[0] = 0 and the last step's smoothed moments the filtered ones.
//
// Bound on the H100: neither bytes nor operations.  At T = 500, k = 16,
// r = 8 a pass moves ~1.1 MB and does ~12 k^2 r flops a step (~12 MFLOP),
// microseconds at the card's rates; but step t+1 needs step t, so the pass
// is a chain of T dependent r x r factorizations and solves between
// k x k x r products, and its floor is T times one step's dependent chain.
//
// Design: one block of 256 threads per lane; P (or the smoothed carry), one
// k x k work buffer and the k x r blocks live in dynamic shared memory (up
// to ~210 KB in f64 at k = 100, r = 32; opted in above 48 KB); C_t, A, Q and
// the moments of other steps are read through L2.  The k x r and k x k
// products spread one output per thread; the r x r Cholesky factorizations
// run on one warp each (Gam and S on two warps at once); the solves with
// k or r right-hand sides run one right-hand side per thread.  The range is
// 1 <= r <= min(k, 32), k <= 100, in both dtypes; the wrappers raise
// outside it.  The lone call is B = 1; a fleet bucket passes its lanes.
#include "common.cuh"

#define DFM_LR_KMAX 100
#define DFM_LR_RMAX 32
constexpr int LR_THREADS = 256;
constexpr size_t LR_SMEM_MAX = 232448;     // opt-in limit of one block

template <typename T> __device__ __forceinline__ T dfm_eps();
template <> __device__ __forceinline__ float dfm_eps<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double dfm_eps<double>() { return DBL_EPSILON; }

// In-place Cholesky of the lower triangle of the r x r row-major W
// (leading dimension r) by one warp; the strict upper triangle is zeroed.
// No clamp: a negative pivot gives NaN.  r <= 32.
template <typename T>
__device__ void warp_chol_r(T* W, int r) {
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < r; ++p) {
    const T d = dfm_sqrt(W[p * r + p]);
    __syncwarp();
    if (lane == p) W[p * r + p] = d;
    else if (lane > p && lane < r) W[lane * r + p] /= d;
    __syncwarp();
    if (lane > p && lane < r) {
      const T ljp = W[lane * r + p];
      for (int i = lane; i < r; ++i) W[i * r + lane] -= W[i * r + p] * ljp;
    }
    __syncwarp();
  }
  if (lane < r)
    for (int i = 0; i < lane; ++i) W[i * r + lane] = T(0);
  __syncwarp();
}

// x = (L L')^{-1} b for one right-hand side, by one thread: b and x are
// read and written at strides bs and xs (x may alias b at the same stride).
template <typename T>
__device__ void chol_solve_one(const T* L, int r, const T* b, int bs, T* x,
                               int xs) {
  for (int i = 0; i < r; ++i) {
    T s = b[i * bs];
    for (int m = 0; m < i; ++m) s -= L[i * r + m] * x[m * xs];
    x[i * xs] = s / L[i * r + i];
  }
  for (int i = r - 1; i >= 0; --i) {
    T s = x[i * xs];
    for (int m = i + 1; m < r; ++m) s -= L[m * r + i] * x[m * xs];
    x[i * xs] = s / L[i * r + i];
  }
}

template <typename T>
__device__ T chol_logdet_r(const T* L, int r) {
  T s = T(0);
  for (int i = 0; i < r; ++i) s += dfm_log(L[i * r + i]);
  return T(2) * s;
}

// ---------------------------------------------------------------- basis --

template <typename T>
__global__ void __launch_bounds__(LR_THREADS)
lowrank_basis_kernel(const T* __restrict__ C, T* __restrict__ V, int k,
                     int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x, kk = k * k;
  const int n = k + (k & 1), half = n / 2;      // round-robin players
  T* M = reinterpret_cast<T*>(smem_raw);
  T* U = M + kk;
  T* cs = U + kk;                               // (c, s) per pair
  int* pq = reinterpret_cast<int*>(cs + 2 * half);   // (p, q) per pair
  int* idx = pq + 2 * half;                     // selected columns
  __shared__ T red[32];
  __shared__ T tol;
  __shared__ int rotated;
  C += (size_t)blockIdx.x * kk;
  V += (size_t)blockIdx.x * k * r;
  T ss = T(0);
  for (int e = tid; e < kk; e += nt) {
    const int i = e / k, j = e % k;
    const T v = T(0.5) * (C[e] + C[j * k + i]);
    M[e] = v;
    U[e] = i == j ? T(1) : T(0);
    ss += v * v;
  }
  ss = block_reduce_sum<T>(ss, red);
  if (tid == 0) tol = dfm_eps<T>() * dfm_sqrt(ss);
  __syncthreads();
  for (int sweep = 0; sweep < 60; ++sweep) {
    if (tid == 0) rotated = 0;
    __syncthreads();
    for (int s = 0; s < n - 1; ++s) {
      // The pairs of this round and their rotations.
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
      // Rows p and q of each pair: M <- J'M.
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
      // Columns p and q: M <- M J, U <- U J.
      for (int e = tid; e < half * k; e += nt) {
        const int i = e / k, j = e % k, q = pq[2 * i + 1];
        const T sn = cs[2 * i + 1];
        if (q < 0 || sn == T(0)) continue;
        const int p = pq[2 * i];
        const T c = cs[2 * i];
        T mp = M[j * k + p], mq = M[j * k + q];
        M[j * k + p] = c * mp - sn * mq;
        M[j * k + q] = sn * mp + c * mq;
        mp = U[j * k + p];
        mq = U[j * k + q];
        U[j * k + p] = c * mp - sn * mq;
        U[j * k + q] = sn * mp + c * mq;
      }
      __syncthreads();
    }
    if (!rotated) break;
    __syncthreads();
  }
  // The r largest eigenvalues, largest first (ties: the lower index).
  if (tid == 0) {
    for (int j = 0; j < r; ++j) {
      int best = -1;
      for (int i = 0; i < k; ++i) {
        bool taken = false;
        for (int m = 0; m < j; ++m) taken |= idx[m] == i;
        if (!taken && (best < 0 || M[i * k + i] > M[best * k + best]))
          best = i;
      }
      idx[j] = best;
    }
  }
  __syncthreads();
  for (int e = tid; e < k * r; e += nt) V[e] = U[(e / r) * k + idx[e % r]];
}

// -------------------------------------------------------------- forward --

template <typename T>
__global__ void __launch_bounds__(LR_THREADS)
lowrank_fwd_kernel(const T* __restrict__ b, const T* __restrict__ C,
                   int c_lane, int c_stride, const T* __restrict__ Vg,
                   const T* __restrict__ A, const T* __restrict__ Q,
                   const T* __restrict__ mu0, const T* __restrict__ P0,
                   T* __restrict__ x_pred, T* __restrict__ P_pred,
                   T* __restrict__ x_filt, T* __restrict__ P_filt,
                   T* __restrict__ logdetG, T* __restrict__ corr, int T_,
                   int k, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int kk = k * k, kr = k * r, rr = r * r;
  const T eps = dfm_jitter<T>();
  T* P = reinterpret_cast<T*>(smem_raw);          // k x k
  T* W = P + kk;            // J | PJ in the update (K over J); A P_f after
  T* J = W;                 // k x r, then K = S^{-1} PJ' (r x k)
  T* PJ = W + kr;           // k x r
  T* V = W + (kk > 2 * kr ? kk : 2 * kr);         // k x r
  T* G = V + kr;            // r x r: Gam, then its factor
  T* S = G + rr;            // r x r: S, then its factor
  T* x = S + rr;
  T* u = x + k;
  T* xf = u + k;
  T* z = xf + k;
  T* a = z + r;
  T* y = a + r;
  T* sc = y + r;            // log|S|, z'a, log|Gam|, z'Gam^{-1}z
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
  for (int e = tid; e < kk; e += nt) P[e] = P0[e];
  for (int e = tid; e < kr; e += nt) V[e] = Vg[e];
  for (int i = tid; i < k; i += nt) x[i] = mu0[i];
  __syncthreads();
  for (int t = 0; t < T_; ++t) {
    const T* Ct = C + (size_t)t * c_stride;
    const T* bt = b + (size_t)t * k;
    // The entering moments; u = b - C x; J = C V.
    for (int e = tid; e < kk; e += nt) P_pred[(size_t)t * kk + e] = P[e];
    for (int i = tid; i < k; i += nt) {
      T s = T(0);
      for (int l = 0; l < k; ++l) s += Ct[i * k + l] * x[l];
      u[i] = bt[i] - s;
      x_pred[(size_t)t * k + i] = x[i];
    }
    for (int e = tid; e < kr; e += nt) {
      const int i = e / r, m = e % r;
      T s = T(0);
      for (int l = 0; l < k; ++l) s += Ct[i * k + l] * V[l * r + m];
      J[e] = s;
    }
    __syncthreads();
    // z = V'u; PJ = P J; Gam = sym(V'J) + eps I.
    for (int m = tid; m < r; m += nt) {
      T s = T(0);
      for (int i = 0; i < k; ++i) s += V[i * r + m] * u[i];
      z[m] = s;
    }
    for (int e = tid; e < kr; e += nt) {
      const int i = e / r, m = e % r;
      T s = T(0);
      for (int l = 0; l < k; ++l) s += P[i * k + l] * J[l * r + m];
      PJ[e] = s;
    }
    for (int e = tid; e < rr; e += nt) {
      const int m = e / r, q = e % r;
      if (m > q) continue;
      T g1 = T(0), g2 = T(0);
      for (int i = 0; i < k; ++i) {
        g1 += V[i * r + m] * J[i * r + q];
        g2 += V[i * r + q] * J[i * r + m];
      }
      const T v = T(0.5) * (g1 + g2) + (m == q ? eps : T(0));
      G[m * r + q] = v;
      G[q * r + m] = v;
    }
    __syncthreads();
    // S = sym(J'PJ) + Gam.
    for (int e = tid; e < rr; e += nt) {
      const int m = e / r, q = e % r;
      if (m > q) continue;
      T s1 = T(0), s2 = T(0);
      for (int i = 0; i < k; ++i) {
        s1 += J[i * r + m] * PJ[i * r + q];
        s2 += J[i * r + q] * PJ[i * r + m];
      }
      const T v = T(0.5) * (s1 + s2) + G[m * r + q];
      S[m * r + q] = v;
      S[q * r + m] = v;
    }
    __syncthreads();
    if (tid < 32) warp_chol_r<T>(G, r);
    else if (tid < 64) warp_chol_r<T>(S, r);
    __syncthreads();
    // K = S^{-1} PJ' over J (dead); a = S^{-1} z; Gam^{-1} z; the logdets.
    for (int j = tid; j < k; j += nt)
      chol_solve_one<T>(S, r, PJ + j * r, 1, J + j, k);
    if (tid == nt - 1) {
      chol_solve_one<T>(S, r, z, 1, a, 1);
      T za = T(0);
      for (int m = 0; m < r; ++m) za += z[m] * a[m];
      sc[0] = chol_logdet_r<T>(S, r);
      sc[1] = za;
    } else if (tid == nt - 2) {
      chol_solve_one<T>(G, r, z, 1, y, 1);
      T zy = T(0);
      for (int m = 0; m < r; ++m) zy += z[m] * y[m];
      sc[2] = chol_logdet_r<T>(G, r);
      sc[3] = zy;
    }
    __syncthreads();
    // x_f = x + PJ a;  P_f = sym(P - PJ K);  ld and corr.
    for (int i = tid; i < k; i += nt) {
      T s = T(0);
      for (int m = 0; m < r; ++m) s += PJ[i * r + m] * a[m];
      xf[i] = x[i] + s;
      x_filt[(size_t)t * k + i] = xf[i];
    }
    for (int e = tid; e < kk; e += nt) {
      const int i = e / k, j = e % k;
      if (i > j) continue;
      T d1 = T(0), d2 = T(0);
      for (int m = 0; m < r; ++m) {
        d1 += PJ[i * r + m] * J[m * k + j];
        d2 += PJ[j * r + m] * J[m * k + i];
      }
      const T v = T(0.5) * ((P[i * k + j] - d1) + (P[j * k + i] - d2));
      P[i * k + j] = v;
      P[j * k + i] = v;
    }
    if (tid == 0) {
      logdetG[t] = sc[0] - sc[2];
      corr[t] = sc[3] - sc[1];
    }
    __syncthreads();
    // Emit P_f; W = A P_f (over the update's blocks, now dead).
    for (int e = tid; e < kk; e += nt) {
      const int i = e / k, j = e % k;
      P_filt[(size_t)t * kk + e] = P[e];
      T s = T(0);
      for (int l = 0; l < k; ++l) s += A[i * k + l] * P[l * k + j];
      W[e] = s;
    }
    __syncthreads();
    // x <- A x_f;  P <- W A' (raw), then sym(. + Q).
    for (int i = tid; i < k; i += nt) {
      T s = T(0);
      for (int l = 0; l < k; ++l) s += A[i * k + l] * xf[l];
      x[i] = s;
    }
    for (int e = tid; e < kk; e += nt) {
      const int i = e / k, j = e % k;
      T s = T(0);
      for (int l = 0; l < k; ++l) s += W[i * k + l] * A[j * k + l];
      P[e] = s;
    }
    __syncthreads();
    for (int e = tid; e < kk; e += nt) {
      const int i = e / k, j = e % k;
      if (i > j) continue;
      const T v = T(0.5) * ((P[i * k + j] + Q[i * k + j])
                            + (P[j * k + i] + Q[j * k + i]));
      P[i * k + j] = v;
      P[j * k + i] = v;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- backward --

template <typename T>
__global__ void __launch_bounds__(LR_THREADS)
lowrank_bwd_kernel(const T* __restrict__ x_pred,
                   const T* __restrict__ P_pred,
                   const T* __restrict__ x_filt,
                   const T* __restrict__ P_filt, const T* __restrict__ A,
                   const T* __restrict__ Vg, T* AV, T* __restrict__ x_sm,
                   T* __restrict__ P_sm, T* __restrict__ P_lag, int T_,
                   int k, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int kk = k * k, kr = k * r, rr = r * r;
  const T eps = dfm_jitter<T>();
  T* Pn = reinterpret_cast<T*>(smem_raw);         // k x k carry P_sm,t+1
  T* V = Pn + kk;           // k x r
  T* G1 = V + kr;           // k x r: P_f,t A'V
  T* W1 = G1 + kr;          // k x r: P_pred,t+1 V, then H = G1 sym(S)
  T* PV = W1 + kr;          // k x r: P_n V, then Z = P_n V Sig^{-1}
  T* Sg = PV + kr;          // r x r: Sig, then its factor
  T* E = Sg + rr;           // r x r: E, then S2 = Sig^{-1} X', then sym
  T* X = E + rr;            // r x r: Sig^{-1} E
  T* xn = X + rr;           // k: the carry x_sm,t+1
  T* dx = xn + k;
  T* v = dx + k;
  T* a = v + r;
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
  AV += pb * kr;            // scratch: A'V, written here, read below
  const size_t last = (size_t)(T_ - 1);
  for (int e = tid; e < kr; e += nt) {
    const int i = e / r, m = e % r;
    V[e] = Vg[e];
    T s = T(0);
    for (int l = 0; l < k; ++l) s += A[l * k + i] * Vg[l * r + m];
    AV[e] = s;
  }
  for (int e = tid; e < kk; e += nt) {
    Pn[e] = P_filt[last * kk + e];
    P_sm[last * kk + e] = Pn[e];
    P_lag[e] = T(0);
  }
  for (int i = tid; i < k; i += nt) {
    xn[i] = x_filt[last * k + i];
    x_sm[last * k + i] = xn[i];
  }
  __syncthreads();
  for (int t = T_ - 2; t >= 0; --t) {
    const T* Pft = P_filt + (size_t)t * kk;
    const T* Pp1 = P_pred + (size_t)(t + 1) * kk;
    // G1 = P_f,t A'V;  W1 = P_pred,t+1 V;  PV = P_n V;  dx.
    for (int e = tid; e < kr; e += nt) {
      const int i = e / r, m = e % r;
      T g = T(0), w = T(0), q = T(0);
      for (int l = 0; l < k; ++l) {
        g += Pft[i * k + l] * AV[l * r + m];
        w += Pp1[i * k + l] * V[l * r + m];
        q += Pn[i * k + l] * V[l * r + m];
      }
      G1[e] = g;
      W1[e] = w;
      PV[e] = q;
    }
    for (int i = tid; i < k; i += nt)
      dx[i] = xn[i] - x_pred[(size_t)(t + 1) * k + i];
    __syncthreads();
    // v = V'dx;  Sig = sym(V'W1) + eps I;  E = V'PV - Sig + eps I.
    for (int m = tid; m < r; m += nt) {
      T s = T(0);
      for (int i = 0; i < k; ++i) s += V[i * r + m] * dx[i];
      v[m] = s;
    }
    for (int e = tid; e < rr; e += nt) {
      const int m = e / r, q = e % r;
      if (m > q) continue;
      T s1 = T(0), s2 = T(0), f1 = T(0), f2 = T(0);
      for (int i = 0; i < k; ++i) {
        s1 += V[i * r + m] * W1[i * r + q];
        s2 += V[i * r + q] * W1[i * r + m];
        f1 += V[i * r + m] * PV[i * r + q];
        f2 += V[i * r + q] * PV[i * r + m];
      }
      const T d = m == q ? eps : T(0);
      const T s = T(0.5) * (s1 + s2) + d;
      Sg[m * r + q] = s;
      Sg[q * r + m] = s;
      E[m * r + q] = f1 - s + d;
      E[q * r + m] = f2 - s + d;
    }
    __syncthreads();
    if (tid < 32) warp_chol_r<T>(Sg, r);
    __syncthreads();
    // a = Sig^{-1} v;  X = Sig^{-1} E (by columns);  Z = PV Sig^{-1} (by
    // rows, in place).
    if (tid == nt - 1) chol_solve_one<T>(Sg, r, v, 1, a, 1);
    for (int q = tid; q < r; q += nt) chol_solve_one<T>(Sg, r, E + q, r, X + q, r);
    for (int i = tid - 32; i >= 0 && i < k; i += nt)
      chol_solve_one<T>(Sg, r, PV + i * r, 1, PV + i * r, 1);
    __syncthreads();
    // S2 = Sig^{-1} X' (by columns) over E;  S = S2'.
    for (int q = tid; q < r; q += nt) chol_solve_one<T>(Sg, r, X + q * r, 1, E + q, r);
    __syncthreads();
    for (int e = tid; e < rr; e += nt) {
      const int m = e / r, q = e % r;
      if (m >= q) continue;
      const T s = T(0.5) * (E[m * r + q] + E[q * r + m]);
      E[m * r + q] = s;
      E[q * r + m] = s;
    }
    __syncthreads();
    // x_s = x_f + G1 a;  H = G1 sym(S) over W1;  P_lag,t+1 = Z G1'.
    for (int i = tid; i < k; i += nt) {
      T s = T(0);
      for (int m = 0; m < r; ++m) s += G1[i * r + m] * a[m];
      xn[i] = x_filt[(size_t)t * k + i] + s;
      x_sm[(size_t)t * k + i] = xn[i];
    }
    for (int e = tid; e < kr; e += nt) {
      const int i = e / r, q = e % r;
      T s = T(0);
      for (int m = 0; m < r; ++m) s += G1[i * r + m] * E[m * r + q];
      W1[e] = s;
    }
    for (int e = tid; e < kk; e += nt) {
      const int i = e / k, j = e % k;
      T s = T(0);
      for (int m = 0; m < r; ++m) s += PV[i * r + m] * G1[j * r + m];
      P_lag[(size_t)(t + 1) * kk + e] = s;
    }
    __syncthreads();
    // P_s = sym(P_f + H G1'), the new carry.
    for (int e = tid; e < kk; e += nt) {
      const int i = e / k, j = e % k;
      if (i > j) continue;
      T d1 = T(0), d2 = T(0);
      for (int q = 0; q < r; ++q) {
        d1 += W1[i * r + q] * G1[j * r + q];
        d2 += W1[j * r + q] * G1[i * r + q];
      }
      const T s = T(0.5) * ((Pft[i * k + j] + d1) + (Pft[j * k + i] + d2));
      Pn[i * k + j] = s;
      Pn[j * k + i] = s;
      P_sm[(size_t)t * kk + i * k + j] = s;
      P_sm[(size_t)t * kk + j * k + i] = s;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ launchers --

static bool lr_range(int k, int r) {
  return k >= 1 && k <= DFM_LR_KMAX && r >= 1 && r <= k && r <= DFM_LR_RMAX;
}

// Opts the kernel in to ``bytes`` of dynamic shared memory (above 48 KB)
// and launches it; returns cudaGetLastError().
template <typename K, typename... Args>
static int lr_launch(K kernel, size_t bytes, int B, cudaStream_t stream,
                     Args... args) {
  if (bytes > LR_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = dfm_smem_optin(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, LR_THREADS, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_basis(const T* C, T* V, int B, int k, int r,
                        cudaStream_t stream) {
  if (!lr_range(k, r)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const int half = (k + (k & 1)) / 2;
  const size_t bytes = sizeof(T) * (2 * (size_t)k * k + 2 * half)
                       + sizeof(int) * (2 * half + r);
  return lr_launch(lowrank_basis_kernel<T>, bytes, B, stream, C, V, k, r);
}

template <typename T>
static int launch_fwd(const T* b, const T* C, int c_lane, int c_stride,
                      const T* V, const T* A, const T* Q, const T* mu0,
                      const T* P0, T* x_pred, T* P_pred, T* x_filt,
                      T* P_filt, T* logdetG, T* corr, int B, int T_, int k,
                      int r, cudaStream_t stream) {
  if (!lr_range(k, r)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T_ <= 0) return (int)cudaGetLastError();
  const size_t kk = (size_t)k * k, kr = (size_t)k * r;
  const size_t bytes = sizeof(T) * (kk + (kk > 2 * kr ? kk : 2 * kr) + kr
                                    + 2 * (size_t)r * r + 3 * k + 3 * r + 4);
  return lr_launch(lowrank_fwd_kernel<T>, bytes, B, stream, b, C, c_lane,
                   c_stride, V, A, Q, mu0, P0, x_pred, P_pred, x_filt, P_filt,
                   logdetG, corr, T_, k, r);
}

template <typename T>
static int launch_bwd(const T* x_pred, const T* P_pred, const T* x_filt,
                      const T* P_filt, const T* A, const T* V, T* AV, T* x_sm,
                      T* P_sm, T* P_lag, int B, int T_, int k, int r,
                      cudaStream_t stream) {
  if (!lr_range(k, r)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T_ <= 0) return (int)cudaGetLastError();
  const size_t kk = (size_t)k * k, kr = (size_t)k * r;
  const size_t bytes = sizeof(T) * (kk + 4 * kr + 3 * (size_t)r * r
                                    + 2 * k + 2 * r);
  return lr_launch(lowrank_bwd_kernel<T>, bytes, B, stream, x_pred, P_pred,
                   x_filt, P_filt, A, V, AV, x_sm, P_sm, P_lag, T_, k, r);
}

extern "C" {
#define DFM_LOWRANK_ENTRIES(SFX, T)                                            \
  int lowrank_basis_##SFX(const T* C, T* V, int B, int k, int r,             \
                          void* stream) {                                    \
    return launch_basis<T>(C, V, B, k, r, (cudaStream_t)stream);             \
  }                                                                          \
  int lowrank_scan_##SFX(const T* b, const T* C, int c_lane, int c_stride,   \
                         const T* V, const T* A, const T* Q, const T* mu0,   \
                         const T* P0, T* x_pred, T* P_pred, T* x_filt,       \
                         T* P_filt, T* logdetG, T* corr, int B, int T_,      \
                         int k, int r, void* stream) {                       \
    return launch_fwd<T>(b, C, c_lane, c_stride, V, A, Q, mu0, P0, x_pred,   \
                         P_pred, x_filt, P_filt, logdetG, corr, B, T_, k, r, \
                         (cudaStream_t)stream);                              \
  }                                                                          \
  int lowrank_smoother_##SFX(const T* x_pred, const T* P_pred,               \
                             const T* x_filt, const T* P_filt, const T* A,   \
                             const T* V, T* AV, T* x_sm, T* P_sm, T* P_lag,  \
                             int B, int T_, int k, int r, void* stream) {    \
    return launch_bwd<T>(x_pred, P_pred, x_filt, P_filt, A, V, AV, x_sm,     \
                         P_sm, P_lag, B, T_, k, r, (cudaStream_t)stream);    \
  }
#if DFM_WANT_F32
DFM_LOWRANK_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_LOWRANK_ENTRIES(f64, double)
#endif
}
