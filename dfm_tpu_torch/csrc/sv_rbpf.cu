// K10: the Rao-Blackwellized particle filter of the stochastic-volatility
// family and its backward sampler.
//
// K10-fwd (sv_rbpf) replaces dfm_tpu/models/sv.py:_rbpf_scan (line 103,
// the step at :128-206) with _systematic_indices (:92).  M particles each
// carry a Kalman state (x, P) and log-vols h; a step t runs
//   h += sigma_h * xi_t;  x_p = A x;  P_p = A P A' + diag(exp h)
//   Lp = chol(sym(P_p) + 1e-6 I);  G = I + Lp' C Lp;  Lg = chol(G)
//   P_f = sym(Lp (Lg Lg')^{-1} Lp');  log|G| = 2 sum log diag Lg
//   residual form: v = y_t - Lam x_p, c2 = v'R^{-1}v, u = Lam'R^{-1}v,
//                  quad = c2 - u'P_f u
//   expanded form: u = b_t - C x_p,
//                  quad = -2 x_p.b_t + x_p'C x_p - u'P_f u
//   x_f = x_p + P_f u;  lw = -(log|G| + quad) / 2;  tot = logW + lw
//   ll_rel = logsumexp(tot);  logW = tot - ll_rel;  ESS = 1 / sum W^2
//   if ESS < ess_frac M: systematic resampling of (x_f, P_f, h), with
//     index_m = the first i with cum_i >= (m + u_t) / M (cum the cumsum
//     of W over its last entry), clipped to [0, M-1]; logW = -log M
//   outputs: ll_rel, W'x_f, W'h, ESS and, with the history, (h, logW).
// The Cholesky factors are K6's (csrc/small_linalg.cuh: chol_unrolled,
// chol_solve_unrolled), the textbook scalar algorithm with no clamp, as
// both JAX branches (k <= 8 unrolled, above it jnp.linalg.cholesky, whose
// input is symmetrized: G is symmetrized first here above k = 8).
//
// K10-ffbs (sv_ffbs) replaces _ffbs_impl (:297, the scan :317): S
// trajectories drawn backward by the Gumbel-max trick,
//   idx = argmax_m(logw_{T-1,m} + g),  h_s,T-1 = h_{T-1}[idx]
//   idx = argmax_m(logw_t,m - |h_s,t+1 - h_t,m|^2_{sigma^2} / 2 + g_t)
// with argmax taking the lowest index on ties, as jnp.argmax does.
//
// The random numbers come in as arrays (the wrapper draws them from a
// torch.Generator, the tests replay the JAX key schedule), so a pass is a
// pure function of its inputs.  No float atomics: every sum runs in a
// fixed order, and two runs on the same inputs agree bit for bit.
//
// Bound on the H100 (S5: T = 1,000, N = 10,000, k = 5, M = 256, f32):
// K10-fwd's residual stage is ~(4k + 3) M N operations a step, ~59 GFLOP a
// pass, 0.9 ms at 67 TFLOP/s: operations; Y is read once (40 MB, 12 us).
// Beside it the latency floor of a T-step chain of k x k factorizations.
// K10-ffbs reads the pre-drawn Gumbels once, T S M values (65 MB in f32):
// bytes, ~0.02 ms.
//
// Design.  One C call enqueues a whole pass on the stream: an init grid
// (h_0, then the step-0 prediction of every particle), then a step at a
// time
//   1. (residual form) a grid over tiles of SV_TILE series x SV_PCHUNK
//      particles: a block stages its tile of Lam, 1/R and y_t in shared
//      memory, each thread owns a particle and writes its tile's partial
//      c2 (in f64, as K1 sums quad_R) and u; no atomics;
//   2. one block, a particle a thread (M <= DFM_SV_MMAX = 1,024): the
//      partials summed in tile order, x_f, quad, lw, the log-sum-exp and
//      ESS by block reductions, the resampling decision on the device, a
//      block scan of W, a binary search a position and the gather of
//      (x_f, P_f, h) through a copy in the state buffer, the weighted
//      means and the history, then the prediction of step t + 1 (K6).
// That puts ~2T launch gaps under a pass; a persistent kernel or a
// captured graph of the loop is a later redesign.  K10-ffbs is one launch,
// a block a draw, each block running its own T-step backward chain.
#include "small_linalg.cuh"

#define DFM_SV_MMAX 1024
constexpr int SV_TILE = 64;      // series a residual block (kernels.SV_TILE)
constexpr int SV_PCHUNK = 128;   // particles a residual block, one a thread
constexpr int SV_NT_SMALL = 256; // step blocks up to this take 255 registers

__device__ __forceinline__ float sv_exp(float x) { return expf(x); }
__device__ __forceinline__ double sv_exp(double x) { return exp(x); }

__device__ __forceinline__ float sv_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double sv_max(double a, double b) { return fmax(a, b); }

template <typename T>
__device__ __forceinline__ T neg_inf() {
  return -(T)INFINITY;
}

// The particle state between steps, laid out in the wrapper's scratch
// buffer: x_p (M, K), P_f (M, K, K), log|G| (M), h (M, K), logW (M), and
// the gather copies of x_f and h (M, K each).
template <typename T>
struct SVState {
  T *xp, *Pf, *ldG, *h, *logW, *gx, *gh;
};

template <typename T>
__host__ __device__ SVState<T> sv_state(T* base, int M, int K) {
  SVState<T> s;
  s.xp = base;
  s.Pf = s.xp + (size_t)M * K;
  s.ldG = s.Pf + (size_t)M * K * K;
  s.h = s.ldG + M;
  s.logW = s.h + (size_t)M * K;
  s.gx = s.logW + M;
  s.gh = s.gx + (size_t)M * K;
  return s;
}

// The prediction of one particle's next step from its filtered (x, P)
// and its propagated h: x_p, P_f (of the coming update) and log|G|, into
// the state at particle m.  Four k x k work arrays, reused in turn (they
// live in local memory: the factorizations are K6's noinline routines).
template <typename T, int K>
__device__ void sv_predict(const T* __restrict__ A, const T* __restrict__ C,
                           const T (&x)[K], const T (&P)[K][K],
                           const T (&h)[K], const SVState<T>& st, int m) {
  T X1[K][K], X2[K][K], Lp[K][K], Lg[K][K];
  for (int i = 0; i < K; ++i) {
    T s = T(0);
    for (int j = 0; j < K; ++j) s += A[i * K + j] * x[j];
    st.xp[(size_t)m * K + i] = s;                      // x_p = A x
  }
  for (int i = 0; i < K; ++i)
    for (int l = 0; l < K; ++l) {
      T s = T(0);
      for (int j = 0; j < K; ++j) s += A[i * K + j] * P[j][l];
      X1[i][l] = s;                                    // A P
    }
  for (int i = 0; i < K; ++i)
    for (int l = 0; l < K; ++l) {
      T s = T(0);
      for (int j = 0; j < K; ++j) s += X1[i][j] * A[l * K + j];
      X2[i][l] = s;                                    // (A P) A'
    }
  for (int i = 0; i < K; ++i) X2[i][i] += sv_exp(h[i]);
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j) X1[i][j] = T(0.5) * (X2[i][j] + X2[j][i]);
  for (int i = 0; i < K; ++i) X1[i][i] += T(1e-6);
  chol_unrolled<T, K>(X1, Lp);
  for (int i = 0; i < K; ++i)
    for (int l = 0; l < K; ++l) {
      T s = T(0);
      for (int j = 0; j < K; ++j) s += C[i * K + j] * Lp[j][l];
      X1[i][l] = s;                                    // C Lp
    }
  for (int i = 0; i < K; ++i)
    for (int l = 0; l < K; ++l) {
      T s = T(0);
      for (int j = 0; j < K; ++j) s += Lp[j][i] * X1[j][l];
      X2[i][l] = (i == l ? T(1) : T(0)) + s;           // I + Lp' C Lp
    }
  if (K > 8) {                       // jnp.linalg.cholesky's symmetrize
    for (int i = 0; i < K; ++i)
      for (int j = 0; j < i; ++j) {
        const T s = T(0.5) * (X2[i][j] + X2[j][i]);
        X2[i][j] = s;
        X2[j][i] = s;
      }
  }
  chol_unrolled<T, K>(X2, Lg);
  transpose<T, K, K>(Lp, X1);
  chol_solve_unrolled<T, K, K>(Lg, X1, X2);            // G^{-1} Lp'
  mat_mul<T, K, K, K>(Lp, X2, X1);
  T ld = T(0);
  for (int i = 0; i < K; ++i) ld += dfm_log(Lg[i][i]);
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < K; ++j)
      st.Pf[((size_t)m * K + i) * K + j] = T(0.5) * (X1[i][j] + X1[j][i]);
  st.ldG[m] = T(2) * ld;
}

// h_0 = h_center + h0_scale z0, the step-0 walk, then the step-0
// prediction from (mu0, P0); logW = -log M; the resample count to 0.
template <typename T, int K>
__global__ void __launch_bounds__(SV_PCHUNK)
sv_init_kernel(const T* __restrict__ A, const T* __restrict__ C,
               const T* __restrict__ mu0, const T* __restrict__ P0,
               const T* __restrict__ h_center, const T* __restrict__ sigma,
               const T* __restrict__ z0, const T* __restrict__ xi, T h0s,
               T logW0, SVState<T> st, int* __restrict__ n_rs, int M) {
  const int m = blockIdx.x * SV_PCHUNK + threadIdx.x;
  if (m == 0) *n_rs = 0;
  if (m >= M) return;
  T x[K], P[K][K], h[K];
  load_vec<T, K>(mu0, x);
  load_mat<T, K, K>(P0, P);
  for (int j = 0; j < K; ++j) {
    h[j] = h_center[j] + h0s * z0[(size_t)m * K + j];
    h[j] = h[j] + sigma[j] * xi[(size_t)m * K + j];
    st.h[(size_t)m * K + j] = h[j];
  }
  st.logW[m] = logW0;
  sv_predict<T, K>(A, C, x, P, h, st, m);
}

// Stage 1 of a step (residual form): per tile of series and particle, the
// partial c2 = sum v^2 / R (f64) and u = sum (v / R) lam_n, v = y_tn -
// lam_n . x_p.  c2p (tiles, M), up (tiles, K, M).
template <typename T, int K>
__global__ void __launch_bounds__(SV_PCHUNK)
sv_residual_kernel(const T* __restrict__ Y, const T* __restrict__ Lam,
                   const T* __restrict__ R, const T* __restrict__ xp,
                   double* __restrict__ c2p, T* __restrict__ up, int t,
                   int N, int M) {
  __shared__ T lam_s[SV_TILE][K];
  __shared__ T rinv_s[SV_TILE];
  __shared__ T y_s[SV_TILE];
  const int tile = blockIdx.x;
  const int n0 = tile * SV_TILE;
  const int nt = min(SV_TILE, N - n0);
  for (int i = threadIdx.x; i < nt * K; i += SV_PCHUNK)
    lam_s[i / K][i % K] = Lam[(size_t)n0 * K + i];
  for (int i = threadIdx.x; i < nt; i += SV_PCHUNK) {
    rinv_s[i] = T(1) / R[n0 + i];
    y_s[i] = Y[(size_t)t * N + n0 + i];
  }
  __syncthreads();
  const int m = blockIdx.y * SV_PCHUNK + threadIdx.x;
  if (m >= M) return;
  T x[K], u[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    x[j] = xp[(size_t)m * K + j];
    u[j] = T(0);
  }
  double c2 = 0.0;
  for (int n = 0; n < nt; ++n) {
    T fit = T(0);
#pragma unroll
    for (int j = 0; j < K; ++j) fit += x[j] * lam_s[n][j];
    const T v = y_s[n] - fit;
    const T vr = v * rinv_s[n];
    c2 += (double)(v * vr);
#pragma unroll
    for (int j = 0; j < K; ++j) u[j] += vr * lam_s[n][j];
  }
  c2p[(size_t)tile * M + m] = c2;
#pragma unroll
  for (int j = 0; j < K; ++j) up[((size_t)tile * K + j) * M + m] = u[j];
}

// Block-wide sum and max, the result in every thread; smem holds 33
// values.  Every thread of the block must call them.
template <typename A>
__device__ A block_all_sum(A v, A* smem) {
  A r = block_reduce_sum(v, smem);
  if (threadIdx.x == 0) smem[32] = r;
  __syncthreads();
  r = smem[32];
  __syncthreads();
  return r;
}

template <typename A>
__device__ A block_all_max(A v, A* smem) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = sv_max(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) smem[wid] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  if (wid == 0) {
    v = lane < nw ? smem[lane] : neg_inf<A>();
    for (int o = 16; o > 0; o >>= 1)
      v = sv_max(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) smem[32] = v;
  }
  __syncthreads();
  v = smem[32];
  __syncthreads();
  return v;
}

// Inclusive prefix sum over the block in thread order; ws holds 32
// values.
template <typename A>
__device__ A block_inclusive_scan(A v, A* ws) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const A n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) ws[wid] = v;
  __syncthreads();
  if (wid == 0) {
    A w = lane < nw ? ws[lane] : A(0);
    for (int o = 1; o < 32; o <<= 1) {
      const A n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < nw) ws[lane] = w;
  }
  __syncthreads();
  if (wid > 0) v += ws[wid - 1];
  __syncthreads();
  return v;
}

// Stage 2 of a step: one block, particle m = threadIdx.x (threads past M
// take part in the block reductions with neutral values).
template <typename T, int K, int NT>
__global__ void __launch_bounds__(NT)
sv_step_kernel(const T* __restrict__ B, const T* __restrict__ A,
               const T* __restrict__ C, const T* __restrict__ sigma,
               const T* __restrict__ xi, const T* __restrict__ u_draw,
               const double* __restrict__ c2p, const T* __restrict__ up,
               int tiles, SVState<T> st, T* __restrict__ ll_out,
               T* __restrict__ f_mean, T* __restrict__ h_mean,
               T* __restrict__ ess_out, int* __restrict__ n_rs,
               T* __restrict__ h_hist, T* __restrict__ logw_hist, int t,
               int T_, int M, int residual, T thr, T logW0) {
  __shared__ T red[33];
  __shared__ T cum[DFM_SV_MMAX];
  __shared__ T wsum[32][2 * K];
  const int m = threadIdx.x;
  const bool live = m < M;
  const int lane = m & 31, wid = m >> 5;
  T xf[K], P[K][K], h[K];
  T tot = neg_inf<T>();
  if (live) {
    T xp[K], u[K];
    load_vec<T, K>(st.xp + (size_t)m * K, xp);
    load_mat<T, K, K>(st.Pf + (size_t)m * K * K, P);
    load_vec<T, K>(st.h + (size_t)m * K, h);
    T Pu[K], uPu = T(0);
    double c2 = 0.0;
    if (residual) {
      for (int j = 0; j < K; ++j) u[j] = T(0);
      for (int tl = 0; tl < tiles; ++tl) {
        c2 += c2p[(size_t)tl * M + m];
        for (int j = 0; j < K; ++j) u[j] += up[((size_t)tl * K + j) * M + m];
      }
    } else {
      for (int i = 0; i < K; ++i) {
        T s = T(0);
        for (int j = 0; j < K; ++j) s += C[i * K + j] * xp[j];
        u[i] = B[(size_t)t * K + i] - s;
      }
    }
    for (int i = 0; i < K; ++i) {
      T s = T(0);
      for (int j = 0; j < K; ++j) s += P[i][j] * u[j];
      Pu[i] = s;
      uPu += s * u[i];
    }
    T quad;
    if (residual) {
      quad = (T)(c2 - (double)uPu);
    } else {
      T xb = T(0), xCx = T(0);
      for (int i = 0; i < K; ++i) {
        T s = T(0);
        for (int j = 0; j < K; ++j) s += C[i * K + j] * xp[j];
        xb += xp[i] * B[(size_t)t * K + i];
        xCx += s * xp[i];
      }
      quad = T(-2) * xb + xCx - uPu;
    }
    for (int i = 0; i < K; ++i) xf[i] = xp[i] + Pu[i];
    const T lw = T(-0.5) * (st.ldG[m] + quad);
    tot = st.logW[m] + lw;
  }
  const T mx = block_all_max(tot, red);
  const T se = block_all_sum(live ? sv_exp(tot - mx) : T(0), red);
  const T ll = mx + dfm_log(se);
  T logW = tot - ll;
  const T ess = T(1) / block_all_sum(live ? sv_exp(T(2) * logW) : T(0),
                                     red);
  if (m == 0) {
    ll_out[t] = ll;
    ess_out[t] = ess;
  }
  if (ess < thr) {                     // block-uniform
    if (live) {
      for (int j = 0; j < K; ++j) {
        st.gx[(size_t)m * K + j] = xf[j];
        st.gh[(size_t)m * K + j] = h[j];
      }
    }
    const T c = block_inclusive_scan(live ? sv_exp(logW) : T(0), red);
    if (live) cum[m] = c;
    __syncthreads();
    const T total = cum[M - 1];
    __syncthreads();
    if (live) cum[m] = c / total;
    __syncthreads();
    if (live) {
      const T pos = (T(m) + u_draw[t]) / T(M);
      int lo = 0, hi = M;                      // searchsorted, side 'left'
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cum[mid] < pos) lo = mid + 1;
        else hi = mid;
      }
      const int idx = min(lo, M - 1);
      load_vec<T, K>(st.gx + (size_t)idx * K, xf);
      load_vec<T, K>(st.gh + (size_t)idx * K, h);
      load_mat<T, K, K>(st.Pf + (size_t)idx * K * K, P);
      logW = logW0;
    }
    if (m == 0) *n_rs += 1;
    __syncthreads();                 // every gather read before P_f moves
  }
  // Weighted means W'x_f and W'h: warp sums, then across warps in order.
  const T W = live ? sv_exp(logW) : T(0);
  for (int c = 0; c < 2 * K; ++c) {
    T v = W * (c < K ? (live ? xf[c] : T(0)) : (live ? h[c - K] : T(0)));
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) wsum[wid][c] = v;
  }
  __syncthreads();
  if (m < 2 * K) {
    const int nw = (blockDim.x + 31) >> 5;
    T s = T(0);
    for (int w = 0; w < nw; ++w) s += wsum[w][m];
    if (m < K) f_mean[(size_t)t * K + m] = s;
    else h_mean[(size_t)t * K + m - K] = s;
  }
  if (!live) return;
  if (h_hist) {
    for (int j = 0; j < K; ++j) h_hist[((size_t)t * M + m) * K + j] = h[j];
    logw_hist[(size_t)t * M + m] = logW;
  }
  if (t + 1 < T_) {
    const T* x1 = xi + ((size_t)(t + 1) * M + m) * K;
    for (int j = 0; j < K; ++j) {
      h[j] = h[j] + sigma[j] * x1[j];
      st.h[(size_t)m * K + j] = h[j];
    }
    st.logW[m] = logW;
    sv_predict<T, K>(A, C, xf, P, h, st, m);
  }
}

template <typename T, int K>
static int sv_rbpf_run(const T* Y, const T* Lam, const T* R, const T* C,
                       const T* B, const T* A, const T* mu0, const T* P0,
                       const T* h_center, const T* sigma, const T* z0,
                       const T* xi, const T* u, T* ll_rel, T* f_mean,
                       T* h_mean, T* ess, int* n_rs, T* h_hist, T* logw_hist,
                       T* state, double* c2p, T* up, int T_, int N, int M,
                       int residual, double h0_scale, double ess_frac,
                       cudaStream_t stream) {
  const SVState<T> st = sv_state(state, M, K);
  const int nthr = (M + 31) / 32 * 32;
  const int pblocks = (M + SV_PCHUNK - 1) / SV_PCHUNK;
  const int tiles = residual ? (N + SV_TILE - 1) / SV_TILE : 0;
  const T logW0 = T(-log((double)M));
  const T thr = T(ess_frac * M);
  sv_init_kernel<T, K><<<pblocks, SV_PCHUNK, 0, stream>>>(
      A, C, mu0, P0, h_center, sigma, z0, xi, T(h0_scale), logW0, st, n_rs,
      M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int t = 0; t < T_; ++t) {
    if (residual)
      sv_residual_kernel<T, K><<<dim3(tiles, pblocks), SV_PCHUNK, 0,
                                 stream>>>(Y, Lam, R, st.xp, c2p, up, t, N,
                                           M);
    if (nthr <= SV_NT_SMALL)
      sv_step_kernel<T, K, SV_NT_SMALL><<<1, nthr, 0, stream>>>(
          B, A, C, sigma, xi, u, c2p, up, tiles, st, ll_rel, f_mean, h_mean,
          ess, n_rs, h_hist, logw_hist, t, T_, M, residual, thr, logW0);
    else
      sv_step_kernel<T, K, DFM_SV_MMAX><<<1, nthr, 0, stream>>>(
          B, A, C, sigma, xi, u, c2p, up, tiles, st, ll_rel, f_mean, h_mean,
          ess, n_rs, h_hist, logw_hist, t, T_, M, residual, thr, logW0);
    if (t == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// Block argmax of (v, index), the lowest index on ties; every thread of
// the block gets it.  rv, ri hold 33 values.
template <typename T>
__device__ int block_argmax(T v, int i, T* rv, int* ri) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    rv[wid] = v;
    ri[wid] = i;
  }
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  if (wid == 0) {
    v = lane < nw ? rv[lane] : neg_inf<T>();
    i = lane < nw ? ri[lane] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, v, o);
      const int oi = __shfl_down_sync(0xffffffffu, i, o);
      if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) ri[32] = i;
  }
  __syncthreads();
  i = ri[32];
  __syncthreads();
  return i;
}

// K10-ffbs: draw s = blockIdx.x, particle m = threadIdx.x.
template <typename T, int K>
__global__ void __launch_bounds__(DFM_SV_MMAX)
sv_ffbs_kernel(const T* __restrict__ h_hist, const T* __restrict__ logw,
               const T* __restrict__ sigma, const T* __restrict__ g_last,
               const T* __restrict__ g, T* __restrict__ out, int T_, int M,
               int S) {
  __shared__ T rv[33];
  __shared__ int ri[33];
  __shared__ T hs[K];
  const int s = blockIdx.x, m = threadIdx.x;
  const bool live = m < M;
  T s2[K];
  for (int j = 0; j < K; ++j) s2[j] = sv_max(sigma[j] * sigma[j], T(1e-20));
  T v = live ? logw[(size_t)(T_ - 1) * M + m] + g_last[(size_t)s * M + m]
             : neg_inf<T>();
  int idx = block_argmax(v, m, rv, ri);
  if (m < K) {
    hs[m] = h_hist[((size_t)(T_ - 1) * M + idx) * K + m];
    out[((size_t)(T_ - 1) * S + s) * K + m] = hs[m];
  }
  __syncthreads();
  for (int t = T_ - 2; t >= 0; --t) {
    v = neg_inf<T>();
    if (live) {
      const T* ht = h_hist + ((size_t)t * M + m) * K;
      T d2 = T(0);
      for (int j = 0; j < K; ++j) {
        const T d = hs[j] - ht[j];
        d2 += d * d / s2[j];
      }
      v = (logw[(size_t)t * M + m] - T(0.5) * d2)
          + g[((size_t)t * S + s) * M + m];
    }
    idx = block_argmax(v, m, rv, ri);
    if (m < K) {
      hs[m] = h_hist[((size_t)t * M + idx) * K + m];
      out[((size_t)t * S + s) * K + m] = hs[m];
    }
    __syncthreads();
  }
}

template <typename T>
static int sv_rbpf_launch(const T* Y, const T* Lam, const T* R, const T* C,
                          const T* B, const T* A, const T* mu0, const T* P0,
                          const T* h_center, const T* sigma, const T* z0,
                          const T* xi, const T* u, T* ll_rel, T* f_mean,
                          T* h_mean, T* ess, int* n_rs, T* h_hist,
                          T* logw_hist, T* state, double* c2p, T* up, int T_,
                          int N, int k, int M, int residual, double h0_scale,
                          double ess_frac, cudaStream_t stream) {
  if (M < 1 || M > DFM_SV_MMAX || T_ < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  DFM_DISPATCH_K(k, return sv_rbpf_run<T, K>(
                     Y, Lam, R, C, B, A, mu0, P0, h_center, sigma, z0, xi, u,
                     ll_rel, f_mean, h_mean, ess, n_rs, h_hist, logw_hist,
                     state, c2p, up, T_, N, M, residual, h0_scale, ess_frac,
                     stream))
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int sv_ffbs_launch(const T* h_hist, const T* logw, const T* sigma,
                          const T* g_last, const T* g, T* out, int T_, int M,
                          int k, int S, cudaStream_t stream) {
  if (M < 1 || M > DFM_SV_MMAX || T_ < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const int nthr = (M + 31) / 32 * 32;
  DFM_DISPATCH_K(k, sv_ffbs_kernel<T, K><<<S, nthr, 0, stream>>>(
                        h_hist, logw, sigma, g_last, g, out, T_, M, S))
  return (int)cudaGetLastError();
}

#define SV_RBPF_ARGS(T)                                                      \
  const T *Y, const T *Lam, const T *R, const T *C, const T *B,              \
      const T *A, const T *mu0, const T *P0, const T *h_center,              \
      const T *sigma, const T *z0, const T *xi, const T *u, T *ll_rel,       \
      T *f_mean, T *h_mean, T *ess, int *n_rs, T *h_hist, T *logw_hist,      \
      T *state, double *c2p, T *up, int T_, int N, int k, int M,             \
      int residual, double h0_scale, double ess_frac, void *stream
#define SV_RBPF_PASS                                                         \
  Y, Lam, R, C, B, A, mu0, P0, h_center, sigma, z0, xi, u, ll_rel, f_mean,   \
      h_mean, ess, n_rs, h_hist, logw_hist, state, c2p, up, T_, N, k, M,     \
      residual, h0_scale, ess_frac, (cudaStream_t)stream

extern "C" {
#if DFM_WANT_F32
int sv_rbpf_f32(SV_RBPF_ARGS(float)) {
  return sv_rbpf_launch<float>(SV_RBPF_PASS);
}
int sv_ffbs_f32(const float* h_hist, const float* logw, const float* sigma,
                const float* g_last, const float* g, float* out, int T, int M,
                int k, int S, void* stream) {
  return sv_ffbs_launch<float>(h_hist, logw, sigma, g_last, g, out, T, M, k,
                               S, (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int sv_rbpf_f64(SV_RBPF_ARGS(double)) {
  return sv_rbpf_launch<double>(SV_RBPF_PASS);
}
int sv_ffbs_f64(const double* h_hist, const double* logw,
                const double* sigma, const double* g_last, const double* g,
                double* out, int T, int M, int k, int S, void* stream) {
  return sv_ffbs_launch<double>(h_hist, logw, sigma, g_last, g, out, T, M,
                                k, S, (cudaStream_t)stream);
}
#endif
}
