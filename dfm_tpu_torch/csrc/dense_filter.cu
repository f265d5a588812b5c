// K15: the dense small-N Kalman filter, the whole T-step chain in one CTA.
//
// Replaces dfm_tpu/ssm/kalman.py:kalman_filter (line 43; the lax.scan step
// of lines 54-80), the engine ``filter="auto"`` picks below N = 32.  Per
// step, from the predicted (x, P), with the static-shape masking rewrite
// (w = mask[t], or 1 with no mask): H = diag(w) Lam, y = w nan_to_num(y_t),
// r = w R + (1 - w):
//   v = y - H x;  S = H P H' + diag(r) (N x N);  L = chol(sym(S) + jitter I)
//   [K' | S^{-1} v] = (L L')^{-1} [H P | v];  x_f = x + K v
//   P_f = sym((I - K H) P (I - K H)' + (K * r) K')       (Joseph form)
//   ll_t = -0.5 (n_t log(2 pi) + 2 sum log diag L + v' S^{-1} v), n_t = sum w
//   x <- A x_f;  P <- sym(A P_f A' + Q)
// and it emits x_pred, P_pred, x_filt, P_filt and ll_t; the wrapper sums
// ll_t in the compute dtype.  Each expression associates as the JAX step's
// (and the plain twin's) does: (H P) H', sym after the sum, the jitter on
// sym(S), (I - K H) P first, so the kernel stays within rounding of them.
//
// Bound on the H100: neither bytes (~(N + 2 k^2) values a step) nor
// operations (~N^3 / 3 + 3 N^2 k + 4 N k^2 + 6 k^3 flops a step, ~0.1
// MFLOP at N = 31, k = 10): step t + 1 needs step t, so the floor is T
// times one step's dependent chain of an N x N Cholesky factorization,
// two triangular solves and a dozen small products.
//
// Design: one CTA of DF_WARPS warps runs the chain; every matrix lives in
// dynamic shared memory at the wide leading dimension (WIDE_LD = 33, rows
// max(N, k)): Lam, A, Q, P, H, [H P | v] (solved in place), S, I - K H,
// two temporaries and P_f, 11 slots (90 KB in f64 at N = 31).  The products
// spread their outputs over all the threads; the Cholesky factorization is
// one warp's (``df_chol``); the two triangular solves spread
// the k + 1 right-hand sides over the warps, a lane a row, x_p broadcast
// by a shuffle at each substitution step (times 1 / L_pp, computed off
// the dependent chain); __syncthreads() separates the phases.  N <= 32 and k <= 32 (DFM_WIDE_KMAX); the mask is optional (a
// null pointer when the panel is fully observed).
#include "warp_linalg.cuh"

constexpr int DF_WARPS = 4;
constexpr int DF_THREADS = 32 * DF_WARPS;
constexpr int DF_SLOTS = 11;
// Right-hand sides a warp solves: k + 1 <= 33 over DF_WARPS warps.
constexpr int DF_RHS = (DFM_WIDE_KMAX + 1 + DF_WARPS - 1) / DF_WARPS;

template <typename T>
__device__ __forceinline__ SMat<T, WIDE_LD> df_slot(T* base, int i, int rows) {
  return reinterpret_cast<SMat<T, WIDE_LD>>(base + (size_t)i * rows * WIDE_LD);
}

// Dynamic shared memory: the matrix slots and six N-vectors / k-vectors.
template <typename T>
static size_t df_smem(int N, int k) {
  const int rows = N > k ? N : k;
  return sizeof(T) * ((size_t)DF_SLOTS * rows * WIDE_LD + 6 * (size_t)rows);
}

// warp_linalg.cuh's chol_inplace, the same operations in the same order,
// with each pivot's column update loading four rows before it stores them
// (so the loads need not wait on the stores: a lane updates up to N - 1
// rows a pivot at N <= 32).  Called by one warp.
template <typename T>
__device__ void df_chol(SMat<T, WIDE_LD> W, int n) {
  const int lane = warp_lane();
  for (int p = 0; p < n; ++p) {
    const T d = dfm_sqrt(W[p][p]);
    __syncwarp();
    if (lane == p) W[p][p] = d;
    else if (lane > p && lane < n) W[lane][p] /= d;
    __syncwarp();
    if (lane > p && lane < n) {
      const T ljp = W[lane][p];
      int i = lane;
      for (; i + 4 <= n; i += 4) {
        const T a0 = W[i][p], a1 = W[i + 1][p], a2 = W[i + 2][p],
                a3 = W[i + 3][p];
        const T w0 = W[i][lane], w1 = W[i + 1][lane], w2 = W[i + 2][lane],
                w3 = W[i + 3][lane];
        W[i][lane] = w0 - a0 * ljp;
        W[i + 1][lane] = w1 - a1 * ljp;
        W[i + 2][lane] = w2 - a2 * ljp;
        W[i + 3][lane] = w3 - a3 * ljp;
      }
      for (; i < n; ++i) W[i][lane] -= W[i][p] * ljp;
    }
    __syncwarp();
  }
  if (lane < n)
    for (int i = 0; i < lane; ++i) W[i][lane] = T(0);
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(DF_THREADS)
dense_filter_kernel(const T* __restrict__ Y, const T* __restrict__ mask,
                    const T* __restrict__ Lam, const T* __restrict__ R,
                    const T* __restrict__ A, const T* __restrict__ Q,
                    const T* __restrict__ mu0, const T* __restrict__ P0,
                    T* __restrict__ x_pred, T* __restrict__ P_pred,
                    T* __restrict__ x_filt, T* __restrict__ P_filt,
                    T* __restrict__ ll, int T_, int N, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int rows = N > k ? N : k;
  SMat<T, WIDE_LD> Lm = df_slot(sm, 0, rows), Am = df_slot(sm, 1, rows),
                   Qm = df_slot(sm, 2, rows), P = df_slot(sm, 3, rows),
                   H = df_slot(sm, 4, rows), B = df_slot(sm, 5, rows),
                   S = df_slot(sm, 6, rows), IKH = df_slot(sm, 7, rows),
                   W1 = df_slot(sm, 8, rows), W2 = df_slot(sm, 9, rows),
                   Pf = df_slot(sm, 10, rows);
  T* vec = sm + (size_t)DF_SLOTS * rows * WIDE_LD;
  T *x = vec, *xf = vec + rows, *yv = vec + 2 * rows, *rv = vec + 3 * rows,
    *vv = vec + 4 * rows, *scal = vec + 5 * rows;
  const int tid = threadIdx.x;
  const int kk = k * k, Nk = N * k, NN = N * N;
  const T jit = dfm_jitter<T>();
  const T log2pi = T(1.8378770664093453);

  for (int e = tid; e < Nk; e += DF_THREADS) Lm[e / k][e % k] = Lam[e];
  for (int e = tid; e < kk; e += DF_THREADS) {
    const int i = e / k, j = e % k;
    Am[i][j] = A[e];
    Qm[i][j] = Q[e];
    P[i][j] = P0[e];
  }
  for (int j = tid; j < k; j += DF_THREADS) x[j] = mu0[j];
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    const size_t row = (size_t)t * N;
    // The masking rewrite; emit the prediction this step starts from.
    for (int n = tid; n < N; n += DF_THREADS) {
      const T y = Y[row + n];
      if (mask) {
        const T w = mask[row + n];
        yv[n] = w * nan_to_num(y);
        rv[n] = w * R[n] + (T(1) - w);
        vv[n] = w;
      } else {
        yv[n] = y;
        rv[n] = R[n];
        vv[n] = T(1);
      }
    }
    for (int e = tid; e < Nk; e += DF_THREADS) {
      const int n = e / k, j = e % k;
      H[n][j] = mask ? mask[row + n] * Lm[n][j] : Lm[n][j];
    }
    for (int e = tid; e < kk; e += DF_THREADS)
      P_pred[(size_t)t * kk + e] = P[e / k][e % k];
    for (int j = tid; j < k; j += DF_THREADS) x_pred[(size_t)t * k + j] = x[j];
    __syncthreads();

    // B = [H P | v], v = y - H x; the observed count n_t.
    for (int e = tid; e < Nk + N; e += DF_THREADS) {
      if (e < Nk) {
        const int i = e / k, j = e % k;
        T s = T(0);
        for (int l = 0; l < k; ++l) s += H[i][l] * P[l][j];
        B[i][j] = s;
      } else {
        const int n = e - Nk;
        T s = T(0);
        for (int l = 0; l < k; ++l) s += H[n][l] * x[l];
        B[n][k] = yv[n] - s;
      }
    }
    if (tid == 0) {
      T c = T(0);
      for (int n = 0; n < N; ++n) c += vv[n];
      scal[0] = mask ? c : T(N);
    }
    __syncthreads();

    // S = (H P) H' + diag(r), raw; keep v (the solve overwrites B's column).
    for (int e = tid; e < NN; e += DF_THREADS) {
      const int i = e / N, j = e % N;
      T s = T(0);
      for (int l = 0; l < k; ++l) s += B[i][l] * H[j][l];
      S[i][j] = i == j ? s + rv[i] : s;
    }
    for (int n = tid; n < N; n += DF_THREADS) vv[n] = B[n][k];
    __syncthreads();
    // sym(S) + jitter I into the lower triangle, a thread a pair.
    for (int e = tid; e < NN; e += DF_THREADS) {
      const int i = e / N, j = e % N;
      if (j > i) continue;
      const T m = T(0.5) * (S[i][j] + S[j][i]);
      S[i][j] = i == j ? m + jit : m;
    }
    __syncthreads();
    if (tid < 32) df_chol<T>(S, N);
    __syncthreads();

    // (L L')^{-1} [H P | v] in place: warp w takes the right-hand sides c
    // = w, w + DF_WARPS, ... (at most DF_RHS), lane i holding row i of
    // each in registers; a substitution step broadcasts x_p by a shuffle.
    {
      const int lane = tid & 31, warp = tid >> 5;
      T b[DF_RHS];
#pragma unroll
      for (int q = 0; q < DF_RHS; ++q) {
        const int c = warp + DF_WARPS * q;
        b[q] = (c <= k && lane < N) ? B[lane][c] : T(0);
      }
      for (int p = 0; p < N; ++p) {
        const T lp = lane > p && lane < N ? S[lane][p] : T(0);
        const T rp = T(1) / S[p][p];
#pragma unroll
        for (int q = 0; q < DF_RHS; ++q) {
          const T xp = __shfl_sync(0xffffffffu, b[q], p) * rp;
          if (lane == p) b[q] = xp;
          else b[q] -= lp * xp;
        }
      }
      for (int p = N - 1; p >= 0; --p) {
        const T lp = lane < p ? S[p][lane] : T(0);
        const T rp = T(1) / S[p][p];
#pragma unroll
        for (int q = 0; q < DF_RHS; ++q) {
          const T xp = __shfl_sync(0xffffffffu, b[q], p) * rp;
          if (lane == p) b[q] = xp;
          else b[q] -= lp * xp;
        }
      }
#pragma unroll
      for (int q = 0; q < DF_RHS; ++q) {
        const int c = warp + DF_WARPS * q;
        if (c <= k && lane < N) B[lane][c] = b[q];
      }
    }
    __syncthreads();

    // x_f = x + K v; I - K H; (K * r) K' (into W2); the loglik term.
    for (int e = tid; e < k + 2 * kk; e += DF_THREADS) {
      if (e < k) {
        T s = T(0);
        for (int n = 0; n < N; ++n) s += B[n][e] * vv[n];
        xf[e] = x[e] + s;
      } else if (e < k + kk) {
        const int q = e - k, i = q / k, j = q % k;
        T s = T(0);
        for (int n = 0; n < N; ++n) s += B[n][i] * H[n][j];
        IKH[i][j] = (i == j ? T(1) : T(0)) - s;
      } else {
        const int q = e - k - kk, i = q / k, j = q % k;
        T s = T(0);
        for (int n = 0; n < N; ++n) s += (B[n][i] * rv[n]) * B[n][j];
        W2[i][j] = s;
      }
    }
    if (tid == DF_THREADS - 1) {
      T ld = T(0), q = T(0);
      for (int n = 0; n < N; ++n) ld += dfm_log(S[n][n]);
      for (int n = 0; n < N; ++n) q += vv[n] * B[n][k];
      ll[t] = T(-0.5) * ((scal[0] * log2pi + T(2) * ld) + q);
    }
    __syncthreads();

    // P_f = sym((I - K H) P (I - K H)' + (K * r) K').
    for (int e = tid; e < kk; e += DF_THREADS) {
      const int i = e / k, j = e % k;
      T s = T(0);
      for (int l = 0; l < k; ++l) s += IKH[i][l] * P[l][j];
      W1[i][j] = s;
    }
    __syncthreads();
    for (int e = tid; e < kk; e += DF_THREADS) {
      const int i = e / k, j = e % k;
      T s = T(0);
      for (int l = 0; l < k; ++l) s += W1[i][l] * IKH[j][l];
      S[i][j] = s + W2[i][j];
    }
    __syncthreads();
    for (int e = tid; e < kk; e += DF_THREADS) {
      const int i = e / k, j = e % k;
      const T v = T(0.5) * (S[i][j] + S[j][i]);
      Pf[i][j] = v;
      P_filt[(size_t)t * kk + e] = v;
    }
    for (int j = tid; j < k; j += DF_THREADS) x_filt[(size_t)t * k + j] = xf[j];
    __syncthreads();

    // The prediction: x <- A x_f, P <- sym(A P_f A' + Q).
    for (int e = tid; e < kk + k; e += DF_THREADS) {
      if (e < kk) {
        const int i = e / k, j = e % k;
        T s = T(0);
        for (int l = 0; l < k; ++l) s += Am[i][l] * Pf[l][j];
        W1[i][j] = s;
      } else {
        const int i = e - kk;
        T s = T(0);
        for (int l = 0; l < k; ++l) s += Am[i][l] * xf[l];
        x[i] = s;
      }
    }
    __syncthreads();
    for (int e = tid; e < kk; e += DF_THREADS) {
      const int i = e / k, j = e % k;
      T s = T(0);
      for (int l = 0; l < k; ++l) s += W1[i][l] * Am[j][l];
      W2[i][j] = s;
    }
    __syncthreads();
    for (int e = tid; e < kk; e += DF_THREADS) {
      const int i = e / k, j = e % k;
      P[i][j] = T(0.5) * ((W2[i][j] + Qm[i][j]) + (W2[j][i] + Qm[j][i]));
    }
    __syncthreads();
  }
}

template <typename T>
static int launch(const T* Y, const T* mask, const T* Lam, const T* R,
                  const T* A, const T* Q, const T* mu0, const T* P0,
                  T* x_pred, T* P_pred, T* x_filt, T* P_filt, T* ll, int T_,
                  int N, int k, cudaStream_t stream) {
  if (N < 1 || N > DFM_WIDE_KMAX || k < 1 || k > DFM_WIDE_KMAX || T_ < 0)
    return (int)cudaErrorInvalidValue;
  if (T_ == 0) return (int)cudaGetLastError();
  const size_t bytes = df_smem<T>(N, k);
  const cudaError_t e = dfm_smem_optin(dense_filter_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  dense_filter_kernel<T><<<1, DF_THREADS, bytes, stream>>>(
      Y, mask, Lam, R, A, Q, mu0, P0, x_pred, P_pred, x_filt, P_filt, ll, T_,
      N, k);
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_DENSE_ENTRY(SFX, T)                                                \
  int dense_filter_##SFX(const T* Y, const T* mask, const T* Lam, const T* R, \
                         const T* A, const T* Q, const T* mu0, const T* P0,   \
                         T* x_pred, T* P_pred, T* x_filt, T* P_filt, T* ll,   \
                         int T_, int N, int k, void* stream) {                \
    return launch<T>(Y, mask, Lam, R, A, Q, mu0, P0, x_pred, P_pred, x_filt, \
                     P_filt, ll, T_, N, k, (cudaStream_t)stream);            \
  }
#if DFM_WANT_F32
DFM_DENSE_ENTRY(f32, float)
#endif
#if DFM_WANT_F64
DFM_DENSE_ENTRY(f64, double)
#endif
}
