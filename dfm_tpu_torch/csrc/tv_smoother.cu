// K11-bwd at k <= 16 (loading_smoother): tv_loadings.cu holds the
// formulas, the bound and the design (one thread a series, the k x k
// state in registers, k a template constant); this source is its own so
// its instantiations compile beside K11-fwd's.
#include "common.cuh"

constexpr int kThreads = 64;

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
loading_smoother_kernel(const T* __restrict__ lam_f,
                        const T* __restrict__ P_f,
                        const T* __restrict__ tau2, T* __restrict__ lam_sm,
                        T* __restrict__ P_sm, T* __restrict__ incr_out,
                        int T_, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const T t2 = tau2[n];
  T lam_n[K], P_n[K][K];
  {
    const size_t o = (size_t)(T_ - 1) * N + n;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      lam_n[i] = lam_f[o * K + i];
      lam_sm[o * K + i] = lam_n[i];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        P_n[i][j] = P_f[o * K * K + i * K + j];
        P_sm[o * K * K + i * K + j] = P_n[i][j];
      }
    }
  }
  T incr = T(0);
  for (int t = T_ - 2; t >= 0; --t) {
    const size_t o = (size_t)t * N + n;
    T lf[K], Pfm[K][K], L[K][K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      lf[i] = lam_f[o * K + i];
#pragma unroll
      for (int j = 0; j < K; ++j) Pfm[i][j] = P_f[o * K * K + i * K + j];
    }
    // L L' = P_pred[t+1] = P_f[t] + tau2 I, from its lower triangle.
#pragma unroll (K <= 8 ? K : 1)
    for (int i = 0; i < K; ++i) {
      T s = Pfm[i][i] + t2;
#pragma unroll
      for (int j = 0; j < i; ++j) s -= L[i][j] * L[i][j];
      L[i][i] = dfm_sqrt(s);
#pragma unroll
      for (int q = i + 1; q < K; ++q) {
        T s2 = Pfm[q][i];
#pragma unroll
        for (int j = 0; j < i; ++j) s2 -= L[q][j] * L[i][j];
        L[q][i] = s2 / L[i][i];
      }
    }
    // JT = J' = (L L')^{-1} P_f[t], a column at a time.
    T JT[K][K];
#pragma unroll (K <= 8 ? K : 1)
    for (int c = 0; c < K; ++c) {
      T z[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        T s = Pfm[i][c];
#pragma unroll
        for (int j = 0; j < i; ++j) s -= L[i][j] * z[j];
        z[i] = s / L[i][i];
      }
#pragma unroll
      for (int i = K - 1; i >= 0; --i) {
        T s = z[i];
#pragma unroll
        for (int j = i + 1; j < K; ++j) s -= L[j][i] * JT[j][c];
        JT[i][c] = s / L[i][i];
      }
    }
    // lam_s = lam_f + J (lam_n - lam_f);  G = J (P_n - P_pred[t+1]).
    T lam_s[K], G[K][K];
#pragma unroll (K <= 8 ? K : 1)
    for (int i = 0; i < K; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) s += JT[j][i] * (lam_n[j] - lf[j]);
      lam_s[i] = lf[i] + s;
#pragma unroll
      for (int l = 0; l < K; ++l) {
        T g = T(0);
#pragma unroll
        for (int j = 0; j < K; ++j)
          g += JT[j][i] * (P_n[j][l] - (j == l ? Pfm[j][l] + t2 : Pfm[j][l]));
        G[i][l] = g;
      }
    }
    // M = P_f + G J';  P_s = sym(M).  The trace terms use the old P_n.
    T M[K][K];
#pragma unroll (K <= 8 ? K : 1)
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int m = 0; m < K; ++m) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < K; ++l) s += G[i][l] * JT[l][m];
        M[i][m] = Pfm[i][m] + s;
      }
    T dd = T(0), tr_n = T(0), tr_s = T(0), tr_lag = T(0);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const T d = lam_n[i] - lam_s[i];
      dd += d * d;
      tr_n += P_n[i][i];
      tr_s += M[i][i];
#pragma unroll
      for (int j = 0; j < K; ++j) tr_lag += P_n[i][j] * JT[j][i];
    }
    incr += dd + tr_n + tr_s - T(2) * tr_lag;
    T* lo = lam_sm + o * K;
    T* Po = P_sm + o * K * K;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      lam_n[i] = lam_s[i];
      lo[i] = lam_s[i];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        P_n[i][j] = T(0.5) * (M[i][j] + M[j][i]);
        Po[i * K + j] = P_n[i][j];
      }
    }
  }
  incr_out[n] = incr;
}

template <typename T>
static int launch_smoother(const T* lam_f, const T* P_f, const T* tau2,
                           T* lam_sm, T* P_sm, T* incr, int T_, int N, int k,
                           cudaStream_t stream) {
  if (T_ <= 0 || N <= 0) return (int)cudaGetLastError();
  const int blocks = (N + kThreads - 1) / kThreads;
  DFM_DISPATCH_K(k, loading_smoother_kernel<T, K><<<blocks, kThreads, 0,
                                                    stream>>>(
                        lam_f, P_f, tau2, lam_sm, P_sm, incr, T_, N))
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_TVL_SMOOTHER_ENTRIES(SFX, T)                                       \
  int loading_smoother_##SFX(const T* lam_f, const T* P_f, const T* tau2,    \
                             T* lam_sm, T* P_sm, T* incr, int T_, int N,     \
                             int k, void* stream) {                          \
    return launch_smoother<T>(lam_f, P_f, tau2, lam_sm, P_sm, incr, T_, N,   \
                              k, (cudaStream_t)stream);                      \
  }
#if DFM_WANT_F32
DFM_TVL_SMOOTHER_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_TVL_SMOOTHER_ENTRIES(f64, double)
#endif
}
