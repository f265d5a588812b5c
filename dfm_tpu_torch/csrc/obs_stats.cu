// K2: masked observation statistics of the information-form filter.
//
// Replaces the masked branch of dfm_tpu/ssm/info_filter.py:obs_stats
// (lines 93-100).  For every step t, over the series n:
//   b_t   = sum_n w y lam_n / R_n          (k,)
//   C_t   = sum_n w lam_n lam_n' / R_n     (k, k), k(k+1)/2 sums, mirrored
//   n_t   = sum_n w
//   ldR_t = sum_n w log R_n
// with y = nan_to_num(y) so a NaN at a missing entry cannot poison b.
// The unmasked branch is a plain GEMM and stays torch.matmul.
//
// Bound on the H100: bytes.  The kernel reads Y and the mask once (40 MB
// in f32 at T = 500, N = 10,000) and does ~k(k+3) flops per entry, below
// the card's flops-per-byte balance at k = 10.
//
// Design: one block per t.  Each thread walks series with a stride of
// blockDim.x, keeps its partials of all k + k(k+1)/2 + 2 outputs in
// registers (k is a template constant so the partials stay in registers),
// then every warp reduces its partials with shuffles and the block adds the
// warps' sums through shared memory.
#include "common.cuh"

constexpr int kThreads = 256;

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
obs_stats_kernel(const T* __restrict__ Y, const T* __restrict__ Lam,
                 const T* __restrict__ R, const T* __restrict__ mask,
                 T* __restrict__ b, T* __restrict__ C, T* __restrict__ nobs,
                 T* __restrict__ ldR, int N) {
  constexpr int NC = K * (K + 1) / 2;
  constexpr int NV = K + NC + 2;
  __shared__ T part[kThreads / 32][NV];
  const int t = blockIdx.x;
  const T* y = Y + (size_t)t * N;
  const T* w = mask + (size_t)t * N;
  T acc[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = T(0);
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const T wn = w[n];
    const T rinv = T(1) / R[n];
    const T yw = wn * nan_to_num(y[n]);
    const T wr = wn * rinv;
    T lam[K];
#pragma unroll
    for (int j = 0; j < K; ++j) lam[j] = Lam[(size_t)n * K + j];
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] += yw * (lam[j] * rinv);
    int e = K;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) acc[e++] += wr * lam[i] * lam[j];
    acc[K + NC] += wn;
    acc[K + NC + 1] += wn * dfm_log(R[n]);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    T v = acc[e];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) part[wid][e] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NV; e += kThreads) {
    T s = T(0);
    for (int q = 0; q < kThreads / 32; ++q) s += part[q][e];
    if (e < K) {
      b[(size_t)t * K + e] = s;
    } else if (e < K + NC) {
      int r = e - K, i = 0;
      while (r > i) { r -= i + 1; ++i; }          // packed (i, j), j <= i
      T* Ct = C + (size_t)t * K * K;
      Ct[i * K + r] = s;
      Ct[r * K + i] = s;
    } else if (e == K + NC) {
      nobs[t] = s;
    } else {
      ldR[t] = s;
    }
  }
}

template <typename T>
static int launch(const T* Y, const T* Lam, const T* R, const T* mask, T* b,
                  T* C, T* nobs, T* ldR, int T_, int N, int k,
                  cudaStream_t stream) {
  if (T_ <= 0) return (int)cudaGetLastError();
  DFM_DISPATCH_K(k, obs_stats_kernel<T, K><<<T_, kThreads, 0, stream>>>(
                        Y, Lam, R, mask, b, C, nobs, ldR, N))
  return (int)cudaGetLastError();
}

extern "C" {
#if DFM_WANT_F32
int obs_stats_f32(const float* Y, const float* Lam, const float* R,
                  const float* mask, float* b, float* C, float* nobs,
                  float* ldR, int T, int N, int k, void* stream) {
  return launch<float>(Y, Lam, R, mask, b, C, nobs, ldR, T, N, k,
                       (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int obs_stats_f64(const double* Y, const double* Lam, const double* R,
                  const double* mask, double* b, double* C, double* nobs,
                  double* ldR, int T, int N, int k, void* stream) {
  return launch<double>(Y, Lam, R, mask, b, C, nobs, ldR, T, N, k,
                        (cudaStream_t)stream);
}
#endif
}
