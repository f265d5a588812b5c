// K3: masked per-series M-step rows.
//
// Replaces the masked branch of dfm_tpu/estim/em.py:mstep_rows (lines
// 197-213).  For every series i, over the steps t with w = mask[t, i] and
// yz = w > 0 ? nan_to_num(y) : 0:
//   S_yf,i = sum_t yz E[f_t]                       (k,)
//   S_ff,i = sum_t w E[f_t f_t']                   (k, k); I when the series
//            is never observed; plus lam_ridge * I
//   Lam_i  = chol-solve of (S_ff,i + jitter I) against S_yf,i
//   R_i    = max((sum_t w (yz - E[f_t] . Lam_i)^2
//                 + Lam_i' (sum_t w P_sm,t) Lam_i) / max(count, 1), r_floor)
//
// Bound on the H100: bytes.  The kernel must read Y and the mask once (40
// MB in f32 at T = 500, N = 10,000); the moments E[f], E[ff'] and P_sm are
// (T, k, k)-sized and every series reads all of them.
//
// K3b-m, the fleet's batched twin, is the same kernel over B lanes (grid
// (ceil(N / 64), B), every tensor of a lane batch-major at a lane stride,
// no ridge): it replaces the observation rows of
// dfm_tpu/estim/batched.py:batched_m_step_masked (lines 701-713).  A
// never-observed series (an N-pad series of a fleet bucket) gets S_ff = I
// and S_yf = 0, so exact-zero loadings.  Bound: bytes, Y and W read once,
// 640 MB at B = 8, T = 1,000, N = 10,000 in f32.
//
// Design: one thread per series, so each step's read of Y and of the mask
// is coalesced across the block.  Two passes over T: the first accumulates
// S_yf and the packed lower triangle of S_ff in registers (k is a template
// constant) and solves the k x k system in place; the second accumulates
// the residual sum and the packed P_sm sum for the smear.  The block stages
// chunks of kTC steps of the moments in shared memory, because every series
// of the block reads them.
#include "common.cuh"

constexpr int kThreads = 64;
constexpr int kTC = 16;

__host__ __device__ constexpr int tri(int a, int c) { return a * (a + 1) / 2 + c; }

// Stage steps [t0, t0 + nt) of Ef (T, K) and of a (T, K, K) moment.
template <typename T, int K>
__device__ void stage(T (*sE)[K], T (*sM)[K * K], const T* Ef, const T* M,
                      int t0, int nt) {
  for (int q = threadIdx.x; q < nt * K; q += kThreads)
    sE[q / K][q % K] = Ef[(size_t)t0 * K + q];
  for (int q = threadIdx.x; q < nt * K * K; q += kThreads)
    sM[q / (K * K)][q % (K * K)] = M[(size_t)t0 * K * K + q];
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
mstep_rows_kernel(const T* __restrict__ Y, const T* __restrict__ mask,
                  const T* __restrict__ Ef, const T* __restrict__ EffT,
                  const T* __restrict__ Psm, T* __restrict__ Lam,
                  T* __restrict__ R, int T_, int N, T r_floor, T lam_ridge) {
  constexpr int NC = K * (K + 1) / 2;
  __shared__ T sE[kTC][K];
  __shared__ T sM[kTC][K * K];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < N;
  // This block's problem lane.
  const size_t pb = blockIdx.y, tn = (size_t)T_ * N;
  Y += pb * tn;
  mask += pb * tn;
  Ef += pb * (size_t)T_ * K;
  EffT += pb * (size_t)T_ * K * K;
  Psm += pb * (size_t)T_ * K * K;
  Lam += pb * (size_t)N * K;
  R += pb * N;

  T syf[K], S[NC], cnt = T(0);
#pragma unroll
  for (int j = 0; j < K; ++j) syf[j] = T(0);
#pragma unroll
  for (int e = 0; e < NC; ++e) S[e] = T(0);
  for (int t0 = 0; t0 < T_; t0 += kTC) {
    const int nt = min(kTC, T_ - t0);
    __syncthreads();
    stage<T, K>(sE, sM, Ef, EffT, t0, nt);
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const size_t off = (size_t)(t0 + tt) * N + i;
      const T w = mask[off];
      const T yz = w > T(0) ? nan_to_num(Y[off]) : T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) syf[j] += yz * sE[tt][j];
#pragma unroll
      for (int a = 0; a < K; ++a)
#pragma unroll
        for (int c = 0; c <= a; ++c) S[tri(a, c)] += w * sM[tt][a * K + c];
      cnt += w;
    }
  }

  // Never observed: S_ff,i = I.  Then the ridge, then psd_cholesky's
  // jitter (S is symmetric by construction, so sym() is exact).
  const T jit = dfm_jitter<T>();
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c) {
      if (cnt == T(0)) S[tri(a, c)] = a == c ? T(1) : T(0);
      if (a == c) S[tri(a, a)] = (S[tri(a, a)] + lam_ridge) + jit;
    }
  // Cholesky in place (row by row, no clamp: an indefinite S gives NaN).
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c) {
      T s = S[tri(a, c)];
#pragma unroll
      for (int m = 0; m < c; ++m) s -= S[tri(a, m)] * S[tri(c, m)];
      S[tri(a, c)] = a == c ? dfm_sqrt(s) : s / S[tri(c, c)];
    }
  T lam[K];
#pragma unroll
  for (int a = 0; a < K; ++a) {
    T s = syf[a];
#pragma unroll
    for (int m = 0; m < a; ++m) s -= S[tri(a, m)] * lam[m];
    lam[a] = s / S[tri(a, a)];
  }
#pragma unroll
  for (int a = K - 1; a >= 0; --a) {
    T s = lam[a];
#pragma unroll
    for (int m = a + 1; m < K; ++m) s -= S[tri(m, a)] * lam[m];
    lam[a] = s / S[tri(a, a)];
  }

  // Second pass: residual sum and sum_t w P_sm,t (packed, reusing S).
  T rs = T(0);
#pragma unroll
  for (int e = 0; e < NC; ++e) S[e] = T(0);
  for (int t0 = 0; t0 < T_; t0 += kTC) {
    const int nt = min(kTC, T_ - t0);
    __syncthreads();
    stage<T, K>(sE, sM, Ef, Psm, t0, nt);
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const size_t off = (size_t)(t0 + tt) * N + i;
      const T w = mask[off];
      const T yz = w > T(0) ? nan_to_num(Y[off]) : T(0);
      T fit = T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) fit += sE[tt][j] * lam[j];
      const T v = yz - fit;
      rs += w * (v * v);
#pragma unroll
      for (int a = 0; a < K; ++a)
#pragma unroll
        for (int c = 0; c <= a; ++c) S[tri(a, c)] += w * sM[tt][a * K + c];
    }
  }
  if (!live) return;
  T smear = T(0);
#pragma unroll
  for (int a = 0; a < K; ++a) {
    T row = T(0);
#pragma unroll
    for (int c = 0; c < K; ++c)
      row += (c <= a ? S[tri(a, c)] : S[tri(c, a)]) * lam[c];
    smear += lam[a] * row;
  }
  const T counts = cnt > T(1) ? cnt : T(1);
  const T r = (rs + smear) / counts;
#pragma unroll
  for (int a = 0; a < K; ++a) Lam[(size_t)i * K + a] = lam[a];
  R[i] = r > r_floor ? r : r_floor;
}

template <typename T>
static int launch(const T* Y, const T* mask, const T* Ef, const T* EffT,
                  const T* Psm, T* Lam, T* R, int B, int T_, int N, int k,
                  double r_floor, double lam_ridge, cudaStream_t stream) {
  if (N <= 0 || B <= 0) return (int)cudaGetLastError();
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  DFM_DISPATCH_K(k, mstep_rows_kernel<T, K><<<grid, kThreads, 0, stream>>>(
                        Y, mask, Ef, EffT, Psm, Lam, R, T_, N, (T)r_floor,
                        (T)lam_ridge))
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_MSTEP_ENTRIES(SFX, T)                                              \
  int mstep_rows_##SFX(const T* Y, const T* mask, const T* Ef,               \
                       const T* EffT, const T* Psm, T* Lam, T* R, int T_,    \
                       int N, int k, double r_floor, double lam_ridge,       \
                       void* stream) {                                       \
    return launch<T>(Y, mask, Ef, EffT, Psm, Lam, R, 1, T_, N, k, r_floor,   \
                     lam_ridge, (cudaStream_t)stream);                       \
  }                                                                          \
  int batched_mstep_rows_##SFX(const T* Y, const T* mask, const T* Ef,       \
                               const T* EffT, const T* Psm, T* Lam, T* R,    \
                               int B, int T_, int N, int k, double r_floor,  \
                               void* stream) {                               \
    return launch<T>(Y, mask, Ef, EffT, Psm, Lam, R, B, T_, N, k, r_floor,   \
                     0.0, (cudaStream_t)stream);                             \
  }
#if DFM_WANT_F32
DFM_MSTEP_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_MSTEP_ENTRIES(f64, double)
#endif
}
