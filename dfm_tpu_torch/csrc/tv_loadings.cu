// K11: the loading filter and smoother of the time-varying-loadings family.
//
// Replaces dfm_tpu/models/tv_loadings.py:loading_pass (line 128): N
// independent k-dim random-walk loading chains lam_n,t = lam_n,t-1 + xi,
// Var xi = tau2_n I, each observed through the scalar y_tn = f_t' lam_n,t
// + eps, Var eps = R_n, given the factor path F (T, k).
//
// K11-fwd (loading_filter), the forward scan fstep (lines 148-173), per
// series and step:
//   P_pred = P + tau2 I;  Pf = P_pred f;  S = f'Pf + R;  K = w Pf / S
//   v = y - lam'f;  lam_f = lam + K v;  P_f = sym(P_pred - K Pf')
// from lam = Lam0_n, P = (1e-2 + tau2) I, with y = w nan_to_num(y) (w = 1
// unmasked).  It writes lam_f (T, N, k) and P_f (T, N, k, k).  The JAX scan
// also stacks the predicted moments; for a random walk they are
// lam_pred[t+1] = lam_f[t] and P_pred[t+1] = P_f[t] + tau2 I, which K11-bwd
// recomputes with the same float operations, so they never reach memory.
//
// K11-bwd (loading_smoother), the reverse scan bstep (lines 179-211): from
// (lam_f[T-1], P_f[T-1]) down to t = 0,
//   J' = chol_solve(chol(P_pred[t+1]), P_f[t])
//   lam_s = lam_f[t] + J (lam_n - lam_f[t])
//   P_s = sym(P_f[t] + J (P_n - P_pred[t+1]) J')
//   incr += |lam_n - lam_s|^2 + tr P_n + tr P_s - 2 tr(P_n J')
// writing lam_sm (T, N, k), P_sm (T, N, k, k) (row T-1 is the filtered
// one) and incr (N,).  The Cholesky is the textbook one with no clamp, as
// chol_unrolled: an indefinite pivot gives NaN, as both JAX branches do
// (k <= 8 unrolled, above it jnp.linalg.cholesky); one routine serves
// every k <= DFM_KMAX.
//
// Bound on the H100: bytes.  K11-fwd writes (T, N, k + k^2) values and
// reads Y (and the mask) once: 126 MB in f32 at T = 300, N = 5,000, k = 4
// (~38 us at 3.35 TB/s); K11-bwd reads them back and writes as much again
// (~72 us), against ~(4 k^2 + 6 k) operations a series and step forward
// and ~(3 k^3 + 4 k^2) backward.
//
// Design: one thread a series, the T loop inside the kernel, the series'
// k x k state in registers (k is a template constant).  The backward
// pass's state and work matrices spill to local memory from k = 8 in f32
// and k = 6 in f64 (nvcc -Xptxas -v; the forward pass at k = 16 and from k = 11),
// so past k = 8 its O(k^3) loop nests unroll only their inner loops: full
// unrolling would grow the code, and the build, as k^3.
// f_t is one (k,) row that every thread of a step reads: it comes through
// the read-only cache as a broadcast.  A block holds kThreads = 64 series,
// so N = 5,000 series spread over 79 blocks, one per SM, instead of 20
// blocks of 256: the pass is a serial chain a thread, and with at most
// N / 32 = 157 warps on the card, a block a thread group on as many SMs
// as possible is what the card can give.  Each thread writes its (k, k)
// block of a step contiguously: a warp's stores of a step cover one
// contiguous 32 k^2 run of P.
//
// Past k = 16 K11 runs its generic kernels, in tv_loadings_gen.cu: a
// source of its own, so the k <= 16 kernels build apart, and first; and
// K11-bwd's sixteen instantiations (the bulk of the compile: k^3 loop
// nests) are tv_smoother.cu, so the two halves build side by side.
#include "common.cuh"

constexpr int kThreads = 64;

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
loading_filter_kernel(const T* __restrict__ Y, const T* __restrict__ mask,
                      const T* __restrict__ F, const T* __restrict__ Lam0,
                      const T* __restrict__ tau2, const T* __restrict__ R,
                      T* __restrict__ lam_f, T* __restrict__ P_f, int T_,
                      int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const T t2 = tau2[n], r = R[n];
  T lam[K], P[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    lam[i] = Lam0[(size_t)n * K + i];
#pragma unroll
    for (int j = 0; j < K; ++j) P[i][j] = i == j ? T(1e-2) + t2 : T(0);
  }
  for (int t = 0; t < T_; ++t) {
    T f[K];
#pragma unroll
    for (int j = 0; j < K; ++j) f[j] = __ldg(F + (size_t)t * K + j);
    const size_t tn = (size_t)t * N + n;
    T y = nan_to_num(Y[tn]);
    T w = T(1);
    if (mask) {
      w = mask[tn];
      y *= w;
    }
#pragma unroll
    for (int i = 0; i < K; ++i) P[i][i] += t2;            // P_pred
    T Pf[K];
    T S = T(0), fit = T(0);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) s += P[i][j] * f[j];
      Pf[i] = s;
      S += s * f[i];
      fit += lam[i] * f[i];
    }
    S += r;
    const T v = y - fit;
    T Kg[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      Kg[i] = w * Pf[i] / S;
      lam[i] += Kg[i] * v;
    }
    T M[K][K];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) M[i][j] = P[i][j] - Kg[i] * Pf[j];
    T* lo = lam_f + tn * K;
    T* Po = P_f + tn * K * K;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      lo[i] = lam[i];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        P[i][j] = T(0.5) * (M[i][j] + M[j][i]);
        Po[i * K + j] = P[i][j];
      }
    }
  }
}

template <typename T>
static int launch_filter(const T* Y, const T* mask, const T* F,
                         const T* Lam0, const T* tau2, const T* R, T* lam_f,
                         T* P_f, int T_, int N, int k, cudaStream_t stream) {
  if (T_ <= 0 || N <= 0) return (int)cudaGetLastError();
  const int blocks = (N + kThreads - 1) / kThreads;
  DFM_DISPATCH_K(k, loading_filter_kernel<T, K><<<blocks, kThreads, 0,
                                                  stream>>>(
                        Y, mask, F, Lam0, tau2, R, lam_f, P_f, T_, N))
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_TVL_ENTRIES(SFX, T)                                                \
  int loading_filter_##SFX(const T* Y, const T* mask, const T* F,            \
                           const T* Lam0, const T* tau2, const T* R,         \
                           T* lam_f, T* P_f, int T_, int N, int k,           \
                           void* stream) {                                   \
    return launch_filter<T>(Y, mask, F, Lam0, tau2, R, lam_f, P_f, T_, N, k, \
                            (cudaStream_t)stream);                           \
  }
#if DFM_WANT_F32
DFM_TVL_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_TVL_ENTRIES(f64, double)
#endif
}
