// K6b: the batched row-wise PSD solve of the batched M-step.
//
// Replaces dfm_tpu/estim/batched.py:_bsolve_rows (line 106), with its
// bchol / bchol_solve (lines 88-103): per problem lane b,
//   L_b = chol(sym(S_b) + jitter I)   (psd_cholesky's jitter, no clamp: an
//                                      indefinite S gives NaN)
//   X[b, i, :] = (L_b L_b')^{-1} V[b, i, :]   for every row i < n.
// batched_m_step calls it for the loadings (S_ff against the N rows of
// S_yf) and for A (S_lag against the k rows of S_cross).  R stays in torch
// (one row-wise dot with the hoisted Ysq, or with a ridge the full
// quadratic): it needs S_yf and Lam only, which the torch caller holds.
//
// Bound on the H100: bytes.  The kernel must read V and write X once (3.2
// MB each in f32 at B = 8, N = 10,000, k = 10) against ~2 k^2 flops a row.
//
// Design: grid (row blocks, B).  Thread 0 of each block factors its lane's
// k x k S into shared memory (~k^3 / 6 multiply-adds, k <= DFM_KMAX), then
// every thread solves one row in registers (k is a template constant), by
// forward and back substitution against the shared factor, and writes it.
// Neighbouring threads read neighbouring rows, k values apart.
//
// K6b-wide (batched_solve_rows_wide): the same solve at 16 < k <= 32, the
// batched M-steps' kernel there (fit_many, the k-grid, the rolling windows
// and the fleet's A rows past k = 16).  A row stays in registers, so the
// width is a template constant, taken in buckets KP in {20, 24, 28, 32} >= k
// (four instantiations a dtype, as K5b-wide's, not sixteen): S is padded
// with an identity block and each row of V with zero columns, which is
// exact (the factor is block diagonal, the padded unknowns solve to zero
// and are never written).  At k = 32 a serial factorization in one thread
// would be ~5,500 dependent multiply-adds, so warp 0 factors S with the
// one-warp Cholesky of warp_linalg.cuh (a column a step, a lane a row),
// leading dimension 33.  Bound: bytes, V read and X written once (6.4 MB
// each in f32 at B = 8, N = 10,000, k = 25) against ~2 k^2 flops a row.
//
// K6b-gen (batched_solve_rows_gen): the same solve at 32 < k <= 128, the
// batched M-steps' kernel there (fit_many, the k-grid, the rolling windows
// and the fleet's A rows past k = 32).  A row no longer fits in registers
// and a serial factorization would be ~170,000 dependent multiply-adds at
// k = 100, so one C call launches two kernels (the wrapper's launch counts
// both: kernels.DEVICE_LAUNCHES).  First, one block of
// GEN_THREADS a lane factors L_b = chol(sym(S_b) + jitter I) once, with
// cta_linalg.cuh's tiled sym and right-looking blocked Cholesky, into a
// (B, k, k) workspace the wrapper allocates (in L2).  Then a grid over
// (tiles of kRowTile rows, lanes) solves each tile in place in X: the tile
// is copied from V, then X L' = V and X L = Z by cta_trsm_right, 32-column
// blocks whose updates from the columns already solved are staged products
// over column panels of L, and whose 32 x 32 diagonal block of L sits in
// shared memory while a thread a row substitutes against it.  Bound: bytes,
// V read and X written once (16 MB at B = 4, N = 10,000, k = 50 in f32,
// ~0.005 ms) against ~2 k^2 flops a row (2e8 flops, ~0.003 ms at 67
// TFLOP/s).
#include "cta_linalg.cuh"

constexpr int kRowThreads = 128;

template <typename T, int K>
__global__ void __launch_bounds__(kRowThreads)
bsolve_rows_kernel(const T* __restrict__ S, const T* __restrict__ V,
                   T* __restrict__ X, int n) {
  __shared__ T L[K][K];
  const size_t pb = blockIdx.y;
  if (threadIdx.x == 0) {
    const T* Sb = S + pb * K * K;
    const T jit = dfm_jitter<T>();
    for (int a = 0; a < K; ++a)
      for (int c = 0; c <= a; ++c)
        L[a][c] = T(0.5) * (Sb[a * K + c] + Sb[c * K + a]) +
                  (a == c ? jit : T(0));
    for (int a = 0; a < K; ++a)
      for (int c = 0; c <= a; ++c) {
        T s = L[a][c];
        for (int m = 0; m < c; ++m) s -= L[a][m] * L[c][m];
        L[a][c] = a == c ? dfm_sqrt(s) : s / L[c][c];
      }
  }
  __syncthreads();
  const int i = blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= n) return;
  const size_t row = (pb * n + i) * K;
  T x[K];
#pragma unroll
  for (int a = 0; a < K; ++a) x[a] = V[row + a];
#pragma unroll
  for (int a = 0; a < K; ++a) {
    T s = x[a];
#pragma unroll
    for (int m = 0; m < a; ++m) s -= L[a][m] * x[m];
    x[a] = s / L[a][a];
  }
#pragma unroll
  for (int a = K - 1; a >= 0; --a) {
    T s = x[a];
#pragma unroll
    for (int m = a + 1; m < K; ++m) s -= L[m][a] * x[m];
    x[a] = s / L[a][a];
  }
#pragma unroll
  for (int a = 0; a < K; ++a) X[row + a] = x[a];
}

template <typename T, int KP>
__global__ void __launch_bounds__(kRowThreads)
bsolve_rows_wide_kernel(const T* __restrict__ S, const T* __restrict__ V,
                        T* __restrict__ X, int n, int k) {
  __shared__ T L[DFM_WIDE_KMAX][WIDE_LD];
  const size_t pb = blockIdx.y;
  if (threadIdx.x < 32) {
    const T* Sb = S + pb * k * k;
    const T jit = dfm_jitter<T>();
    for (int e = threadIdx.x; e < KP * KP; e += 32) {
      const int a = e / KP, c = e % KP;
      L[a][c] = a < k && c < k
                    ? T(0.5) * (Sb[a * k + c] + Sb[c * k + a]) +
                          (a == c ? jit : T(0))
                    : T(a == c ? 1 : 0);
    }
    __syncwarp();
    chol_inplace<T>(L, k);
  }
  __syncthreads();
  const int i = blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= n) return;
  const size_t row = (pb * n + i) * k;
  T x[KP];
#pragma unroll
  for (int a = 0; a < KP; ++a) x[a] = a < k ? V[row + a] : T(0);
#pragma unroll
  for (int a = 0; a < KP; ++a) {
    T s = x[a];
#pragma unroll
    for (int m = 0; m < a; ++m) s -= L[a][m] * x[m];
    x[a] = s / L[a][a];
  }
#pragma unroll
  for (int a = KP - 1; a >= 0; --a) {
    T s = x[a];
#pragma unroll
    for (int m = a + 1; m < KP; ++m) s -= L[m][a] * x[m];
    x[a] = s / L[a][a];
  }
#pragma unroll
  for (int a = 0; a < KP; ++a)
    if (a < k) X[row + a] = x[a];
}

template <typename T, int KP>
static int launch_wide_kp(const T* S, const T* V, T* X, int B, int n, int k,
                          cudaStream_t stream) {
  const dim3 grid((n + kRowThreads - 1) / kRowThreads, B);
  bsolve_rows_wide_kernel<T, KP><<<grid, kRowThreads, 0, stream>>>(S, V, X,
                                                                   n, k);
  return (int)cudaGetLastError();
}

// k in 1 .. DFM_WIDE_KMAX, run at the bucket KP in {20, 24, 28, 32} >= k.
template <typename T>
static int launch_wide(const T* S, const T* V, T* X, int B, int n, int k,
                       cudaStream_t stream) {
  if (k < 1 || k > DFM_WIDE_KMAX) return (int)cudaErrorInvalidValue;
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  if (k <= 20) return launch_wide_kp<T, 20>(S, V, X, B, n, k, stream);
  if (k <= 24) return launch_wide_kp<T, 24>(S, V, X, B, n, k, stream);
  if (k <= 28) return launch_wide_kp<T, 28>(S, V, X, B, n, k, stream);
  return launch_wide_kp<T, 32>(S, V, X, B, n, k, stream);
}

template <typename T>
static int launch(const T* S, const T* V, T* X, int B, int n, int k,
                  cudaStream_t stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  const dim3 grid((n + kRowThreads - 1) / kRowThreads, B);
  DFM_DISPATCH_K(k, bsolve_rows_kernel<T, K><<<grid, kRowThreads, 0, stream>>>(
                        S, V, X, n))
  return (int)cudaGetLastError();
}

constexpr int kRowTile = DFM_GEN_KMAX;   // rows a block of the solve

// Shared scratch of the tile solve: cta_trsm_right's products (kRowTile x
// 32 outputs over 32-deep slices, two stages) or its diagonal block and
// rows.
constexpr int solve_scratch() {
  return gen_max(2 * GEN_TB * (kRowTile + 1 + GEN_TB + 1),
                 (GEN_TB + kRowTile) * WIDE_LD);
}

// L_b = chol(sym(S_b) + jitter I) (psd_cholesky), a block a lane.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
bsolve_factor_gen_kernel(const T* S, T* L, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const size_t pb = blockIdx.x, kk = (size_t)k * k;
  cta_sym<T>(L + pb * kk, S + pb * kk, k, true, sm);
  cta_potrf<T>(L + pb * kk, k, sm);
}

// X[b, r0 : r0 + m] = V[b, r0 : r0 + m] (L_b L_b')^{-1}: blockIdx.x the
// tile of rows, blockIdx.y the lane.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
bsolve_rows_gen_kernel(const T* V, T* X, const T* L, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const size_t pb = blockIdx.y;
  const int r0 = blockIdx.x * kRowTile, m = min(kRowTile, n - r0);
  const T* Vt = V + (pb * n + r0) * k;
  T* Xt = X + (pb * n + r0) * k;
  const T* Lb = L + pb * k * k;
  cta_batched(
      m * k, [&](int e) { return Vt[e]; }, [&](int e, T v) { Xt[e] = v; });
  cta_trsm_right<T>(Xt, m, Lb, k, true, sm);       // X L' = V
  cta_trsm_right<T>(Xt, m, Lb, k, false, sm);      // X L = Z
}

// Both kernels on the stream, 1 <= k <= DFM_GEN_KMAX.
template <typename T>
static int launch_gen(const T* S, const T* V, T* X, T* L, int B, int n,
                      int k, cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const size_t fbytes = sizeof(T) * (size_t)gen_scratch(k);
  cudaError_t e = dfm_smem_optin(bsolve_factor_gen_kernel<T>, fbytes);
  if (e != cudaSuccess) return (int)e;
  bsolve_factor_gen_kernel<T><<<B, GEN_THREADS, fbytes, stream>>>(S, L, k);
  e = cudaGetLastError();
  if (e != cudaSuccess || n <= 0) return (int)e;
  const size_t sbytes = sizeof(T) * (size_t)solve_scratch();
  e = dfm_smem_optin(bsolve_rows_gen_kernel<T>, sbytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kRowTile - 1) / kRowTile, B);
  bsolve_rows_gen_kernel<T><<<grid, GEN_THREADS, sbytes, stream>>>(V, X, L,
                                                                  n, k);
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_BSOLVE_ENTRIES(SFX, T)                                             \
  int batched_solve_rows_##SFX(const T* S, const T* V, T* X, int B, int n,   \
                               int k, void* stream) {                        \
    return launch<T>(S, V, X, B, n, k, (cudaStream_t)stream);                \
  }                                                                          \
  int batched_solve_rows_wide_##SFX(const T* S, const T* V, T* X, int B,     \
                                    int n, int k, void* stream) {            \
    return launch_wide<T>(S, V, X, B, n, k, (cudaStream_t)stream);           \
  }                                                                          \
  int batched_solve_rows_gen_##SFX(const T* S, const T* V, T* X, T* work,    \
                                   int B, int n, int k, void* stream) {      \
    return launch_gen<T>(S, V, X, work, B, n, k, (cudaStream_t)stream);      \
  }
#if DFM_WANT_F32
DFM_BSOLVE_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_BSOLVE_ENTRIES(f64, double)
#endif
}
