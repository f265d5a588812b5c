// K1: the innovation quadratic of the information-form loglik.
//
// Replaces dfm_tpu/ssm/info_filter.py:quad_local (line 159):
//   quad_R[t] = sum_n w_tn * (y_tn - lam_n . x_t)^2 / R_n
// with the (T, N) -> (T,) sum accumulated in double and, when masked, the
// residual of a missing entry zeroed (w * nan_to_num(v)) before it is
// squared.  The JAX routine also returns the residual panel V, but its only
// caller drops it, so here V never reaches device memory.
//
// K1b, the batched twin, is the same kernel over B problem lanes (grid
// (T, B), each lane's tensors batch-major at a lane stride, unmasked): it
// replaces the residual pass of dfm_tpu/estim/batched.py:_batched_loglik
// (lines 419-421), whose (B, T, N) residual V the JAX function
// materializes and this kernel never stores, and also writes
// U[b, t] = b_t - C_b x_pred,t (line 421, C symmetric) from the x_t it
// holds in shared memory.
//
// K1b-m, the fleet's masked twin, is the same kernel with the mask and a
// per-step C (c_lane = T k^2, c_tstride = k^2): it replaces the residual
// pass of dfm_tpu/estim/batched.py:_batched_loglik_masked (lines 656-659),
// quad[b, t] = sum_n w (y - lam . x_pred)^2 / R and U = b - C_t x_pred.
//
// K1-tv, the time-varying-loadings twin (quad_terms_kernel below), replaces
// the residual pass of dfm_tpu/models/tv_loadings.py:factor_pass_tv (lines
// 111-117; the same lines in _tvl_loglik_impl, 270-275) with per-step
// loadings Lam_t (T, N, k):
//   v = y - lam_t,n . x_pred,t  (masked: w nan_to_num(v)),  vr = v / R_n
//   quad_R[t] = sum_n v vr      (f64 sum)
//   U[t]      = sum_n vr lam_t,n  (k,)
// U comes from the residual, as the JAX function computes it (not from
// b - C x, equal only in exact arithmetic).  Masked and unmasked, one
// kernel.  Bound: bytes, Y (and the mask) and the loadings read once, 30
// MB in f32 at T = 300, N = 5,000, k = 4 (~9 us at 3.35 TB/s).  Design:
// K1's, with k a template constant so each thread's k partials of U stay
// in registers; the block reduces them with shuffles and shared memory,
// in the compute type, and the quadratic in double.
//
// K12 = K1-wide, the same kernel (quad_terms_kernel) over static loadings
// (a loading time stride of 0) at k <= DFM_WIDE_KMAX = 32: it replaces
// dfm_tpu/ssm/info_filter.py:loglik_terms_local (line 139) where
// dfm_tpu/models/mixed_freq.py:mf_em_core runs it on the augmented loadings
// (lines 185-186; m = 25 at S3): quad_R (f64 sum) and U = sum_n (v / R_n)
// lam_n from the masked residual at x_pred, as K1-tv.  The lone quad_local
// wrapper takes it (with no U) for 16 < k <= 32.  Bound: bytes, Y, the mask
// and the loadings read once, 4.8 MB in f32 at S3 (T = 300, N = 2,000).
//
// K1b-wide and K1b-m-wide (batched_quad_wide, batched_quad_masked_wide):
// K1b and K1b-m at 16 < k <= 32, the batched wrappers' kernels there.  They
// replace the same residual passes at wide k (fit_many, the k-grid and the
// rolling windows past k = 16; a fleet bucket padded past 16).  K1b's body
// already takes a runtime k and forms U = b - C x_pred from the x_t it
// holds (not from the residual, as K1-wide does), so the wide twin is that
// body with its shared x_t sized DFM_WIDE_KMAX: one more instantiation a
// dtype, not K1-wide's 32 unrolled widths.  Bound: bytes, Y (and the mask)
// read once, 160 MB at B = 8, T = 500, N = 10,000 in f32 (K1b-m-wide: 480
// MB at B = 6, T = 1,000).
//
// K1-gen (quad_gen_kernel below): K1-wide at 32 < k <= DFM_GEN_KMAX = 128,
// which the lone quad_local (no U) and loglik_terms_local (quad_R and U)
// wrappers take there: it replaces dfm_tpu/ssm/info_filter.py:quad_local
// (line 159) and loglik_terms_local (line 139) at those widths (the lone
// info and lowrank fits past 32; the mixed-frequency seq route at m > 32).
// K1-wide keeps a thread's k partials of U in registers, one unrolled width
// a k; here k is a runtime value, so the block stages 32-series slices of
// Lam (k + 1 wide) in shared memory with x_t (capacity 128): eight threads
// a series form the slice's fits (k-strided partial dots, reduced with
// shuffles), one thread a series squares and scales its residual into the
// double sum, and thread j < k adds the slice's (v / R_n) lam_n[j] to U_j.
// Bound: bytes, Y (and the mask) and Lam read once, 40 MB masked in f32 at
// T = 500, N = 10,000 (~0.012 ms), against 2 T N (2 k + 3) ~ 2e9 flops at
// k = 100 (~0.03 ms): operations; each block re-reads Lam from L2.
//
// K1b-gen and K1b-m-gen (batched_quad_gen, batched_quad_masked_gen): the
// K1-gen kernel with a lane grid dimension (grid (T, B), each lane's
// tensors batch-major at a lane stride; the lone entry launches B = 1), the
// batched wrappers' kernels at 32 < k <= 128.  They replace the residual
// passes of dfm_tpu/estim/batched.py:_batched_loglik (lines 419-421, C
// static per lane) and _batched_loglik_masked (lines 656-659, a per-step
// C_t) there: quad_R with an f64 sum and U = b_t - C_t x_pred, formed from
// the statistics as the batched twins do (a warp a row of C_t, coalesced),
// not from the residual as K1-gen forms it.  Bound: bytes, Y (and the
// mask) read once, 80 MB at B = 4, T = 500, N = 10,000 in f32 (~0.024 ms;
// K1b-m-gen 160 MB at B = 2, T = 1,000), against 2 B T N (k + 3) flops,
// ~0.021 ms at k = 50; each block re-reads its lane's Lam from L2.
//
// K1-tv-wide and K1-tv-gen (tvl_quad_wide, tvl_quad_gen): K1-tv's residual
// pass (quad_R with an f64 sum, U from the residual) at 16 < k <= 32, on
// quad_terms_kernel with a loading time stride of N k (the unrolled widths
// K1-wide already instantiates), and at 32 < k <= 128 on K1-gen's kernel
// with the same stride.  They replace dfm_tpu/models/tv_loadings.py:
// factor_pass_tv's residual pass (lines 111-117) there.  Bound: bytes, Y
// (and the mask) and the per-step loadings read once, 150 MB in f32 at S4
// and k = 25 (~0.045 ms), 300 MB at k = 50.
//
// Bound on the H100: bytes.  The kernel must read Y (and the mask) once:
// 20 MB unmasked, 40 MB masked in f32 at T = 500, N = 10,000 (K1b: 160 MB
// at B = 8), against ~2(k+2) flops per entry.
//
// Design: one block per time row (and lane).  Each thread walks series n
// with a stride of blockDim.x (coalesced reads of the row of Y and of the
// mask), forms the k-dot with x_t held in shared memory, squares and scales
// in the compute type, and adds the term to a double accumulator; the block
// then reduces in double.
#include "common.cuh"

// KX: the capacity of the shared x_t (DFM_KMAX, or DFM_WIDE_KMAX for the
// batched wide twins).
template <typename T, int KX>
__global__ void quad_local_kernel(const T* __restrict__ Y,
                                  const T* __restrict__ Lam,
                                  const T* __restrict__ R,
                                  const T* __restrict__ x_pred,
                                  const T* __restrict__ mask,
                                  const T* __restrict__ bvec,
                                  const T* __restrict__ C, int c_lane,
                                  int c_tstride, double* __restrict__ out,
                                  T* __restrict__ U, int N, int k) {
  __shared__ T xs[KX];
  __shared__ double red[32];
  const int t = blockIdx.x, T_ = gridDim.x;
  // This block's problem lane.
  const size_t pb = blockIdx.y, tn = (size_t)T_ * N;
  Y += pb * tn;
  if (mask) mask += pb * tn;
  Lam += pb * N * k;
  R += pb * N;
  x_pred += pb * T_ * k;
  out += pb * T_;
  if (threadIdx.x < k) xs[threadIdx.x] = x_pred[(size_t)t * k + threadIdx.x];
  __syncthreads();
  if (U && threadIdx.x < k) {
    const int j = threadIdx.x;
    const T* Cb = C + pb * c_lane + (size_t)t * c_tstride;
    T s = T(0);
    for (int l = 0; l < k; ++l) s += Cb[j * k + l] * xs[l];
    const size_t o = (pb * T_ + t) * k + j;
    U[o] = bvec[o] - s;
  }
  const T* y = Y + (size_t)t * N;
  const T* w = mask ? mask + (size_t)t * N : nullptr;
  double acc = 0.0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const T* lam = Lam + (size_t)n * k;
    T fit = T(0);
    for (int j = 0; j < k; ++j) fit += lam[j] * xs[j];
    T v = y[n] - fit;
    if (w) v = w[n] * nan_to_num(v);
    acc += (double)(v * (v / R[n]));
  }
  acc = block_reduce_sum(acc, red);
  if (threadIdx.x == 0) out[t] = acc;
}

// K1-tv and K1-wide: Lam_t advances lam_tstride values a step (N K for
// per-step loadings, 0 for static ones); U may be null (quad_R only).
template <typename T, int K>
__global__ void __launch_bounds__(256)
quad_terms_kernel(const T* __restrict__ Y, const T* __restrict__ Lam_t,
                  const T* __restrict__ R, const T* __restrict__ x_pred,
                  const T* __restrict__ mask, double* __restrict__ out,
                  T* __restrict__ U, int N, size_t lam_tstride) {
  constexpr int kW = 256 / 32;
  __shared__ T xs[K];
  __shared__ T part[kW][K];
  __shared__ double red[32];
  const int t = blockIdx.x;
  if (threadIdx.x < K) xs[threadIdx.x] = x_pred[(size_t)t * K + threadIdx.x];
  __syncthreads();
  const T* y = Y + (size_t)t * N;
  const T* w = mask ? mask + (size_t)t * N : nullptr;
  const T* lam_row = Lam_t + (size_t)t * lam_tstride;
  double acc = 0.0;
  T u[K];
#pragma unroll
  for (int j = 0; j < K; ++j) u[j] = T(0);
  for (int n = threadIdx.x; n < N; n += 256) {
    T lam[K];
    T fit = T(0);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      lam[j] = lam_row[(size_t)n * K + j];
      fit += lam[j] * xs[j];
    }
    T v = y[n] - fit;
    if (w) v = w[n] * nan_to_num(v);
    const T vr = v / R[n];
    acc += (double)(v * vr);
#pragma unroll
    for (int j = 0; j < K; ++j) u[j] += vr * lam[j];
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T v = u[j];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) part[wid][j] = v;
  }
  acc = block_reduce_sum(acc, red);   // its __syncthreads orders part too
  if (threadIdx.x == 0) out[t] = acc;
  if (U && threadIdx.x < K) {
    T s = T(0);
    for (int q = 0; q < kW; ++q) s += part[q][threadIdx.x];
    U[(size_t)t * K + threadIdx.x] = s;
  }
}

template <typename T>
static int launch_tvl(const T* Y, const T* Lam_t, const T* R,
                      const T* x_pred, const T* mask, double* out, T* U,
                      int T_, int N, int k, cudaStream_t stream) {
  if (T_ <= 0) return (int)cudaGetLastError();
  DFM_DISPATCH_K(k, quad_terms_kernel<T, K><<<T_, 256, 0, stream>>>(
                        Y, Lam_t, R, x_pred, mask, out, U, N,
                        (size_t)N * K))
  return (int)cudaGetLastError();
}

// K1-wide (static loadings) and K1-tv-wide (``tv``: per-step loadings, a
// time stride of N K).
template <typename T>
static int launch_wide(const T* Y, const T* Lam, const T* R, const T* x_pred,
                       const T* mask, double* out, T* U, int T_, int N,
                       int k, bool tv, cudaStream_t stream) {
  if (T_ <= 0) return (int)cudaGetLastError();
  DFM_DISPATCH_WIDE_K(k, quad_terms_kernel<T, K><<<T_, 256, 0, stream>>>(
                             Y, Lam, R, x_pred, mask, out, U, N,
                             tv ? (size_t)N * K : 0))
  return (int)cudaGetLastError();
}

constexpr int kGenSlice = 32;     // series a staged slice, 8 threads each

// quad_R (f64 sum) and, when U is given, U at any k <= DFM_GEN_KMAX: from
// the residual (the lone K1-gen), or U = b_t - C_t x_t when ``bvec`` is
// given (K1b-gen, K1b-m-gen: C_t at c_lane and c_tstride).  The mask may be
// null (unmasked); blockIdx.y is the lane (B = 1 for the lone kernel); Lam
// advances lam_tstride values a step (N k for K1-tv-gen's per-step
// loadings, else 0).
template <typename T>
__global__ void __launch_bounds__(256)
quad_gen_kernel(const T* __restrict__ Y, const T* __restrict__ Lam,
                const T* __restrict__ R, const T* __restrict__ x_pred,
                const T* __restrict__ mask, const T* __restrict__ bvec,
                const T* __restrict__ C, int c_lane, int c_tstride,
                double* __restrict__ out, T* __restrict__ U, int N, int k,
                size_t lam_tstride) {
  __shared__ T xs[DFM_GEN_KMAX];
  __shared__ T lam[kGenSlice][DFM_GEN_KMAX + 1];
  __shared__ T vr[kGenSlice];
  __shared__ double red[32];
  const int t = blockIdx.x, tid = threadIdx.x, T_ = gridDim.x;
  const int s = tid >> 3, part = tid & 7;
  // This block's problem lane.
  const size_t pb = blockIdx.y, tn = (size_t)T_ * N;
  Y += pb * tn;
  if (mask) mask += pb * tn;
  Lam += pb * (size_t)N * k + t * lam_tstride;
  R += pb * N;
  x_pred += pb * (size_t)T_ * k;
  out += pb * T_;
  if (U) U += pb * (size_t)T_ * k;
  if (tid < k) xs[tid] = x_pred[(size_t)t * k + tid];
  const bool u_res = U && !bvec;
  if (U && bvec) {
    // U = b_t - C_t x_t, a warp a row of C_t (coalesced), then the warp's
    // shuffle sum.
    __syncthreads();
    const T* Ct = C + pb * c_lane + (size_t)t * c_tstride;
    const T* bt = bvec + (pb * T_ + t) * k;
    const int lane = tid & 31;
    for (int j = tid >> 5; j < k; j += 256 / 32) {
      T v = T(0);
      for (int l = lane; l < k; l += 32) v += Ct[(size_t)j * k + l] * xs[l];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) U[(size_t)t * k + j] = bt[j] - v;
    }
  }
  const T* y = Y + (size_t)t * N;
  const T* w = mask ? mask + (size_t)t * N : nullptr;
  double acc = 0.0;
  T u = T(0);
  for (int n0 = 0; n0 < N; n0 += kGenSlice) {
    const int nt = min(kGenSlice, N - n0);
    __syncthreads();                       // the previous slice is consumed
    for (int e = tid; e < nt * k; e += 256)
      lam[e / k][e % k] = Lam[(size_t)n0 * k + e];
    __syncthreads();
    T fit = T(0);
    if (s < nt)
      for (int j = part; j < k; j += 8) fit += lam[s][j] * xs[j];
    for (int o = 4; o > 0; o >>= 1)
      fit += __shfl_xor_sync(0xffffffffu, fit, o);
    if (s < nt && part == 0) {
      const int n = n0 + s;
      T v = y[n] - fit;
      if (w) v = w[n] * nan_to_num(v);
      const T q = v / R[n];
      acc += (double)(v * q);
      vr[s] = q;
    }
    __syncthreads();
    if (u_res && tid < k)
      for (int q = 0; q < nt; ++q) u += vr[q] * lam[q][tid];
  }
  acc = block_reduce_sum(acc, red);
  if (tid == 0) out[t] = acc;
  if (u_res && tid < k) U[(size_t)t * k + tid] = u;
}

template <typename T>
static int launch_gen(const T* Y, const T* Lam, const T* R, const T* x_pred,
                      const T* mask, const T* bvec, const T* C, int c_lane,
                      int c_tstride, double* out, T* U, int B, int T_, int N,
                      int k, size_t lam_tstride, cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX) return (int)cudaErrorInvalidValue;
  if (B > 0 && T_ > 0)
    quad_gen_kernel<T><<<dim3(T_, B), 256, 0, stream>>>(
        Y, Lam, R, x_pred, mask, bvec, C, c_lane, c_tstride, out, U, N, k,
        lam_tstride);
  return (int)cudaGetLastError();
}

template <typename T, int KX = DFM_KMAX>
static int launch(const T* Y, const T* Lam, const T* R, const T* x_pred,
                  const T* mask, const T* bvec, const T* C, int c_lane,
                  int c_tstride, double* out, T* U, int B, int T_, int N,
                  int k, cudaStream_t stream) {
  if (k < 1 || k > KX) return (int)cudaErrorInvalidValue;
  if (B > 0 && T_ > 0)
    quad_local_kernel<T, KX><<<dim3(T_, B), 256, 0, stream>>>(
        Y, Lam, R, x_pred, mask, bvec, C, c_lane, c_tstride, out, U, N, k);
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_QUAD_ENTRIES(SFX, T)                                               \
  int quad_local_##SFX(const T* Y, const T* Lam, const T* R,                 \
                       const T* x_pred, const T* mask, double* out, int T_,  \
                       int N, int k, void* stream) {                         \
    return launch<T>(Y, Lam, R, x_pred, mask, nullptr, nullptr, 0, 0, out,   \
                     nullptr, 1, T_, N, k, (cudaStream_t)stream);            \
  }                                                                          \
  int tvl_quad_##SFX(const T* Y, const T* Lam_t, const T* R,                 \
                     const T* x_pred, const T* mask, double* out, T* U,      \
                     int T_, int N, int k, void* stream) {                   \
    return launch_tvl<T>(Y, Lam_t, R, x_pred, mask, out, U, T_, N, k,        \
                         (cudaStream_t)stream);                              \
  }                                                                          \
  int batched_quad_##SFX(const T* Y, const T* Lam, const T* R,               \
                         const T* x_pred, const T* bvec, const T* C,         \
                         double* out, T* U, int B, int T_, int N, int k,     \
                         void* stream) {                                     \
    return launch<T>(Y, Lam, R, x_pred, nullptr, bvec, C, k * k, 0, out, U,  \
                     B, T_, N, k, (cudaStream_t)stream);                     \
  }                                                                          \
  int batched_quad_masked_##SFX(const T* Y, const T* Lam, const T* R,        \
                                const T* x_pred, const T* mask,              \
                                const T* bvec, const T* C, double* out,      \
                                T* U, int B, int T_, int N, int k,           \
                                void* stream) {                              \
    return launch<T>(Y, Lam, R, x_pred, mask, bvec, C, T_ * k * k, k * k,    \
                     out, U, B, T_, N, k, (cudaStream_t)stream);             \
  }                                                                          \
  int batched_quad_wide_##SFX(const T* Y, const T* Lam, const T* R,          \
                              const T* x_pred, const T* bvec, const T* C,    \
                              double* out, T* U, int B, int T_, int N,       \
                              int k, void* stream) {                         \
    return launch<T, DFM_WIDE_KMAX>(Y, Lam, R, x_pred, nullptr, bvec, C,     \
                                    k * k, 0, out, U, B, T_, N, k,           \
                                    (cudaStream_t)stream);                   \
  }                                                                          \
  int batched_quad_masked_wide_##SFX(const T* Y, const T* Lam, const T* R,   \
                                     const T* x_pred, const T* mask,         \
                                     const T* bvec, const T* C, double* out, \
                                     T* U, int B, int T_, int N, int k,      \
                                     void* stream) {                         \
    return launch<T, DFM_WIDE_KMAX>(Y, Lam, R, x_pred, mask, bvec, C,        \
                                    T_ * k * k, k * k, out, U, B, T_, N, k,  \
                                    (cudaStream_t)stream);                   \
  }                                                                          \
  int quad_local_wide_##SFX(const T* Y, const T* Lam, const T* R,            \
                            const T* x_pred, const T* mask, double* out,     \
                            T* U, int T_, int N, int k, void* stream) {      \
    return launch_wide<T>(Y, Lam, R, x_pred, mask, out, U, T_, N, k, false,  \
                          (cudaStream_t)stream);                             \
  }                                                                          \
  int quad_local_gen_##SFX(const T* Y, const T* Lam, const T* R,             \
                           const T* x_pred, const T* mask, double* out,      \
                           T* U, int T_, int N, int k, void* stream) {       \
    return launch_gen<T>(Y, Lam, R, x_pred, mask, nullptr, nullptr, 0, 0,    \
                         out, U, 1, T_, N, k, 0, (cudaStream_t)stream);      \
  }                                                                          \
  int batched_quad_gen_##SFX(const T* Y, const T* Lam, const T* R,           \
                             const T* x_pred, const T* bvec, const T* C,     \
                             double* out, T* U, int B, int T_, int N, int k, \
                             void* stream) {                                 \
    return launch_gen<T>(Y, Lam, R, x_pred, nullptr, bvec, C, k * k, 0, out, \
                         U, B, T_, N, k, 0, (cudaStream_t)stream);           \
  }                                                                          \
  int batched_quad_masked_gen_##SFX(const T* Y, const T* Lam, const T* R,    \
                                    const T* x_pred, const T* mask,          \
                                    const T* bvec, const T* C, double* out,  \
                                    T* U, int B, int T_, int N, int k,       \
                                    void* stream) {                          \
    return launch_gen<T>(Y, Lam, R, x_pred, mask, bvec, C, T_ * k * k,       \
                         k * k, out, U, B, T_, N, k, 0,                      \
                         (cudaStream_t)stream);                              \
  }                                                                          \
  int tvl_quad_wide_##SFX(const T* Y, const T* Lam_t, const T* R,            \
                          const T* x_pred, const T* mask, double* out, T* U, \
                          int T_, int N, int k, void* stream) {              \
    return launch_wide<T>(Y, Lam_t, R, x_pred, mask, out, U, T_, N, k, true, \
                          (cudaStream_t)stream);                             \
  }                                                                          \
  int tvl_quad_gen_##SFX(const T* Y, const T* Lam_t, const T* R,             \
                         const T* x_pred, const T* mask, double* out, T* U,  \
                         int T_, int N, int k, void* stream) {               \
    return launch_gen<T>(Y, Lam_t, R, x_pred, mask, nullptr, nullptr, 0, 0,  \
                         out, U, 1, T_, N, k, (size_t)N * k,                 \
                         (cudaStream_t)stream);                              \
  }
#if DFM_WANT_F32
DFM_QUAD_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_QUAD_ENTRIES(f64, double)
#endif
}
