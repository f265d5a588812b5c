// K5b: the steady-state engine's mean recursions, x_t = M_t x_{t-1} + d_t,
// in one launch of one CTA.
//
// Replaces dfm_tpu/ops/scan.py:affine_const_prefix (line 39) together with
// the exact-coefficient head scans of dfm_tpu/ssm/steady.py (lines 183-191
// and 243-245): the JAX engine runs the first tau steps as a sequential
// lax.scan and the frozen tail as log2(T) rounds of shift-doubling.  Here
// one kernel runs the whole recursion over t in [0, T):
//   forward:  x_0 = xb,      x_t = M_t x_{t-1} + d_t   for t = 1 .. T-1
//   reverse:  x_{T-1} = xb,  x_t = M_t x_{t+1} + d_t   for t = T-2 .. 0
// with M_t = Mh[t] for t < h (the exact head) and the constant M after.
// d has T rows; the boundary row of d is not read.
//
// Bound on the H100: neither bytes (~2 T k values) nor operations (2 T k^2
// flops): a plain sequential chain costs T dependent k x k matrix-vector
// products.  Design: a chunked scan.  Each of AF_WARPS warps owns a run of
// ~T/AF_WARPS consecutive steps.  Phase 1: the warp composes its run from
// a zero carry as the k x (k+1) affine map [Phi | z] (lane j keeps column
// j in registers, so no lane waits on another).  Phase 2: warp 0 carries
// the state across the AF_WARPS maps (AF_WARPS matrix-vector steps).
// Phase 3: each warp re-runs its steps from its entry state and writes x.
// The sequential depth is ~2 T / AF_WARPS + AF_WARPS steps instead of T.
// Only the order of additions differs from the sequential recursion; the
// closed-loop M of the filter and smoother has spectral radius < 1, so the
// carried maps stay bounded.  k is a template constant (1 .. DFM_KMAX).
#include "common.cuh"

constexpr int AF_WARPS = 16;

template <typename T, int K>
__global__ void __launch_bounds__(32 * AF_WARPS)
affine_scan_kernel(const T* __restrict__ d, const T* __restrict__ Mh,
                   const T* __restrict__ M, const T* __restrict__ xb,
                   T* __restrict__ x, int T_, int h, int reverse) {
  __shared__ T Ms[K][K];
  __shared__ T Phi[AF_WARPS][K][K + 1];
  __shared__ T cin[AF_WARPS][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) Ms[e / K][e % K] = M[e];
  const int n = T_ - 1;                       // steps, at positions 1 .. n
  const int L = (n + AF_WARPS - 1) / AF_WARPS;
  const int lo = 1 + warp * L, hi = min(1 + (warp + 1) * L, n + 1);
  __syncthreads();

  // Phase 1: [Phi | z] of this warp's steps; lane j < K holds column j of
  // Phi, lane K holds z.
  if (lane <= K) {
    T col[K];
    for (int r = 0; r < K; ++r) col[r] = (r == lane) ? T(1) : T(0);
    for (int i = lo; i < hi; ++i) {
      const int t = reverse ? T_ - 1 - i : i;
      const T* Mt = t < h ? Mh + (size_t)t * K * K : &Ms[0][0];
      T nw[K];
      for (int r = 0; r < K; ++r) {
        T s = T(0);
        for (int l = 0; l < K; ++l) s += Mt[r * K + l] * col[l];
        nw[r] = s;
      }
      if (lane == K)
        for (int r = 0; r < K; ++r) nw[r] += d[(size_t)t * K + r];
      for (int r = 0; r < K; ++r) col[r] = nw[r];
    }
    for (int r = 0; r < K; ++r) Phi[warp][r][lane] = col[r];
  }
  __syncthreads();

  // Phase 2: the entry state of every warp's run (all lanes of warp 0
  // carry the same vector; lane 0 stores it).
  if (warp == 0) {
    T c[K];
    for (int r = 0; r < K; ++r) c[r] = xb[r];
    for (int w = 0; w < AF_WARPS; ++w) {
      if (lane == 0)
        for (int r = 0; r < K; ++r) cin[w][r] = c[r];
      T nc[K];
      for (int r = 0; r < K; ++r) {
        T s = Phi[w][r][K];
        for (int l = 0; l < K; ++l) s += Phi[w][r][l] * c[l];
        nc[r] = s;
      }
      for (int r = 0; r < K; ++r) c[r] = nc[r];
    }
  }
  __syncthreads();

  // Phase 3: re-run each run from its entry state; lane r writes x_t[r].
  {
    T c[K];
    for (int r = 0; r < K; ++r) c[r] = cin[warp][r];
    for (int i = lo; i < hi; ++i) {
      const int t = reverse ? T_ - 1 - i : i;
      const T* Mt = t < h ? Mh + (size_t)t * K * K : &Ms[0][0];
      T nw[K];
      for (int r = 0; r < K; ++r) {
        T s = T(0);
        for (int l = 0; l < K; ++l) s += Mt[r * K + l] * c[l];
        nw[r] = s + d[(size_t)t * K + r];
      }
      for (int r = 0; r < K; ++r) {
        c[r] = nw[r];
        if (r == lane) x[(size_t)t * K + r] = nw[r];
      }
    }
  }
  if (threadIdx.x < K) {
    const int tb = reverse ? T_ - 1 : 0;
    x[(size_t)tb * K + threadIdx.x] = xb[threadIdx.x];
  }
}

template <typename T>
static int launch(const T* d, const T* Mh, const T* M, const T* xb, T* x,
                  int T_, int h, int k, int reverse, cudaStream_t stream) {
  if (T_ < 1 || h < 0) return (int)cudaErrorInvalidValue;
  DFM_DISPATCH_K(k, affine_scan_kernel<T, K><<<1, 32 * AF_WARPS, 0, stream>>>(
                        d, Mh, M, xb, x, T_, h, reverse))
  return (int)cudaGetLastError();
}

extern "C" {
#if DFM_WANT_F32
int affine_scan_f32(const float* d, const float* Mh, const float* M,
                    const float* xb, float* x, int T, int h, int k,
                    int reverse, void* stream) {
  return launch<float>(d, Mh, M, xb, x, T, h, k, reverse,
                       (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int affine_scan_f64(const double* d, const double* Mh, const double* M,
                    const double* xb, double* x, int T, int h, int k,
                    int reverse, void* stream) {
  return launch<double>(d, Mh, M, xb, x, T, h, k, reverse,
                        (cudaStream_t)stream);
}
#endif
}
