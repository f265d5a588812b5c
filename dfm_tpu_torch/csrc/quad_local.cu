// K1: the innovation quadratic of the information-form loglik.
//
// Replaces dfm_tpu/ssm/info_filter.py:quad_local (line 159):
//   quad_R[t] = sum_n w_tn * (y_tn - lam_n . x_t)^2 / R_n
// with the (T, N) -> (T,) sum accumulated in double and, when masked, the
// residual of a missing entry zeroed (w * nan_to_num(v)) before it is
// squared.  The JAX routine also returns the residual panel V, but its only
// caller drops it, so here V never reaches device memory.
//
// Bound on the H100: bytes.  The kernel must read Y (and the mask) once:
// 20 MB unmasked, 40 MB masked in f32 at T = 500, N = 10,000, against
// ~2(k+2) flops per entry.
//
// Design: one block per time row.  Each thread walks series n with a
// stride of blockDim.x (coalesced reads of the row of Y and of the mask),
// forms the k-dot with x_t held in shared memory, squares and scales in the
// compute type, and adds the term to a double accumulator; the block then
// reduces in double.
#include "common.cuh"

template <typename T>
__global__ void quad_local_kernel(const T* __restrict__ Y,
                                  const T* __restrict__ Lam,
                                  const T* __restrict__ R,
                                  const T* __restrict__ x_pred,
                                  const T* __restrict__ mask,
                                  double* __restrict__ out, int N, int k) {
  __shared__ T xs[DFM_KMAX];
  __shared__ double red[32];
  const int t = blockIdx.x;
  if (threadIdx.x < k) xs[threadIdx.x] = x_pred[(size_t)t * k + threadIdx.x];
  __syncthreads();
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

template <typename T>
static int launch(const T* Y, const T* Lam, const T* R, const T* x_pred,
                  const T* mask, double* out, int T_, int N, int k,
                  cudaStream_t stream) {
  if (k < 1 || k > DFM_KMAX) return (int)cudaErrorInvalidValue;
  if (T_ > 0)
    quad_local_kernel<T><<<T_, 256, 0, stream>>>(Y, Lam, R, x_pred, mask,
                                                 out, N, k);
  return (int)cudaGetLastError();
}

extern "C" {
#if DFM_WANT_F32
int quad_local_f32(const float* Y, const float* Lam, const float* R,
                   const float* x_pred, const float* mask, double* out,
                   int T, int N, int k, void* stream) {
  return launch<float>(Y, Lam, R, x_pred, mask, out, T, N, k,
                       (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int quad_local_f64(const double* Y, const double* Lam, const double* R,
                   const double* x_pred, const double* mask, double* out,
                   int T, int N, int k, void* stream) {
  return launch<double>(Y, Lam, R, x_pred, mask, out, T, N, k,
                        (cudaStream_t)stream);
}
#endif
}
