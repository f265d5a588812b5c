// Latency floor of K4 (info_scan.cu), for the roofline of its two passes.
//
// Bytes and operations do not bound K4: each pass moves well under a MB and
// does a few MFLOP, but step t+1 needs step t.  This probe measures the
// floor that the dependence sets.  One thread runs, for each step, the
// dependent chain of one step's scalar operations, with every operation
// off that chain removed.  That is the time a pass would take with
// unlimited parallelism and free synchronization, as the algorithm is
// written: Cholesky pivots in sequence, IEEE sqrt and division as the
// kernels do them, and each k x k product as one multiply and a balanced
// tree of adds, 1 + ceil(log2 k) dependent operations per element.
//
// Forward step (info_scan_kernel), the chain from P_pred,t to P_pred,t+1:
//   sym(P) + jitter                         2
//   Lp = chol(.)                            k sqrt, k-1 div, k-1 fma (pivot
//                                           p: sqrt, scale column p by it,
//                                           update pivot p+1)
//   C_t Lp, Lp'(C_t Lp), sym(I + G)         2 products, 2
//   Lg = chol(.)                            k sqrt, k-1 div, k-1 fma
//   X = G^{-1} Lp'                          2k div, 2(k-1) fma (forward and
//                                           back substitution)
//   P_f = sym(Lp X)                         1 product, 1
//   A P_f, (A P_f) A', + Q and sym          2 products, 2
// The x chain (C_t x, P_f u, A x_f) is shorter and runs beside it.
//
// Backward step (rts_smoother_kernel): J_t depends on the forward pass
// alone, so every J_t can be formed at once, and the chain from P_sm,t+1
// to P_sm,t is  P_next - P_pred (1), J D and (J D) J' (2 products), + P_f
// and sym (2), over T-1 steps; plus one J_t (a Cholesky, two
// substitutions, a product) at the start.
//
// Each operation on the chain is an fma, a sqrt or a division whose
// operands come from memory, so nothing folds; the values stay near fixed
// points (x -> x h + c, x -> b - (a / sqrt x)^2), so nothing overflows.
// k runs to DFM_WIDE_KMAX with K a template constant (the k <= 16 and
// wide K4 pairs), and from there to DFM_GEN_KMAX = 128 with a runtime k
// (step_chain_gen_kernel, the generic pair's floor; the loop counters run
// beside the floating-point chain, off its dependence).  The generic pair's
// blocked Cholesky and triangular solves keep the same chain of k pivots
// and substitutions a step.
#include "common.cuh"

__host__ __device__ constexpr int ceil_log2(int k) {
  return k <= 1 ? 0 : 1 + ceil_log2((k + 1) / 2);
}

__device__ __forceinline__ float chain_fma(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double chain_fma(double x, double y, double z) {
  return fma(x, y, z);
}

template <typename T>
struct Chain {
  T h, c, a, b, e;

  // Each takes its length as an argument: a template caller passes a
  // constant (the loops unroll), the generic kernel a runtime k.
  __device__ __forceinline__ T fmas(T x, int n) const {
#pragma unroll
    for (int i = 0; i < n; ++i) x = chain_fma(x, h, c);
    return x;
  }

  __device__ __forceinline__ T chol(T x, int k) const {
#pragma unroll
    for (int p = 0; p < k; ++p) {
      const T d = dfm_sqrt(x);
      if (p + 1 < k) {
        const T l = a / d;
        x = chain_fma(-l, l, b);
      } else {
        x = d;
      }
    }
    return x;
  }

  __device__ __forceinline__ T subst(T x, int k) const {
#pragma unroll
    for (int i = 0; i < k; ++i) {
      if (i > 0) x = chain_fma(x, h, c);
      x = x / e;
    }
    return x;
  }

  // One pass: the backward pass's J_t at the start, then its T - 1 steps;
  // or the forward pass's T steps (the chains of the header).
  __device__ __forceinline__ T pass(T x, int T_, int k, int prod,
                                    int backward) const {
    if (backward) {
      x = chol(x, k);
      x = subst(x, k);
      x = subst(x, k);
      x = fmas(x, prod);
      for (int t = 0; t + 1 < T_; ++t) x = fmas(x, 2 * prod + 3);
    } else {
      for (int t = 0; t < T_; ++t) {
        x = fmas(x, 2);
        x = chol(x, k);
        x = fmas(x, 2 * prod + 2);
        x = chol(x, k);
        x = subst(x, k);
        x = subst(x, k);
        x = fmas(x, prod + 1);
        x = fmas(x, 2 * prod + 2);
      }
    }
    return x;
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(1)
step_chain_kernel(const T* __restrict__ consts, T* __restrict__ out, int T_,
                  int backward) {
  constexpr int PROD = 1 + ceil_log2(K);
  const Chain<T> ch{consts[0], consts[1], consts[2], consts[3], consts[4]};
  out[0] = ch.pass(consts[1], T_, K, PROD, backward);
}

template <typename T>
__global__ void __launch_bounds__(1)
step_chain_gen_kernel(const T* __restrict__ consts, T* __restrict__ out,
                      int T_, int k, int backward) {
  const Chain<T> ch{consts[0], consts[1], consts[2], consts[3], consts[4]};
  out[0] = ch.pass(consts[1], T_, k, 1 + ceil_log2(k), backward);
}

template <typename T>
static int launch_chain(const T* consts, T* out, int T_, int k, int backward,
                        cudaStream_t stream) {
  if (k > DFM_WIDE_KMAX && k <= DFM_GEN_KMAX) {
    step_chain_gen_kernel<T><<<1, 1, 0, stream>>>(consts, out, T_, k,
                                                  backward);
    return (int)cudaGetLastError();
  }
  DFM_DISPATCH_WIDE_K(k, step_chain_kernel<T, K><<<1, 1, 0, stream>>>(
                             consts, out, T_, backward))
  return (int)cudaGetLastError();
}

extern "C" {
#if DFM_WANT_F32
int step_chain_f32(const float* consts, float* out, int T, int k,
                   int backward, void* stream) {
  return launch_chain<float>(consts, out, T, k, backward,
                             (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int step_chain_f64(const double* consts, double* out, int T, int k,
                   int backward, void* stream) {
  return launch_chain<double>(consts, out, T, k, backward,
                              (cudaStream_t)stream);
}
#endif
}
