// K8: the blocked associative scans of the square-root parallel-in-time
// engine, in one launch of one CTA each.
//
// Replaces dfm_tpu/ops/scan.py:blocked_scan (line 73) driven by
// dfm_tpu/ssm/parallel_filter.py:qr_combine_filter (395; the filter's
// inclusive prefix) and qr_combine_smoother (497; the smoother's inclusive
// suffix).  The decomposition is the JAX one, so the kernel and the plain
// twin associate identically: S = min(max(1, floor(sqrt(T))), T) elements
// a block, B = T // S blocks, T0 = B S, and
//   phase 1  each block's inclusive prefix (one thread per block, S - 1
//            combines in sequence);
//   phase 2  the inclusive prefix of the B block totals (one thread, into
//            the scratch buffer);
//   phase 3  every element of blocks 1 .. B-1 combined with the total of
//            the blocks before it (one thread per element);
//   then the T - T0 remaining elements in sequence from element T0 - 1.
// The smoother runs the same scan over the reversed sequence with
// combine(carry, element) = qr_combine_smoother(later, earlier).
//
// A filter combine (ei earlier, ej later; the algebra is in
// parallel_filter.py:259-285) is four tria, two tri_solve, three chol_solve
// and about a dozen k x k products; a smoother combine one tria and two
// products.  Bound on the H100: the 2 sqrt(T) combines in sequence (phases
// 1 and 2), each a chain of dependent scalar operations in one thread; the
// bytes (~3 T k^2 values in and out) and the operations (~60 k^3 a
// combine) are far below.  Design: elements are read from and written to
// the global arrays in place (they stay in L2), the working elements and
// temporaries of a combine live in one thread's registers and local memory,
// and __syncthreads() separates the phases.  k <= DFM_QR_KMAX.  The
// combine bodies live in qr_combine.cuh, shared with pit_assoc.cu.
#include "qr_combine.cuh"

constexpr int QS_THREADS = 256;

template <typename T, int K, typename Elem>
__global__ void __launch_bounds__(QS_THREADS)
qr_scan_kernel(Arrays<T> el, Arrays<T> off, int n, int S, int reverse) {
  const int tid = threadIdx.x;
  const int B = n / S, T0 = B * S;
  auto at = [&](int i) { return reverse ? n - 1 - i : i; };
  Elem acc, e, o;
  // Phase 1: within-block inclusive prefixes, in place.
  for (int blk = tid; blk < B; blk += blockDim.x) {
    load(el, at(blk * S), acc);
    for (int s = 1; s < S; ++s) {
      load(el, at(blk * S + s), e);
      combine(acc, e, o);
      acc = o;
      store(el, at(blk * S + s), acc);
    }
  }
  __syncthreads();
  if (B > 1) {
    // Phase 2: inclusive prefix of the block totals, into off.
    if (tid == 0) {
      load(el, at(S - 1), acc);
      store(off, 0, acc);
      for (int b = 1; b < B - 1; ++b) {
        load(el, at(b * S + S - 1), e);
        combine(acc, e, o);
        acc = o;
        store(off, b, acc);
      }
    }
    __syncthreads();
    // Phase 3: offset every element of blocks 1 .. B-1.
    for (int i = tid; i < (B - 1) * S; i += blockDim.x) {
      const int b = 1 + i / S, s = i % S;
      load(off, b - 1, acc);
      load(el, at(b * S + s), e);
      combine(acc, e, o);
      store(el, at(b * S + s), o);
    }
    __syncthreads();
  }
  // The remainder, in sequence.
  if (tid == 0 && T0 < n) {
    load(el, at(T0 - 1), acc);
    for (int i = T0; i < n; ++i) {
      load(el, at(i), e);
      combine(acc, e, o);
      acc = o;
      store(el, at(i), acc);
    }
  }
}

template <typename T>
static int launch(int smoother, T* e0, T* e1, T* e2, T* e3, T* e4,
                  T* scratch, int n, int S, int k, cudaStream_t s) {
  if (n < 1 || S < 1 || S > n) return (int)cudaErrorInvalidValue;
  const size_t kk = (size_t)k * k, nb = (size_t)(n / S);
  Arrays<T> el{{e0, e1, e2, e3, e4}};
  // The scratch holds B block totals in the element layout.
  Arrays<T> off{{scratch, scratch + nb * kk, scratch + nb * (kk + k),
                 scratch + nb * (2 * kk + k), scratch + nb * (2 * kk + 2 * k)}};
  if (smoother) {
    DFM_DISPATCH_QR_K(k, qr_scan_kernel<T, K, SElem<T, K>><<<1, QS_THREADS, 0, s>>>(
                             el, off, n, S, 1))
  } else {
    DFM_DISPATCH_QR_K(k, qr_scan_kernel<T, K, FElem<T, K>><<<1, QS_THREADS, 0, s>>>(
                             el, off, n, S, 0))
  }
  return (int)cudaGetLastError();
}

extern "C" {
#if DFM_WANT_F32
int qr_scan_f32(int smoother, float* e0, float* e1, float* e2, float* e3,
                float* e4, float* scratch, int n, int S, int k,
                void* stream) {
  return launch<float>(smoother, e0, e1, e2, e3, e4, scratch, n, S, k,
                       (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int qr_scan_f64(int smoother, double* e0, double* e1, double* e2, double* e3,
                double* e4, double* scratch, int n, int S, int k,
                void* stream) {
  return launch<double>(smoother, e0, e1, e2, e3, e4, scratch, n, S, k,
                        (cudaStream_t)stream);
}
#endif
}
